"""Weights between the JAX package's param tree and the port's modules.

``params_from_jax`` turns a JAX CLIP param tree (numpy arrays, or anything
``np.asarray`` takes) into a state dict for ``CLIPModel``: the leading layer axis
of ``blocks`` is unstacked, (in, out) kernels become ``nn.Linear``'s (out, in),
and the patch-embedding kernel keeps its (ph*pw*3, width) patchify layout. The
keys are the reference checkpoint's, the ones the JAX package's
``params_to_torch_state_dict(params, custom_text=False)`` emits; a NaFlex visual
tree (``naflexvit_*`` towers) maps onto ``models/naflex_vit.py:NaFlexVit``'s names and
a ViT's MAP head (``map_pool``, SigLIP's) onto the same ``visual.attn_pool.*`` names,
a Swin visual tree (``swin_*``) onto timm's names in ``models/swin.py``, and the
CLAP tree of ``init_clap`` (``audio.encoder``, ``audio.proj``, ``text``,
``logit_scale``) onto ``audio.encoder.*`` (HTSAT, ``models/htsat.py``) and
``audio.proj.0``/``audio.proj.2``. Convolution kernels (kh, kw, in, out) keep the
patchify layout (kh*kw*in, out), except the token-semantic head's, which becomes
``nn.Conv2d``'s (out, in, kh, kw).

The reference's checkpoints come the same way: ``torch_clip_to_params`` (the port's
numpy copy of the JAX package's converter, with the Swin, HTSAT and CLAP ones in
``models/``) turns a reference state dict into the JAX tree, which
``params_from_jax`` then carries into the port; ``big_vision_to_params`` does the
same for big_vision SigLIP ``.npz`` files. ``reference_state_dict`` is the inverse
for the native ViT and text towers. The port's ``visual.conv1.weight`` keeps the
reference's name but not its layout, so a reference state dict is never loaded
directly.
"""

from __future__ import annotations

import logging
import re
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from .config import CLIPModelCfg

_BLOCK_KEYS = {
    ("ln_1", "scale"): "ln_1.weight",
    ("ln_1", "bias"): "ln_1.bias",
    ("ln_2", "scale"): "ln_2.weight",
    ("ln_2", "bias"): "ln_2.bias",
    ("attn", "qkv", "kernel"): "attn.in_proj_weight",
    ("attn", "qkv", "bias"): "attn.in_proj_bias",
    ("attn", "out", "kernel"): "attn.out_proj.weight",
    ("attn", "out", "bias"): "attn.out_proj.bias",
    ("mlp", "c_fc", "kernel"): "mlp.c_fc.weight",
    ("mlp", "c_fc", "bias"): "mlp.c_fc.bias",
    ("mlp", "c_proj", "kernel"): "mlp.c_proj.weight",
    ("mlp", "c_proj", "bias"): "mlp.c_proj.bias",
    ("ls_1",): "ls_1.gamma",
    ("ls_2",): "ls_2.gamma",
    # the NaFlex tower's SwiGLU blocks
    ("mlp", "w12", "kernel"): "mlp.w12.weight",
    ("mlp", "w12", "bias"): "mlp.w12.bias",
    ("mlp", "w3", "kernel"): "mlp.w3.weight",
    ("mlp", "w3", "bias"): "mlp.w3.bias",
}


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _blocks(blocks: Dict[str, Any], layers: int, prefix: str,
            out: Dict[str, torch.Tensor]) -> None:
    _stacked(blocks, _BLOCK_KEYS, layers, f"{prefix}transformer.resblocks.", out)


# the JAX param entries the port's modules hold; any other entry (a patch-embed
# bias of a plain ViT, a projection bias, a tower the port lacks) raises rather
# than being dropped
_LINEAR = {"kernel", "bias"}
_NORM = {"scale", "bias"}
_ROOT = {(): {"visual", "text", "logit_scale", "logit_bias"},
         ("text",): {"token_embedding", "positional_embedding", "ln_final", "text_projection",
                     "blocks"}}
_MAP_POOL = {"latent", "q", "kv", "proj", "norm", "mlp"}
_EXPECTED = {
    **_ROOT,
    ("text", "text_projection"): _LINEAR,
    ("visual",): {"patch_embed", "class_embedding", "positional_embedding", "ln_pre", "ln_post",
                  "proj", "blocks", "map_pool"},
    ("visual", "patch_embed"): _LINEAR,
    ("visual", "map_pool"): _MAP_POOL,
    ("visual", "map_pool", "mlp"): {"c_fc", "c_proj"},
}
_EXPECTED_CLAP = {(): {"audio", "text", "logit_scale", "logit_bias"},
                  ("audio",): {"encoder", "proj"}, ("text",): _ROOT[("text",)],
                  ("text", "text_projection"): _LINEAR}
_EXPECTED_SWIN = {**_ROOT, ("text", "text_projection"): _LINEAR,
                  ("visual",): {"patch_embed", "layers", "norm", "head"}}
_EXPECTED_NAFLEX = {
    **_ROOT,
    ("text", "text_projection"): _LINEAR,
    ("visual",): {"patch_embed", "pos_embed", "norm", "norm_pre", "cls_token", "reg_tokens",
                  "blocks", "attn_pool", "head"},
    ("visual", "patch_embed"): _LINEAR,
    ("visual", "norm"): _NORM,
    ("visual", "norm_pre"): _NORM,
    ("visual", "head"): _LINEAR,
    ("visual", "attn_pool"): _MAP_POOL,
    ("visual", "attn_pool", "mlp"): {"c_fc", "c_proj"},
}


_EXPECTED_MODERN_TEXT = {
    ("text",): {"token_embedding", "reg_tokens", "norm_pre", "blocks", "ln_final", "pool",
                "text_projection"},
    ("text", "text_projection"): _LINEAR,
    ("text", "pool"): {"query", "q", "kv", "q_norm", "k_norm"},
}
_EXPECTED_NAFLEX_AUDIO = {
    ("audio", "encoder"): {"patch_embed", "trunk", "attn_pool"},
    ("audio", "encoder", "trunk"): {"blocks", "ln_post"},
    ("audio", "encoder", "attn_pool"): _MAP_POOL,
}


def _check_keys(params: Dict[str, Any], expected, modern_text: bool = False) -> None:
    """Raise for an entry of ``params`` that ``expected`` does not allow; with
    ``modern_text`` the text tower is held to the modern tower's entries."""
    if modern_text:
        expected = {**{k: v for k, v in expected.items() if k[:1] != ("text",)},
                    **_EXPECTED_MODERN_TEXT}
    for path, allowed in expected.items():
        node = params
        for key in path:
            node = node.get(key) if isinstance(node, dict) else None
            if node is None:
                break
        else:
            extra = set(node) - allowed if isinstance(node, dict) else set()
            if extra:
                raise KeyError(f"JAX params {'/'.join(path) or '<root>'} hold {sorted(extra)}, "
                               "which the port does not have")


def _linear(node: Dict[str, Any], name: str, out: Dict[str, torch.Tensor]) -> None:
    """A JAX {kernel (in, out), bias?} entry as an ``nn.Linear``'s weight and bias.
    Here and below, a leaf the tree lacks gives no entry: the caller that loads a
    checkpoint reports it as missing."""
    extra = set(node) - _LINEAR
    if extra:
        raise KeyError(f"JAX linear {name} holds {sorted(extra)}, which the port does not have")
    if node.get("kernel") is not None:
        out[f"{name}.weight"] = _t(node["kernel"]).T.contiguous()
    if node.get("bias") is not None:
        out[f"{name}.bias"] = _t(node["bias"])


def _norm(node: Dict[str, Any], name: str, out: Dict[str, torch.Tensor]) -> None:
    for src, dst in (("scale", "weight"), ("bias", "bias")):
        if src in node:
            out[f"{name}.{dst}"] = _t(node[src])


def _naflex_visual(vis: Dict[str, Any], layers: int, out: Dict[str, torch.Tensor]) -> None:
    _linear(vis["patch_embed"], "visual.patch_embed", out)
    out["visual.pos_embed"] = _t(vis["pos_embed"])
    for name in ("norm", "norm_pre"):
        if name in vis:
            _norm(vis[name], f"visual.{name}", out)
    for name in ("cls_token", "reg_tokens"):
        if name in vis:
            out[f"visual.{name}"] = _t(vis[name])
    _blocks(vis["blocks"], layers, "visual.", out)
    if "attn_pool" in vis:
        _map_pool(vis["attn_pool"], out)
    _linear(vis["head"], "visual.head", out)


def _map_pool(pool: Dict[str, Any], out: Dict[str, torch.Tensor],
              prefix: str = "visual.attn_pool") -> None:
    """The MAP head (the NaFlex tower's ``attn_pool``, the ViT's ``map_pool``, the
    NaFlex audio encoder's ``attn_pool``) as the port's ``AttentionPoolLatent``."""
    out[f"{prefix}.latent"] = _t(pool["latent"])
    for name in ("q", "kv", "proj"):
        _linear(pool[name], f"{prefix}.{name}", out)
    _norm(pool["norm"], f"{prefix}.norm", out)
    for name in ("c_fc", "c_proj"):
        _linear(pool["mlp"][name], f"{prefix}.mlp.{name}", out)


def _stacked(blocks: Dict[str, Any], table, layers: int, prefix: str,
             out: Dict[str, torch.Tensor], skip=lambda path, i: False) -> None:
    """Layer-stacked JAX leaves -> ``{prefix}{i}.{name}`` tensors, ``table`` mapping a
    leaf's path to the port's name (a kernel is transposed)."""
    for path, stacked in _flatten(blocks):
        if path not in table:
            raise KeyError(f"block param {'/'.join(path)} has no counterpart in the port")
        stacked = np.asarray(stacked)
        if stacked.shape[0] != layers:
            raise ValueError(f"{prefix} blocks/{'/'.join(path)} stacks {stacked.shape[0]} "
                             f"layers; the config has {layers}")
        for i in range(layers):
            if not skip(path, i):
                v = _t(stacked[i])
                out[f"{prefix}{i}.{table[path]}"] = v.T.contiguous() if path[-1] == "kernel" else v


def _modern_text(txt: Dict[str, Any], layers: int, out: Dict[str, torch.Tensor]) -> None:
    """The modern text tower's tree as ``text.*`` (``models/modern_text.py``); layer
    0's stacked ``vr_lambda`` is the JAX tree's dummy and has no counterpart."""
    out["text.token_embedding.weight"] = _t(txt["token_embedding"])
    if "reg_tokens" in txt:
        out["text.reg_tokens"] = _t(txt["reg_tokens"])
    for name in ("norm_pre", "ln_final"):
        if name in txt:
            _norm(txt[name], f"text.{name}", out)
    table = {path: name for name, path in _MODERN_BLOCK_KEYS.items()}
    _stacked(txt.get("blocks", {}), table, layers, "text.transformer.resblocks.", out,
             skip=lambda path, i: i == 0 and path == ("attn", "vr_lambda"))
    if "pool" in txt:
        pool = txt["pool"]
        out["text.pool.query"] = _t(pool["query"])
        for name in ("q", "kv"):
            _linear(pool[name], f"text.pool.{name}", out)
        for name in ("q_norm", "k_norm"):
            if name in pool:
                _norm(pool[name], f"text.pool.{name}", out)
    if "text_projection" in txt:
        _linear(txt["text_projection"], "text.text_projection", out)


_TRUNK_LEAVES = ((("layer_norm1",), ("scale", "bias")), (("layer_norm2",), ("scale", "bias")),
                 *((("attn", n), ("kernel", "bias")) for n in ("q_proj", "k_proj", "v_proj",
                                                              "out_proj")),
                 *((("attn", n), ("scale", "bias")) for n in ("q_norm", "k_norm")),
                 *((("mlp", n), ("kernel", "bias")) for n in ("fc1", "gate_fc", "fc2")))
_TRUNK_BLOCK = {**{(*path, leaf): ".".join(path) + (".bias" if leaf == "bias" else ".weight")
                   for path, leaves in _TRUNK_LEAVES for leaf in leaves},
                ("ls1",): "ls1.gamma", ("ls2",): "ls2.gamma"}


def _naflex_audio(enc: Dict[str, Any], depth: int, out: Dict[str, torch.Tensor]) -> None:
    """The NaFlex audio encoder's tree as ``audio.encoder.*`` (``models/naflex_audio.py``)."""
    p = "audio.encoder."
    _linear(enc["patch_embed"]["proj"], f"{p}patch_embed.proj", out)
    _stacked(enc["trunk"]["blocks"], _TRUNK_BLOCK, depth, f"{p}trunk.resblocks.", out)
    _norm(enc["trunk"]["ln_post"], f"{p}trunk.ln_post", out)
    _map_pool(enc["attn_pool"], out, f"{p}attn_pool")


_SWIN_BLOCK = {
    ("norm1",): "norm1", ("norm2",): "norm2", ("attn", "qkv"): "attn.qkv",
    ("attn", "proj"): "attn.proj", ("mlp", "fc1"): "mlp.fc1", ("mlp", "fc2"): "mlp.fc2",
}


def _swin_block(blk: Dict[str, Any], prefix: str, out: Dict[str, torch.Tensor]) -> None:
    extra = set(blk) - {"norm1", "norm2", "attn", "mlp"}
    extra |= set(blk["attn"]) - {"qkv", "proj", "rel_bias"}
    if extra:
        raise KeyError(f"JAX Swin block {prefix} holds {sorted(extra)}, which the port does not have")
    for path, name in _SWIN_BLOCK.items():
        node = blk[path[0]] if len(path) == 1 else blk[path[0]][path[1]]
        (_norm if path[0].startswith("norm") else _linear)(node, f"{prefix}{name}", out)
    out[f"{prefix}attn.relative_position_bias_table"] = _t(blk["attn"]["rel_bias"])


def _swin_stage(stage: Dict[str, Any], blocks, prefix: str, out: Dict[str, torch.Tensor]) -> None:
    for bi, blk in enumerate(blocks):
        _swin_block(blk, f"{prefix}blocks.{bi}.", out)
    if "downsample" in stage:
        _norm(stage["downsample"]["norm"], f"{prefix}downsample.norm", out)
        _linear(stage["downsample"]["reduction"], f"{prefix}downsample.reduction", out)


def _patch_embed(pe: Dict[str, Any], prefix: str, out: Dict[str, torch.Tensor]) -> None:
    kernel = np.asarray(pe["proj"]["kernel"])  # (kh, kw, in, out) -> (kh*kw*in, out)
    out[f"{prefix}proj.weight"] = _t(kernel.reshape(-1, kernel.shape[-1]))
    out[f"{prefix}proj.bias"] = _t(pe["proj"]["bias"])
    _norm(pe["norm"], f"{prefix}norm", out)


def _swin_visual(vis: Dict[str, Any], out: Dict[str, torch.Tensor]) -> None:
    _patch_embed(vis["patch_embed"], "visual.patch_embed.", out)
    for li, layer in enumerate(vis["layers"]):
        _swin_stage(layer, layer["blocks"], f"visual.layers.{li}.", out)
    _norm(vis["norm"], "visual.norm", out)
    _linear(vis["head"]["proj"], "visual.head.proj", out)


def _htsat(enc: Dict[str, Any], out: Dict[str, torch.Tensor]) -> None:
    extra = set(enc) - {"bn0", "patch_embed", "stages", "norm", "tscam_conv", "head"}
    if extra:
        raise KeyError(f"JAX HTSAT params hold {sorted(extra)} (audio fusion?), which the port "
                       "does not have")
    p = "audio.encoder."
    for src, dst in (("scale", "weight"), ("bias", "bias"), ("mean", "running_mean"),
                     ("var", "running_var")):
        out[f"{p}bn0.{dst}"] = _t(enc["bn0"][src])
    _patch_embed(enc["patch_embed"], f"{p}patch_embed.", out)
    for li in range(len(enc["stages"])):
        stage = enc["stages"][f"stage{li}"]
        blocks = [stage["blocks"][str(bi)] for bi in range(len(stage["blocks"]))]
        _swin_stage(stage, blocks, f"{p}layers.{li}.", out)
    _norm(enc["norm"], f"{p}norm", out)
    out[f"{p}tscam_conv.weight"] = _t(np.asarray(enc["tscam_conv"]["kernel"]).transpose(3, 2, 0, 1))
    out[f"{p}tscam_conv.bias"] = _t(enc["tscam_conv"]["bias"])
    _linear(enc["head"], f"{p}head", out)


def params_from_jax(params: Dict[str, Any], cfg: CLIPModelCfg) -> Dict[str, torch.Tensor]:
    """JAX CLIP or CLAP params -> ``CLIPModel`` state dict (float32 tensors on the CPU)."""
    from .models.clap import is_naflex_audio
    from .models.text import is_modern

    out: Dict[str, torch.Tensor] = {}
    modern = is_modern(cfg.text_cfg)
    if cfg.audio_cfg is not None:
        naflex_audio = is_naflex_audio(cfg.audio_cfg)
        _check_keys(params, {**_EXPECTED_CLAP, **(_EXPECTED_NAFLEX_AUDIO if naflex_audio else {})},
                    modern)
        if naflex_audio:
            from .models.naflex_audio import _trunk_cfg_from_audio

            _naflex_audio(params["audio"]["encoder"], _trunk_cfg_from_audio(cfg.audio_cfg).depth,
                          out)
        else:
            _htsat(params["audio"]["encoder"], out)
        _linear(params["audio"]["proj"]["fc1"], "audio.proj.0", out)
        _linear(params["audio"]["proj"]["fc2"], "audio.proj.2", out)
    else:
        _visual(params, cfg, out, modern)
    if modern:
        _modern_text(params.get("text", {}), cfg.text_cfg.layers, out)
        for name in ("logit_scale", "logit_bias"):
            if name in params:
                out[name] = _t(params[name])
    else:
        _text(params, cfg, out)
    return out


def _visual(params: Dict[str, Any], cfg: CLIPModelCfg, out: Dict[str, torch.Tensor],
            modern_text: bool = False) -> None:
    from .models.naflex_vit import is_naflex, parse_naflex_cfg
    from .models.swin import is_swin
    from .models.vit import check_vision_cfg

    vis = params.get("visual", {})
    if is_swin(cfg.vision_cfg):
        _check_keys(params, _EXPECTED_SWIN, modern_text)
        _swin_visual(vis, out)
        return
    naflex = is_naflex(cfg.vision_cfg)
    _check_keys(params, _EXPECTED_NAFLEX if naflex else _EXPECTED, modern_text)
    if naflex:
        _naflex_visual(vis, parse_naflex_cfg(cfg.vision_cfg).layers, out)
    else:
        for src, dst in (("kernel", "weight"), ("bias", "bias")):
            if src in vis.get("patch_embed", {}):
                out[f"visual.conv1.{dst}"] = _t(vis["patch_embed"][src])
        for name in ("class_embedding", "positional_embedding", "proj"):
            if name in vis:
                out[f"visual.{name}"] = _t(vis[name])
        for ln in ("ln_pre", "ln_post"):
            if ln in vis:
                _norm(vis[ln], f"visual.{ln}", out)
        if "map_pool" in vis:
            _map_pool(vis["map_pool"], out)
        if "blocks" in vis:
            _blocks(vis["blocks"], check_vision_cfg(cfg.vision_cfg).layers, "visual.", out)


def _text(params: Dict[str, Any], cfg: CLIPModelCfg, out: Dict[str, torch.Tensor]) -> None:
    txt = params.get("text", {})
    for src, dst in (("token_embedding", "token_embedding.weight"),
                     ("positional_embedding", "positional_embedding")):
        if src in txt:
            out[dst] = _t(txt[src])
    _norm(txt.get("ln_final", {}), "ln_final", out)
    tp = txt.get("text_projection")
    if isinstance(tp, dict):  # a projection with a bias (``proj_bias``)
        _linear(tp, "text_projection", out)
    elif tp is not None:
        out["text_projection"] = _t(tp)
    if "blocks" in txt:
        _blocks(txt["blocks"], cfg.text_cfg.layers, "", out)
    for name in ("logit_scale", "logit_bias"):
        if name in params:
            out[name] = _t(params[name])


@torch.no_grad()
def convert_params_dtype_(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast, in place, the weights and biases of the linear maps and convolutions
    (patch embeddings, fused qkv, out/MLP projections, the MAP pools, the NaFlex
    tower's head, Swin patch merging, HTSAT's token-semantic head, the audio projection) and
    the two tower projections to ``dtype``; norms, embeddings, position grids, class,
    register and latent tokens, layer scales, relative-position tables, ``bn0`` and
    the logit scale stay fp32. The partition of
    the JAX package's ``convert_params_dtype`` and the reference's
    ``convert_weights_to_lp``, used for the pure_bf16/pure_fp16 precisions."""
    from .models.blocks import Attention
    from .models.vit import PatchEmbed

    for m in model.modules():
        names = ()
        if isinstance(m, (nn.Linear, nn.Conv2d, PatchEmbed)):
            names = ("weight", "bias")
        elif isinstance(m, Attention):
            names = ("in_proj_weight", "in_proj_bias")
        elif isinstance(getattr(m, "text_projection", None), nn.Parameter):
            names = ("text_projection",)
        if isinstance(getattr(m, "proj", None), nn.Parameter):
            names = names + ("proj",)
        for n in names:
            p = getattr(m, n, None)
            if p is not None:
                p.data = p.data.to(dtype)
    return model


# ---------------------------------------------------------------------------
# reference checkpoints -> the JAX package's param tree (numpy), the port's copy of
# ``open_clip_tpu/convert.py``'s torch -> jax half. A checkpoint loads as
# ``params_from_jax(torch_clip_to_params(sd, cfg), cfg)``: through the tree the port
# already speaks, so no second naming table stands between the two packages.
# ---------------------------------------------------------------------------

logger = logging.getLogger(__name__)


def _np(t) -> np.ndarray:
    """A numpy copy of a tensor (bfloat16 widened to float32) or an array as it is."""
    if isinstance(t, np.ndarray):
        return t
    if isinstance(t, torch.Tensor):
        t = t.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy().copy()
    return np.asarray(t)


def normalize_torch_state_dict(sd: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """Strip ``module.`` and ``_orig_mod.``, drop ``position_ids``, and move the flat
    OpenAI-CLIP text keys under ``text.``."""
    out: Dict[str, np.ndarray] = {}
    for k, v in sd.items():
        k = k.removeprefix("module.").removeprefix("_orig_mod.")
        if k.endswith("position_ids"):
            continue
        out[k] = _np(v)
    flat_text = any(k.startswith(("token_embedding", "ln_final", "transformer.resblocks"))
                    or k in ("text_projection", "positional_embedding") for k in out) \
        and not any(k.startswith("text.") for k in out)
    if flat_text:
        out = {("text." + k if k.startswith(("token_embedding", "ln_final", "transformer.",
                                             "cls_emb", "text_projection."))
                or k in ("positional_embedding", "text_projection") else k): v
               for k, v in out.items()}
    return out


_BLOCK_RE = re.compile(r"^(.*?)transformer\.resblocks\.(\d+)\.(.*)$")
_REF_BLOCK_KEYS = {
    "ln_1.weight": ("ln_1", "scale"), "ln_1.bias": ("ln_1", "bias"),
    "ln_2.weight": ("ln_2", "scale"), "ln_2.bias": ("ln_2", "bias"),
    "attn.in_proj_weight": ("attn", "qkv", "kernel"), "attn.in_proj_bias": ("attn", "qkv", "bias"),
    "attn.out_proj.weight": ("attn", "out", "kernel"), "attn.out_proj.bias": ("attn", "out", "bias"),
    "attn.ln_q.weight": ("attn", "ln_q", "scale"), "attn.ln_q.bias": ("attn", "ln_q", "bias"),
    "attn.ln_k.weight": ("attn", "ln_k", "scale"), "attn.ln_k.bias": ("attn", "ln_k", "bias"),
    "attn.ln_inner.weight": ("attn", "ln_inner", "scale"),
    "attn.ln_inner.bias": ("attn", "ln_inner", "bias"),
    "attn.head_scale": ("attn", "head_scale"), "attn.logit_scale": ("attn", "logit_scale"),
    "ln_attn.weight": ("ln_attn", "scale"), "ln_attn.bias": ("ln_attn", "bias"),
    "mlp.c_fc.weight": ("mlp", "c_fc", "kernel"), "mlp.c_fc.bias": ("mlp", "c_fc", "bias"),
    "mlp.ln.weight": ("mlp", "ln", "scale"), "mlp.ln.bias": ("mlp", "ln", "bias"),
    "mlp.c_proj.weight": ("mlp", "c_proj", "kernel"), "mlp.c_proj.bias": ("mlp", "c_proj", "bias"),
    "ls_1.gamma": ("ls_1",), "ls_2.gamma": ("ls_2",),
    "ln_1_kv.weight": ("ln_1_kv", "scale"), "ln_1_kv.bias": ("ln_1_kv", "bias"),
}


def _set(tree: dict, path, value) -> None:
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = value


def _convert_block_key(rest: str, value: np.ndarray):
    """One reference resblock key suffix -> (JAX path, value in the JAX layout)."""
    path = _REF_BLOCK_KEYS[rest]  # KeyError: a key the converter leaves over
    if path[-1] == "kernel":
        value = value.T
    elif rest in ("attn.head_scale", "attn.logit_scale"):
        value = value.reshape(-1)
    return path, value


def _stack_blocks(per_layer: Dict[int, dict]) -> dict:
    """{layer: tree} -> one tree of (layers, ...) leaves."""
    n = max(per_layer) + 1
    if set(per_layer) != set(range(n)):
        raise KeyError(f"checkpoint blocks skip layers: {sorted(per_layer)}")

    def merge(path, node0):
        if isinstance(node0, dict):
            return {k: merge(path + (k,), v) for k, v in node0.items()}
        leaves = []
        for i in range(n):
            node = per_layer[i]
            for p in path:
                node = node[p]
            leaves.append(node)
        return np.stack(leaves)

    return merge((), per_layer[0])


def _convert_attn_pool(prefix: str, sd: Dict[str, np.ndarray], tree: dict, pool_key: str) -> None:
    """The reference's AttentionalPooler (CoCa's; separate q/k/v where kdim != dim)."""
    sub = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    if not sub:
        return
    a: Dict[str, Any] = {}
    if "attn.in_proj_weight" in sub:
        w = sub["attn.in_proj_weight"]
        d = w.shape[0] // 3
        a["q"], a["k"], a["v"] = ({"kernel": w[i * d:(i + 1) * d].T} for i in range(3))
    else:
        for n in ("q", "k", "v"):
            a[n] = {"kernel": sub[f"attn.{n}_proj_weight"].T}
    if "attn.in_proj_bias" in sub:
        b = sub["attn.in_proj_bias"]
        d = b.shape[0] // 3
        for i, n in enumerate(("q", "k", "v")):
            a[n]["bias"] = b[i * d:(i + 1) * d]
    a["out"] = {"kernel": sub["attn.out_proj.weight"].T, "bias": sub["attn.out_proj.bias"]}
    tree[pool_key] = {"query": sub["query"], "attn": a,
                      "ln_q": {"scale": sub["ln_q.weight"], "bias": sub["ln_q.bias"]},
                      "ln_k": {"scale": sub["ln_k.weight"], "bias": sub["ln_k.bias"]}}


def _trunk_readers(sd: Mapping[str, np.ndarray]):
    def ln(prefix):
        return {"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]}

    def lin(prefix):
        p = {"kernel": sd[f"{prefix}.weight"].T}
        if f"{prefix}.bias" in sd:
            p["bias"] = sd[f"{prefix}.bias"]
        return p

    return ln, lin


def _trunk_depth(sd: Mapping[str, np.ndarray]) -> int:
    return 1 + max(int(k.split(".")[3]) for k in sd if k.startswith("visual.trunk.blocks."))


def _trunk_attn_pool(sd: Mapping[str, np.ndarray]) -> Dict[str, Any]:
    ln, lin = _trunk_readers(sd)
    ap = "visual.trunk.attn_pool"
    return {"latent": sd[f"{ap}.latent"].reshape(-1), "q": lin(f"{ap}.q"), "kv": lin(f"{ap}.kv"),
            "proj": lin(f"{ap}.proj"), "norm": ln(f"{ap}.norm"),
            "mlp": {"c_fc": lin(f"{ap}.mlp.fc1"), "c_proj": lin(f"{ap}.mlp.fc2")}}


def _convert_timm_vit_trunk(sd: Mapping[str, np.ndarray]) -> Dict[str, Any]:
    """A timm ViT trunk (``visual.trunk.*`` of the reference's SigLIP-family
    checkpoints: the siglip, clip and gap trunks) -> the native ViT tower's tree."""
    if "visual.trunk.patch_embed.backbone.0.conv.weight" in sd:
        raise NotImplementedError("the MCi hybrid conv stem (vit_base_mci_224, MobileCLIP-B) "
                                  "is not ported yet")
    ln, lin = _trunk_readers(sd)
    blocks = {}
    for i in range(_trunk_depth(sd)):
        b = f"visual.trunk.blocks.{i}"
        blocks[i] = {"ln_1": ln(f"{b}.norm1"),
                     "attn": {"qkv": lin(f"{b}.attn.qkv"), "out": lin(f"{b}.attn.proj")},
                     "ln_2": ln(f"{b}.norm2"),
                     "mlp": {"c_fc": lin(f"{b}.mlp.fc1"), "c_proj": lin(f"{b}.mlp.fc2")}}
    emb = sd["visual.trunk.patch_embed.proj.weight"]  # (W, 3, P, P)
    pos = sd["visual.trunk.pos_embed"]
    vis: Dict[str, Any] = {
        "patch_embed": {"kernel": emb.transpose(2, 3, 1, 0).reshape(-1, emb.shape[0]),
                        "bias": sd["visual.trunk.patch_embed.proj.bias"]},
        "positional_embedding": pos.reshape(-1, pos.shape[-1]),
        # gap trunks normalize after the pool (fc_norm)
        "ln_post": ln("visual.trunk.norm") if "visual.trunk.norm.weight" in sd
        else ln("visual.trunk.fc_norm"),
        "blocks": _stack_blocks(blocks),
    }
    if "visual.trunk.cls_token" in sd:
        vis["class_embedding"] = sd["visual.trunk.cls_token"].reshape(-1)
    if "visual.trunk.norm_pre.weight" in sd:
        vis["ln_pre"] = ln("visual.trunk.norm_pre")
    if "visual.trunk.head.weight" in sd:  # the trunk's classifier head as the projection
        vis["proj"] = sd["visual.trunk.head.weight"].T
        if "visual.trunk.head.bias" in sd:
            vis["proj_bias"] = sd["visual.trunk.head.bias"]
    if "visual.trunk.attn_pool.latent" in sd:
        vis["map_pool"] = _trunk_attn_pool(sd)
    return vis


def _convert_timm_naflexvit_trunk(sd: Mapping[str, np.ndarray]) -> Dict[str, Any]:
    """A timm NaFlexVit trunk (SigLIP2 NaFlex) -> the NaFlex tower's tree. timm's
    patchifier flattens patches channels-last, as ``NaFlexTransform`` does, so the
    patch embedding transposes without a column permutation."""
    ln, lin = _trunk_readers(sd)
    blocks = {}
    for i in range(_trunk_depth(sd)):
        b = f"visual.trunk.blocks.{i}"
        blk = {"ln_1": ln(f"{b}.norm1"),
               "attn": {"qkv": lin(f"{b}.attn.qkv"), "out": lin(f"{b}.attn.proj")},
               "ln_2": ln(f"{b}.norm2")}
        if f"{b}.mlp.fc1_g.weight" in sd:  # SwiGLU: fc1_x then the gate fc1_g
            w12 = {"kernel": np.concatenate([sd[f"{b}.mlp.fc1_x.weight"].T,
                                             sd[f"{b}.mlp.fc1_g.weight"].T], axis=1)}
            if f"{b}.mlp.fc1_g.bias" in sd:
                w12["bias"] = np.concatenate([sd[f"{b}.mlp.fc1_x.bias"], sd[f"{b}.mlp.fc1_g.bias"]])
            blk["mlp"] = {"w12": w12, "w3": lin(f"{b}.mlp.fc2")}
        else:
            blk["mlp"] = {"c_fc": lin(f"{b}.mlp.fc1"), "c_proj": lin(f"{b}.mlp.fc2")}
        if f"{b}.ls1.gamma" in sd:
            blk["ls_1"], blk["ls_2"] = sd[f"{b}.ls1.gamma"], sd[f"{b}.ls2.gamma"]
        blocks[i] = blk
    pos = sd["visual.trunk.pos_embed"]  # (1, gh, gw, W)
    vis: Dict[str, Any] = {
        "patch_embed": lin("visual.trunk.patch_embed.proj"),
        "pos_embed": pos.reshape(pos.shape[-3], pos.shape[-2], pos.shape[-1]),
        "norm": ln("visual.trunk.norm") if "visual.trunk.norm.weight" in sd
        else ln("visual.trunk.fc_norm"),
        "blocks": _stack_blocks(blocks),
    }
    if "visual.trunk.norm_pre.weight" in sd:
        vis["norm_pre"] = ln("visual.trunk.norm_pre")
    if "visual.trunk.cls_token" in sd:
        vis["cls_token"] = sd["visual.trunk.cls_token"].reshape(-1)
    if "visual.trunk.reg_token" in sd:
        reg = sd["visual.trunk.reg_token"]
        vis["reg_tokens"] = reg.reshape(-1, reg.shape[-1])
    if "visual.trunk.attn_pool.latent" in sd:
        vis["attn_pool"] = _trunk_attn_pool(sd)
    # the projection: TimmModel's head, the trunk's classifier head, or none (identity)
    if "visual.head.proj.weight" in sd:
        vis["head"] = lin("visual.head.proj")
    elif "visual.trunk.head.weight" in sd:
        vis["head"] = lin("visual.trunk.head")
    else:
        vis["head"] = {"kernel": np.eye(vis["norm"]["scale"].shape[0], dtype=np.float32)}
    return vis


def _unported_trunk(cfg: Optional[CLIPModelCfg], sd: Mapping[str, np.ndarray]) -> Optional[str]:
    """The family of a checkpoint or config the port does not build, else None."""
    vcfg = cfg.vision_cfg if cfg is not None else None
    name = (vcfg.timm_model_name or "") if vcfg is not None else ""
    for prefix, family in (("fastvit", "FastViT (MobileCLIP)"), ("mobileclip", "FastViT (MobileCLIP)"),
                           ("vitamin", "ViTamin"), ("convnext", "ConvNeXt"), ("eva", "EVA"),
                           ("vit_relpos", "relpos-ViT")):
        if name.startswith(prefix):
            return family
    if name.startswith("vit_base_mci"):
        return "the MCi hybrid conv stem (MobileCLIP-B)"
    keys = (("image_encoder.", "MobileCLIP release (image_encoder.*, the MCi stem)"),
            ("visual.trunk.stem.", "ConvNeXt"), ("visual.layer1", "ModifiedResNet"),
            ("text_decoder.", "CoCa"))
    for prefix, family in keys:
        if any(k.startswith(prefix) for k in sd):
            return family
    if any(k.startswith("visual.trunk.blocks.") and ".attn.rel_pos.mlp." in k for k in sd):
        return "relpos-ViT"
    if cfg is not None and cfg.text_cfg is not None and (cfg.text_cfg.hf_model_name
                                                         or cfg.text_cfg.hf_model_config):
        return "Hugging Face text tower"
    return None


def torch_clip_to_params(sd: Mapping[str, Any], cfg: Optional[CLIPModelCfg] = None
                         ) -> Dict[str, Any]:
    """A reference CLIP / CustomTextCLIP state dict -> the JAX package's param tree
    (numpy leaves), for the families the port builds: the native ViT and text towers,
    and the timm ViT, NaFlexVit and Swin trunks. Keys it cannot place are logged and
    listed under ``_unconverted``, as in the JAX package; a checkpoint of a family the
    port does not build raises."""
    sd = normalize_torch_state_dict(sd)
    family = _unported_trunk(cfg, sd)
    if family is not None:
        raise NotImplementedError(f"checkpoints of the {family} family are not ported yet")
    vcfg = cfg.vision_cfg if cfg is not None else None
    if any(k.startswith("visual.trunk.") for k in sd):
        if vcfg is not None and (vcfg.timm_model_name or "").startswith("naflexvit"):
            tree_vis = _convert_timm_naflexvit_trunk(sd)
            own = ("visual.trunk.", "visual.head.")
        elif any(k.startswith("visual.trunk.layers.")
                 and ".attn.relative_position_bias_table" in k for k in sd):
            from .models.swin import torch_swin_to_params

            if cfg is None:
                raise ValueError("Swin conversion needs the model config")
            trunk = {k[len("visual.trunk."):]: v for k, v in sd.items()
                     if k.startswith("visual.trunk.")}
            for hk in ("head.proj.weight", "head.proj.bias"):
                if "visual." + hk in sd:  # TimmModel's adapter projection
                    trunk[hk] = sd["visual." + hk]
            tree_vis = torch_swin_to_params(trunk, vcfg)
            own = ("visual.",)
        elif any(k.startswith("visual.trunk.blocks.") for k in sd):
            tree_vis = _convert_timm_vit_trunk(sd)
            own = ("visual.",)
        else:
            raise NotImplementedError("this timm trunk's checkpoint is not ported yet")
        rest = {k: v for k, v in sd.items() if not k.startswith(own)}
        tree = torch_clip_to_params(rest, cfg) if rest else {}
        tree["visual"] = tree_vis
        return tree
    if any(k.startswith("text.blocks.") for k in sd):  # the modern text tower
        tree = torch_clip_to_params({k: v for k, v in sd.items() if not k.startswith("text.")},
                                    cfg)
        tree["text"] = _convert_modern_text({k[len("text."):]: v for k, v in sd.items()
                                             if k.startswith("text.")})
        return tree

    tree: Dict[str, Any] = {}
    vis_blocks: Dict[int, dict] = {}
    txt_blocks: Dict[int, dict] = {}
    leftovers = []
    direct = {
        "visual.class_embedding": ("visual", "class_embedding"),
        "visual.positional_embedding": ("visual", "positional_embedding"),
        "visual.ln_pre.weight": ("visual", "ln_pre", "scale"),
        "visual.ln_pre.bias": ("visual", "ln_pre", "bias"),
        "visual.ln_post.weight": ("visual", "ln_post", "scale"),
        "visual.ln_post.bias": ("visual", "ln_post", "bias"),
        "visual.proj": ("visual", "proj"),
        "text.token_embedding.weight": ("text", "token_embedding"),
        "text.positional_embedding": ("text", "positional_embedding"),
        "text.cls_emb": ("text", "cls_emb"),
        "text.ln_final.weight": ("text", "ln_final", "scale"),
        "text.ln_final.bias": ("text", "ln_final", "bias"),
        "text.text_projection": ("text", "text_projection"),
        "logit_scale": ("logit_scale",),
        "logit_bias": ("logit_bias",),
    }
    for k, v in sd.items():
        if k.startswith(("visual.attn_pool.", "visual.attn_pool_contrastive.")):
            continue  # grouped below
        m = _BLOCK_RE.match(k)
        if m:
            try:
                path, val = _convert_block_key(m.group(3), v)
            except KeyError:
                leftovers.append(k)
                continue
            target = vis_blocks if m.group(1).startswith("visual.") else txt_blocks
            _set(target.setdefault(int(m.group(2)), {}), path, val)
        elif k == "visual.conv1.weight":  # (W, 3, P, P) -> (P*P*3, W)
            w = v.transpose(2, 3, 1, 0)
            _set(tree, ("visual", "patch_embed", "kernel"), w.reshape(-1, w.shape[-1]))
        elif k == "text.text_projection.weight":
            _set(tree, ("text", "text_projection", "kernel"), v.T)
        elif k == "text.text_projection.bias":
            _set(tree, ("text", "text_projection", "bias"), v)
        elif k in direct:
            if direct[k][-1] in ("logit_scale", "logit_bias") and v.ndim == 1:
                v = v.reshape(())
            _set(tree, direct[k], v)
        else:
            leftovers.append(k)
    if vis_blocks:
        tree.setdefault("visual", {})["blocks"] = _stack_blocks(vis_blocks)
    if txt_blocks:
        tree.setdefault("text", {})["blocks"] = _stack_blocks(txt_blocks)
    _convert_attn_pool("visual.attn_pool.", sd, tree.setdefault("visual", {}), "attn_pool")
    _convert_attn_pool("visual.attn_pool_contrastive.", sd, tree["visual"],
                       "attn_pool_contrastive")
    if leftovers:
        logger.warning("unconverted checkpoint keys: %s", leftovers[:20])
        tree["_unconverted"] = leftovers
    return tree


_MODERN_BLOCK_KEYS = {
    **{f"{m}.{p}.{leaf}": (m, p, "kernel" if leaf == "weight" else "bias")
       for m, ps in (("attn", ("qkv", "proj", "gate")), ("mlp", ("w12", "w3", "c_fc", "c_proj")))
       for p in ps for leaf in ("weight", "bias")},
    **{f"{n}.{leaf}": (n, "scale" if leaf == "weight" else "bias")
       for n in ("norm1", "norm1_post", "norm2", "norm2_post") for leaf in ("weight", "bias")},
    **{f"attn.{n}.{leaf}": ("attn", n, "scale" if leaf == "weight" else "bias")
       for n in ("q_norm", "k_norm") for leaf in ("weight", "bias")},
    "attn.vr_lambda": ("attn", "vr_lambda"), "ls1.gamma": ("ls1",), "ls2.gamma": ("ls2",),
}


def _norm_tree(sd: Mapping[str, np.ndarray], name: str) -> Dict[str, np.ndarray]:
    t = {"scale": sd[f"{name}.weight"]}
    if f"{name}.bias" in sd:
        t["bias"] = sd[f"{name}.bias"]
    return t


def _convert_modern_text(sd: Mapping[str, np.ndarray]) -> Dict[str, Any]:
    """A reference ModernTextTransformer state dict (keys without ``text.``) -> the JAX
    package's stacked tree (its ``_convert_modern_text``): ``blocks.{i}.*`` stack
    into ``blocks``, kernels transposed to (in, out). Layer 0 has no ``vr_lambda``;
    the stacked tree carries the 0.5 of the init there."""
    tree: Dict[str, Any] = {"token_embedding": sd["token_embedding.weight"]}
    if "reg_tokens" in sd:
        tree["reg_tokens"] = sd["reg_tokens"].reshape(-1, sd["reg_tokens"].shape[-1])
    for name in ("norm_pre", "ln_final"):
        if f"{name}.weight" in sd:
            tree[name] = _norm_tree(sd, name)
    per_layer: Dict[int, dict] = {}
    for k, v in sd.items():
        m = re.match(r"^blocks\.(\d+)\.(.*)$", k)
        if not m:
            continue
        if m.group(2) not in _MODERN_BLOCK_KEYS:
            raise KeyError(f"unknown modern-text block key {m.group(2)}")
        path = _MODERN_BLOCK_KEYS[m.group(2)]
        _set(per_layer.setdefault(int(m.group(1)), {}), path, v.T if path[-1] == "kernel" else v)
    if per_layer:
        if any("vr_lambda" in p.get("attn", {}) for p in per_layer.values()):
            for p in per_layer.values():
                p["attn"].setdefault("vr_lambda", np.full((1,), 0.5, dtype=np.float32))
        tree["blocks"] = _stack_blocks(per_layer)
    if "pool.query" in sd:
        pool: Dict[str, Any] = {"query": sd["pool.query"].reshape(-1)}
        for name in ("q", "kv"):
            pool[name] = {"kernel": sd[f"pool.{name}.weight"].T}
            if f"pool.{name}.bias" in sd:
                pool[name]["bias"] = sd[f"pool.{name}.bias"]
        for name in ("q_norm", "k_norm"):
            if f"pool.{name}.weight" in sd:
                pool[name] = _norm_tree(sd, f"pool.{name}")
        tree["pool"] = pool
    if "text_projection.weight" in sd:
        tree["text_projection"] = {"kernel": sd["text_projection.weight"].T}
        if "text_projection.bias" in sd:
            tree["text_projection"]["bias"] = sd["text_projection.bias"]
    return tree


def reference_state_dict(model: nn.Module, custom_text: bool = True) -> Dict[str, torch.Tensor]:
    """The model's weights in the reference checkpoint's layout and names (the JAX
    package's ``params_to_torch_state_dict``): the patch embedding as the conv's
    (W, 3, P, P), the text tower under ``text.`` when ``custom_text``. That inverse
    covers the native ViT and text towers only; a model with any other part raises
    rather than giving a dict that silently lacks it."""
    from .models.vit import VisionTransformer

    tower = getattr(model, "visual", None) or getattr(model, "audio", None)
    if not isinstance(tower, VisionTransformer):
        raise NotImplementedError("the reference layout is written for native ViT towers only "
                                  f"(this model's is {type(tower).__name__})")
    text_prefix = "text." if custom_text else ""
    text_parts = ("token_embedding.", "positional_embedding", "ln_final.", "text_projection",
                  "transformer.")
    out: Dict[str, torch.Tensor] = {}
    for k, v in model.state_dict().items():
        v = v.detach().cpu()
        if k == "visual.conv1.weight":  # (P*P*3, W) -> (W, 3, P, P)
            p = int(round((v.shape[0] // 3) ** 0.5))
            out[k] = v.reshape(p, p, 3, -1).permute(3, 2, 0, 1).contiguous()
        elif k.startswith(("visual.conv1.", "visual.attn_pool.")):
            raise NotImplementedError(f"{k}: the reference layout has no place for it here "
                                      "(the JAX package's inverse drops it)")
        elif k.startswith(("visual.", "logit_scale", "logit_bias")):
            out[k] = v
        elif k.startswith(text_parts):
            out[text_prefix + k] = v
        else:
            raise NotImplementedError(f"{k}: not a part of the native ViT and text towers")
    return out


# ---------------------------------------------------------------------------
# big_vision (SigLIP) .npz
# ---------------------------------------------------------------------------

def big_vision_to_params(w: Mapping[str, np.ndarray], cfg: CLIPModelCfg) -> Dict[str, Any]:
    """An official big_vision SigLIP ``.npz`` (as a name -> array mapping) -> the
    JAX package's param tree: per-head q/k/v kernels (W, H, hd) fused into the
    (W, 3W) qkv, the MAP head onto ``map_pool``, ``t`` and ``b`` onto the logit scale
    and bias. Blocks are read from ``encoderblock_{i}`` or from one stacked
    ``encoderblock``."""
    files = set(w)
    root = "params/" if any(k.startswith("params/") for k in files) else ""

    def g(name):
        return np.asarray(w[root + name])

    def block_tree(prefix, i):
        if f"{root}{prefix}encoderblock/LayerNorm_0/scale" in files:
            bp, sel = f"{prefix}encoderblock/", (lambda a: a[i])
        else:
            bp, sel = f"{prefix}encoderblock_{i}/", (lambda a: a)
        mp = bp + "MultiHeadDotProductAttention_0/"
        ks = [sel(g(f"{mp}{n}/kernel")) for n in ("query", "key", "value")]
        bs = [sel(g(f"{mp}{n}/bias")) for n in ("query", "key", "value")]
        width = ks[0].shape[0]

        def dense(j):
            d = f"{bp}MlpBlock_0/Dense_{j}/"
            return {"kernel": sel(g(d + "kernel")), "bias": sel(g(d + "bias"))}

        return {
            "ln_1": {"scale": sel(g(f"{bp}LayerNorm_0/scale")), "bias": sel(g(f"{bp}LayerNorm_0/bias"))},
            "attn": {"qkv": {"kernel": np.concatenate([k.reshape(width, -1) for k in ks], axis=1),
                             "bias": np.concatenate([b.reshape(-1) for b in bs])},
                     "out": {"kernel": sel(g(f"{mp}out/kernel")).reshape(-1, width),
                             "bias": sel(g(f"{mp}out/bias"))}},
            "ln_2": {"scale": sel(g(f"{bp}LayerNorm_1/scale")), "bias": sel(g(f"{bp}LayerNorm_1/bias"))},
            "mlp": {"c_fc": dense(0), "c_proj": dense(1)},
        }

    def map_head(prefix):
        bp = f"{prefix}MAPHead_0/"
        mp = bp + "MultiHeadDotProductAttention_0/"
        width = g(f"{bp}probe").shape[-1]

        def dense(j):
            d = f"{bp}MlpBlock_0/Dense_{j}/"
            return {"kernel": g(d + "kernel"), "bias": g(d + "bias")}

        return {
            "latent": g(f"{bp}probe").reshape(-1),
            "q": {"kernel": g(f"{mp}query/kernel").reshape(width, -1),
                  "bias": g(f"{mp}query/bias").reshape(-1)},
            "kv": {"kernel": np.concatenate([g(f"{mp}{n}/kernel").reshape(width, -1)
                                             for n in ("key", "value")], axis=1),
                   "bias": np.concatenate([g(f"{mp}{n}/bias").reshape(-1) for n in ("key", "value")])},
            "proj": {"kernel": g(f"{mp}out/kernel").reshape(-1, width), "bias": g(f"{mp}out/bias")},
            "norm": {"scale": g(f"{bp}LayerNorm_0/scale"), "bias": g(f"{bp}LayerNorm_0/bias")},
            "mlp": {"c_fc": dense(0), "c_proj": dense(1)},
        }

    from .models.vit import resolve_timm_vision_cfg

    vcfg = resolve_timm_vision_cfg(cfg.vision_cfg) if cfg.vision_cfg.timm_model_name \
        else cfg.vision_cfg
    emb = g("img/embedding/kernel")  # (P, P, 3, W) or (P*P*3, W)
    pos = g("img/pos_embedding")
    vis: Dict[str, Any] = {
        "patch_embed": {"kernel": emb.reshape(-1, emb.shape[-1]), "bias": g("img/embedding/bias")},
        "positional_embedding": pos.reshape(-1, pos.shape[-1]),
        "ln_post": {"scale": g("img/Transformer/encoder_norm/scale"),
                    "bias": g("img/Transformer/encoder_norm/bias")},
        "blocks": _stack_blocks({i: block_tree("img/Transformer/", i) for i in range(vcfg.layers)}),
    }
    if f"{root}img/MAPHead_0/probe" in files:
        vis["map_pool"] = map_head("img/")
    tpos = g("txt/pos_embedding")
    txt: Dict[str, Any] = {
        "token_embedding": g("txt/Embed_0/embedding"),
        "positional_embedding": tpos.reshape(-1, tpos.shape[-1]),
        "ln_final": {"scale": g("txt/Encoder_0/encoder_norm/scale"),
                     "bias": g("txt/Encoder_0/encoder_norm/bias")},
        "blocks": _stack_blocks({i: block_tree("txt/Encoder_0/", i)
                                 for i in range(cfg.text_cfg.layers)}),
    }
    if f"{root}txt/head/kernel" in files:
        txt["text_projection"] = {"kernel": g("txt/head/kernel"), "bias": g("txt/head/bias")}
    return {"visual": vis, "text": txt, "logit_scale": g("t").reshape(()),
            "logit_bias": g("b").reshape(())}


def load_big_vision_weights(model: nn.Module, checkpoint_path) -> nn.Module:
    """Load an official big_vision SigLIP ``.npz`` into ``model`` in place, as the
    JAX package's ``load_big_vision_weights`` merges it (not strict: a part the file
    lacks keeps the model's value). ``create_model(pretrained="x.npz")`` does not
    call this: there, as in the JAX package, an ``.npz`` is a flat state dict of
    reference names."""
    from .checkpoint import merge_params_

    with np.load(checkpoint_path) as w:
        tree = big_vision_to_params(w, model.cfg)
    merge_params_(model, tree, strict=False)
    return model
