"""Weights between the JAX package's param tree and the port's modules.

``params_from_jax`` turns a JAX CLIP param tree (numpy arrays, or anything
``np.asarray`` takes) into a state dict for ``CLIPModel``: the leading layer axis
of ``blocks`` is unstacked, (in, out) kernels become ``nn.Linear``'s (out, in),
and the patch-embedding kernel keeps its (ph*pw*3, width) patchify layout. The
keys are the reference checkpoint's, the ones the JAX package's
``params_to_torch_state_dict(params, custom_text=False)`` emits; a NaFlex visual
tree (``naflexvit_*`` towers) maps onto ``models/naflex_vit.py:NaFlexVit``'s names,
a Swin visual tree (``swin_*``) onto timm's names in ``models/swin.py``, and the
CLAP tree of ``init_clap`` (``audio.encoder``, ``audio.proj``, ``text``,
``logit_scale``) onto ``audio.encoder.*`` (HTSAT, ``models/htsat.py``) and
``audio.proj.0``/``audio.proj.2``. Convolution kernels (kh, kw, in, out) keep the
patchify layout (kh*kw*in, out), except the token-semantic head's, which becomes
``nn.Conv2d``'s (out, in, kh, kw).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from .config import CLIPModelCfg

_BLOCK_KEYS = {
    ("ln_1", "scale"): ("ln_1.weight", False),
    ("ln_1", "bias"): ("ln_1.bias", False),
    ("ln_2", "scale"): ("ln_2.weight", False),
    ("ln_2", "bias"): ("ln_2.bias", False),
    ("attn", "qkv", "kernel"): ("attn.in_proj_weight", True),
    ("attn", "qkv", "bias"): ("attn.in_proj_bias", False),
    ("attn", "out", "kernel"): ("attn.out_proj.weight", True),
    ("attn", "out", "bias"): ("attn.out_proj.bias", False),
    ("mlp", "c_fc", "kernel"): ("mlp.c_fc.weight", True),
    ("mlp", "c_fc", "bias"): ("mlp.c_fc.bias", False),
    ("mlp", "c_proj", "kernel"): ("mlp.c_proj.weight", True),
    ("mlp", "c_proj", "bias"): ("mlp.c_proj.bias", False),
    ("ls_1",): ("ls_1.gamma", False),
    ("ls_2",): ("ls_2.gamma", False),
    # the NaFlex tower's SwiGLU blocks
    ("mlp", "w12", "kernel"): ("mlp.w12.weight", True),
    ("mlp", "w12", "bias"): ("mlp.w12.bias", False),
    ("mlp", "w3", "kernel"): ("mlp.w3.weight", True),
    ("mlp", "w3", "bias"): ("mlp.w3.bias", False),
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
    for path, stacked in _flatten(blocks):
        if path not in _BLOCK_KEYS:
            raise KeyError(f"block param {'/'.join(path)} has no counterpart in the port")
        name, transpose = _BLOCK_KEYS[path]
        stacked = np.asarray(stacked)
        if stacked.shape[0] != layers:
            raise ValueError(f"{prefix}blocks/{'/'.join(path)} stacks {stacked.shape[0]} layers; "
                             f"the config has {layers}")
        for i in range(layers):
            v = _t(stacked[i])
            out[f"{prefix}transformer.resblocks.{i}.{name}"] = v.T.contiguous() if transpose else v


# the JAX param entries the port's modules hold; any other entry (a patch-embed
# bias of a plain ViT, a projection bias, a tower the port lacks) raises rather
# than being dropped
_LINEAR = {"kernel", "bias"}
_NORM = {"scale", "bias"}
_ROOT = {(): {"visual", "text", "logit_scale", "logit_bias"},
         ("text",): {"token_embedding", "positional_embedding", "ln_final", "text_projection",
                     "blocks"}}
_EXPECTED = {
    **_ROOT,
    ("visual",): {"patch_embed", "class_embedding", "positional_embedding", "ln_pre", "ln_post",
                  "proj", "blocks"},
    ("visual", "patch_embed"): {"kernel"},
}
_EXPECTED_CLAP = {(): {"audio", "text", "logit_scale", "logit_bias"},
                  ("audio",): {"encoder", "proj"}, ("text",): _ROOT[("text",)]}
_EXPECTED_SWIN = {**_ROOT, ("visual",): {"patch_embed", "layers", "norm", "head"}}
_EXPECTED_NAFLEX = {
    **_ROOT,
    ("visual",): {"patch_embed", "pos_embed", "norm", "norm_pre", "cls_token", "reg_tokens",
                  "blocks", "attn_pool", "head"},
    ("visual", "patch_embed"): _LINEAR,
    ("visual", "norm"): _NORM,
    ("visual", "norm_pre"): _NORM,
    ("visual", "head"): _LINEAR,
    ("visual", "attn_pool"): {"latent", "q", "kv", "proj", "norm", "mlp"},
    ("visual", "attn_pool", "mlp"): {"c_fc", "c_proj"},
}


def _check_keys(params: Dict[str, Any], expected) -> None:
    for path, allowed in expected.items():
        node = params
        for key in path:
            node = node.get(key) if isinstance(node, dict) else None
            if node is None:
                break
        else:
            extra = set(node) - allowed
            if extra:
                raise KeyError(f"JAX params {'/'.join(path) or '<root>'} hold {sorted(extra)}, "
                               "which the port does not have")


def _linear(node: Dict[str, Any], name: str, out: Dict[str, torch.Tensor]) -> None:
    """A JAX {kernel (in, out), bias?} entry as an ``nn.Linear``'s weight and bias."""
    extra = set(node) - _LINEAR
    if extra:
        raise KeyError(f"JAX linear {name} holds {sorted(extra)}, which the port does not have")
    out[f"{name}.weight"] = _t(node["kernel"]).T.contiguous()
    if node.get("bias") is not None:
        out[f"{name}.bias"] = _t(node["bias"])


def _norm(node: Dict[str, Any], name: str, out: Dict[str, torch.Tensor]) -> None:
    out[f"{name}.weight"] = _t(node["scale"])
    out[f"{name}.bias"] = _t(node["bias"])


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
        pool = vis["attn_pool"]
        out["visual.attn_pool.latent"] = _t(pool["latent"])
        for name in ("q", "kv", "proj"):
            _linear(pool[name], f"visual.attn_pool.{name}", out)
        _norm(pool["norm"], "visual.attn_pool.norm", out)
        for name in ("c_fc", "c_proj"):
            _linear(pool["mlp"][name], f"visual.attn_pool.mlp.{name}", out)
    _linear(vis["head"], "visual.head", out)


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
    out: Dict[str, torch.Tensor] = {}
    if cfg.audio_cfg is not None:
        _check_keys(params, _EXPECTED_CLAP)
        _htsat(params["audio"]["encoder"], out)
        _linear(params["audio"]["proj"]["fc1"], "audio.proj.0", out)
        _linear(params["audio"]["proj"]["fc2"], "audio.proj.2", out)
    else:
        _visual(params, cfg, out)
    _text(params, cfg, out)
    return out


def _visual(params: Dict[str, Any], cfg: CLIPModelCfg, out: Dict[str, torch.Tensor]) -> None:
    from .models.naflex_vit import is_naflex, parse_naflex_cfg
    from .models.swin import is_swin

    vis = params["visual"]
    if is_swin(cfg.vision_cfg):
        _check_keys(params, _EXPECTED_SWIN)
        _swin_visual(vis, out)
        return
    naflex = is_naflex(cfg.vision_cfg)
    _check_keys(params, _EXPECTED_NAFLEX if naflex else _EXPECTED)
    if naflex:
        _naflex_visual(vis, parse_naflex_cfg(cfg.vision_cfg).layers, out)
    else:
        out["visual.conv1.weight"] = _t(vis["patch_embed"]["kernel"])
        out["visual.class_embedding"] = _t(vis["class_embedding"])
        out["visual.positional_embedding"] = _t(vis["positional_embedding"])
        for ln in ("ln_pre", "ln_post"):
            if ln in vis:
                _norm(vis[ln], f"visual.{ln}", out)
        out["visual.proj"] = _t(vis["proj"])
        _blocks(vis["blocks"], cfg.vision_cfg.layers, "visual.", out)


def _text(params: Dict[str, Any], cfg: CLIPModelCfg, out: Dict[str, torch.Tensor]) -> None:
    txt = params["text"]
    out["token_embedding.weight"] = _t(txt["token_embedding"])
    out["positional_embedding"] = _t(txt["positional_embedding"])
    _norm(txt["ln_final"], "ln_final", out)
    out["text_projection"] = _t(txt["text_projection"])
    _blocks(txt["blocks"], cfg.text_cfg.layers, "", out)

    out["logit_scale"] = _t(params["logit_scale"])
    if "logit_bias" in params:
        out["logit_bias"] = _t(params["logit_bias"])


@torch.no_grad()
def convert_params_dtype_(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast, in place, the weights and biases of the linear maps and convolutions
    (patch embeddings, fused qkv, out/MLP projections, the NaFlex tower's pool and
    head, Swin patch merging, HTSAT's token-semantic head, the audio projection) and
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
        elif hasattr(m, "text_projection"):
            names = ("text_projection",)
        if isinstance(getattr(m, "proj", None), nn.Parameter):
            names = names + ("proj",)
        for n in names:
            p = getattr(m, n, None)
            if p is not None:
                p.data = p.data.to(dtype)
    return model
