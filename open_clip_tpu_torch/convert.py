"""Weights between the JAX package's param tree and the port's modules.

``params_from_jax`` turns a JAX CLIP param tree (numpy arrays, or anything
``np.asarray`` takes) into a state dict for ``CLIPModel``: the leading layer axis
of ``blocks`` is unstacked, (in, out) kernels become ``nn.Linear``'s (out, in),
and the patch-embedding kernel keeps its (ph*pw*3, width) patchify layout. The
keys are the reference checkpoint's, the ones the JAX package's
``params_to_torch_state_dict(params, custom_text=False)`` emits.
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
# bias, a projection bias, a tower the port lacks) raises rather than being dropped
_EXPECTED = {
    (): {"visual", "text", "logit_scale", "logit_bias"},
    ("visual",): {"patch_embed", "class_embedding", "positional_embedding", "ln_pre", "ln_post",
                  "proj", "blocks"},
    ("visual", "patch_embed"): {"kernel"},
    ("text",): {"token_embedding", "positional_embedding", "ln_final", "text_projection",
                "blocks"},
}


def _check_keys(params: Dict[str, Any]) -> None:
    for path, allowed in _EXPECTED.items():
        node = params
        for key in path:
            node = node[key]
        extra = set(node) - allowed
        if extra:
            raise KeyError(f"JAX params {'/'.join(path) or '<root>'} hold {sorted(extra)}, "
                           "which the port does not have")


def params_from_jax(params: Dict[str, Any], cfg: CLIPModelCfg) -> Dict[str, torch.Tensor]:
    """JAX CLIP params -> ``CLIPModel`` state dict (float32 tensors on the CPU)."""
    _check_keys(params)
    out: Dict[str, torch.Tensor] = {}
    vis = params["visual"]
    out["visual.conv1.weight"] = _t(vis["patch_embed"]["kernel"])
    out["visual.class_embedding"] = _t(vis["class_embedding"])
    out["visual.positional_embedding"] = _t(vis["positional_embedding"])
    for ln in ("ln_pre", "ln_post"):
        if ln in vis:
            out[f"visual.{ln}.weight"] = _t(vis[ln]["scale"])
            out[f"visual.{ln}.bias"] = _t(vis[ln]["bias"])
    out["visual.proj"] = _t(vis["proj"])
    _blocks(vis["blocks"], cfg.vision_cfg.layers, "visual.", out)

    txt = params["text"]
    out["token_embedding.weight"] = _t(txt["token_embedding"])
    out["positional_embedding"] = _t(txt["positional_embedding"])
    out["ln_final.weight"] = _t(txt["ln_final"]["scale"])
    out["ln_final.bias"] = _t(txt["ln_final"]["bias"])
    out["text_projection"] = _t(txt["text_projection"])
    _blocks(txt["blocks"], cfg.text_cfg.layers, "", out)

    out["logit_scale"] = _t(params["logit_scale"])
    if "logit_bias" in params:
        out["logit_bias"] = _t(params["logit_bias"])
    return out


@torch.no_grad()
def convert_params_dtype_(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast, in place, the weights and biases of the linear maps (patch embedding,
    fused qkv, out/MLP projections) and the two tower projections to ``dtype``;
    norms, embeddings, layer scales and the logit scale stay fp32. The partition of
    the JAX package's ``convert_params_dtype`` and the reference's
    ``convert_weights_to_lp``, used for the pure_bf16/pure_fp16 precisions."""
    from .models.blocks import Attention
    from .models.vit import PatchEmbed

    for m in model.modules():
        names = ()
        if isinstance(m, (nn.Linear, PatchEmbed)):
            names = ("weight", "bias")
        elif isinstance(m, Attention):
            names = ("in_proj_weight", "in_proj_bias")
        elif hasattr(m, "text_projection"):
            names = ("text_projection",)
        if getattr(m, "proj", None) is not None:
            names = names + ("proj",)
        for n in names:
            p = getattr(m, n, None)
            if p is not None:
                p.data = p.data.to(dtype)
    return model
