"""Swin-Transformer image tower, timm's ``swin_base_patch4_window7_224`` and its
siblings (counterpart of ``open_clip_tpu/models/swin.py``).

Built from HTSAT's Swin block (``models/htsat.py``), as the JAX package builds it:
a 4x4 patch embedding and LayerNorm, four stages of window attention (window 7,
shift 3 on odd blocks where the map is wider than a window) with patch merging
between them, a final LayerNorm, the mean over tokens and a linear projection.
Names follow timm's keys (``patch_embed.proj``, ``layers.{i}.blocks.{j}``,
``layers.{i}.downsample``, ``norm``, ``head.proj``). With ``remat`` each block is
recomputed in the backward pass under ``blocks.REMAT_POLICY``, as the JAX Swin does
(its blocks carry no remat tags, so the ``names`` presets save what full remat
saves). Windows of 7x7 fail the panel kernel's gate, so
on the card every block takes the window kernel (``ops/window_attention.py``).
"""

from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn

from ..config import CLIPVisionCfg, to_2tuple
from ..ops.layers import linear
from .blocks import LayerNorm, remat_call
from .htsat import SwinStage, _trunc_normal_
from .vit import PatchEmbed, patchify

SWIN_CONFIGS: Dict[str, Dict[str, Any]] = {
    "swin_base_patch4_window7_224": dict(
        patch_size=4, embed_dim=128, depths=(2, 2, 18, 2), heads=(4, 8, 16, 32),
        window=7, mlp_ratio=4.0),
    "swin_tiny_patch4_window7_224": dict(
        patch_size=4, embed_dim=96, depths=(2, 2, 6, 2), heads=(3, 6, 12, 24),
        window=7, mlp_ratio=4.0),
    "swin_small_patch4_window7_224": dict(
        patch_size=4, embed_dim=96, depths=(2, 2, 18, 2), heads=(3, 6, 12, 24),
        window=7, mlp_ratio=4.0),
    "swin_large_patch4_window7_224": dict(
        patch_size=4, embed_dim=192, depths=(2, 2, 18, 2), heads=(6, 12, 24, 48),
        window=7, mlp_ratio=4.0),
}


def is_swin(vision_cfg) -> bool:
    return vision_cfg is not None and (vision_cfg.timm_model_name or "").startswith("swin_")


def swin_cfg(vision_cfg: CLIPVisionCfg) -> Dict[str, Any]:
    name = vision_cfg.timm_model_name
    if name not in SWIN_CONFIGS:
        raise NotImplementedError(f"Swin variant {name!r} has no config yet")
    return SWIN_CONFIGS[name]


class SwinTransformer(nn.Module):
    def __init__(self, vision_cfg: CLIPVisionCfg, embed_dim: int):
        super().__init__()
        sc = self.sc = swin_cfg(vision_cfg)
        self.image_size = to_2tuple(vision_cfg.image_size)
        dims = [sc["embed_dim"] * 2 ** i for i in range(len(sc["depths"]))]
        self.patch_embed = nn.Module()
        self.patch_embed.proj = PatchEmbed(sc["patch_size"], dims[0], in_chans=3, bias=True)
        self.patch_embed.norm = LayerNorm(dims[0])
        last = len(sc["depths"]) - 1
        self.layers = nn.ModuleList(
            SwinStage(dims[li], depth, sc["heads"][li], sc["window"], sc["mlp_ratio"], li < last)
            for li, depth in enumerate(sc["depths"]))
        self.norm = LayerNorm(dims[-1])
        self.head = nn.Module()
        self.head.proj = nn.Linear(dims[-1], embed_dim)

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator) -> None:
        """The JAX package's ``init_swin`` distributions."""
        _trunc_normal_(self.patch_embed.proj.weight, gen)
        self.patch_embed.proj.bias.zero_()
        for norm in (self.patch_embed.norm, self.norm):
            norm.weight.fill_(1.0)
            norm.bias.zero_()
        for stage in self.layers:
            stage.init_weights(gen)
        _trunc_normal_(self.head.proj.weight, gen)
        self.head.proj.bias.zero_()

    def forward(self, image: torch.Tensor, compute_dtype: torch.dtype = torch.float32, *,
                train: bool = False, remat: bool = False) -> torch.Tensor:
        """(B, H, W, 3) normalized NHWC -> pooled, projected (B, embed_dim)."""
        ps, ws = self.sc["patch_size"], self.sc["window"]
        h, w = self.image_size[0] // ps, self.image_size[1] // ps
        x = self.patch_embed.proj(patchify(image.to(compute_dtype), ps))
        x = self.patch_embed.norm(x)
        for stage in self.layers:
            for bi, blk in enumerate(stage.blocks):
                # no shift where one window covers the map (timm's final 7x7 stage)
                shift = ws // 2 if bi % 2 == 1 and min(h, w) > ws else 0
                args = ((h, w), min(ws, h, w), shift)
                if remat and torch.is_grad_enabled():
                    x = remat_call(blk, x, *args)
                else:
                    x = blk(x, *args)
            if stage.downsample is not None:
                x = stage.downsample(x, (h, w))
                h, w = h // 2, w // 2
        pooled = self.norm(x).mean(dim=1)
        return linear(pooled, self.head.proj.weight, self.head.proj.bias, transposed=True)


def torch_swin_to_params(sd: Dict[str, Any], vision_cfg: CLIPVisionCfg) -> Dict[str, Any]:
    """A timm Swin trunk's state dict (``visual.trunk.`` stripped; TimmModel's
    ``head.proj`` adapter, or the trunk's ``head.fc``, beside it) -> the JAX
    package's Swin tree (numpy leaves), as its ``torch_swin_to_params`` makes it.
    Both placements of patch merging are read: at the end of stage i (older timm,
    this layout) or at the start of stage i + 1 (current timm). The buffers
    (``relative_position_index``, ``attn_mask``) are rebuilt, not read."""
    from ..convert import _np

    sc = swin_cfg(vision_cfg)
    sd = {k: _np(v) for k, v in sd.items()}
    new_layout = ("layers.1.downsample.reduction.weight" in sd
                  and "layers.0.downsample.reduction.weight" not in sd)

    def ln(prefix):
        return {"scale": sd[prefix + "weight"], "bias": sd[prefix + "bias"]}

    def lin(prefix):
        return {"kernel": sd[prefix + "weight"].T, "bias": sd[prefix + "bias"]}

    p: Dict[str, Any] = {
        "patch_embed": {"proj": {"kernel": sd["patch_embed.proj.weight"].transpose(2, 3, 1, 0),
                                 "bias": sd["patch_embed.proj.bias"]},
                        "norm": ln("patch_embed.norm.")},
        "layers": [],
        "norm": ln("norm."),
    }
    for li, depth in enumerate(sc["depths"]):
        layer: Dict[str, Any] = {"blocks": []}
        for bi in range(depth):
            b = f"layers.{li}.blocks.{bi}."
            layer["blocks"].append({
                "norm1": ln(b + "norm1."),
                "attn": {"qkv": lin(b + "attn.qkv."), "proj": lin(b + "attn.proj."),
                         "rel_bias": sd[b + "attn.relative_position_bias_table"]},
                "norm2": ln(b + "norm2."),
                "mlp": {"fc1": lin(b + "mlp.fc1."), "fc2": lin(b + "mlp.fc2.")},
            })
        ds = f"layers.{li + 1}.downsample." if new_layout else f"layers.{li}.downsample."
        if ds + "reduction.weight" in sd:
            layer["downsample"] = {"norm": ln(ds + "norm."),
                                   "reduction": {"kernel": sd[ds + "reduction.weight"].T}}
        p["layers"].append(layer)
    head = "head.proj" if "head.proj.weight" in sd else ("head.fc" if "head.fc.weight" in sd else None)
    if head is not None:
        p["head"] = {"proj": {"kernel": sd[head + ".weight"].T}}
        if head + ".bias" in sd:
            p["head"]["proj"]["bias"] = sd[head + ".bias"]
    return p
