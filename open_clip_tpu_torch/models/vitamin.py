"""ViTamin image towers (counterpart of ``open_clip_tpu/models/vitamin.py``).

The hybrid tower of the ViTamin paper in timm's ``vitamin.py`` layout, as the JAX
package builds it natively: a stem of two 3x3 convolutions (the first at stride 2),
each followed by a channel LayerNorm and GELU; two MBConv-LN stages, each entered at
stride 2; a LayerNorm and a strided 3x3 ``pool`` convolution to the ViT width (the
map at 1/16 of the image); ``pos_embed`` without a class token; the ViT blocks, whose
MLP is GeGLU (``gelu(w0(h)) * w1(h) -> w2``) and whose qkv is one product plus bias;
the final ``norm``, the mean over tokens and ``proj``.

An MBConv-LN block: pre-norm, 1x1 expand x4, GELU, 3x3 depthwise (stride 2 in a
stage's first block), GELU, 1x1, on a residual; where the shape changes the shortcut
is a 2x2/2 average pool (zero-padded at an odd edge and still divided by 4, the JAX
``reduce_window(..., "SAME") / 4``) and a 1x1 convolution. Every convolution pads
``k // 2`` on each side (torch's), not XLA's "SAME", which shifts the grid at stride 2;
the forward passes each one's stride and padding.

Activations stay NHWC: the LayerNorms read the channels as the last axis and each
convolution sees a ``channels_last`` NCHW view of the same memory (``ops/layers.py:
conv2d``), as in ``models/convnext.py``. Names follow the JAX tree (``stem.conv1``,
``stages.{i}.blocks.{j}.conv2_kxk``, ``pool.conv``, ``pos_embed``, ``norm``,
``proj``), with the layer-stacked ViT ``blocks`` held one module a block under
``transformer.resblocks``; the MBConv blocks are a plain list in the JAX tree too.

Training changes nothing: every registry config sets ``timm_drop_path`` 0.1, and the
JAX ``apply_vitamin`` ignores it (``del train, rng``), so the port's train-mode
forward is its eval forward (ROADMAP, the reference's faults). With ``remat`` each ViT
block is recomputed whole in the backward pass, as the JAX ``jax.checkpoint`` of each
block without a policy. A timm checkpoint (``visual.trunk.*``, ``visual.head.proj``)
converts through ``torch_vitamin_clip_to_params``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..config import CLIPVisionCfg
from ..ops.attention import multi_head_attention
from ..ops.layers import gelu, linear
from .blocks import LayerNorm
from .convnext import _conv_nhwc
from .naflex_vit import _ln_init_


@dataclasses.dataclass(frozen=True)
class ViTaminCfg:
    conv_dims: Tuple[int, int]          # C1, C2 (MBConv stages)
    conv_depths: Tuple[int, int]
    embed_dim: int                      # C3 (ViT stage width)
    depth: int                          # ViT blocks
    heads: int
    mlp_ratio: float = 2.0              # GeGLU hidden = ratio * dim
    expand_ratio: float = 4.0           # MBConv expansion
    image_size: int = 224
    ln_eps: float = 1e-6


# the JAX package's table, sized to the paper's parameter counts (S 22M, B 87M, L 333M)
VITAMIN_CFGS: Dict[str, ViTaminCfg] = {
    "vitamin_small": ViTaminCfg((64, 128), (2, 4), 384, 14, 6),
    "vitamin_base": ViTaminCfg((128, 256), (2, 4), 768, 14, 12),
    "vitamin_large": ViTaminCfg((160, 320), (2, 4), 1024, 31, 16),
    "vitamin_large2": ViTaminCfg((160, 320), (2, 4), 1024, 31, 16),
    "vitamin_xlarge": ViTaminCfg((192, 384), (2, 4), 1152, 32, 16),
}


def _base_name(vcfg: Optional[CLIPVisionCfg]) -> str:
    """The table's key: the timm name without its resolution (vitamin_large2_224)."""
    parts = (getattr(vcfg, "timm_model_name", None) or "").split(".")[0].split("_")
    return "_".join(parts[:-1] if parts and parts[-1].isdigit() else parts)


def is_vitamin(vcfg: Optional[CLIPVisionCfg]) -> bool:
    return _base_name(vcfg) in VITAMIN_CFGS


def parse_vitamin_cfg(vcfg: CLIPVisionCfg) -> ViTaminCfg:
    size = vcfg.image_size if isinstance(vcfg.image_size, int) else vcfg.image_size[0]
    return dataclasses.replace(VITAMIN_CFGS[_base_name(vcfg)], image_size=size)


def _avg_pool_same(x: torch.Tensor) -> torch.Tensor:
    """NHWC 2x2/2 average: an odd edge gets a zero row or column and the window's sum
    is still divided by 4."""
    x = F.pad(x, (0, 0, 0, x.shape[2] % 2, 0, x.shape[1] % 2))
    return F.avg_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)


class MbConvBlock(nn.Module):
    def __init__(self, cin: int, cout: int, expand: float, stride: int, eps: float):
        super().__init__()
        mid = int(cout * expand)
        self.stride = stride
        self.pre_norm = LayerNorm(cin, eps=eps)
        self.conv1_1x1 = nn.Conv2d(cin, mid, 1)
        self.conv2_kxk = nn.Conv2d(mid, mid, 3, groups=mid)  # depthwise
        self.conv3_1x1 = nn.Conv2d(mid, cout, 1)
        self.down = nn.Conv2d(cin, cout, 1) if stride == 2 or cin != cout else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x
        if self.down is not None:
            if self.stride == 2:
                shortcut = _avg_pool_same(shortcut)
            shortcut = _conv_nhwc(shortcut, self.down)
        h = gelu(_conv_nhwc(self.pre_norm(x), self.conv1_1x1))
        h = gelu(_conv_nhwc(h, self.conv2_kxk, self.stride, 1, groups=h.shape[-1]))
        return shortcut + _conv_nhwc(h, self.conv3_1x1)


class GeGluBlock(nn.Module):
    """A ViT block of the ViTamin stage: ``ln_1``, fused-qkv attention, and the GeGLU
    MLP with its own pre-norm ``mlp.norm``."""

    def __init__(self, dim: int, heads: int, hidden: int, eps: float):
        super().__init__()
        self.heads = heads
        self.ln_1 = LayerNorm(dim, eps=eps)
        self.attn = nn.ModuleDict({"qkv": nn.Linear(dim, 3 * dim), "proj": nn.Linear(dim, dim)})
        self.mlp = nn.ModuleDict({"norm": LayerNorm(dim, eps=eps), "w0": nn.Linear(dim, hidden),
                                  "w1": nn.Linear(dim, hidden), "w2": nn.Linear(hidden, dim)})

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a, m = self.attn, self.mlp
        x = x + multi_head_attention(self.ln_1(x), a["qkv"].weight, a["qkv"].bias,
                                     a["proj"].weight, a["proj"].bias, num_heads=self.heads)
        h = m["norm"](x)
        g = gelu(linear(h, m["w0"].weight, m["w0"].bias, transposed=True))
        u = linear(h, m["w1"].weight, m["w1"].bias, transposed=True)
        return x + linear(g * u, m["w2"].weight, m["w2"].bias, transposed=True)


class ViTamin(nn.Module):
    def __init__(self, vision_cfg: CLIPVisionCfg, embed_dim: int):
        super().__init__()
        cfg = self.cfg = parse_vitamin_cfg(vision_cfg)
        (c1, c2), d, eps = cfg.conv_dims, cfg.embed_dim, cfg.ln_eps
        self.stem = nn.ModuleDict({"conv1": nn.Conv2d(3, c1, 3), "norm1": LayerNorm(c1, eps=eps),
                                   "conv2": nn.Conv2d(c1, c1, 3), "norm2": LayerNorm(c1, eps=eps)})
        self.stages = nn.ModuleList()
        cin = c1
        for depth, cout in zip(cfg.conv_depths, cfg.conv_dims):
            stage = nn.Module()
            stage.blocks = nn.ModuleList(
                MbConvBlock(cin if j == 0 else cout, cout, cfg.expand_ratio, 2 if j == 0 else 1, eps)
                for j in range(depth))
            self.stages.append(stage)
            cin = cout
        self.pool = nn.ModuleDict({"norm": LayerNorm(c2, eps=eps), "conv": nn.Conv2d(c2, d, 3)})
        grid = cfg.image_size // 16
        self.pos_embed = nn.Parameter(torch.empty(grid * grid, d))
        self.transformer = nn.Module()
        self.transformer.resblocks = nn.ModuleList(
            GeGluBlock(d, cfg.heads, int(d * cfg.mlp_ratio), eps) for _ in range(cfg.depth))
        self.norm = LayerNorm(d, eps=eps)
        self.proj = nn.Linear(d, embed_dim)

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator) -> None:
        """The JAX ``init_vitamin`` distributions: convolutions N(0, 2 / fan_in), the
        ViT kernels N(0, 1 / fan_in), ``pos_embed`` N(0, 0.02), zero biases,
        LayerNorms at the identity."""
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                fan_in = m.weight[0].numel()
                gain = 2.0 if isinstance(m, nn.Conv2d) else 1.0
                m.weight.normal_(0.0, (gain / fan_in) ** 0.5, generator=gen)
                m.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                _ln_init_(m)
        self.pos_embed.normal_(0.0, 0.02, generator=gen)

    def forward(self, image: torch.Tensor, compute_dtype: torch.dtype = torch.float32, *,
                train: bool = False, remat: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B, H, W, 3) normalized NHWC -> pooled, projected (B, embed_dim); ``train``
        changes nothing (see the module's docstring)."""
        s = self.stem
        x = gelu(s["norm1"](_conv_nhwc(image.to(compute_dtype), s["conv1"], 2, 1)))
        x = gelu(s["norm2"](_conv_nhwc(x, s["conv2"], 1, 1)))
        for stage in self.stages:
            for blk in stage.blocks:
                x = blk(x)
        x = _conv_nhwc(self.pool["norm"](x), self.pool["conv"], 2, 1)
        x = x.flatten(1, 2) + self.pos_embed.to(x.dtype)
        for blk in self.transformer.resblocks:
            if remat and torch.is_grad_enabled():
                x = checkpoint(blk, x, use_reentrant=False)
            else:
                x = blk(x)
        x = self.norm(x).mean(dim=1)
        return linear(x, self.proj.weight, self.proj.bias, transposed=True)


# ---------------------------------------------------------------------------
# weights: the JAX tree -> the port's names, and the timm layout -> the JAX tree
# ---------------------------------------------------------------------------

def params_from_jax(vis: Dict[str, Any], depth: int, out: Dict[str, torch.Tensor]) -> None:
    """The JAX ``init_vitamin`` tree into ``out`` under the port's names
    (``visual.*``): the stacked ViT ``blocks`` become ``transformer.resblocks.{i}``,
    every other entry keeps its JAX path (the MBConv lists by index). A ``fc_norm``,
    which the reference converter keeps where a checkpoint has one beside ``norm``,
    has no module: loading it reports an unexpected key, as the JAX ``merge_params``
    does, since ``init_vitamin`` makes none."""
    from ..convert import _stacked_to_port, _tree_to_port

    _tree_to_port({k: v for k, v in vis.items() if k != "blocks"}, "visual", out)
    if "blocks" in vis:
        _stacked_to_port(vis["blocks"], depth, "visual.transformer.resblocks", out)


def torch_vitamin_clip_to_params(sd: Mapping[str, np.ndarray], vcfg: CLIPVisionCfg
                                 ) -> Dict[str, Any]:
    """The ``visual.*`` part of a reference ViTamin CLIP state dict, its prefix
    stripped (the timm trunk under ``trunk.``, the CLIP projection at ``head.proj``;
    numpy leaves) -> the JAX package's visual tree, as its
    ``torch_vitamin_clip_to_params`` makes it (the GluMlp ``fc1_g``/``fc1_x``/``fc2``
    naming and a HybridEmbed ``patch_embed.proj`` in place of the backbone's ``pool``
    included)."""
    from ..convert import _stack_blocks

    cfg = parse_vitamin_cfg(vcfg)

    def conv(prefix):
        p = {"kernel": sd[f"{prefix}.weight"].transpose(2, 3, 1, 0)}
        if f"{prefix}.bias" in sd:
            p["bias"] = sd[f"{prefix}.bias"]
        return p

    def ln(prefix):
        return {"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]}

    def lin(prefix):
        p = {"kernel": sd[f"{prefix}.weight"].T}
        if f"{prefix}.bias" in sd:
            p["bias"] = sd[f"{prefix}.bias"]
        return p

    bb = "trunk.patch_embed.backbone"
    params: Dict[str, Any] = {
        "stem": {"conv1": conv(f"{bb}.stem.conv1"), "norm1": ln(f"{bb}.stem.norm1"),
                 "conv2": conv(f"{bb}.stem.conv2"), "norm2": ln(f"{bb}.stem.norm2")},
        "stages": {},
    }
    for i, depth in enumerate(cfg.conv_depths):
        blocks = []
        for j in range(depth):
            bp = f"{bb}.stages.{i}.blocks.{j}"
            blk = {"pre_norm": ln(f"{bp}.pre_norm"), "conv1_1x1": conv(f"{bp}.conv1_1x1"),
                   "conv2_kxk": conv(f"{bp}.conv2_kxk"), "conv3_1x1": conv(f"{bp}.conv3_1x1")}
            if f"{bp}.down.weight" in sd:
                blk["down"] = conv(f"{bp}.down")
            blocks.append(blk)
        params["stages"][str(i)] = {"blocks": blocks}
    if f"{bb}.pool.conv.weight" in sd:
        params["pool"] = {"norm": ln(f"{bb}.pool.norm"), "conv": conv(f"{bb}.pool.conv")}
    else:  # a HybridEmbed-style projection
        params["pool"] = {"norm": ln("trunk.patch_embed.norm"), "conv": conv("trunk.patch_embed.proj")}
    if "trunk.pos_embed" in sd:
        pe = sd["trunk.pos_embed"]
        params["pos_embed"] = pe.reshape(-1, pe.shape[-1])
    blocks = []
    for i in range(cfg.depth):
        bp = f"trunk.blocks.{i}"
        mlp = {}
        if f"{bp}.mlp.w0.weight" in sd:
            mlp = {"norm": ln(f"{bp}.mlp.norm"), "w0": lin(f"{bp}.mlp.w0"),
                   "w1": lin(f"{bp}.mlp.w1"), "w2": lin(f"{bp}.mlp.w2")}
        elif f"{bp}.mlp.fc1_g.weight" in sd:  # timm GluMlp naming variant
            mlp = {"norm": ln(f"{bp}.mlp.norm"), "w0": lin(f"{bp}.mlp.fc1_g"),
                   "w1": lin(f"{bp}.mlp.fc1_x"), "w2": lin(f"{bp}.mlp.fc2")}
        blocks.append({"ln_1": ln(f"{bp}.norm1"),
                       "attn": {"qkv": lin(f"{bp}.attn.qkv"), "proj": lin(f"{bp}.attn.proj")},
                       "mlp": mlp})
    params["blocks"] = _stack_blocks(dict(enumerate(blocks)))
    params["norm"] = ln("trunk.norm") if "trunk.norm.weight" in sd else ln("trunk.fc_norm")
    if "trunk.fc_norm.weight" in sd and "trunk.norm.weight" in sd:
        params["fc_norm"] = ln("trunk.fc_norm")
    params["proj"] = lin("head.proj")
    return params
