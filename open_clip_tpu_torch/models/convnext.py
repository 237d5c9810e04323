"""ConvNeXt image tower, the LAION ``convnext_*`` CLIP line (counterpart of
``open_clip_tpu/models/convnext.py``).

timm's architecture, as the JAX package builds it natively: a 4x4/4 stem convolution
and LayerNorm; four stages, each after the first opened by a LayerNorm and a 2x2/2
convolution; blocks of a 7x7 depthwise convolution, LayerNorm, fc1, GELU, fc2 and the
``gamma`` layer scale on a residual, with per-sample drop path at rates spaced
linearly over all the blocks; then the global average, ``head_norm`` and the ``proj``
linear or ``proj_mlp`` (fc1, GELU, fc2) projection. Activations stay NHWC, so the
LayerNorms and the pointwise MLP read the channels as the last axis; each
convolution sees a ``channels_last`` NCHW view of the same memory (``ops/layers.py:
conv2d``). The LayerNorms go through ``ops/layers.py:layer_norm`` (the fused
backward kernel with ``FUSED_LN_BWD``) at the JAX default eps 1e-5, where timm's use
1e-6 (ROADMAP, the reference's faults; the port follows the JAX package).

Names follow the JAX tree (``stem.conv``, ``stages.{i}.blocks.{j}.dwconv``,
``stages.{i}.downsample.norm``, ``head_norm``, ``proj``, ``proj_mlp.fc1``), whose
layer-stacked ``blocks`` the port holds one module a block: the weight-decay mask,
layer decay and tower locking of ``train/optim.py`` read them as the JAX rules read
the stacked leaves. A reference checkpoint (``visual.trunk.stem/stages/head``,
``visual.head.proj|mlp``) converts through ``torch_convnext_clip_to_params``.

With ``remat`` every block is recomputed in the backward pass (full remat, one
checkpoint a block, as the JAX ``jax.checkpoint`` of each block). In training with a
drop-path rate the keep masks are drawn before each block runs, from ``generator``
(the device's default generator where None), so the recompute applies the same ones.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..config import CLIPVisionCfg
from ..ops.layers import conv2d, gelu, linear
from .blocks import LayerNorm
from .htsat import _trunc_normal_

# name -> (depths, dims); timm's convnext registry
CONVNEXT_CFGS: Dict[str, Tuple[Tuple[int, ...], Tuple[int, ...]]] = {
    "convnext_tiny": ((3, 3, 9, 3), (96, 192, 384, 768)),
    "convnext_small": ((3, 3, 27, 3), (96, 192, 384, 768)),
    "convnext_base": ((3, 3, 27, 3), (128, 256, 512, 1024)),
    "convnext_large": ((3, 3, 27, 3), (192, 384, 768, 1536)),
    "convnext_xlarge": ((3, 3, 27, 3), (256, 512, 1024, 2048)),
    "convnext_xxlarge": ((3, 4, 30, 3), (384, 768, 1536, 3072)),
}
LS_INIT = 1e-6  # the ``gamma`` layer scale's initial value


@dataclasses.dataclass(frozen=True)
class ConvNeXtCfg:
    depths: Tuple[int, ...]
    dims: Tuple[int, ...]
    drop_path_rate: float = 0.0
    proj: str = "linear"  # 'linear' | 'mlp' | 'none'
    proj_bias: bool = False


def parse_convnext_cfg(vcfg: CLIPVisionCfg) -> ConvNeXtCfg:
    name = (vcfg.timm_model_name or "").split(".")[0]
    if name not in CONVNEXT_CFGS:
        raise NotImplementedError(f"unknown convnext variant {name!r}")
    depths, dims = CONVNEXT_CFGS[name]
    return ConvNeXtCfg(depths=depths, dims=dims,
                       drop_path_rate=vcfg.timm_drop_path or 0.0, proj=vcfg.timm_proj or "none",
                       proj_bias=vcfg.timm_proj_bias)


def is_convnext(vcfg: Optional[CLIPVisionCfg]) -> bool:
    return bool(vcfg is not None and vcfg.timm_model_name
                and vcfg.timm_model_name.split(".")[0] in CONVNEXT_CFGS)


def _conv_nhwc(x: torch.Tensor, conv: nn.Conv2d, stride: int = 1, padding: int = 0,
               groups: int = 1) -> torch.Tensor:
    """``conv`` on NHWC ``x``, through its channels_last NCHW view; NHWC out."""
    y = conv2d(x.permute(0, 3, 1, 2), conv.weight, conv.bias, stride, padding, groups)
    return y.permute(0, 2, 3, 1)


class Block(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.dwconv = nn.Conv2d(dim, dim, 7, padding=3, groups=dim)
        self.norm = LayerNorm(dim)
        self.fc1, self.fc2 = nn.Linear(dim, 4 * dim), nn.Linear(4 * dim, dim)
        self.gamma = nn.Parameter(torch.empty(dim))

    def forward(self, x: torch.Tensor, keep: Optional[torch.Tensor] = None,
                keep_prob: float = 1.0) -> torch.Tensor:
        """NHWC ``x``; ``keep``: the (B, 1, 1, 1) drop-path mask, or None."""
        h = _conv_nhwc(x, self.dwconv, padding=3, groups=x.shape[-1])
        h = self.norm(h)
        h = gelu(linear(h, self.fc1.weight, self.fc1.bias, transposed=True))
        h = linear(h, self.fc2.weight, self.fc2.bias, transposed=True)
        h = h * self.gamma.to(h.dtype)
        if keep is not None:  # the JAX where(mask, h / keep_prob, 0), rounded once
            h = torch.where(keep, h / keep_prob, 0.0)
        return x + h


class ConvNeXt(nn.Module):
    def __init__(self, vision_cfg: CLIPVisionCfg, embed_dim: int):
        super().__init__()
        cfg = self.cfg = parse_convnext_cfg(vision_cfg)
        dims = cfg.dims
        self.stem = nn.Module()
        self.stem.conv = nn.Conv2d(3, dims[0], 4, stride=4)
        self.stem.norm = LayerNorm(dims[0])
        self.stages = nn.ModuleList()
        for i, (depth, dim) in enumerate(zip(cfg.depths, dims)):
            stage = nn.Module()
            stage.downsample = None
            if i > 0:
                stage.downsample = nn.Module()
                stage.downsample.norm = LayerNorm(dims[i - 1])
                stage.downsample.conv = nn.Conv2d(dims[i - 1], dim, 2, stride=2)
            stage.blocks = nn.ModuleList(Block(dim) for _ in range(depth))
            self.stages.append(stage)
        self.head_norm = LayerNorm(dims[-1])
        self.proj = self.proj_mlp = None
        if cfg.proj == "linear":
            self.proj = nn.Linear(dims[-1], embed_dim, bias=cfg.proj_bias)
        elif cfg.proj == "mlp":
            self.proj_mlp = nn.Module()
            self.proj_mlp.fc1 = nn.Linear(dims[-1], 2 * embed_dim)
            self.proj_mlp.fc2 = nn.Linear(2 * embed_dim, embed_dim, bias=cfg.proj_bias)
        # each block's keep probability, float32 as the JAX scan carries it
        rates = np.linspace(0.0, cfg.drop_path_rate, sum(cfg.depths))
        self.keep_probs = [float(np.float32(1.0 - r)) for r in rates]

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator) -> None:
        """The JAX ``init_convnext`` distributions: kernels N(0, 0.02) clipped to
        +-2 std, zero biases, LayerNorms at the identity, ``gamma`` 1e-6."""
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                _trunc_normal_(m.weight, gen)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, Block):
                m.gamma.fill_(LS_INIT)

    def forward(self, image: torch.Tensor, compute_dtype: torch.dtype = torch.float32, *,
                train: bool = False, remat: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B, H, W, 3) normalized NHWC -> pooled, projected (B, embed_dim)."""
        x = _conv_nhwc(image.to(compute_dtype), self.stem.conv, stride=4)
        x = self.stem.norm(x)
        drop = train and self.cfg.drop_path_rate > 0.0
        j = 0
        for stage in self.stages:
            if stage.downsample is not None:
                x = _conv_nhwc(stage.downsample.norm(x), stage.downsample.conv, stride=2)
            for blk in stage.blocks:
                keep_prob, keep = self.keep_probs[j], None
                j += 1
                if drop and keep_prob < 1.0:
                    keep = torch.rand((x.shape[0], 1, 1, 1), generator=generator,
                                      device=x.device) < keep_prob
                if remat and torch.is_grad_enabled():
                    x = checkpoint(blk, x, keep, keep_prob, use_reentrant=False)
                else:
                    x = blk(x, keep, keep_prob)
        x = self.head_norm(x.mean(dim=(1, 2)))
        if self.proj is not None:
            return linear(x, self.proj.weight, self.proj.bias, transposed=True)
        if self.proj_mlp is not None:
            fc1, fc2 = self.proj_mlp.fc1, self.proj_mlp.fc2
            x = gelu(linear(x, fc1.weight, fc1.bias, transposed=True))
            return linear(x, fc2.weight, fc2.bias, transposed=True)
        return x


# ---------------------------------------------------------------------------
# weights: the JAX tree -> the port's names, and the reference layout -> the JAX tree
# ---------------------------------------------------------------------------

_BLOCK_LEAVES = {"dwconv": ("kernel", "bias"), "norm": ("scale", "bias"),
                 "fc1": ("kernel", "bias"), "fc2": ("kernel", "bias")}


def params_from_jax(vis: Dict[str, Any], out: Dict[str, torch.Tensor]) -> None:
    """The JAX ``init_convnext`` tree into ``out`` under the port's names
    (``visual.*``): each stage's stacked ``blocks`` unstacked, HWIO kernels to
    (out, in / groups, kh, kw), (in, out) kernels to ``nn.Linear``'s."""
    from ..convert import _linear, _norm, _t

    def conv(node, name):
        out[f"{name}.weight"] = _t(np.asarray(node["kernel"]).transpose(3, 2, 0, 1)).contiguous()
        out[f"{name}.bias"] = _t(node["bias"])

    conv(vis["stem"]["conv"], "visual.stem.conv")
    _norm(vis["stem"]["norm"], "visual.stem.norm", out)
    for i, stage in vis["stages"].items():
        pre = f"visual.stages.{i}"
        if "downsample" in stage:
            _norm(stage["downsample"]["norm"], f"{pre}.downsample.norm", out)
            conv(stage["downsample"]["conv"], f"{pre}.downsample.conv")
        blocks = stage["blocks"]
        extra = set(blocks) - {*_BLOCK_LEAVES, "gamma"}
        if extra:
            raise KeyError(f"JAX ConvNeXt blocks of stage {i} hold {sorted(extra)}, which the "
                           "port does not have")
        for j in range(np.asarray(blocks["gamma"]).shape[0]):
            b = f"{pre}.blocks.{j}"
            row = {name: {leaf: np.asarray(blocks[name][leaf])[j] for leaf in leaves}
                   for name, leaves in _BLOCK_LEAVES.items()}
            conv(row["dwconv"], f"{b}.dwconv")
            _norm(row["norm"], f"{b}.norm", out)
            _linear(row["fc1"], f"{b}.fc1", out)
            _linear(row["fc2"], f"{b}.fc2", out)
            out[f"{b}.gamma"] = _t(np.asarray(blocks["gamma"])[j])
    _norm(vis["head_norm"], "visual.head_norm", out)
    if "proj" in vis:
        _linear(vis["proj"], "visual.proj", out)
    if "proj_mlp" in vis:
        for name in ("fc1", "fc2"):
            _linear(vis["proj_mlp"][name], f"visual.proj_mlp.{name}", out)


def torch_convnext_clip_to_params(sd: Mapping[str, np.ndarray], vcfg: CLIPVisionCfg
                                  ) -> Dict[str, Any]:
    """The ``visual.*`` part of a reference timm-ConvNeXt CLIP state dict
    (``visual.trunk.stem/stages/head``, ``visual.head.proj|mlp``; numpy leaves) ->
    the JAX package's visual tree, as its ``torch_convnext_clip_to_params`` makes it:
    each stage's blocks stacked, OIHW kernels to HWIO."""
    cfg = parse_convnext_cfg(vcfg)

    def ln(prefix):
        return {"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]}

    def conv(prefix):
        return {"kernel": sd[f"{prefix}.weight"].transpose(2, 3, 1, 0), "bias": sd[f"{prefix}.bias"]}

    def lin(prefix):
        p = {"kernel": sd[f"{prefix}.weight"].T}
        if f"{prefix}.bias" in sd:
            p["bias"] = sd[f"{prefix}.bias"]
        return p

    params: Dict[str, Any] = {
        "stem": {"conv": conv("visual.trunk.stem.0"), "norm": ln("visual.trunk.stem.1")},
        "stages": {},
        "head_norm": ln("visual.trunk.head.norm"),
    }
    for i, depth in enumerate(cfg.depths):
        blocks = []
        for j in range(depth):
            b = f"visual.trunk.stages.{i}.blocks.{j}"
            blocks.append({"dwconv": conv(f"{b}.conv_dw"), "norm": ln(f"{b}.norm"),
                           "fc1": lin(f"{b}.mlp.fc1"), "fc2": lin(f"{b}.mlp.fc2"),
                           "gamma": sd[f"{b}.gamma"]})
        stacked = {name: ({leaf: np.stack([blk[name][leaf] for blk in blocks])
                           for leaf in blocks[0][name]} if isinstance(blocks[0][name], dict)
                          else np.stack([blk[name] for blk in blocks]))
                   for name in blocks[0]}
        stage: Dict[str, Any] = {"blocks": stacked}
        if i > 0:
            d = f"visual.trunk.stages.{i}.downsample"
            stage["downsample"] = {"norm": ln(f"{d}.0"), "conv": conv(f"{d}.1")}
        params["stages"][str(i)] = stage
    if "visual.head.proj.weight" in sd:
        params["proj"] = lin("visual.head.proj")
    elif "visual.head.mlp.fc1.weight" in sd:
        params["proj_mlp"] = {"fc1": lin("visual.head.mlp.fc1"), "fc2": lin("visual.head.mlp.fc2")}
    return params
