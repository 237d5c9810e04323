"""Pre-LN residual transformer blocks (counterpart of ``open_clip_tpu/models/blocks.py``).

One ``nn.Module`` per layer, in place of the JAX package's layer-stacked params
and ``lax.scan``. Names follow the reference checkpoint layout
(``transformer.resblocks.{i}.attn.in_proj_weight``, ``ln_1``, ``mlp.c_fc``, ...),
so a reference state dict loads by name. Semantics of ``apply_block``:

    x = x + ls_1(attn(ln_1(x)));  x = x + ls_2(mlp(ln_2(x)))
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.attention import multi_head_attention
from ..ops.layers import ACT_FNS, layer_norm, linear

UNPORTED_BLOCK_OPTIONS = ("qk_norm", "scaled_cosine_attn", "scale_heads",
                          "scale_attn_inner", "scale_attn", "scale_fc")


def check_block_options(tower_cfg) -> None:
    """Raise for the custom-block options this slice does not port."""
    on = [f for f in UNPORTED_BLOCK_OPTIONS if getattr(tower_cfg, f, False)]
    if on or getattr(tower_cfg, "block_type", None):
        raise NotImplementedError(f"custom transformer block options {on or tower_cfg.block_type} "
                                  "are not ported yet")


class LayerNorm(nn.LayerNorm):
    """LayerNorm with fp32 statistics; output in the input dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps)


class LayerScale(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.empty(width))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.gamma.to(x.dtype)


class Attention(nn.Module):
    """Fused-qkv self-attention; parameters named as ``nn.MultiheadAttention``'s."""

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * width))
        self.out_proj = nn.Linear(width, width)

    def forward(self, x: torch.Tensor, *, causal: bool = False) -> torch.Tensor:
        return multi_head_attention(x, self.in_proj_weight, self.in_proj_bias,
                                    self.out_proj.weight, self.out_proj.bias,
                                    num_heads=self.heads, causal=causal)


class Mlp(nn.Module):
    def __init__(self, width: int, mlp_width: int, act: str):
        super().__init__()
        self.c_fc = nn.Linear(width, mlp_width)
        self.c_proj = nn.Linear(mlp_width, width)
        self.act = ACT_FNS[act]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = linear(x, self.c_fc.weight, self.c_fc.bias, transposed=True)
        return linear(self.act(h), self.c_proj.weight, self.c_proj.bias, transposed=True)


class ResidualAttentionBlock(nn.Module):
    def __init__(self, width: int, heads: int, mlp_width: int, *, act: str = "gelu",
                 ls_init_value: Optional[float] = None, norm_eps: float = 1e-5):
        super().__init__()
        self.ln_1 = LayerNorm(width, eps=norm_eps)
        self.attn = Attention(width, heads)
        self.ln_2 = LayerNorm(width, eps=norm_eps)
        self.mlp = Mlp(width, mlp_width, act)
        self.ls_init_value = ls_init_value
        if ls_init_value is not None:
            self.ls_1 = LayerScale(width)
            self.ls_2 = LayerScale(width)

    def forward(self, x: torch.Tensor, *, causal: bool = False) -> torch.Tensor:
        h = self.attn(self.ln_1(x), causal=causal)
        if self.ls_init_value is not None:
            h = self.ls_1(h)
        x = x + h
        h = self.mlp(self.ln_2(x))
        if self.ls_init_value is not None:
            h = self.ls_2(h)
        return x + h

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator, scheme: str, depth: int) -> None:
        """Distributions of the JAX package's ``init_block``. ``scheme``:
        'vision' keeps torch-default inits (xavier-uniform fused qkv,
        kaiming-uniform linears); 'text' is the reference text tower's normal(std)
        scheme."""
        width = self.attn.out_proj.in_features
        for ln in (self.ln_1, self.ln_2):
            ln.weight.fill_(1.0)
            ln.bias.zero_()
        attn, mlp = self.attn, self.mlp
        attn.in_proj_bias.zero_()
        attn.out_proj.bias.zero_()
        if scheme == "text":
            proj_std = (width ** -0.5) * ((2 * depth) ** -0.5)
            attn.in_proj_weight.normal_(0.0, width ** -0.5, generator=gen)
            attn.out_proj.weight.normal_(0.0, proj_std, generator=gen)
            mlp.c_fc.weight.normal_(0.0, (2 * width) ** -0.5, generator=gen)
            mlp.c_fc.bias.zero_()
            mlp.c_proj.weight.normal_(0.0, proj_std, generator=gen)
            mlp.c_proj.bias.zero_()
        else:
            bound = math.sqrt(6.0 / (width + 3 * width))
            attn.in_proj_weight.uniform_(-bound, bound, generator=gen)
            attn.out_proj.weight.uniform_(-width ** -0.5, width ** -0.5, generator=gen)
            for lin in (mlp.c_fc, mlp.c_proj):
                b = lin.in_features ** -0.5
                lin.weight.uniform_(-b, b, generator=gen)
                lin.bias.uniform_(-b, b, generator=gen)
        if self.ls_init_value is not None:
            self.ls_1.gamma.fill_(self.ls_init_value)
            self.ls_2.gamma.fill_(self.ls_init_value)


class Transformer(nn.Module):
    """A stack of per-layer blocks (``apply_transformer``). With ``remat`` each block
    is recomputed in the backward pass and saves nothing but its input (the JAX
    package's ``jax.checkpoint`` with the policy ``none``)."""

    def __init__(self, width: int, layers: int, heads: int, mlp_width: int, **block_kw):
        super().__init__()
        self.resblocks = nn.ModuleList(
            ResidualAttentionBlock(width, heads, mlp_width, **block_kw) for _ in range(layers))

    def forward(self, x: torch.Tensor, *, causal: bool = False,
                remat: bool = False) -> torch.Tensor:
        for block in self.resblocks:
            if remat and torch.is_grad_enabled():
                x = checkpoint(block, x, causal=causal, use_reentrant=False)
            else:
                x = block(x, causal=causal)
        return x

    def init_weights(self, gen: torch.Generator, scheme: str) -> None:
        for block in self.resblocks:
            block.init_weights(gen, scheme, depth=len(self.resblocks))
