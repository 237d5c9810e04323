"""Pre-LN residual transformer blocks (counterpart of ``open_clip_tpu/models/blocks.py``).

One ``nn.Module`` per layer, in place of the JAX package's layer-stacked params
and ``lax.scan``. Names follow the reference checkpoint layout
(``transformer.resblocks.{i}.attn.in_proj_weight``, ``ln_1``, ``mlp.c_fc``, ...),
so a reference state dict loads by name. Semantics of ``apply_block``:

    x = x + ls_1(attn(ln_1(x)));  x = x + ls_2(mlp(ln_2(x)))

Two module globals mirror the JAX package's: ``MLP_LINEAR_IMPL`` ("dense" or
"switchback", the int8 SwitchBack forward of both MLP linears) and
``REMAT_POLICY`` (what a rematerialized block saves: "none", "names" or
"names_mm"). The training CLI sets both from its flags.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..ops import layers as _layers
from ..ops.attention import multi_head_attention
from ..ops.layers import ACT_FNS, layer_norm, linear, remat_name
from ..ops.switchback import switchback_linear

# MLP linear implementation of the transformer blocks: "dense" (default) or
# "switchback", the int8 forward / bf16 backward of ``ops/switchback.py`` (reference
# --use-bnb-linear SwitchBackLinearGlobal). Set by the training CLI's
# --use-switchback. ``SwiGLUMlp`` (NaFlex) does not take it, as in the JAX package.
MLP_LINEAR_IMPL: str = "dense"

# What a rematerialized block saves (``--remat-policy`` with --grad-checkpointing).
# "none": nothing but the block's input; the whole block runs again in the backward.
# "names" and "names_mm" save the outputs of the ops tagged with the named
# ``remat_name`` tags (the JAX package's ``checkpoint_name`` tags, set in the same
# places) and recompute the rest: "names" the matmul inputs (LN outputs, attention
# output, activation), "names_mm" the matmul outputs (fused qkv, attention output,
# fc1 before its bias). The math does not change. PyTorch's selective checkpoint
# reruns every op of the block that is not saved, in order, up to the last one whose
# result the backward needs (it has no dead-code elimination as XLA has): under
# "names_mm" the qkv and fc1 products and the attention kernel do not run again, the
# out and c_proj products do.
REMAT_POLICY: str = "none"
REMAT_NAME_PRESETS: dict = {
    "names": ("remat_ln1", "remat_attn_ctx", "remat_ln2", "remat_act"),
    "names_mm": ("remat_qkv", "remat_attn_ctx", "remat_fc1"),
}
UNPORTED_REMAT_POLICIES = ("dots", "dots_no_batch")


def _save_named(saved: tuple, ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return (CheckpointPolicy.MUST_SAVE if _layers.REMAT_TAG in saved
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat_context_fn():
    """``checkpoint``'s ``context_fn`` for ``REMAT_POLICY``, or None for full remat."""
    if REMAT_POLICY == "none":
        return None
    if REMAT_POLICY in REMAT_NAME_PRESETS:
        policy = functools.partial(_save_named, REMAT_NAME_PRESETS[REMAT_POLICY])
        return functools.partial(create_selective_checkpoint_contexts, policy)
    if REMAT_POLICY in UNPORTED_REMAT_POLICIES:
        raise NotImplementedError(f"remat policy {REMAT_POLICY!r} is not ported yet "
                                  f"(none, {', '.join(REMAT_NAME_PRESETS)} are)")
    raise ValueError(f"unknown remat policy {REMAT_POLICY!r}")


def remat_call(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` under activation checkpointing with ``REMAT_POLICY``."""
    context_fn = remat_context_fn()
    if context_fn is None:
        return checkpoint(fn, *args, use_reentrant=False, **kwargs)
    return checkpoint(fn, *args, use_reentrant=False, context_fn=context_fn, **kwargs)

UNPORTED_BLOCK_OPTIONS = ("qk_norm", "scaled_cosine_attn", "scale_heads",
                          "scale_attn_inner", "scale_attn", "scale_fc")


def check_block_options(tower_cfg) -> None:
    """Raise for the custom-block options this slice does not port."""
    on = [f for f in UNPORTED_BLOCK_OPTIONS if getattr(tower_cfg, f, False)]
    if on or getattr(tower_cfg, "block_type", None):
        raise NotImplementedError(f"custom transformer block options {on or tower_cfg.block_type} "
                                  "are not ported yet")


class LayerNorm(nn.LayerNorm):
    """LayerNorm with fp32 statistics; output in the input dtype. ``name``: the
    output's remat tag."""

    def forward(self, x: torch.Tensor, name: Optional[str] = None) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps, name=name)


class Norm(nn.Module):
    """RMSNorm (``weight`` only) or LayerNorm (``weight``, ``bias``) by ``norm_type``,
    with fp32 statistics; the norm of the modern text tower and the GenLIP trunk."""

    def __init__(self, width: int, norm_type: str, eps: float):
        super().__init__()
        self.rms = norm_type == "rmsnorm"
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(width))
        self.bias = None if self.rms else nn.Parameter(torch.zeros(width))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.rms:
            return _layers.rms_norm(x, self.weight, self.eps)
        return layer_norm(x, self.weight, self.bias, self.eps)

    @torch.no_grad()
    def reset(self) -> None:
        self.weight.fill_(1.0)
        if self.bias is not None:
            self.bias.zero_()


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

    def forward(self, x: torch.Tensor, *, causal: bool = False,
                key_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        return multi_head_attention(x, self.in_proj_weight, self.in_proj_bias,
                                    self.out_proj.weight, self.out_proj.bias,
                                    num_heads=self.heads, causal=causal, key_valid=key_valid)


class Mlp(nn.Module):
    def __init__(self, width: int, mlp_width: int, act: str):
        super().__init__()
        self.c_fc = nn.Linear(width, mlp_width)
        self.c_proj = nn.Linear(mlp_width, width)
        self.act = ACT_FNS[act]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        proj = switchback_linear if MLP_LINEAR_IMPL == "switchback" else functools.partial(
            linear, transposed=True)
        h = proj(x, self.c_fc.weight, self.c_fc.bias, name="remat_fc1")
        with remat_name("remat_act"):
            h = self.act(h)
        return proj(h, self.c_proj.weight, self.c_proj.bias)


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

    def forward(self, x: torch.Tensor, *, causal: bool = False,
                key_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.attn(self.ln_1(x, "remat_ln1"), causal=causal, key_valid=key_valid)
        if self.ls_init_value is not None:
            h = self.ls_1(h)
        x = x + h
        h = self.mlp(self.ln_2(x, "remat_ln2"))
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
    is recomputed in the backward pass and saves its input and what ``REMAT_POLICY``
    names (the JAX package's ``jax.checkpoint`` with ``remat_policy()``)."""

    def __init__(self, width: int, layers: int, heads: int, mlp_width: int, **block_kw):
        super().__init__()
        self.resblocks = nn.ModuleList(
            ResidualAttentionBlock(width, heads, mlp_width, **block_kw) for _ in range(layers))

    def forward(self, x: torch.Tensor, *, causal: bool = False, remat: bool = False,
                key_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``key_valid``: optional (B, L) key-padding mask, the same for every block."""
        for block in self.resblocks:
            if remat and torch.is_grad_enabled():
                x = remat_call(block, x, causal=causal, key_valid=key_valid)
            else:
                x = block(x, causal=causal, key_valid=key_valid)
        return x

    def init_weights(self, gen: torch.Generator, scheme: str) -> None:
        for block in self.resblocks:
            block.init_weights(gen, scheme, depth=len(self.resblocks))
