"""Primitive ops: norms, activations, linear (counterpart of ``open_clip_tpu/ops/layers.py``).

Normalisation statistics are always taken in float32 whatever the compute dtype,
and the result is cast back to the input dtype. GELU follows the JAX package's
rule: the tanh form in bf16/fp16, the exact erf form in fp32.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

# Opt-in, off by default as in the JAX package: route LayerNorm through
# ``ops/fused_ln.py``, whose backward is the hand-written one-pass CUDA kernel.
# With it on, a CUDA tensor's backward runs that kernel or raises.
FUSED_LN_BWD = False


def layer_norm_plain(x: torch.Tensor, scale: torch.Tensor, bias: Optional[torch.Tensor],
                     eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis with fp32 statistics and affine, output in x.dtype."""
    y = F.layer_norm(x.float(), x.shape[-1:], scale.float(),
                     None if bias is None else bias.float(), eps)
    return y.to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: Optional[torch.Tensor],
               eps: float = 1e-5) -> torch.Tensor:
    """``layer_norm_plain``, or with ``FUSED_LN_BWD`` the same forward with the fused
    backward kernel of ``ops/fused_ln.py``."""
    if FUSED_LN_BWD:
        from .fused_ln import layer_norm_fused_bwd

        return layer_norm_fused_bwd(x, scale, bias, eps)
    return layer_norm_plain(x, scale, bias, eps)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(1.702 * x), the OpenAI CLIP activation."""
    return x * torch.sigmoid(1.702 * x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU in fp32; the tanh form in bf16/fp16, as the JAX package does.

    The tanh form differs from erf by at most 4.8e-4, below one bf16 ulp wherever
    the output is representable; ``nn.GELU()``'s erf in bf16 would not match the
    JAX package bit for bit."""
    if x.dtype in (torch.bfloat16, torch.float16):
        return F.gelu(x, approximate="tanh")
    return F.gelu(x)


ACT_FNS = {"gelu": gelu, "quick_gelu": quick_gelu}


def linear(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None, *,
           transposed: bool = False) -> torch.Tensor:
    """y = x @ W (+ bias), the one place every projection of the port goes through.

    ``weight`` is the JAX package's (in, out) kernel, or with ``transposed=True``
    ``nn.Linear``'s (out, in) weight. The product runs in x.dtype without the bias,
    and the bias is added after it in the same dtype: two roundings, as in the JAX
    package, so bf16 outputs match it."""
    w = weight.to(x.dtype)
    y = F.linear(x, w) if transposed else x @ w
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y
