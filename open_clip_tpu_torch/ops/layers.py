"""Primitive ops: norms, activations, linear (counterpart of ``open_clip_tpu/ops/layers.py``).

Normalisation statistics (LayerNorm's and RMSNorm's) are always taken in float32
whatever the compute dtype, and the result is cast back to the input dtype. GELU follows the JAX package's
rule: the tanh form in bf16/fp16, the exact erf form in fp32.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn.functional as F

# Opt-in, off by default as in the JAX package: route LayerNorm through
# ``ops/fused_ln.py``, whose backward is the hand-written one-pass CUDA kernel.
# With it on, a CUDA tensor's backward runs that kernel or raises.
FUSED_LN_BWD = False


# The remat tag of the op running now (see ``remat_name``); None outside any tag.
REMAT_TAG: Optional[str] = None


@contextlib.contextmanager
def remat_name(name: Optional[str]):
    """Tag the ops run inside with ``name``, the JAX package's ``checkpoint_name``:
    a selective remat policy (``models/blocks.py``) saves the outputs of the ops
    whose tag it names. Callers wrap only the op(s) that make the named tensor
    (the product, not the weight's cast or the view of its input), so that what a
    policy saves is that tensor and nothing more."""
    global REMAT_TAG
    outer, REMAT_TAG = REMAT_TAG, name
    try:
        yield
    finally:
        REMAT_TAG = outer


def layer_norm_plain(x: torch.Tensor, scale: torch.Tensor, bias: Optional[torch.Tensor],
                     eps: float = 1e-5, *, name: Optional[str] = None) -> torch.Tensor:
    """LayerNorm over the last axis with fp32 statistics and affine, output in x.dtype.
    ``name`` tags the op that makes the output: the final cast, or in fp32 (where
    the cast is no op) the norm itself."""
    if x.dtype == torch.float32:
        with remat_name(name):
            return F.layer_norm(x, x.shape[-1:], scale.float(),
                                None if bias is None else bias.float(), eps)
    y = F.layer_norm(x.float(), x.shape[-1:], scale.float(),
                     None if bias is None else bias.float(), eps)
    with remat_name(name):
        return y.to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: Optional[torch.Tensor],
               eps: float = 1e-5, *, name: Optional[str] = None) -> torch.Tensor:
    """``layer_norm_plain``, or with ``FUSED_LN_BWD`` the same forward with the fused
    backward kernel of ``ops/fused_ln.py``. ``name``: the output's remat tag."""
    if FUSED_LN_BWD:
        from .fused_ln import layer_norm_fused_bwd

        with remat_name(name):
            return layer_norm_fused_bwd(x, scale, bias, eps)
    return layer_norm_plain(x, scale, bias, eps, name=name)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis: fp32 mean of squares and scale, output in x.dtype."""
    x32 = x.float()
    y = x32 * torch.rsqrt(x32.square().mean(dim=-1, keepdim=True) + eps)
    return (y * scale.float()).to(x.dtype)


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


def relu_squared(x: torch.Tensor) -> torch.Tensor:
    """relu(x) ** 2, the modern text tower's ``relu2`` MLP activation."""
    r = torch.relu(x)
    return r * r


ACT_FNS = {"gelu": gelu, "quick_gelu": quick_gelu, "relu2": relu_squared}


def linear(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None, *,
           transposed: bool = False, name: Optional[str] = None) -> torch.Tensor:
    """y = x @ W (+ bias), the one place every projection of the port goes through.

    ``weight`` is the JAX package's (in, out) kernel, or with ``transposed=True``
    ``nn.Linear``'s (out, in) weight. The product runs in x.dtype without the bias,
    and the bias is added after it in the same dtype: two roundings, as in the JAX
    package, so bf16 outputs match it. The product is the one ``mm`` that
    ``F.linear`` or ``@`` would make of it, called directly so that ``name`` (its
    remat tag) covers that op alone, not the views around it."""
    wt = weight.to(x.dtype)
    wt, x2 = (wt.t() if transposed else wt), x.reshape(-1, x.shape[-1])
    with remat_name(name):
        y = torch.mm(x2, wt)
    y = y.view(*x.shape[:-1], wt.shape[1])
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def conv2d(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
           stride=1, padding=0, groups: int = 1) -> torch.Tensor:
    """2-D convolution of an NCHW ``x`` (the conv towers pass ``channels_last`` views
    of NHWC memory, so cuDNN takes its NHWC path) by PyTorch's (out, in / groups, kh,
    kw) ``weight``, cast to x.dtype and laid out channels_last. The bias is added after
    the convolution in the same dtype: two roundings, as the JAX package's conv and
    bias, like ``linear``'s."""
    w = weight.to(dtype=x.dtype, memory_format=torch.channels_last)
    y = F.conv2d(x, w, None, stride, padding, 1, groups)
    return y if bias is None else y + bias.to(y.dtype)[:, None, None]
