"""Short-sequence self-attention: the CUDA kernel, its plain version and its dispatch gate.

The kernel (``csrc/short_attention.cu``) replaces the TPU kernel
``open_clip_tpu/ops/short_attention.py:_fwd_kernel_v2``: exact single-block
attention for L <= 288 and hd in {32, 64, 128}, optionally causal, with no bias.
It is memory-bound on an H100 (at CLIP's shapes it does ~L operations per byte,
far below the ~295 where the bf16 tensor cores would be the limit), so its
design moves the fewest bytes: it reads q/k/v in place from the tower's
(B, L, H*hd) layout with strides, so the slices of one fused qkv projection need
no copy and no (B, H, L, hd) transpose, keeps logits and probabilities in shared
memory, and writes only the output. The source file says more.

The TPU kernel's head pairing, lane masks and VMEM budgeting are layout tricks
of the TPU and are left out: any head count is served, and each row has its own
softmax max.

``short_attention`` launches the kernel for CUDA tensors, or raises; for CPU
tensors, and only for them, it computes ``short_attention_reference``. Only the
forward is ported: the wrapper raises when autograd would need a gradient
through it.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

MAX_SEQ = 288
HEAD_DIMS = (32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

LAUNCHES = 0  # kernel launches since the last reset; chip_smoke.py reads it

_fn = None


def supports(l: int, h: int, hd: int, bias) -> bool:
    """Can the kernel serve self-attention of this shape? (Dispatch gate.)"""
    return bias is None and 1 <= l <= MAX_SEQ and hd in HEAD_DIMS and h >= 1


def short_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                              causal: bool = False, scale: Optional[float] = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel: fp32 logits and softmax, probabilities
    cast to ``v.dtype`` before the product with v. Differentiable by autograd."""
    from .attention import dense_attention

    return dense_attention(q, k, v, causal=causal, scale=scale)


def _kernel():
    global _fn
    if _fn is None:
        from ._build import load

        fn = load("short_attention").oct_short_attention_fwd
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p, ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        _fn = fn
    return _fn


def _check(x: torch.Tensor, name: str, shape, dtype, device) -> None:
    b, l, h, hd = shape
    if x.shape != shape or x.dtype != dtype or x.device != device:
        raise ValueError(f"short_attention: {name} is {tuple(x.shape)} {x.dtype} on {x.device}; "
                         f"expected {tuple(shape)} {dtype} on {device}")
    # the (H, hd) block of each row must be dense; batch and row strides are free,
    # so q/k/v may be the three slices of one fused (B, L, 3, H, hd) projection.
    # The kernel reads 4 elements at a time, so every row starts 4-element aligned.
    if (x.stride(3) != 1 or x.stride(2) != hd or x.stride(0) % 4 or x.stride(1) % 4
            or x.data_ptr() % 16):
        raise ValueError(f"short_attention: {name} must have a dense, 16-byte aligned (H, hd) "
                         f"block per row; got strides {x.stride()}")


def short_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False, scale: Optional[float] = None) -> torch.Tensor:
    """Self-attention over (B, L, H, hd) tensors; returns (B, L, H, hd) in q.dtype."""
    if q.shape != k.shape or q.shape != v.shape:
        raise ValueError("short_attention is self-attention: q, k and v need one shape, "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, l, h, hd = q.shape
    if scale is None:
        scale = hd ** -0.5
    if q.device.type == "cpu":
        return short_attention_reference(q, k, v, causal=causal, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"short_attention: no kernel for device {q.device}")
    if not supports(l, h, hd, None):
        raise ValueError(f"short_attention: unsupported shape L={l}, H={h}, hd={hd} "
                         f"(needs L <= {MAX_SEQ}, hd in {HEAD_DIMS})")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"short_attention: dtype {q.dtype} unsupported (float32, bfloat16)")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise RuntimeError("short_attention: the backward kernel is not ported yet; "
                           "run inference under torch.no_grad() or torch.inference_mode()")
    for x, name in ((q, "q"), (k, "k"), (v, "v")):
        _check(x, name, q.shape, q.dtype, q.device)
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    strides = (ctypes.c_longlong * 8)(q.stride(0), q.stride(1), k.stride(0), k.stride(1),
                                      v.stride(0), v.stride(1), out.stride(0), out.stride(1))
    fn = _kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, l, h, hd,
                 strides, float(scale), int(causal), _DTYPE_CODES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"short_attention kernel launch failed: cudaError {err}")
    global LAUNCHES
    LAUNCHES += 1
    return out
