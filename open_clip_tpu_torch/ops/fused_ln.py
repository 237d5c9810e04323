"""LayerNorm with a fused backward: the CUDA kernel, its plain version and its gate
(counterpart of ``open_clip_tpu/ops/fused_ln.py``).

The forward is the plain fp32-statistics LayerNorm of ``ops/layers.py``. The
backward kernel (``csrc/layer_norm_bwd.cu``) replaces the TPU kernel
``open_clip_tpu/ops/fused_ln.py:_bwd_kernel``: one pass over x and dy gives dx
and per-block partial sums of dscale and dbias, which a second small kernel
folds in a fixed order. It is memory-bound on an H100 (3 * R * W * size bytes for
about 12 * R * W operations), so it reads each element once and keeps the row in
registers. The statistics are recomputed from x: autograd keeps x and scale only,
where the plain path keeps an fp32 copy of x and the row statistics.

The TPU kernel's gate (W % 128, rows >= 256, 256-row blocks) is TPU layout and
is not carried over: ``supported`` is this kernel's own. What it does not take
raises; nothing gives way to the plain version on a CUDA tensor. For CPU
tensors, and only for them, the backward is ``layer_norm_bwd_reference``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .layers import layer_norm_plain

MAX_WIDTH = 4096
BLOCKS_PER_SM = 8
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# launches of the kernel since the last reset; chip_smoke.py sets and reads it
LAUNCHES = {"bwd": 0}

_fns = {}


def supported(x: torch.Tensor) -> bool:
    """Can the backward kernel take the gradient of a LayerNorm over x's last axis?"""
    w = x.shape[-1]
    return x.dtype in _DTYPE_CODES and w % 4 == 0 and 4 <= w <= MAX_WIDTH and x.numel() > 0


def layer_norm_bwd_reference(x: torch.Tensor, dy: torch.Tensor, scale: torch.Tensor,
                             eps: float = 1e-5):
    """Plain PyTorch version of the backward kernel, all in fp32: (dx in x.dtype,
    dscale fp32 (W,), dbias fp32 (W,))."""
    w = x.shape[-1]
    x32 = x.float().reshape(-1, w)
    dy32 = dy.float().reshape(-1, w)
    mu = x32.mean(dim=-1, keepdim=True)
    xc = x32 - mu
    inv = torch.rsqrt((xc * xc).mean(dim=-1, keepdim=True) + eps)
    xhat = xc * inv
    g = dy32 * scale.float()
    mg = g.mean(dim=-1, keepdim=True)
    mgx = (g * xhat).mean(dim=-1, keepdim=True)
    dx = inv * (g - mg - xhat * mgx)
    return dx.to(x.dtype).reshape(x.shape), (dy32 * xhat).sum(dim=0), dy32.sum(dim=0)


def _kernel():
    fn = _fns.get("bwd")
    if fn is None:
        from ._build import load

        fn = load("layer_norm_bwd").oct_layer_norm_bwd
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        _fns["bwd"] = fn
    return fn


def layer_norm_bwd(x: torch.Tensor, dy: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5):
    """(dx, dscale, dbias) of LayerNorm over the last axis: the kernel for CUDA
    tensors, or raise; the plain version for CPU tensors."""
    if x.device.type == "cpu":
        return layer_norm_bwd_reference(x, dy, scale, eps)
    if x.device.type != "cuda":
        raise ValueError(f"layer_norm_bwd: no kernel for device {x.device}")
    if not supported(x):
        raise ValueError(f"layer_norm_bwd: unsupported input {tuple(x.shape)} {x.dtype} "
                         f"(needs float32 or bfloat16, width % 4 == 0, width <= {MAX_WIDTH})")
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"layer_norm_bwd: dy is {tuple(dy.shape)} {dy.dtype} on {dy.device}; "
                         f"expected {tuple(x.shape)} {x.dtype} on {x.device}")
    w = x.shape[-1]
    if scale.shape != (w,) or scale.device != x.device:
        raise ValueError(f"layer_norm_bwd: scale is {tuple(scale.shape)} on {scale.device}; "
                         f"expected ({w},) on {x.device}")
    x2 = x.contiguous().view(-1, w)
    dy2 = dy.contiguous().view(-1, w)
    scale32 = scale.float().contiguous()
    rows = x2.shape[0]
    dx = torch.empty_like(x2)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    blocks = min(rows, BLOCKS_PER_SM * sms)
    partials = torch.empty((2, blocks, w), dtype=torch.float32, device=x.device)
    sums = torch.empty((2, w), dtype=torch.float32, device=x.device)
    for t, name in ((x2, "x"), (dy2, "dy"), (scale32, "scale")):
        if t.data_ptr() % 16:
            raise ValueError(f"layer_norm_bwd: {name} must be 16-byte aligned")
    fn = _kernel()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x2.data_ptr(), dy2.data_ptr(), scale32.data_ptr(), dx.data_ptr(),
                 partials.data_ptr(), sums.data_ptr(), rows, w, blocks, float(eps),
                 _DTYPE_CODES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"layer_norm_bwd kernel launch failed: cudaError {err}")
    LAUNCHES["bwd"] += 1
    return dx.view(x.shape), sums[0], sums[1]


class _LayerNormFusedBwd(torch.autograd.Function):
    """Saves x and scale only; the backward recomputes the statistics."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps: float):
        ctx.save_for_backward(x, scale)
        ctx.eps, ctx.has_bias = eps, bias is not None
        return layer_norm_plain(x, scale, bias, eps)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        dx, dscale, dbias = layer_norm_bwd(x, dy, scale, ctx.eps)
        return dx, dscale.to(scale.dtype), dbias.to(scale.dtype) if ctx.has_bias else None, None


def layer_norm_fused_bwd(x: torch.Tensor, scale: torch.Tensor, bias: Optional[torch.Tensor],
                         eps: float = 1e-5) -> torch.Tensor:
    """Drop-in for ``ops.layers.layer_norm`` whose backward is the fused kernel."""
    return _LayerNormFusedBwd.apply(x, scale, bias, eps)
