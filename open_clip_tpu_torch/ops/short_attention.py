"""Short-sequence self-attention: the CUDA kernels, their plain versions and the dispatch gate.

The kernels (``csrc/short_attention.cu``) replace the TPU kernels
``open_clip_tpu/ops/short_attention.py:_fwd_kernel_v2`` and ``_bwd_kernel_v2``:
exact single-block attention for L <= 288 and hd in {32, 64, 128}, optionally
causal, with no bias, and its gradient. They are memory-bound on an H100 (at
CLIP's shapes they do ~L operations per byte, far below the ~295 where the bf16
tensor cores would be the limit), so the design moves the fewest bytes: q/k/v
are read in place from the tower's (B, L, H*hd) layout with strides, so the
slices of one fused qkv projection need no copy and no (B, H, L, hd) transpose,
logits and probabilities stay on the chip (registers in the tensor-core bodies,
shared memory in the CUDA-core ones), and only the outputs are written. The
backward recomputes the softmax from q, k and v, as the TPU kernel does: the
forward saves nothing else. The source file says more.

The TPU kernel's head pairing, lane masks and VMEM budgeting are layout tricks
of the TPU and are left out: any head count is served, and each row has its own
softmax max.

The forward and the backward have two bodies each, chosen by ``fwd_body`` and
``bwd_body`` from the dtype alone: "mma", bf16 on the tensor cores, and "simt", fp32
on CUDA cores. The bf16 backward is one fused kernel at L <= 128 (one block per
sample and head holds Q, K, V and dO whole) and two kernels with a row-statistics
scratch at 128 < L <= 288 (dq, then dk and dv, each block keeping the operand its
rows share whole); the C side picks by L. The fp32 backward is always the two
CUDA-core kernels. Inputs the chosen body cannot read (rows not 16-byte aligned for
"mma") raise; they are never sent to the other body.

``short_attention`` is differentiable. For CUDA tensors it launches the forward
kernel and, in autograd's backward, the backward kernel, or raises; for CPU
tensors, and only for them, it computes ``short_attention_reference`` and
``short_attention_bwd_reference``. ``LAUNCHES`` counts the launches of each, and
``FWD_BODIES`` and ``BWD_BODIES`` the launches of each by body.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

MAX_SEQ = 288
HEAD_DIMS = (32, 64, 128)
DTYPES = (torch.float32, torch.bfloat16)

# launches of each kernel since the last reset, and of each by body; chip_smoke.py
# sets and reads them
LAUNCHES = {"fwd": 0, "bwd": 0}
FWD_BODIES = {"mma": 0, "simt": 0}
BWD_BODIES = {"mma": 0, "simt": 0}

_fns = {}


def supports(l: int, h: int, hd: int, bias) -> bool:
    """Can the kernel serve self-attention of this shape? (Dispatch gate.)"""
    return bias is None and 1 <= l <= MAX_SEQ and hd in HEAD_DIMS and h >= 1


def fwd_body(l: int, hd: int, dtype: torch.dtype) -> str:
    """Which forward body serves a shape the kernel takes: "mma" (tensor cores) for
    bf16, "simt" (CUDA cores) for fp32."""
    return "mma" if dtype == torch.bfloat16 else "simt"


def bwd_body(l: int, hd: int, dtype: torch.dtype) -> str:
    """Which backward body serves a shape the kernels take: "mma" (tensor cores: the
    fused kernel at L <= 128, two kernels above) for bf16, "simt" (the two CUDA-core
    kernels) for fp32."""
    return fwd_body(l, hd, dtype)


def short_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                              causal: bool = False, scale: Optional[float] = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel: fp32 logits and softmax, probabilities
    cast to ``v.dtype`` before the product with v. Differentiable by autograd."""
    from .attention import dense_attention

    return dense_attention(q, k, v, causal=causal, scale=scale)


def short_attention_bwd_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                  do: torch.Tensor, *, causal: bool = False,
                                  scale: Optional[float] = None):
    """Plain PyTorch version of the backward kernel, step by step with its rounding
    points: fp32 logits, softmax and dp; ds and the probabilities rounded to the
    input dtype; dq, dk, dv accumulated in fp32 and returned in the input dtype."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    dtype = q.dtype
    q32, k32, v32, do32 = q.float(), k.float(), v.float(), do.float()
    s = torch.einsum("bqhd,bkhd->bhqk", q32, k32) * scale
    if causal:
        l = q.shape[1]
        mask = torch.ones(l, l, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, float("-inf"))
    p32 = torch.softmax(s, dim=-1)
    dp = torch.einsum("bqhd,bkhd->bhqk", do32, v32)
    delta = (dp * p32).sum(dim=-1, keepdim=True)
    ds = (p32 * (dp - delta) * scale).to(dtype).float()
    p = p32.to(dtype).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k32)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q32)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do32)
    return dq.to(dtype), dk.to(dtype), dv.to(dtype)


def _kernel(which: str):
    fn = _fns.get(which)
    if fn is None:
        from ._build import load

        lib = load("short_attention")
        pointers = 4 if which.startswith("fwd") else 8  # tensors (and the bwd's scratch)
        fn = getattr(lib, f"oct_short_attention_{which}")
        fn.argtypes = [ctypes.c_void_p] * pointers + [ctypes.c_int] * 4 + [
            ctypes.c_void_p, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[which] = fn
    return fn


def _check(x: torch.Tensor, name: str, shape, dtype, device, vec: int = 4) -> None:
    b, l, h, hd = shape
    if x.shape != shape or x.dtype != dtype or x.device != device:
        raise ValueError(f"short_attention: {name} is {tuple(x.shape)} {x.dtype} on {x.device}; "
                         f"expected {tuple(shape)} {dtype} on {device}")
    # the (H, hd) block of each row must be dense; batch and row strides are free,
    # so q/k/v may be the three slices of one fused (B, L, 3, H, hd) projection.
    # The CUDA-core kernels read 4 elements at a time (vec = 4), the fused kernel 16
    # bytes (vec = 8 bf16 elements), so every row starts vec-element aligned.
    if (x.stride(3) != 1 or x.stride(2) != hd or x.stride(0) % vec or x.stride(1) % vec
            or x.data_ptr() % 16):
        raise ValueError(f"short_attention: {name} must have a dense, 16-byte aligned (H, hd) "
                         f"block per row with strides in multiples of {vec}; "
                         f"got strides {x.stride()}")


def check_inputs(tensors, names, body: str) -> None:
    """Raise unless every tensor is what ``body``'s kernels read: the first one's shape,
    dtype and device, a dense (H, hd) block per row, every row aligned (16 bytes for
    "mma"). An input that does not fit raises; it is never sent to the other body."""
    first = tensors[0]
    vec = 16 // first.element_size() if body == "mma" else 4
    for x, name in zip(tensors, names):
        _check(x, name, first.shape, first.dtype, first.device, vec)


def check_fwd_inputs(q, k, v, body: str) -> None:
    check_inputs((q, k, v), ("q", "k", "v"), body)


def check_bwd_inputs(q, k, v, do, body: str) -> None:
    check_inputs((q, k, v, do), ("q", "k", "v", "do"), body)


def _check_cuda_call(q: torch.Tensor) -> None:
    """Raise for what neither kernel takes: device, shape, dtype."""
    _, l, h, hd = q.shape
    if q.device.type != "cuda":
        raise ValueError(f"short_attention: no kernel for device {q.device}")
    if not supports(l, h, hd, None):
        raise ValueError(f"short_attention: unsupported shape L={l}, H={h}, hd={hd} "
                         f"(needs L <= {MAX_SEQ}, hd in {HEAD_DIMS})")
    if q.dtype not in DTYPES:
        raise ValueError(f"short_attention: dtype {q.dtype} unsupported (float32, bfloat16)")


def _strides(*tensors):
    """[batch, row] strides in elements of each tensor, as the kernels take them."""
    flat = [x.stride(d) for x in tensors for d in (0, 1)]
    return (ctypes.c_longlong * len(flat))(*flat)


def _launch_fwd(q, k, v, causal: bool, scale: float) -> torch.Tensor:
    b, l, h, hd = q.shape
    body = fwd_body(l, hd, q.dtype)
    check_fwd_inputs(q, k, v, body)
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, l, h, hd,
            _strides(q, k, v, out), float(scale), int(causal)]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel("fwd_mma" if body == "mma" else "fwd")(*args, stream)
    if err != 0:
        raise RuntimeError(f"short_attention kernel ({body}) launch failed: cudaError {err}")
    LAUNCHES["fwd"] += 1
    FWD_BODIES[body] += 1
    return out


def short_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor, *,
                        causal: bool = False, scale: Optional[float] = None):
    """(dq, dk, dv) of ``short_attention`` for the output gradient ``do``: the backward
    kernel for CUDA tensors, or raise; the plain version for CPU tensors."""
    b, l, h, hd = q.shape
    if scale is None:
        scale = hd ** -0.5
    if q.device.type == "cpu":
        return short_attention_bwd_reference(q, k, v, do, causal=causal, scale=scale)
    _check_cuda_call(q)
    do = do.contiguous()  # the gradient of a reshape: dense already, or made so here
    body = bwd_body(l, hd, q.dtype)
    check_bwd_inputs(q, k, v, do, body)
    dq, dk, dv = (torch.empty_like(q, memory_format=torch.contiguous_format) for _ in range(3))
    # row statistics (max, sum, delta) of the two-kernel bodies; the fused one leaves it
    stats = torch.empty((b, h, 3, l), dtype=torch.float32, device=q.device)
    args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), stats.data_ptr(), b, l, h, hd,
            _strides(q, k, v, do, dq, dk, dv), float(scale), int(causal)]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel("bwd_mma" if body == "mma" else "bwd")(*args, stream)
    if err != 0:
        raise RuntimeError(f"short_attention backward kernel ({body}) launch failed: "
                           f"cudaError {err}")
    LAUNCHES["bwd"] += 1
    BWD_BODIES[body] += 1
    return dq, dk, dv


@torch.library.custom_op("oct::short_attention_fwd", mutates_args=())
def short_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
                        scale: float) -> torch.Tensor:
    """The forward without autograd: the kernel for CUDA tensors, the plain version
    for CPU tensors. A custom op, so that a selective remat policy can save its
    output (a ctypes launch is invisible to it)."""
    if q.device.type == "cpu":
        return short_attention_reference(q, k, v, causal=causal, scale=scale)
    return _launch_fwd(q, k, v, causal, scale)


class _ShortAttention(torch.autograd.Function):
    """Forward and backward are the kernels on CUDA tensors and the plain versions
    on CPU tensors. Saves q, k and v only: the backward recomputes the softmax."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.scale = causal, scale
        return torch.ops.oct.short_attention_fwd(q, k, v, causal, scale)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = short_attention_bwd(q, k, v, do, causal=ctx.causal, scale=ctx.scale)
        return dq, dk, dv, None, None


def short_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False, scale: Optional[float] = None) -> torch.Tensor:
    """Self-attention over (B, L, H, hd) tensors; returns (B, L, H, hd) in q.dtype.
    Differentiable with respect to q, k and v."""
    if q.shape != k.shape or q.shape != v.shape:
        raise ValueError("short_attention is self-attention: q, k and v need one shape, "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, l, h, hd = q.shape
    if scale is None:
        scale = hd ** -0.5
    if q.device.type != "cpu":
        _check_cuda_call(q)
    return _ShortAttention.apply(q, k, v, bool(causal), float(scale))
