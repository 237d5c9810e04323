"""Swin window attention over pre-partitioned windows: the CUDA kernels, their plain
versions and the dispatch gate (counterpart of ``open_clip_tpu/ops/window_attention.py``).

The kernels (``csrc/window_attention.cu``, PARTITIONED mode) replace the TPU
kernels ``open_clip_tpu/ops/window_attention.py:_fwd_kernel`` and ``_bwd_kernel``:
exact attention inside each window of N <= 128 tokens, under an additive fp32 bias
(nW, H, N, N) that carries the relative-position table and the shifted-window mask,
and its gradient with respect to q, k, v and the bias. Row i of the (B*nW, N, C)
q/k/v uses bias window ``i % nW`` (0 when nW = 1). One block owns a (window, head)
tile; q, k and v are read in place as strided views of the fused qkv projection.
dbias sums over every window that shares a bias window, in fixed groups whose fp32
partials a second kernel folds in order: no atomics, the same bits every run.

The TPU kernel's head pairing, lane masks, VMEM chunking and ``_pick_gb``
divisibility terms are TPU layout and are left out: ``supports`` keeps the JAX
gate's semantics (N <= 128, C <= 1024, C % heads == 0).

``window_attention`` is differentiable in q, k, v and the bias. For CUDA tensors its
forward and backward launch the kernels or raise; for CPU tensors, and only for
them, they compute ``window_attention_reference`` and
``window_attention_bwd_reference``. ``LAUNCHES`` counts the launches of each. The
panel form (``ops/swin_attention.py``) launches the same source in PANEL mode.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

MAX_N = 128
MAX_C = 1024
PARTITIONED, PANEL = 0, 1
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the backward walks windows that share a bias window in groups, so that at least
# this many blocks run even where every window shares one bias window
_BWD_TARGET_BLOCKS = 1056

# launches of each kernel since the last reset; chip_smoke.py sets and reads them
LAUNCHES = {"fwd": 0, "bwd": 0}

_fns = {}


def supports(n: int, heads: int, c: int) -> bool:
    """Can the kernel serve this window-attention shape? (Dispatch gate; every batch
    and bias-window count is served.)"""
    return 1 <= n <= MAX_N and 1 <= c <= MAX_C and heads >= 1 and c % heads == 0


def _scale(c: int, heads: int, scale: Optional[float]) -> float:
    return (c // heads) ** -0.5 if scale is None else float(scale)


def window_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               bias: torch.Tensor, *, scale: Optional[float] = None) -> torch.Tensor:
    """Plain PyTorch version of the forward kernel: (B*nW, N, C) q/k/v, (nW, H, N, N)
    bias; fp32 logits and softmax, probabilities rounded to the input dtype before the
    product with v, output in the input dtype. Differentiable by autograd."""
    bn, n, c = q.shape
    nw, heads = bias.shape[:2]
    hd = c // heads
    scale = _scale(c, heads, scale)
    split = lambda x: x.float().reshape(bn, n, heads, hd)  # noqa: E731
    s = torch.einsum("bqhd,bkhd->bhqk", split(q), split(k)) * scale
    s = (s.reshape(-1, nw, heads, n, n) + bias.float()).reshape(bn, heads, n, n)
    p = torch.softmax(s, dim=-1).to(q.dtype).float()
    out = torch.einsum("bhqk,bkhd->bqhd", p, split(v))
    return out.to(q.dtype).reshape(bn, n, c)


def window_attention_bwd_reference(q, k, v, bias, do, *, scale: Optional[float] = None):
    """Plain PyTorch version of the backward kernel, with its rounding points: fp32
    logits, softmax, dp and ds; p and ds rounded to the input dtype for the products;
    dq, dk, dv in the input dtype and dbias (nW, H, N, N) in fp32, summed over every
    window that shares a bias window."""
    bn, n, c = q.shape
    nw, heads = bias.shape[:2]
    hd = c // heads
    scale = _scale(c, heads, scale)
    dtype = q.dtype
    split = lambda x: x.float().reshape(bn, n, heads, hd)  # noqa: E731
    q32, k32, v32, do32 = split(q), split(k), split(v), split(do)
    s = torch.einsum("bqhd,bkhd->bhqk", q32, k32) * scale
    s = (s.reshape(-1, nw, heads, n, n) + bias.float()).reshape(bn, heads, n, n)
    p32 = torch.softmax(s, dim=-1)
    dp = torch.einsum("bqhd,bkhd->bhqk", do32, v32)
    ds = p32 * (dp - (dp * p32).sum(dim=-1, keepdim=True))
    dbias = ds.reshape(-1, nw, heads, n, n).sum(dim=0)
    dsr = ds.to(dtype).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", dsr, k32) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", dsr, q32) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p32.to(dtype).float(), do32)
    return (dq.to(dtype).reshape(bn, n, c), dk.to(dtype).reshape(bn, n, c),
            dv.to(dtype).reshape(bn, n, c), dbias)


# ---------------------------------------------------------------------------
# the kernels (shared with ops/swin_attention.py)
# ---------------------------------------------------------------------------

def _kernel(which: str):
    fn = _fns.get(which)
    if fn is None:
        from ._build import load

        lib = load("window_attention")
        if which == "fwd":
            fn = lib.oct_window_attention_fwd
            fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        else:
            fn = lib.oct_window_attention_bwd
            fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                                                      ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fns[which] = fn
    return fn


def _longs(values):
    return (ctypes.c_longlong * len(values))(*[int(x) for x in values])


def _check_rows(x: torch.Tensor, name: str, like: torch.Tensor) -> None:
    """A 3-D q/k/v/do-like tensor: like's shape, dtype and device, dense columns."""
    if x.shape != like.shape or x.dtype != like.dtype or x.device != like.device:
        raise ValueError(f"window attention: {name} is {tuple(x.shape)} {x.dtype} on {x.device}; "
                         f"expected {tuple(like.shape)} {like.dtype} on {like.device}")
    if x.stride(2) != 1:
        raise ValueError(f"window attention: {name} needs dense columns; strides {x.stride()}")


def check_cuda_call(q: torch.Tensor, bias: torch.Tensor, n: int, heads: int) -> None:
    """Raise for what the kernels do not take: device, dtype, shape."""
    c = q.shape[-1]
    if q.device.type != "cuda":
        raise ValueError(f"window attention: no kernel for device {q.device}")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"window attention: dtype {q.dtype} unsupported (float32, bfloat16)")
    if not supports(n, heads, c):
        raise ValueError(f"window attention: unsupported shape N={n}, heads={heads}, C={c} "
                         f"(needs N <= {MAX_N}, C <= {MAX_C}, C % heads == 0)")
    if bias.device != q.device:
        raise ValueError(f"window attention: bias on {bias.device}, q on {q.device}")


def launch_fwd(mode: int, q, k, v, bias, geom, scale: float, launches) -> torch.Tensor:
    """The forward kernel; ``geom`` = [S, P, N, H, hd, nWb, ws, W, nWx]. Returns a new
    tensor shaped as q and counts the launch in ``launches``."""
    for x, name in ((k, "k"), (v, "v"), (q, "q")):
        _check_rows(x, name, q)
    bias = bias.float().contiguous()
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    fn = _kernel("fwd")
    strides = [x.stride(d) for x in (q, k, v, out) for d in (0, 1)]
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), out.data_ptr(),
                 _longs([mode, *geom]), _longs(strides), float(scale), _DTYPE_CODES[q.dtype],
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"window attention forward kernel launch failed: cudaError {err}")
    launches["fwd"] += 1
    return out


def bwd_groups(geom) -> tuple:
    """(G, nG): windows per group and groups per bias window of the backward."""
    s, p, _, heads, _, nwb = geom[:6]
    count = s * p if nwb == 1 else s
    groups = min(count, max(1, math.ceil(_BWD_TARGET_BLOCKS / (nwb * heads))))
    size = math.ceil(count / groups)
    return size, math.ceil(count / size)


def launch_bwd(mode: int, q, k, v, bias, do, geom, scale: float, launches):
    """The backward kernels: (dq, dk, dv shaped as q, dbias (nWb, H, N, N) fp32)."""
    do = do.contiguous()
    for x, name in ((k, "k"), (v, "v"), (do, "do"), (q, "q")):
        _check_rows(x, name, q)
    bias = bias.float().contiguous()
    dq, dk, dv = (torch.empty(q.shape, dtype=q.dtype, device=q.device) for _ in range(3))
    dbias = torch.empty(bias.shape, dtype=torch.float32, device=q.device)
    size, groups = bwd_groups(geom)
    partials = (torch.empty((groups, *bias.shape), dtype=torch.float32, device=q.device)
                if groups > 1 else dbias)
    fn = _kernel("bwd")
    strides = [x.stride(d) for x in (q, k, v, do, dq, dk, dv) for d in (0, 1)]
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), do.data_ptr(),
                 dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), partials.data_ptr(),
                 dbias.data_ptr(), _longs([mode, *geom]), _longs(strides), size, groups,
                 float(scale), _DTYPE_CODES[q.dtype], torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"window attention backward kernel launch failed: cudaError {err}")
    launches["bwd"] += 1
    return dq, dk, dv, dbias


def _geom(q: torch.Tensor, bias: torch.Tensor):
    """PARTITIONED geometry of (B*nW, N, C) rows under an (nW, H, N, N) bias."""
    bn, n, c = q.shape
    nw, heads = bias.shape[:2]
    return [bn // nw, nw, n, heads, c // heads, nw, 0, 0, 1]


def window_attention_fwd(q, k, v, bias, *, scale: Optional[float] = None) -> torch.Tensor:
    """The forward kernel for CUDA tensors, or raise; the plain version for CPU tensors."""
    bn, n, c = q.shape
    heads = bias.shape[1]
    scale = _scale(c, heads, scale)
    if q.device.type == "cpu":
        return window_attention_reference(q, k, v, bias, scale=scale)
    check_cuda_call(q, bias, n, heads)
    return launch_fwd(PARTITIONED, q, k, v, bias, _geom(q, bias), scale, LAUNCHES)


def window_attention_bwd(q, k, v, bias, do, *, scale: Optional[float] = None):
    """(dq, dk, dv, dbias) of ``window_attention``: the backward kernels for CUDA
    tensors, or raise; the plain version for CPU tensors."""
    bn, n, c = q.shape
    heads = bias.shape[1]
    scale = _scale(c, heads, scale)
    if q.device.type == "cpu":
        return window_attention_bwd_reference(q, k, v, bias, do, scale=scale)
    check_cuda_call(q, bias, n, heads)
    return launch_bwd(PARTITIONED, q, k, v, bias, do, _geom(q, bias), scale, LAUNCHES)


class _WindowAttention(torch.autograd.Function):
    """Saves q, k, v and the bias; the backward recomputes the softmax."""

    @staticmethod
    def forward(ctx, q, k, v, bias, scale: float):
        ctx.save_for_backward(q, k, v, bias)
        ctx.scale = scale
        return window_attention_fwd(q, k, v, bias, scale=scale)

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias = ctx.saved_tensors
        dq, dk, dv, dbias = window_attention_bwd(q, k, v, bias, do, scale=ctx.scale)
        return dq, dk, dv, dbias.to(bias.dtype), None


def _check_args(q, k, v, bias):
    if q.ndim != 3 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError("window attention: q, k and v need one (B*nW, N, C) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    bn, n, c = q.shape
    nw, heads = bias.shape[:2]
    if bias.shape[2:] != (n, n) or c % heads or bn % nw:
        raise ValueError(f"window attention: bias {tuple(bias.shape)} does not fit q "
                         f"{tuple(q.shape)} (needs (nW, H, N, N), B*nW % nW == 0, C % H == 0)")


def window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor, *,
                     scale: Optional[float] = None) -> torch.Tensor:
    """Window attention over (B*nW, N, C) windows (window-minor: row i uses bias window
    ``i % nW``) under the (nW, H, N, N) additive bias; returns (B*nW, N, C) in q.dtype.
    Differentiable in q, k, v and the bias."""
    _check_args(q, k, v, bias)
    c, heads = q.shape[-1], bias.shape[1]
    if q.device.type != "cpu":
        check_cuda_call(q, bias, q.shape[1], heads)
    return _WindowAttention.apply(q, k, v, bias, _scale(c, heads, scale))
