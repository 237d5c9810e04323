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

The forward and the backward have two bodies each, chosen by ``fwd_body`` and
``bwd_body`` (one rule) from the mode, the window length, the head width and the
dtype alone: "mma" (bf16 on the tensor cores; hd % 8 == 0, hd <= 64, PANEL windows or
PARTITIONED windows of N <= 64 tokens, padded to 64 in the kernel: Swin's 49-token
windows) and "simt" (CUDA cores; fp32 and every other shape). Inputs the chosen body
cannot read (rows not 16-byte aligned for "mma") raise; they are never sent to the
other body. ``FWD_BODIES`` and ``BWD_BODIES`` count the launches by body, here and in
the panel form.
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
# this many blocks run even where every window shares one bias window: 1056 for the
# CUDA-core body and the panel form (at HTSAT's stages no other target wins at every
# one); 264 for the tensor-core body over partitioned windows, whose blocks
# (three an SM) then fill about one wave with the fewest partials to fold (Swin-B's
# four stages at batch 32, H100: 0.132 / 0.059 / 0.039 / 0.023 ms against 0.132 /
# 0.081 / 0.054 / 0.043 at 1056; chip_smoke.py's window_bwd_groups line)
_BWD_TARGET_BLOCKS = 1056
_BWD_TARGET_BLOCKS_MMA = 264
# the tensor-core forward walks its groups in the same way; it folds no partials, so
# a group only shares the bias tile's load among its windows. 264 blocks, about two an
# SM, in both modes: Swin-B's four stages at batch 32, H100, 0.053 / 0.031 / 0.018 /
# 0.012 ms against 0.059 / 0.035 / 0.019 / 0.016 at 1056; HTSAT's shifted stage 0 at
# batch 128 runs faster at 132 (0.210 against 0.315 ms: 256 blocks, not 512) but its
# stages 2 and 3 slower (0.080 / 0.053 against 0.068 / 0.038); chip_smoke.py's
# window_fwd_groups line
_FWD_TARGET_BLOCKS = 264

# the widest head and the longest window of the tensor-core bodies
MMA_MAX_HD = 64
MMA_MAX_N = 64

# launches of each kernel since the last reset, and of each by body; chip_smoke.py
# sets and reads them
LAUNCHES = {"fwd": 0, "bwd": 0}
FWD_BODIES = {"mma": 0, "simt": 0}
BWD_BODIES = {"mma": 0, "simt": 0}

_fns = {}


def supports(n: int, heads: int, c: int) -> bool:
    """Can the kernel serve this window-attention shape? (Dispatch gate; every batch
    and bias-window count is served.)"""
    return 1 <= n <= MAX_N and 1 <= c <= MAX_C and heads >= 1 and c % heads == 0


def fwd_body(mode: int, n: int, hd: int, dtype: torch.dtype) -> str:
    """Which body serves a shape the kernels take, forward and backward alike, for
    windows of ``n`` tokens: "mma" (tensor cores) for bf16 with hd % 8 == 0 and
    hd <= 64, PANEL windows or PARTITIONED ones of n <= 64; "simt" (CUDA cores) for
    every other: fp32, longer windows, and head widths such as 12 or 72."""
    fits = mode == PANEL or n <= MMA_MAX_N
    if dtype == torch.bfloat16 and fits and hd % 8 == 0 and hd <= MMA_MAX_HD:
        return "mma"
    return "simt"


# the backward's rule is the forward's; two names, so that either can be sent to the
# CUDA-core body alone (chip_smoke.py's before-and-after windows rebind one of them)
bwd_body = fwd_body


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
            fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                                                     ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        else:
            fn = lib.oct_window_attention_bwd
            fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                                                      ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fns[which] = fn
    return fn


def _longs(values):
    return (ctypes.c_longlong * len(values))(*[int(x) for x in values])


def _check_rows(x: torch.Tensor, name: str, like: torch.Tensor, aligned: bool = False) -> None:
    """A 3-D q/k/v/do-like tensor: like's shape, dtype and device, dense columns; with
    ``aligned``, every row 16-byte aligned (pointer and strides)."""
    if x.shape != like.shape or x.dtype != like.dtype or x.device != like.device:
        raise ValueError(f"window attention: {name} is {tuple(x.shape)} {x.dtype} on {x.device}; "
                         f"expected {tuple(like.shape)} {like.dtype} on {like.device}")
    if x.stride(2) != 1:
        raise ValueError(f"window attention: {name} needs dense columns; strides {x.stride()}")
    vec = 16 // x.element_size()
    if aligned and (x.data_ptr() % 16 or x.stride(0) % vec or x.stride(1) % vec):
        raise ValueError(f"window attention: the tensor-core kernels need 16-byte aligned rows "
                         f"of {name}; got strides {x.stride()}")


def check_fwd_inputs(q, k, v, body: str) -> None:
    """Raise unless q, k and v are what ``body``'s forward reads: q's shape, dtype and
    device, dense columns, and for "mma" every row 16-byte aligned. An input that
    does not fit raises; it is never sent to the other body."""
    for x, name in ((k, "k"), (v, "v"), (q, "q")):
        _check_rows(x, name, q, aligned=body == "mma")


def check_bwd_inputs(q, k, v, do, body: str) -> None:
    """``check_fwd_inputs``, and do as well."""
    check_fwd_inputs(q, k, v, body)
    _check_rows(do, "do", q, aligned=body == "mma")


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


def launch_fwd(mode: int, q, k, v, bias, geom, scale: float, launches, bodies) -> torch.Tensor:
    """The forward kernel of the body ``fwd_body`` picks; ``geom`` = [S, P, N, H, hd,
    nWb, ws, W, nWx]. Returns a new tensor shaped as q and counts the launch in
    ``launches`` and ``bodies``."""
    body = fwd_body(mode, geom[2], geom[4], q.dtype)
    check_fwd_inputs(q, k, v, body)
    bias = bias.float().contiguous()
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    size, groups = bwd_groups(geom, fwd_target())
    fn = _kernel("fwd")
    strides = [x.stride(d) for x in (q, k, v, out) for d in (0, 1)]
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), out.data_ptr(),
                 _longs([mode, *geom]), _longs(strides), size, groups, float(scale),
                 _DTYPE_CODES[q.dtype], int(body == "mma"), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"window attention forward kernel ({body}) launch failed: "
                           f"cudaError {err}")
    launches["fwd"] += 1
    bodies[body] += 1
    return out


def fwd_target() -> int:
    """The blocks the tensor-core forward's group split aims at."""
    return _FWD_TARGET_BLOCKS


def bwd_target(mode: int, body: str) -> int:
    """The blocks the backward's group split aims at, for a mode and body."""
    return _BWD_TARGET_BLOCKS_MMA if mode == PARTITIONED and body == "mma" else _BWD_TARGET_BLOCKS


def bwd_groups(geom, target: Optional[int] = None) -> tuple:
    """(G, nG): windows per group and groups per bias window of the backward (and of
    the tensor-core forward), for ``target`` blocks (the CUDA-core backward's by
    default)."""
    s, p, _, heads, _, nwb = geom[:6]
    count = s * p if nwb == 1 else s
    target = _BWD_TARGET_BLOCKS if target is None else target
    groups = min(count, max(1, math.ceil(target / (nwb * heads))))
    size = math.ceil(count / groups)
    return size, math.ceil(count / size)


def launch_bwd(mode: int, q, k, v, bias, do, geom, scale: float, launches, bodies):
    """The backward kernels of the body ``bwd_body`` picks: (dq, dk, dv shaped as q,
    dbias (nWb, H, N, N) fp32). Counts the launch in ``launches`` and ``bodies``."""
    do = do.contiguous()
    body = bwd_body(mode, geom[2], geom[4], q.dtype)
    check_bwd_inputs(q, k, v, do, body)
    bias = bias.float().contiguous()
    dq, dk, dv = (torch.empty(q.shape, dtype=q.dtype, device=q.device) for _ in range(3))
    dbias = torch.empty(bias.shape, dtype=torch.float32, device=q.device)
    size, groups = bwd_groups(geom, bwd_target(mode, body))
    partials = (torch.empty((groups, *bias.shape), dtype=torch.float32, device=q.device)
                if groups > 1 else dbias)
    fn = _kernel("bwd")
    strides = [x.stride(d) for x in (q, k, v, do, dq, dk, dv) for d in (0, 1)]
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), do.data_ptr(),
                 dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), partials.data_ptr(),
                 dbias.data_ptr(), _longs([mode, *geom]), _longs(strides), size, groups,
                 float(scale), _DTYPE_CODES[q.dtype], int(body == "mma"),
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"window attention backward kernel ({body}) launch failed: "
                           f"cudaError {err}")
    launches["bwd"] += 1
    bodies[body] += 1
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
    return launch_fwd(PARTITIONED, q, k, v, bias, _geom(q, bias), scale, LAUNCHES, FWD_BODIES)


def window_attention_bwd(q, k, v, bias, do, *, scale: Optional[float] = None):
    """(dq, dk, dv, dbias) of ``window_attention``: the backward kernels for CUDA
    tensors, or raise; the plain version for CPU tensors."""
    bn, n, c = q.shape
    heads = bias.shape[1]
    scale = _scale(c, heads, scale)
    if q.device.type == "cpu":
        return window_attention_bwd_reference(q, k, v, bias, do, scale=scale)
    check_cuda_call(q, bias, n, heads)
    return launch_bwd(PARTITIONED, q, k, v, bias, do, _geom(q, bias), scale, LAUNCHES,
                      BWD_BODIES)


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
