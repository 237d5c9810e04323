"""Flash attention: the three CUDA kernels, their plain versions and the dispatch gate.

The kernels (``csrc/flash_attention.cu``) replace the TPU kernels of
``open_clip_tpu/ops/flash_attention.py``: ``_fa_fwd_kernel`` (tiled online-softmax
forward that also emits each row's logsumexp), ``_fa_bwd_dq_kernel`` and
``_fa_bwd_dkv_kernel`` (the gradient, with the probabilities recomputed from the
logsumexp, never an (L, L) tensor in device memory). Self-attention over
(B, L, H, hd) tensors, hd in {64, 128}, any L, bf16 or fp32, with three masks
applied inside the kernels: a (B, L) key-validity vector shared by the heads (the
NaFlex ``patch_valid`` contract), the causal mask, and ``prefix_len`` (prefix-LM:
the first ``prefix_len`` keys are visible to every query). Key j is visible to
query i iff ``key_valid[b, j]`` and (not causal, or i >= j, or j < prefix_len).

At the long lengths the dispatch sends here the work is bound by operations on an
H100, so the bf16 kernels run their matrix products on the tensor cores; q, k and
v are read in place from the tower's (B, L, H*hd) layout, with no transpose, no
padding of L and no per-head copy of the mask. The source file says more. The TPU
version's (B*H, Lp, hd) transpose, its padding of L to 128 and its 512x1024 blocks
are TPU layout and are left out.

A query that sees no key at all (a sample with no valid patch; the data never
makes one) gets a zero output row and zero gradients, from the kernels and from
the plain versions alike. Padded queries are computed like any other row.

``flash_attention`` is differentiable with respect to q, k and v. For CUDA
tensors it launches the kernels or raises; for CPU tensors, and only for them, it
computes ``flash_attention_reference`` and ``flash_attention_bwd_reference``.
``LAUNCHES`` counts the launches of each kernel.

Each kernel has two bodies, chosen from the dtype by ``fwd_body`` and ``bwd_body``:
"wgmma" (bf16: Hopper's warpgroup products fed by TMA copies; the forward and dq skip
the key tiles that hold no valid key, dk/dv the key tiles with none) and "simt" (fp32
on CUDA cores). ``FWD_BODIES`` counts the forward's launches by body, ``BWD_BODIES``
the backward passes (one dq and one dk/dv launch each) by body. The dq kernel also
computes di = rowsum(out * do) and writes it for the dk/dv kernel. TMA reads q, k, v,
do and out through tensor maps over their strided views, which need every row 16-byte
aligned; ``check_inputs`` raises where they are not (every body reads 16 bytes at a
time), and no input is sent to another body.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

HEAD_DIMS = (64, 128)
NEG_INF = torch.finfo(torch.float32).min * 0.5  # large negative, not -inf: no NaN from inf - inf
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# launches of each kernel since the last reset, of the forward by body, and the
# backward passes (a dq and a dk/dv launch) by body; chip_smoke.py sets and reads them
LAUNCHES = {"fwd": 0, "bwd_dq": 0, "bwd_dkv": 0}
FWD_BODIES = {"wgmma": 0, "simt": 0}
BWD_BODIES = {"wgmma": 0, "simt": 0}

_fns = {}


def supports(l: int, h: int, hd: int, bias) -> bool:
    """Can the kernels serve self-attention of this shape? (Dispatch gate.)"""
    return bias is None and l >= 1 and h >= 1 and hd in HEAD_DIMS


def fwd_body(hd: int, dtype: torch.dtype) -> str:
    """Which forward body serves a shape the kernels take: "wgmma" (tensor cores,
    TMA) for bf16, "simt" (CUDA cores) for fp32."""
    return "wgmma" if dtype == torch.bfloat16 else "simt"


def bwd_body(hd: int, dtype: torch.dtype) -> str:
    """Which body both backward kernels (dq, dk/dv) take for a shape the kernels take:
    "wgmma" (tensor cores, TMA) for bf16 at either head width, "simt" (CUDA cores) for
    fp32."""
    return "wgmma" if dtype == torch.bfloat16 else "simt"


def _visible(l: int, causal: bool, prefix_len: int, key_valid: Optional[torch.Tensor],
             device) -> Optional[torch.Tensor]:
    """(B or 1, 1, L, L) bool, True where the query (row) sees the key (column);
    None when every query sees every key."""
    vis = None
    if causal:
        vis = torch.ones(l, l, dtype=torch.bool, device=device).tril()
        if prefix_len:
            vis[:, :prefix_len] = True
        vis = vis[None, None]
    if key_valid is not None:
        kv = key_valid.to(device=device, dtype=torch.bool)[:, None, None, :]
        vis = kv if vis is None else vis & kv
    return vis


def _check_masks(causal: bool, prefix_len: int) -> None:
    if prefix_len < 0 or (prefix_len and not causal):
        raise ValueError("prefix_len implies the causal (prefix-LM) mask and is not negative")


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                              causal: bool = False, scale: Optional[float] = None,
                              key_valid: Optional[torch.Tensor] = None,
                              prefix_len: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the forward kernel: dense fp32 logits and softmax,
    a masked entry's probability exactly 0, probabilities cast to ``v.dtype`` before
    the product with v. Returns (out (B, L, H, hd) in q.dtype, lse (B, H, L) fp32).
    Differentiable by autograd."""
    _check_masks(causal, prefix_len)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    vis = _visible(q.shape[1], causal, prefix_len, key_valid, q.device)
    if vis is not None:
        s = s.masked_fill(~vis, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    if vis is not None:
        p = p * vis  # a row with no visible key: all zeros, not uniform
    total = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhqk,bkhd->bqhd", (p / total).to(v.dtype), v)
    return out, (m + total.log()).squeeze(-1)


def flash_attention_bwd_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                  out: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, *,
                                  causal: bool = False, scale: Optional[float] = None,
                                  key_valid: Optional[torch.Tensor] = None, prefix_len: int = 0):
    """Plain PyTorch version of the two backward kernels, step by step with their
    rounding points: di = rowsum(out * do) in fp32; p = exp(logits - lse) where
    visible, else 0; ds = p * (dp - di) and p rounded to the input dtype; dq, dk, dv
    accumulated in fp32, dq and dk scaled once at the end, returned in the input dtype."""
    _check_masks(causal, prefix_len)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    dtype = q.dtype
    q32, k32, v32, do32 = q.float(), k.float(), v.float(), do.float()
    di = (out.float() * do32).sum(dim=-1).permute(0, 2, 1)  # (B, H, L)
    s = torch.einsum("bqhd,bkhd->bhqk", q32, k32) * scale
    vis = _visible(q.shape[1], causal, prefix_len, key_valid, q.device)
    if vis is not None:
        s = s.masked_fill(~vis, float("-inf"))
    p32 = torch.exp(s - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", do32, v32)
    ds = (p32 * (dp - di[..., None])).to(dtype).float()
    p = p32.to(dtype).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k32) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q32) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do32)
    return dq.to(dtype), dk.to(dtype), dv.to(dtype)


def _kernel(which: str):
    fn = _fns.get(which)
    if fn is None:
        from ._build import load

        lib = load("flash_attention")
        tail = [ctypes.c_int] * 4 + [ctypes.c_void_p, ctypes.c_float, ctypes.c_int, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_void_p]
        fn = getattr(lib, f"oct_flash_attention_{which}")
        pointers = {"fwd": 6, "bwd_dq": 9, "bwd_dkv": 9}[which]
        fn.argtypes = [ctypes.c_void_p] * pointers + tail
        fn.restype = ctypes.c_int
        _fns[which] = fn
    return fn


def _check(x: torch.Tensor, name: str, shape, dtype, device) -> None:
    hd = shape[3]
    if x.shape != shape or x.dtype != dtype or x.device != device:
        raise ValueError(f"flash_attention: {name} is {tuple(x.shape)} {x.dtype} on {x.device}; "
                         f"expected {tuple(shape)} {dtype} on {device}")
    # the (H, hd) block of each row must be dense; batch and row strides are free, so
    # q/k/v may be the three slices of one fused (B, L, 3, H, hd) projection. The
    # kernels read 16 bytes at a time, so every row starts 16-byte aligned.
    vec = 16 // x.element_size()
    if (x.stride(3) != 1 or x.stride(2) != hd or x.stride(0) % vec or x.stride(1) % vec
            or x.data_ptr() % 16):
        raise ValueError(f"flash_attention: {name} must have a dense, 16-byte aligned (H, hd) "
                         f"block per row; got strides {x.stride()}")


def check_inputs(tensors, names) -> None:
    """Raise unless every tensor has the first one's shape, dtype and device and a
    dense, 16-byte aligned (H, hd) block per row: what the kernels (and the forward's
    TMA tensor maps) read. Runs on tensors of any device."""
    q = tensors[0]
    for x, name in zip(tensors, names):
        _check(x, name, q.shape, q.dtype, q.device)


def _check_cuda_call(q: torch.Tensor) -> None:
    """Raise for what no kernel takes: device, shape, dtype."""
    _, l, h, hd = q.shape
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    if not supports(l, h, hd, None):
        raise ValueError(f"flash_attention: unsupported shape L={l}, H={h}, hd={hd} "
                         f"(needs hd in {HEAD_DIMS})")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"flash_attention: dtype {q.dtype} unsupported (float32, bfloat16)")


def _valid_bytes(key_valid: Optional[torch.Tensor], q: torch.Tensor) -> Optional[torch.Tensor]:
    """``key_valid`` as the contiguous (B, L) uint8 tensor the kernels read."""
    if key_valid is None:
        return None
    if key_valid.shape != (q.shape[0], q.shape[1]):
        raise ValueError(f"flash_attention: key_valid is {tuple(key_valid.shape)}, "
                         f"expected {(q.shape[0], q.shape[1])}")
    if key_valid.dtype == torch.uint8:
        return key_valid.to(q.device).contiguous()
    mask = key_valid > 0 if key_valid.is_floating_point() else key_valid.bool()
    return mask.to(device=q.device, dtype=torch.uint8).contiguous()


def _strides(*tensors):
    """[batch, row] strides in elements of each tensor, as the kernels take them."""
    flat = [x.stride(d) for x in tensors for d in (0, 1)]
    return (ctypes.c_longlong * len(flat))(*flat)


def _ptr(x: Optional[torch.Tensor]):
    return None if x is None else x.data_ptr()


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = False, scale: Optional[float] = None,
                        key_valid: Optional[torch.Tensor] = None,
                        prefix_len: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, lse) without autograd: the forward kernel for CUDA tensors, or raise;
    the plain version for CPU tensors."""
    _check_masks(causal, prefix_len)
    b, l, h, hd = q.shape
    if scale is None:
        scale = hd ** -0.5
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal=causal, scale=scale,
                                         key_valid=key_valid, prefix_len=prefix_len)
    _check_cuda_call(q)
    check_inputs((q, k, v), ("q", "k", "v"))
    valid = _valid_bytes(key_valid, q)
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = torch.empty((b, h, l), dtype=torch.float32, device=q.device)
    fn = _kernel("fwd")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(valid), out.data_ptr(),
                 lse.data_ptr(), b, l, h, hd, _strides(q, k, v, out), float(scale), int(causal),
                 int(prefix_len), _DTYPE_CODES[q.dtype], stream)
    body = fwd_body(hd, q.dtype)
    if err != 0:
        raise RuntimeError(f"flash_attention forward kernel ({body}) launch failed: "
                           f"cudaError {err}")
    LAUNCHES["fwd"] += 1
    FWD_BODIES[body] += 1
    return out, lse


def _launch_bwd(which: str, q, k, v, out, do, lse, di, valid, causal: bool, scale: float,
                prefix_len: int):
    """Launch one backward kernel on checked CUDA tensors. "bwd_dq" reads ``out``
    and returns (dq, di), di = rowsum(out * do) as fp32 (B, H, L); "bwd_dkv" reads
    that ``di`` and returns (dk, dv)."""
    b, l, h, hd = q.shape
    dq_kernel = which == "bwd_dq"
    outs = [torch.empty_like(q, memory_format=torch.contiguous_format)
            for _ in range(1 if dq_kernel else 2)]
    if dq_kernel:
        di = torch.empty((b, h, l), dtype=torch.float32, device=q.device)
        ptrs, strided = (out.data_ptr(), lse.data_ptr(), di.data_ptr()), (q, k, v, do, out)
    else:
        ptrs, strided = (lse.data_ptr(), di.data_ptr()), (q, k, v, do)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel(which)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(valid), do.data_ptr(), *ptrs,
            *(x.data_ptr() for x in outs), b, l, h, hd, _strides(*strided, *outs), float(scale),
            int(causal), int(prefix_len), _DTYPE_CODES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash_attention {which} kernel ({bwd_body(hd, q.dtype)}) launch "
                           f"failed: cudaError {err}")
    LAUNCHES[which] += 1
    return (outs[0], di) if dq_kernel else tuple(outs)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                        lse: torch.Tensor, do: torch.Tensor, *, causal: bool = False,
                        scale: Optional[float] = None, key_valid: Optional[torch.Tensor] = None,
                        prefix_len: int = 0):
    """(dq, dk, dv) for the output gradient ``do``, from the forward's ``out`` and
    ``lse``: the two backward kernels for CUDA tensors, or raise; the plain version
    for CPU tensors. ``key_valid`` gets no gradient."""
    _check_masks(causal, prefix_len)
    b, l, h, hd = q.shape
    if scale is None:
        scale = hd ** -0.5
    if q.device.type == "cpu":
        return flash_attention_bwd_reference(q, k, v, out, lse, do, causal=causal, scale=scale,
                                             key_valid=key_valid, prefix_len=prefix_len)
    _check_cuda_call(q)
    do = do.contiguous()  # the gradient of a reshape: dense already, or made so here
    check_inputs((q, k, v, out, do), ("q", "k", "v", "out", "do"))
    if lse.shape != (b, h, l) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError(f"flash_attention: lse must be a contiguous fp32 {(b, h, l)} tensor")
    valid = _valid_bytes(key_valid, q)
    # the dq kernel takes di = rowsum(out * do) in fp32 and hands it to dk/dv
    dq, di = _launch_bwd("bwd_dq", q, k, v, out, do, lse, None, valid, causal, scale, prefix_len)
    dk, dv = _launch_bwd("bwd_dkv", q, k, v, out, do, lse, di, valid, causal, scale, prefix_len)
    BWD_BODIES[bwd_body(hd, q.dtype)] += 1
    return dq, dk, dv


@torch.library.custom_op("oct::flash_attention_fwd", mutates_args=())
def _flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  key_valid: Optional[torch.Tensor], causal: bool, scale: float,
                  prefix_len: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``flash_attention_fwd`` as a custom op, so that a selective remat policy can
    save its outputs (a ctypes launch is invisible to it)."""
    return flash_attention_fwd(q, k, v, causal=causal, scale=scale, key_valid=key_valid,
                               prefix_len=prefix_len)


class _FlashAttention(torch.autograd.Function):
    """Forward and backward are the kernels on CUDA tensors and the plain versions on
    CPU tensors. Saves q, k, v, out, lse and the validity bytes."""

    @staticmethod
    def forward(ctx, q, k, v, key_valid, causal: bool, scale: float, prefix_len: int):
        out, lse = torch.ops.oct.flash_attention_fwd(q, k, v, key_valid, causal, scale, prefix_len)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.key_valid = key_valid  # a mask, not a differentiable input
        ctx.causal, ctx.scale, ctx.prefix_len = causal, scale, prefix_len
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do, causal=ctx.causal,
                                         scale=ctx.scale, key_valid=ctx.key_valid,
                                         prefix_len=ctx.prefix_len)
        return dq, dk, dv, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = False,
                    scale: Optional[float] = None, key_valid: Optional[torch.Tensor] = None,
                    prefix_len: int = 0) -> torch.Tensor:
    """Self-attention over (B, L, H, hd) tensors; returns (B, L, H, hd) in q.dtype.
    ``key_valid``: optional (B, L) bool/0-1 key-padding mask; ``prefix_len``: with
    ``causal``, the first ``prefix_len`` keys are visible to every query.
    Differentiable with respect to q, k and v."""
    if q.shape != k.shape or q.shape != v.shape:
        raise ValueError("flash_attention is self-attention: q, k and v need one shape, "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    _check_masks(causal, prefix_len)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type != "cpu":
        _check_cuda_call(q)
    valid = _valid_bytes(key_valid, q)
    return _FlashAttention.apply(q, k, v, valid, bool(causal), float(scale), int(prefix_len))
