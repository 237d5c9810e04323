"""LayerNorm with a fused backward: the CUDA kernel, its plain version and its gate
(counterpart of ``open_clip_tpu/ops/fused_ln.py``).

The forward is the plain fp32-statistics LayerNorm of ``ops/layers.py``. The
backward kernel (``csrc/layer_norm_bwd.cu``) replaces the TPU kernel
``open_clip_tpu/ops/fused_ln.py:_bwd_kernel``: one persistent launch streams x and
dy through a ring of row tiles in shared memory (bulk copies on mbarriers), gives dx
and per-block partial sums of dscale and dbias, and folds the partials in a fixed
order in the same launch. It is memory-bound on an H100 (3 * R * W * size bytes for
about 12 * R * W operations), so it reads each element once and keeps many rows in
flight an SM. The statistics are recomputed from x: autograd keeps x and scale only,
where the plain path keeps an fp32 copy of x and the row statistics.

``launch_plan`` decides the launch's shape from (rows, width, dtype, SMs): the
lanes that own a row, the tile of rows and the ring's depth, the blocks, the fold.

The TPU kernel's gate (W % 128, rows >= 256, 256-row blocks) is TPU layout and
is not carried over: ``supported`` is this kernel's own. What it does not take
raises; nothing gives way to the plain version on a CUDA tensor. For CPU
tensors, and only for them, the backward is ``layer_norm_bwd_reference``.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .layers import layer_norm_plain

MAX_WIDTH = 4096
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# the kernel's launch shape (csrc/layer_norm_bwd.cu): 8 consumer warps and one
# producer warp a block, one block an SM; a ring of up to 4 stages of 32-64 KB of x
# and dy; rows owned by groups of 16 or 32 lanes up to WARP_ROW_WIDTH columns, by a
# warpgroup past it and in launches of fewer rows than the card has consumer warps;
# the partials folded by up to 16 blocks
CONSUMER_WARPS = 8
CONSUMER_THREADS = 32 * CONSUMER_WARPS
THREADS = CONSUMER_THREADS + 32
MAX_STAGES = 4
STAGE_BYTES = 32 * 1024
UNROLL_BYTES = 64 * 1024
SMEM_BYTES = 232448 - 1024  # a block's 227 KB, less room for the static barriers
WARP_ROW_WIDTH = 1024
MAX_FOLD_SLICES = 16
# the chunks a lane owns that the kernel is instantiated for, by lanes a row
_NV = {16: (1,), 32: (1, 2, 3, 4, 6, 8), 128: (1, 2, 3, 4, 6, 8)}

# launches of the kernel since the last reset; chip_smoke.py sets and reads it
LAUNCHES = {"bwd": 0}

_fns = {}
_sms = {}       # device index -> multiprocessor count
_counters = {}  # device index -> the kernel's arrival counters and launch count


def supported(x: torch.Tensor) -> bool:
    """Can the backward kernel take the gradient of a LayerNorm over x's last axis?"""
    w = x.shape[-1]
    return x.dtype in _DTYPE_CODES and w % 4 == 0 and 4 <= w <= MAX_WIDTH and x.numel() > 0


@dataclass(frozen=True)
class LaunchPlan:
    """The kernel's launch for (rows, width, dtype) on a card of ``sms`` SMs.

    The full rounds of tiles of rows_per_tile rows go round the blocks, tile t to
    block t % blocks; the R rows they leave are cut into even shares, block b taking
    the row pairs [b * P // blocks, (b + 1) * P // blocks) of their P = ceil(R / 2)
    (the last ending at ``rows``). A tile's first ``bulk_rows`` rows arrive by one
    bulk copy each of x and dy, the rest (at most the last row of all) by plain loads."""

    rows: int
    width: int
    size: int           # bytes an element
    vec: int            # elements a lane moves at once (16 or 8 bytes)
    lanes: int          # threads that own a row: 16 or 32 of a warp, or a warpgroup (128)
    nv: int             # vec-wide chunks of the row a thread owns
    unroll: int         # rows a group takes side by side
    rows_per_tile: int
    stages: int
    blocks: int
    fold_slices: int

    @property
    def stage_bytes(self) -> int:
        return -(-2 * self.rows_per_tile * self.width * self.size // 128) * 128

    @property
    def smem_bytes(self) -> int:
        """Dynamic shared memory: the ring and scale, or the block's column sums (one
        row of dscale and dbias a consumer warp, or a warpgroup), or a fold slice's runs."""
        parts = CONSUMER_WARPS if self.lanes <= 32 else CONSUMER_THREADS // 128
        per = -(-(self.width // 2) // self.fold_slices)
        return max(self.stages * self.stage_bytes + 4 * self.width, parts * 8 * self.width,
                   16 * max(per, THREADS))

    def tile_table(self):
        """Per tile, in row order: (block, first row, rows, rows by bulk copy, byte
        offset, bulk bytes of x and of dy), as numpy arrays."""
        g, t = self.blocks, self.rows_per_tile
        full = self.rows // (g * t) * g  # tiles of the full rounds
        start = full * t
        pairs = (self.rows - start + 1) // 2
        b = np.arange(g, dtype=np.int64)
        a = start + 2 * (b * pairs // g)
        e = np.minimum(start + 2 * ((b + 1) * pairs // g), self.rows)
        keep = e > a
        block = np.concatenate([np.arange(full, dtype=np.int64) % g, b[keep]])
        first = np.concatenate([np.arange(full, dtype=np.int64) * t, a[keep]])
        rows = np.concatenate([np.full(full, t, dtype=np.int64), (e - a)[keep]])
        bulk = np.where(rows * self.width * self.size % 16 != 0, rows - 1, rows)
        return {"block": block, "first": first, "rows": rows, "bulk_rows": bulk,
                "offset": first * self.width * self.size, "bytes": bulk * self.width * self.size}


def _round_up_to(values, n: int) -> int:
    return next(v for v in values if v >= n)


def _unroll(lanes: int, nv: int, vec: int, size: int) -> int:
    """Rows a group takes side by side (``unroll`` of the CUDA source): 4, 2 or 1,
    the most whose pass over every consumer warp stays within UNROLL_BYTES of x and
    dy; 1 where a warpgroup owns the row."""
    if lanes > 32:
        return 1
    rows_pass = CONSUMER_WARPS * (32 // lanes)
    return next(u for u in (4, 2, 1)
                if u == 1 or rows_pass * u * 2 * lanes * nv * vec * size <= UNROLL_BYTES)


@functools.lru_cache(maxsize=256)
def launch_plan(rows: int, width: int, dtype: torch.dtype, sms: int) -> LaunchPlan:
    """The launch shape for a backward over (rows, width) in ``dtype`` on ``sms`` SMs."""
    if not (dtype in _DTYPE_CODES and width % 4 == 0 and 4 <= width <= MAX_WIDTH and rows >= 1
            and sms >= 1):
        raise ValueError(f"layer_norm_bwd: no launch for {rows}x{width} {dtype} on {sms} SMs")
    size = 4 if dtype == torch.float32 else 2
    vec = 16 // size if width * size % 16 == 0 else 8 // size
    vectors = width // vec
    if width > WARP_ROW_WIDTH or rows < CONSUMER_WARPS * sms:  # fewer rows than warps
        lanes = 128
    else:
        lanes = 16 if vectors <= 16 else 32
    nv = _round_up_to(_NV[lanes], -(-vectors // lanes))
    unroll = _unroll(lanes, nv, vec, size)
    # rows the consumers take at once; a tile is a whole number of those, about
    # STAGE_BYTES of x and dy, unless a short launch needs smaller tiles to reach
    # every SM; always even
    at_once = CONSUMER_THREADS // lanes * unroll
    row_pair = 2 * width * size
    per_tile = at_once * max(1, STAGE_BYTES // (at_once * row_pair))
    stages = MAX_STAGES
    while stages > 2 and stages * -(-per_tile * row_pair // 128) * 128 + 4 * width > SMEM_BYTES:
        stages -= 1
    per_tile = min(per_tile, max(2, 2 * -(-rows // (2 * sms))))
    blocks = min(sms, (rows + 1) // 2)
    fold_slices = max(1, min(MAX_FOLD_SLICES, blocks, width // 2 // 16))
    return LaunchPlan(rows, width, size, vec, lanes, nv, unroll, per_tile, stages, blocks,
                      fold_slices)


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
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong] + [ctypes.c_int] * 10
                       + [ctypes.c_float, ctypes.c_void_p])
        _fns["bwd"] = fn
    return fn


def _device_state(index: int):
    """(SM count, counters) of card ``index``, made at its first launch: the kernel's
    counters are zeroed once, and every launch leaves them ready for the next."""
    counters = _counters.get(index)
    if counters is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("layer_norm_bwd: the first launch on a card must not be captured "
                               "in a CUDA graph (it zeroes the kernel's counters)")
        _sms[index] = torch.cuda.get_device_properties(index).multi_processor_count
        counters = _counters[index] = torch.zeros(4, dtype=torch.int32, device=f"cuda:{index}")
    return _sms[index], counters


def layer_norm_bwd(x: torch.Tensor, dy: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5):
    """(dx, dscale, dbias) of LayerNorm over the last axis: the kernel for CUDA
    tensors, or raise; the plain version for CPU tensors."""
    device = x.device
    if device.type == "cpu":
        return layer_norm_bwd_reference(x, dy, scale, eps)
    if device.type != "cuda":
        raise ValueError(f"layer_norm_bwd: no kernel for device {device}")
    if not supported(x):
        raise ValueError(f"layer_norm_bwd: unsupported input {tuple(x.shape)} {x.dtype} "
                         f"(needs float32 or bfloat16, width % 4 == 0, width <= {MAX_WIDTH})")
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != device:
        raise ValueError(f"layer_norm_bwd: dy is {tuple(dy.shape)} {dy.dtype} on {dy.device}; "
                         f"expected {tuple(x.shape)} {x.dtype} on {device}")
    w = x.shape[-1]
    if scale.shape != (w,) or scale.device != device:
        raise ValueError(f"layer_norm_bwd: scale is {tuple(scale.shape)} on {scale.device}; "
                         f"expected ({w},) on {device}")
    if not x.is_contiguous():
        x = x.contiguous()
    if not dy.is_contiguous():
        dy = dy.contiguous()
    if scale.dtype != torch.float32 or not scale.is_contiguous():
        scale = scale.float().contiguous()
    for t, name in ((x, "x"), (dy, "dy"), (scale, "scale")):
        if t.data_ptr() % 16:
            raise ValueError(f"layer_norm_bwd: {name} must be 16-byte aligned")
    index = device.index
    sms, counters = _device_state(index)
    rows = x.numel() // w
    plan = launch_plan(rows, w, x.dtype, sms)
    dx = torch.empty_like(x)
    # the blocks' partials, then the result: dscale and dbias
    scratch = torch.empty((plan.blocks + 1, 2, w), dtype=torch.float32, device=device)
    err = _kernel()(x.data_ptr(), dy.data_ptr(), scale.data_ptr(), dx.data_ptr(),
                    scratch.data_ptr(), counters.data_ptr(), rows, w, _DTYPE_CODES[x.dtype],
                    plan.vec, plan.lanes, plan.nv, plan.rows_per_tile, plan.stages, plan.blocks,
                    plan.fold_slices, index, float(eps), torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        raise RuntimeError(f"layer_norm_bwd kernel launch failed: cudaError {err}")
    LAUNCHES["bwd"] += 1
    dscale, dbias = scratch[plan.blocks].unbind()
    return dx, dscale, dbias


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
        if scale.dtype != dscale.dtype:
            dscale, dbias = dscale.to(scale.dtype), dbias.to(scale.dtype)
        return dx, dscale, dbias if ctx.has_bias else None, None


def layer_norm_fused_bwd(x: torch.Tensor, scale: torch.Tensor, bias: Optional[torch.Tensor],
                         eps: float = 1e-5) -> torch.Tensor:
    """Drop-in for ``ops.layers.layer_norm`` whose backward is the fused kernel."""
    return _LayerNormFusedBwd.apply(x, scale, bias, eps)
