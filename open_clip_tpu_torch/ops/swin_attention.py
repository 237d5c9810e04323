"""Panel window attention: Swin window attention read straight from the token map
(counterpart of ``open_clip_tpu/ops/swin_attention.py``).

The kernels are those of ``csrc/window_attention.cu`` in PANEL mode; they replace
the TPU kernels ``open_clip_tpu/ops/swin_attention.py:_fwd_kernel`` and
``_bwd_kernel``. q, k and v stay in the tower's (B, H*W, C) token layout: window
(wy, wx) of a sample is the rows (wy*ws + r)*W + wx*ws + c, r, c < ws, which the
kernel gathers itself, and its outputs go back to the same rows, so neither
``window_partition`` nor ``window_reverse`` is ever written to memory. The window
uses bias ``bias[wy*nWx + wx]``, or ``bias[0]`` when the bias is shared. The
shifted-window roll stays outside, as ``torch.roll``, as in the JAX package.

``supports`` keeps the JAX gate's semantics (ws == 8, the map tiles by ws,
C % heads == 0, head width >= 8, C <= 1024); the TPU row-pairing bound it also
checks holds for every such shape. ``panel_attention`` is differentiable in q, k,
v and the bias; for CPU tensors, and only for them, it computes the plain versions
``panel_attention_reference`` and ``panel_attention_bwd_reference`` (partition,
the plain window attention, reverse). ``LAUNCHES`` counts the kernel launches.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import window_attention as wa

# launches of each kernel since the last reset; chip_smoke.py sets and reads them
LAUNCHES = {"fwd": 0, "bwd": 0}


def supports(h: int, w: int, ws: int, heads: int, c: int) -> bool:
    """Can the panel kernel serve this shape? (Dispatch gate; every batch is served.)"""
    if ws != 8 or h % ws or w % ws or heads < 1 or c % heads or c > wa.MAX_C:
        return False
    return c // heads >= 8


def partition(x: torch.Tensor, hw: Tuple[int, int], ws: int) -> torch.Tensor:
    """(B, H*W, C) token map -> (B*nW, ws*ws, C) windows, window-minor."""
    h, w = hw
    b, _, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, c)


def reverse(x: torch.Tensor, hw: Tuple[int, int], ws: int) -> torch.Tensor:
    """(B*nW, ws*ws, C) windows -> (B, H*W, C) token map."""
    h, w = hw
    c = x.shape[-1]
    x = x.reshape(-1, h // ws, w // ws, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, h * w, c)


def panel_attention_reference(q, k, v, bias, *, hw: Tuple[int, int], ws: int,
                              scale: Optional[float] = None) -> torch.Tensor:
    """Plain PyTorch version of the forward kernel: partition, the plain window
    attention, reverse."""
    part = lambda x: partition(x, hw, ws)  # noqa: E731
    out = wa.window_attention_reference(part(q), part(k), part(v), bias, scale=scale)
    return reverse(out, hw, ws)


def panel_attention_bwd_reference(q, k, v, bias, do, *, hw: Tuple[int, int], ws: int,
                                  scale: Optional[float] = None):
    """Plain PyTorch version of the backward kernels: (dq, dk, dv) in the token layout
    and dbias (nW, H, N, N) fp32."""
    part = lambda x: partition(x, hw, ws)  # noqa: E731
    dq, dk, dv, dbias = wa.window_attention_bwd_reference(part(q), part(k), part(v), bias,
                                                          part(do), scale=scale)
    return reverse(dq, hw, ws), reverse(dk, hw, ws), reverse(dv, hw, ws), dbias


def _geom(q: torch.Tensor, bias: torch.Tensor, hw: Tuple[int, int], ws: int):
    h, w = hw
    b, _, c = q.shape
    nwb, heads = bias.shape[:2]
    nwy, nwx = h // ws, w // ws
    return [b, nwy * nwx, ws * ws, heads, c // heads, nwb, ws, w, nwx]


def _check_cuda_call(q, bias, hw, ws) -> None:
    heads = bias.shape[1]
    wa.check_cuda_call(q, bias, ws * ws, heads)
    if not supports(hw[0], hw[1], ws, heads, q.shape[-1]):
        raise ValueError(f"panel attention: unsupported map {hw}, ws={ws}, heads={heads}, "
                         f"C={q.shape[-1]} (needs ws == 8 tiling the map, head width >= 8)")


def panel_attention_fwd(q, k, v, bias, *, hw: Tuple[int, int], ws: int,
                        scale: Optional[float] = None) -> torch.Tensor:
    """The forward kernel for CUDA tensors, or raise; the plain version for CPU tensors."""
    scale = wa._scale(q.shape[-1], bias.shape[1], scale)
    if q.device.type == "cpu":
        return panel_attention_reference(q, k, v, bias, hw=hw, ws=ws, scale=scale)
    _check_cuda_call(q, bias, hw, ws)
    return wa.launch_fwd(wa.PANEL, q, k, v, bias, _geom(q, bias, hw, ws), scale, LAUNCHES)


def panel_attention_bwd(q, k, v, bias, do, *, hw: Tuple[int, int], ws: int,
                        scale: Optional[float] = None):
    """(dq, dk, dv, dbias) of ``panel_attention``: the backward kernels for CUDA
    tensors, or raise; the plain version for CPU tensors."""
    scale = wa._scale(q.shape[-1], bias.shape[1], scale)
    if q.device.type == "cpu":
        return panel_attention_bwd_reference(q, k, v, bias, do, hw=hw, ws=ws, scale=scale)
    _check_cuda_call(q, bias, hw, ws)
    return wa.launch_bwd(wa.PANEL, q, k, v, bias, do, _geom(q, bias, hw, ws), scale, LAUNCHES)


class _PanelAttention(torch.autograd.Function):
    """Saves q, k, v and the bias; the backward recomputes the softmax."""

    @staticmethod
    def forward(ctx, q, k, v, bias, hw, ws: int, scale: float):
        ctx.save_for_backward(q, k, v, bias)
        ctx.hw, ctx.ws, ctx.scale = hw, ws, scale
        return panel_attention_fwd(q, k, v, bias, hw=hw, ws=ws, scale=scale)

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias = ctx.saved_tensors
        dq, dk, dv, dbias = panel_attention_bwd(q, k, v, bias, do, hw=ctx.hw, ws=ctx.ws,
                                                scale=ctx.scale)
        return dq, dk, dv, dbias.to(bias.dtype), None, None, None


def panel_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor, *,
                    hw: Tuple[int, int], ws: int, scale: Optional[float] = None) -> torch.Tensor:
    """Window attention over the un-partitioned (B, H*W, C) token map; window (wy, wx)
    attends within itself under ``bias[wy*nWx + wx]`` (or ``bias[0]`` when the bias
    is shared); returns (B, H*W, C) in token order. Differentiable in q, k, v, bias."""
    h, w = hw
    b, l, c = q.shape
    nwb, heads, n, _ = bias.shape
    if q.shape != k.shape or q.shape != v.shape or l != h * w or n != ws * ws:
        raise ValueError(f"panel attention: q/k/v {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)} and bias {tuple(bias.shape)} do not fit map {hw}, "
                         f"ws={ws}")
    if h % ws or w % ws or (nwb != 1 and nwb != (h // ws) * (w // ws)) or c % heads:
        raise ValueError(f"panel attention: map {hw} with ws={ws} and {nwb} bias windows")
    if q.device.type != "cpu":
        _check_cuda_call(q, bias, hw, ws)
    return _PanelAttention.apply(q, k, v, bias, (h, w), ws, wa._scale(c, heads, scale))
