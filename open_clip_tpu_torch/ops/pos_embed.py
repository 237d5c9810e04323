"""Resizing learned position embeddings (counterpart of ``resize_vision_pos_embed``
and ``resize_text_pos_embed`` in ``open_clip_tpu/ops/pos_embed.py``).

The JAX package resizes with ``jax.image.resize``, which is not what
``F.interpolate`` computes: its bicubic is Keys' cubic with a = -0.5 (PyTorch's is
a = -0.75), it renormalises the kernel's weights where the kernel runs past an edge
(PyTorch clamps the source index), and with ``antialias`` a grid that shrinks widens
the kernel by the ratio of the sizes. Here each axis is one weight matrix built in
float64 numpy with those rules (``scale_and_translate`` at translation 0) and applied
by a matrix product.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    x = np.abs(x)
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


def _triangle(x: np.ndarray) -> np.ndarray:
    return np.maximum(0.0, 1.0 - np.abs(x))


_KERNELS = {"bicubic": _keys_cubic, "cubic": _keys_cubic, "linear": _triangle,
            "bilinear": _triangle}


def resize_matrix(in_size: int, out_size: int, method: str = "bicubic",
                  antialias: bool = True) -> np.ndarray:
    """(out_size, in_size) float64 weights of ``jax.image.resize`` along one axis."""
    if method not in _KERNELS:
        raise NotImplementedError(f"resize method {method!r}; one of {sorted(_KERNELS)}")
    # the sample positions in float32, as JAX computes them on the CPU: the scale
    # rounded to float32, then (i + 0.5) * scale - 0.5 fused into one rounding (XLA
    # contracts it to a fused multiply-add); the rest in float64
    inv_scale = np.float32(1.0 / (out_size / in_size))
    kernel_scale = max(float(inv_scale), 1.0) if antialias else 1.0
    exact = (np.arange(out_size, dtype=np.float64) + 0.5) * np.float64(inv_scale) - 0.5
    sample = exact.astype(np.float32).astype(np.float64)
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=np.float64)[:, None]) / kernel_scale
    w = _KERNELS[method](x)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0.0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, 0.0).T


def resize_vision_pos_embed(pos_embed: torch.Tensor, new_grid: Tuple[int, int],
                            old_grid: Tuple[int, int], num_prefix: int = 1,
                            method: str = "bicubic", antialias: bool = True) -> torch.Tensor:
    """(num_prefix + old_h * old_w, D) -> (num_prefix + new_h * new_w, D): the
    spatial rows resized on their grid, the prefix rows (class token) kept."""
    old_grid, new_grid = tuple(old_grid), tuple(new_grid)
    if old_grid == new_grid:
        return pos_embed
    prefix, spatial = pos_embed[:num_prefix], pos_embed[num_prefix:]
    d = spatial.shape[-1]
    grid = spatial.to(torch.float64).reshape(old_grid[0], old_grid[1], d)
    rows = torch.from_numpy(resize_matrix(old_grid[0], new_grid[0], method, antialias))
    cols = torch.from_numpy(resize_matrix(old_grid[1], new_grid[1], method, antialias))
    grid = torch.einsum("Hh,hwd,Ww->HWd", rows, grid, cols)
    spatial = grid.reshape(new_grid[0] * new_grid[1], d).to(pos_embed.dtype)
    return torch.cat([prefix, spatial], dim=0)


def resize_text_pos_embed(pos_embed: torch.Tensor, new_len: int,
                          method: str = "linear") -> torch.Tensor:
    """(old_len, D) -> (new_len, D), ``jax.image.resize`` without antialiasing."""
    if pos_embed.shape[0] == new_len:
        return pos_embed
    w = torch.from_numpy(resize_matrix(pos_embed.shape[0], new_len, method, antialias=False))
    return (w @ pos_embed.to(torch.float64)).to(pos_embed.dtype)
