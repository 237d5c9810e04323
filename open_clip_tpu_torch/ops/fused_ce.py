"""Chunked linear + cross-entropy (counterpart of ``open_clip_tpu/ops/fused_ce.py``).

``CE(hidden @ weight.T + bias, labels)`` without the whole (N, V) logit matrix: the
rows go in chunks, each chunk's logits and log-softmax in float32 under
``torch.utils.checkpoint``, so the backward recomputes a chunk's logits instead of
keeping them. At CoCa's b256 x 75 positions x 49408 tokens the whole matrix would be
3.8 GB in float32; a chunk of 4096 rows is 0.8 GB. Plain PyTorch, as the JAX
function is a ``lax.scan`` under ``jax.checkpoint`` there, not a Pallas kernel.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from .layers import linear


def _chunk_loss(h: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
                labels: torch.Tensor, ignore_index: int,
                label_smoothing: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum of the chunk's per-row losses over its kept rows, count of kept rows)."""
    logits = linear(h, weight, transposed=True).float()
    if bias is not None:
        logits = logits + bias.float()
    logp = torch.log_softmax(logits, dim=-1)
    keep = labels != ignore_index
    nll = -torch.gather(logp, 1, torch.where(keep, labels, 0)[:, None])[:, 0]
    if label_smoothing > 0.0:
        nll = (1 - label_smoothing) * nll + label_smoothing * -logp.mean(dim=-1)
    mask = keep.float()
    return (nll * mask).sum(), mask.sum()


def fused_linear_cross_entropy(hidden: torch.Tensor, weight: torch.Tensor,
                               labels: torch.Tensor, bias: Optional[torch.Tensor] = None, *,
                               ignore_index: int = -100, chunk_size: int = 4096,
                               label_smoothing: float = 0.0) -> torch.Tensor:
    """Mean cross-entropy over the rows whose label is not ``ignore_index``: ``hidden``
    (N, D), ``weight`` (V, D) in ``nn.Linear``'s layout, ``labels`` (N,), ``bias`` (V,).
    The product runs in ``hidden``'s dtype, the softmax in float32. The chunk is
    capped at N rounded up to 128, as in the JAX function (whose padding rows are
    ignored labels; here the last chunk is shorter)."""
    n = hidden.shape[0]
    chunk_size = min(chunk_size, max(128, (n + 127) // 128 * 128))
    total = hidden.new_zeros((), dtype=torch.float32)
    count = hidden.new_zeros((), dtype=torch.float32)
    for start in range(0, n, chunk_size):
        args = (hidden[start:start + chunk_size], weight, bias,
                labels[start:start + chunk_size], ignore_index, label_smoothing)
        if torch.is_grad_enabled():
            s, c = checkpoint(_chunk_loss, *args, use_reentrant=False)
        else:
            s, c = _chunk_loss(*args)
        total, count = total + s, count + c
    return total / count.clamp_min(1.0)
