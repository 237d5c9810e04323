"""Paired-retrieval metrics (counterpart of ``open_clip_tpu/train/metrics.py``), in numpy.

The rank of pair i is the number of logits in row i strictly greater than the true
logit plus the number of equal logits at an earlier index (ties break by index),
computed in row chunks of O(chunk x N) memory.
"""

from __future__ import annotations

from typing import Dict, Sequence, Union

import numpy as np


def _as_matrix(features: Union[np.ndarray, Sequence[np.ndarray]]) -> np.ndarray:
    if isinstance(features, (list, tuple)):
        return np.concatenate([np.asarray(f) for f in features], axis=0)
    return np.asarray(features)


def paired_retrieval_ranks(query: np.ndarray, gallery: np.ndarray, logit_scale: float = 1.0,
                           chunk_size: int = 1024) -> np.ndarray:
    """rank[i] of gallery item i for query i under logits = scale * q @ g.T
    (normalized (N, D) features, fp32)."""
    q = np.asarray(query, dtype=np.float32)
    g = np.asarray(gallery, dtype=np.float32)
    n = q.shape[0]
    ranks = np.zeros(n, dtype=np.int64)
    gt = g.T
    for start in range(0, n, chunk_size):
        end = min(start + chunk_size, n)
        logits = logit_scale * q[start:end] @ gt  # (c, N)
        idx = np.arange(start, end)
        true = logits[np.arange(end - start), idx]
        greater = (logits > true[:, None]).sum(axis=1)
        eq = logits == true[:, None]
        equal_before = np.array([eq[r, : idx[r]].sum() for r in range(end - start)], np.int64)
        ranks[start:end] = greater + equal_before
    return ranks


def get_clip_metrics(image_features, text_features, logit_scale: float = 1.0,
                     chunk_size: int = 1024) -> Dict[str, float]:
    """R@1/5/10 and the mean and median rank (1-based), both directions."""
    imf = _as_matrix(image_features)
    txf = _as_matrix(text_features)
    metrics: Dict[str, float] = {}
    for name, q, g in (("image_to_text", imf, txf), ("text_to_image", txf, imf)):
        ranks = paired_retrieval_ranks(q, g, logit_scale, chunk_size)
        metrics[f"{name}_mean_rank"] = float(ranks.mean() + 1)
        metrics[f"{name}_median_rank"] = float(np.floor(np.median(ranks)) + 1)
        for k in (1, 5, 10):
            metrics[f"{name}_R@{k}"] = float((ranks < k).mean())
    return metrics
