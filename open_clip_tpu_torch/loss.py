"""Contrastive loss (counterpart of ``open_clip_tpu/loss.py``, single-process form).

``clip_loss`` is the symmetric InfoNCE of the JAX package's ``clip_loss`` with
``axis_name=None``: fp32 features, ``scale * imf @ txf.T``, the mean
cross-entropy of the logits both ways against the diagonal. All loss math runs
in float32 whatever the feature dtype. The gathered (multi-process) forms wait
for the port's ``parallel`` package.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def clip_loss(image_features: torch.Tensor, text_features: torch.Tensor,
              logit_scale: torch.Tensor, *, world_size: int = 1) -> torch.Tensor:
    """Symmetric InfoNCE over (B, D) unit features; ``logit_scale`` is already exp()ed."""
    if world_size > 1:
        raise NotImplementedError("the gathered clip_loss across processes is not ported yet")
    scale = logit_scale.float()
    imf = image_features.float()
    txf = text_features.float()
    logits_per_image = scale * imf @ txf.T
    labels = torch.arange(imf.shape[0], device=imf.device)
    return 0.5 * (F.cross_entropy(logits_per_image, labels)
                  + F.cross_entropy(logits_per_image.T, labels))
