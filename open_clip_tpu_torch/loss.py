"""Contrastive losses (counterpart of ``open_clip_tpu/loss.py``, single-process forms).

``clip_loss`` is the symmetric InfoNCE of the JAX package's ``clip_loss`` with
``axis_name=None``: fp32 features, ``scale * imf @ txf.T``, the mean
cross-entropy of the logits both ways against the diagonal. ``siglip_loss`` is
its pairwise sigmoid loss with ``axis_name=None`` (SigLIP): ``-log sigmoid(z *
logit)`` summed over every (image, text) pair, z = +1 on the diagonal and -1
elsewhere, divided by the batch; ``siglip_loss_chunked`` is the same sum over a
longer set of texts, taken in column chunks. All loss math runs in float32
whatever the feature dtype. The gathered (multi-process) forms wait for the
port's ``parallel`` package.
"""

from __future__ import annotations

from typing import Optional

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


def _sigmoid_pair_sum(imf: torch.Tensor, txf: torch.Tensor, scale: torch.Tensor,
                      bias: Optional[torch.Tensor], first_col: int,
                      diag_offset: int) -> torch.Tensor:
    """Sum of -log sigmoid(z * logit) over the pairs of imf's rows and txf's rows, txf
    being the columns from ``first_col`` on; z = +1 where column == row + diag_offset."""
    logits = scale * imf @ txf.T
    if bias is not None:
        logits = logits + bias
    rows = torch.arange(imf.shape[0], device=imf.device)
    cols = torch.arange(first_col, first_col + txf.shape[0], device=imf.device)
    z = torch.where(cols[None, :] == (rows + diag_offset)[:, None], 1.0, -1.0)
    return -F.logsigmoid(z * logits).sum()


def siglip_loss(image_features: torch.Tensor, text_features: torch.Tensor,
                logit_scale: torch.Tensor, logit_bias: Optional[torch.Tensor] = None, *,
                world_size: int = 1) -> torch.Tensor:
    """Pairwise sigmoid loss over (B, D) features, normalised by the batch;
    ``logit_scale`` is already exp()ed, ``logit_bias`` is added to every logit."""
    if world_size > 1:
        raise NotImplementedError("the siglip loss across processes is not ported yet")
    bias = None if logit_bias is None else logit_bias.float()
    return _sigmoid_pair_sum(image_features.float(), text_features.float(), logit_scale.float(),
                             bias, 0, 0) / image_features.shape[0]


def siglip_loss_chunked(image_features: torch.Tensor, text_features: torch.Tensor,
                        logit_scale: torch.Tensor, logit_bias: Optional[torch.Tensor], *,
                        diag_offset: int = 0, chunk_size: int = 1024) -> torch.Tensor:
    """The sigmoid loss of (B, D) images against (N, D) texts (a negative set already
    at hand), the positive pair of row i at column i + ``diag_offset``; the logits
    are made ``chunk_size`` columns at a time, so memory is O(B x chunk). The JAX
    function pads the last chunk to the chunk size and masks the padding out; here
    the last chunk is shorter, which sums the same terms."""
    imf, txf = image_features.float(), text_features.float()
    scale = logit_scale.float()
    bias = None if logit_bias is None else logit_bias.float()
    total = imf.new_zeros(())
    for c0 in range(0, txf.shape[0], chunk_size):
        total = total + _sigmoid_pair_sum(imf, txf[c0:c0 + chunk_size], scale, bias, c0,
                                          diag_offset)
    return total / imf.shape[0]
