"""Contrastive losses (counterpart of ``open_clip_tpu/loss.py``).

``clip_loss`` is the symmetric InfoNCE of the JAX package's ``clip_loss``: fp32
features, ``scale * imf @ txf.T``, the mean cross-entropy of the logits both ways
against the diagonal. ``siglip_loss`` is its pairwise sigmoid loss (SigLIP):
``-log sigmoid(z * logit)`` summed over every (image, text) pair, z = +1 on the
diagonal and -1 elsewhere, divided by the batch; ``siglip_loss_chunked`` is the same
sum over a longer set of texts, taken in column chunks. All loss math runs in
float32 whatever the feature dtype.

Across processes (``group``, or ``world_size > 1`` on the default group) each rank
passes its own rows and gets its own loss, the JAX function's value inside
``shard_map`` over the data axis: the mean of the ranks' losses is the loss of the
rank-ordered global batch, and a backward of each rank's loss over the number of
ranks gives each rank its rows of the global gradient. The collectives are autograd
functions: ``gather_features`` (a tiled all-gather whose backward sums the
cotangents over ranks and keeps this rank's rows, the transpose of
``lax.all_gather``), a neighbour exchange over ``batch_isend_irecv`` whose backward
sends the cotangent the other way (``lax.ppermute``'s transpose), and an all-reduce
whose backward all-reduces the cotangent (``lax.psum``'s).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F


def _loss_group(world_size: int, group):
    """The group a loss crosses, or None for the one-process form."""
    if group is None and world_size <= 1:
        return None
    if not dist.is_initialized():
        raise RuntimeError(f"a loss across {world_size} processes needs torch.distributed "
                           "initialised (parallel.distributed.init_distributed)")
    group = dist.group.WORLD if group is None else group
    if world_size > 1 and dist.get_world_size(group) != world_size:
        raise ValueError(f"world_size={world_size}, but the group has "
                         f"{dist.get_world_size(group)} processes")
    return group


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        n = dist.get_world_size(group)
        out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(out, x.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        n = dist.get_world_size(ctx.group)
        mine = grad.new_empty((grad.shape[0] // n,) + tuple(grad.shape[1:]))
        dist.reduce_scatter_tensor(mine, grad.contiguous(), group=ctx.group)
        return mine, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def _exchange(xs: Sequence[torch.Tensor], dsts: Sequence[int], srcs: Sequence[int],
              group) -> List[torch.Tensor]:
    """For each i, send xs[i] to group rank dsts[i] and receive a tensor of its shape
    from group rank srcs[i], all in flight together."""
    outs = [torch.empty_like(x) for x in xs]
    ops = []
    for x, out, dst, src in zip(xs, outs, dsts, srcs):
        ops.append(dist.P2POp(dist.isend, x.contiguous(), dist.get_global_rank(group, dst), group))
        ops.append(dist.P2POp(dist.irecv, out, dist.get_global_rank(group, src), group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return outs


class _NeighbourExchange(torch.autograd.Function):
    """Tensor i goes to the rank ``shifts[i]`` ahead on the ring and the tensor from
    the rank ``shifts[i]`` behind comes back; the backward sends each cotangent the
    other way round."""

    @staticmethod
    def forward(ctx, group, shifts, *xs):
        ctx.group, ctx.shifts = group, shifts
        rank, n = dist.get_rank(group), dist.get_world_size(group)
        return tuple(_exchange(xs, [(rank + s) % n for s in shifts],
                               [(rank - s) % n for s in shifts], group))

    @staticmethod
    def backward(ctx, *grads):
        rank, n = dist.get_rank(ctx.group), dist.get_world_size(ctx.group)
        back = _exchange(grads, [(rank - s) % n for s in ctx.shifts],
                         [(rank + s) % n for s in ctx.shifts], ctx.group)
        return (None, None, *back)


def gather_features(features: torch.Tensor, group) -> torch.Tensor:
    """Every rank's rows of ``group``, in rank order (differentiable). None: identity."""
    return features if group is None else _AllGather.apply(features, group)


def clip_loss(image_features: torch.Tensor, text_features: torch.Tensor,
              logit_scale: torch.Tensor, *, world_size: int = 1, group=None,
              local_loss: bool = True) -> torch.Tensor:
    """Symmetric InfoNCE over (B, D) unit features; ``logit_scale`` is already exp()ed.
    Across processes the negatives are every rank's features: with ``local_loss``
    this rank's rows against all columns (labels ``arange(B) + rank * B``), without
    it the whole (B·W, B·W) loss on every rank."""
    group = _loss_group(world_size, group)
    scale = logit_scale.float()
    imf = image_features.float()
    txf = text_features.float()
    if group is None:
        logits_per_image = scale * imf @ txf.T
        labels = torch.arange(imf.shape[0], device=imf.device)
        return 0.5 * (F.cross_entropy(logits_per_image, labels)
                      + F.cross_entropy(logits_per_image.T, labels))
    all_im = gather_features(imf, group)
    all_tx = gather_features(txf, group)
    b = imf.shape[0]
    if local_loss:
        logits_per_image = scale * imf @ all_tx.T
        logits_per_text = scale * txf @ all_im.T
        labels = torch.arange(b, device=imf.device) + dist.get_rank(group) * b
    else:
        logits_per_image = scale * all_im @ all_tx.T
        logits_per_text = logits_per_image.T
        labels = torch.arange(all_im.shape[0], device=imf.device)
    return 0.5 * (F.cross_entropy(logits_per_image, labels)
                  + F.cross_entropy(logits_per_text, labels))


def _sigmoid_pair_sum(imf: torch.Tensor, txf: torch.Tensor, scale: torch.Tensor,
                      bias: Optional[torch.Tensor], first_col: Optional[int],
                      diag_offset: int = 0) -> torch.Tensor:
    """Sum of -log sigmoid(z * logit) over the pairs of imf's rows and txf's rows, txf
    being the columns from ``first_col`` on; z = +1 where column == row + diag_offset,
    and -1 at every pair when ``first_col`` is None (a block of negatives only)."""
    logits = scale * imf @ txf.T
    if bias is not None:
        logits = logits + bias
    if first_col is None:
        return -F.logsigmoid(-logits).sum()
    rows = torch.arange(imf.shape[0], device=imf.device)
    cols = torch.arange(first_col, first_col + txf.shape[0], device=imf.device)
    z = torch.where(cols[None, :] == (rows + diag_offset)[:, None], 1.0, -1.0)
    return -F.logsigmoid(z * logits).sum()


SIGLIP_DIST_IMPLS = ("bidir", "shift", "gather", "reduce")


def siglip_loss(image_features: torch.Tensor, text_features: torch.Tensor,
                logit_scale: torch.Tensor, logit_bias: Optional[torch.Tensor] = None, *,
                world_size: int = 1, group=None, dist_impl: str = "bidir") -> torch.Tensor:
    """Pairwise sigmoid loss over (B, D) features, normalised by this rank's batch;
    ``logit_scale`` is already exp()ed, ``logit_bias`` is added to every logit.

    Across processes this rank's images meet every rank's texts, as the JAX
    function's ``dist_impl`` says: "gather" all-gathers the texts into one (B, B·W)
    block; "shift" passes the texts W - 1 times one rank along a ring; "bidir" passes
    them both ways at once, (W - 1) // 2 times, and one more step one way when W is
    even (with two ranks it is "shift"); "reduce" broadcasts each rank's texts in
    turn by an all-reduce of them masked to that rank. The blocks are summed in the
    JAX function's order."""
    if dist_impl not in SIGLIP_DIST_IMPLS:
        raise ValueError(f"unknown siglip dist_impl {dist_impl!r}")
    group = _loss_group(world_size, group)
    b = image_features.shape[0]
    imf, txf = image_features.float(), text_features.float()
    scale = logit_scale.float()
    bias = None if logit_bias is None else logit_bias.float()
    if group is None:
        return _sigmoid_pair_sum(imf, txf, scale, bias, 0) / b
    rank, n = dist.get_rank(group), dist.get_world_size(group)
    if dist_impl == "gather":
        return _sigmoid_pair_sum(imf, gather_features(txf, group), scale, bias, 0,
                                 rank * b) / b
    loss = _sigmoid_pair_sum(imf, txf, scale, bias, 0)
    if dist_impl == "reduce":
        for i in range(n):
            # masked by a select from txf, not a tensor of zeros: every rank's all-reduce
            # then stays in the graph, so every rank takes part in each all-reduce of
            # the backward, in the same order
            keep = torch.tensor(rank == i, device=txf.device)
            text_from_i = _AllReduce.apply(torch.where(keep, txf, torch.zeros_like(txf)), group)
            mask = float(rank != i)  # this rank's own block: in the graph, weighted 0
            loss = loss + mask * _sigmoid_pair_sum(imf, text_from_i, scale, bias, None)
    elif dist_impl == "shift" or n == 2:
        neigh = txf
        for _ in range(n - 1):
            (neigh,) = _NeighbourExchange.apply(group, (1,), neigh)
            loss = loss + _sigmoid_pair_sum(imf, neigh, scale, bias, None)
    else:
        steps, odd = (n - 1) // 2, (n - 1) % 2
        right = left = txf
        for _ in range(steps):
            right, left = _NeighbourExchange.apply(group, (1, -1), right, left)
            loss = loss + _sigmoid_pair_sum(imf, right, scale, bias, None)
            loss = loss + _sigmoid_pair_sum(imf, left, scale, bias, None)
        if odd:
            (right,) = _NeighbourExchange.apply(group, (1,), right)
            loss = loss + _sigmoid_pair_sum(imf, right, scale, bias, None)
    return loss / b


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
