"""Contrastive losses (counterpart of ``open_clip_tpu/loss.py``).

``clip_loss`` is the symmetric InfoNCE of the JAX package's ``clip_loss``: fp32
features, ``scale * imf @ txf.T``, the mean cross-entropy of the logits both ways
against the diagonal. ``siglip_loss`` is its pairwise sigmoid loss (SigLIP):
``-log sigmoid(z * logit)`` summed over every (image, text) pair, z = +1 on the
diagonal and -1 elsewhere, divided by the batch; ``siglip_loss_chunked`` is the same
sum over a longer set of texts, taken in column chunks. ``caption_cross_entropy``
is CoCa's caption term and ``distill_kl`` the distillation term. ``create_loss``
(the JAX factory) returns the loss object of a run: ``CoCaLoss`` or
``DistillClipLoss``, both built on ``ClipLoss``, ``SigLipLoss``, or ``GenLipLoss``
(GenLIP's and GenLAP's caption loss from whole logits). All loss math runs
in float32 whatever the feature dtype.

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


def caption_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          pad_id: int = 0) -> torch.Tensor:
    """Token-level cross-entropy of (..., V) logits, in float32, over the positions
    whose label is not ``pad_id`` (the reference CoCaLoss's ``ignore_index``)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    mask = (labels != pad_id).float()
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)


def distill_kl(image_features: torch.Tensor, text_features: torch.Tensor,
               logit_scale: torch.Tensor, t_image_features: torch.Tensor,
               t_text_features: torch.Tensor, t_logit_scale: torch.Tensor, *,
               group=None) -> torch.Tensor:
    """The distillation term (the JAX train step's, and ``DistillClipLoss``'s): 0.5 (KL
    image->text + KL text->image) as cross-entropies of the student's log-softmax under
    the teacher's softmax, in float32. Scales are exp()ed. Across processes
    (``group``) this rank's rows meet every rank's columns, student and teacher alike."""
    group = _loss_group(1, group)
    imf, txf = image_features.float(), text_features.float()
    t_imf, t_txf = t_image_features.float(), t_text_features.float()
    s, ts = logit_scale.float(), t_logit_scale.float()
    s_i, s_t = s * imf @ gather_features(txf, group).T, s * txf @ gather_features(imf, group).T
    t_i, t_t = (ts * t_imf @ gather_features(t_txf, group).T,
                ts * t_txf @ gather_features(t_imf, group).T)
    return 0.5 * (_soft_cross_entropy(t_i, s_i) + _soft_cross_entropy(t_t, s_t))


def _soft_cross_entropy(teacher_logits: torch.Tensor, student_logits: torch.Tensor):
    """The mean over rows of -sum softmax(teacher) * log_softmax(student)."""
    return -(torch.softmax(teacher_logits, dim=-1)
             * torch.log_softmax(student_logits, dim=-1)).sum(-1).mean()


class ClipLoss:
    """The reference ``ClipLoss`` as a callable over ``clip_loss`` (``group`` in place
    of the rank and world-size arguments); the base of ``CoCaLoss`` and
    ``DistillClipLoss``."""

    def __init__(self, local_loss: bool = True, group=None, **_ignored):
        self.local_loss = local_loss
        self.group = group

    def __call__(self, image_features, text_features, logit_scale, output_dict: bool = False,
                 **_):
        loss = clip_loss(image_features, text_features, logit_scale, group=self.group,
                         local_loss=self.local_loss)
        return {"contrastive_loss": loss} if output_dict else loss


class SigLipLoss:
    """The reference ``SigLipLoss`` as a callable over ``siglip_loss`` (what
    ``create_loss`` returns with ``siglip``)."""

    def __init__(self, group=None, dist_impl: Optional[str] = None, **_ignored):
        self.group = group
        self.dist_impl = dist_impl or "bidir"

    def __call__(self, image_features, text_features, logit_scale, logit_bias=None,
                 output_dict: bool = False, **_):
        loss = siglip_loss(image_features, text_features, logit_scale, logit_bias,
                           group=self.group, dist_impl=self.dist_impl)
        return {"contrastive_loss": loss} if output_dict else loss


class CoCaLoss(ClipLoss):
    """Contrastive plus captioning cross-entropy (the JAX ``CoCaLoss``): each term
    times its weight; the caption term over (B, L, V) logits, pad labels left out."""

    def __init__(self, caption_loss_weight: float = 2.0, clip_loss_weight: float = 1.0,
                 pad_id: int = 0, **kw):
        super().__init__(**kw)
        self.caption_loss_weight = caption_loss_weight
        self.clip_loss_weight = clip_loss_weight
        self.pad_id = pad_id

    def __call__(self, image_features, text_features, logits, labels, logit_scale,
                 output_dict: bool = False, **_):
        if self.clip_loss_weight:
            closs = clip_loss(image_features, text_features, logit_scale, group=self.group,
                              local_loss=self.local_loss) * self.clip_loss_weight
        else:
            closs = logits.new_zeros((), dtype=torch.float32)
        caption = caption_cross_entropy(logits, labels, self.pad_id) * self.caption_loss_weight
        if output_dict:
            return {"contrastive_loss": closs, "caption_loss": caption}
        return closs, caption


class DistillClipLoss(ClipLoss):
    """Contrastive plus the KL distillation from a teacher's features (the JAX
    ``DistillClipLoss``): across processes the student's and the teacher's logits
    take every rank's columns."""

    def __call__(self, image_features, text_features, logit_scale, dist_image_features=None,
                 dist_text_features=None, dist_logit_scale=None, output_dict: bool = False,
                 **_):
        closs = clip_loss(image_features, text_features, logit_scale, group=self.group,
                          local_loss=self.local_loss)
        dloss = distill_kl(image_features, text_features, logit_scale, dist_image_features,
                           dist_text_features, dist_logit_scale, group=self.group)
        if output_dict:
            return {"contrastive_loss": closs, "distill_loss": dloss}
        return closs, dloss


class GenLipLoss:
    """GenLIP's caption loss from logits (the JAX ``GenLipLoss``): the mean
    next-token cross-entropy of already shifted (..., V) logits against their labels,
    float32, rows labelled ``ignore_index`` left out. Training takes the model's own
    fused form (``models/genlip.py:genlip_forward(compute_loss=True)``); this one
    reads whole logits."""

    def __init__(self, ignore_index: int = -100):
        self.ignore_index = ignore_index

    def __call__(self, logits: torch.Tensor, labels: torch.Tensor, output_dict: bool = False):
        logits = logits.reshape(-1, logits.shape[-1]).float()
        labels = labels.reshape(-1).long()
        keep = labels != self.ignore_index
        lp = torch.gather(torch.log_softmax(logits, dim=-1), 1, labels.clamp_min(0)[:, None])[:, 0]
        loss = -(lp * keep).sum() / keep.sum().clamp_min(1)
        return {"caption_loss": loss} if output_dict else loss


def create_loss(args):
    """The loss object a run trains with (the JAX ``create_loss``), chosen as the train
    step chooses its loss (``loss_type_for`` on the named model's config): distillation
    when ``distill`` is set, CoCa for a config with a multimodal decoder (the registry's
    ``coca_*``, JAX's rule by name), ``GenLipLoss`` for a GenLIP or GenLAP config
    (where the JAX rule by name falls to InfoNCE), the sigmoid loss with ``siglip``,
    else InfoNCE. ``args``: a namespace or dict with the CLI's names."""
    from .config import parse_model_cfg
    from .train.train_step import loss_type_for

    get = (args.get if isinstance(args, dict) else lambda k, d=None: getattr(args, k, d))
    group = get("group", None)
    loss_type = loss_type_for(parse_model_cfg(get("model")), distill=bool(get("distill", False)),
                              siglip=bool(get("siglip", False)))
    if loss_type == "distill":
        return DistillClipLoss(local_loss=get("local_loss", True), group=group)
    if loss_type == "coca":
        return CoCaLoss(caption_loss_weight=get("coca_caption_loss_weight", 2.0),
                        clip_loss_weight=get("coca_contrastive_loss_weight", 1.0),
                        local_loss=get("local_loss", True), group=group)
    if loss_type == "siglip":
        return SigLipLoss(group=group, dist_impl=get("loss_dist_impl", None))
    if loss_type in ("genlip", "genlap"):
        return GenLipLoss()
    return ClipLoss(local_loss=get("local_loss", True), group=group)
