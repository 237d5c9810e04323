"""Device mesh and parameter sharding (counterpart of ``open_clip_tpu/parallel/mesh.py``).

One ``DeviceMesh`` with the JAX package's named axes over the processes of the
group, one device each:

    data  — replicas of the parameters (the JAX mesh's batch axis)
    fsdp  — parameter shards (FSDP/ZeRO-3)

``shard_model`` puts the model under FSDP2 (``fully_shard`` on the 2-D mesh:
replicated over ``data``, sharded over ``fsdp``), which all-gathers a block's
parameters before its forward and backward and reduce-scatters its gradients. The
layout differs from XLA's (FSDP2 cuts dim 0, padding the last shard), the numbers
do not.

Every rank of the mesh feeds its own rows: the global batch is the rank-ordered
concatenation of the ranks' batches, split over ``data`` and ``fsdp`` alike (XLA
splits it over ``data``; the loss and its gradient are the same for either split).
So a train step under a mesh of more than one rank gathers the loss over all of
them, and averages every gradient over all of them.
"""

from __future__ import annotations

import sys
from typing import Dict, Iterable, List

import torch
import torch.distributed as dist
from torch import nn

DATA_AXIS = "data"
FSDP_AXIS = "fsdp"
# leaves smaller than this stay replicated (the JAX package's ``_choose_fsdp_spec``)
MIN_SHARD_SIZE = 2 ** 16


def create_mesh(data: int = -1, fsdp: int = 1, tensor: int = 1, *, device: str = "cuda"):
    """A (data, fsdp) ``DeviceMesh`` over every process of the default group;
    ``data=-1`` takes what ``fsdp`` leaves. ``device`` is "cuda" (NCCL) or "cpu"
    (gloo). Tensor parallelism (``tensor > 1``) raises."""
    from torch.distributed.device_mesh import init_device_mesh

    if tensor != 1:
        raise NotImplementedError("tensor parallelism is not ported yet (--mesh-tensor 1)")
    if not dist.is_initialized():
        raise RuntimeError("create_mesh needs a process group: call "
                           "parallel.distributed.init_distributed first")
    n = dist.get_world_size()
    if data == -1:
        if n % fsdp:
            raise ValueError(f"{n} processes do not split into fsdp={fsdp}")
        data = n // fsdp
    if data * fsdp != n:
        raise ValueError(f"mesh {data}x{fsdp} != {n} processes")
    return init_device_mesh(torch.device(device).type, (data, fsdp),
                            mesh_dim_names=(DATA_AXIS, FSDP_AXIS))


def _dtensor_type():
    """``DTensor``, or None while ``torch.distributed.tensor`` was never imported (then
    no tensor is one; importing it costs a second that a one-process run need not pay)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return None if mod is None else mod.DTensor


def is_sharded(t: torch.Tensor) -> bool:
    cls = _dtensor_type()
    return cls is not None and isinstance(t, cls)


def local_tensor(t: torch.Tensor) -> torch.Tensor:
    """The local shard of a sharded tensor (a view: writes reach the parameter), else ``t``."""
    return t.to_local() if is_sharded(t) else t


def full_tensor(t: torch.Tensor) -> torch.Tensor:
    """The whole of a sharded tensor (a collective: every rank calls it), else ``t``."""
    return t.full_tensor() if is_sharded(t) else t


def shard_model(model: nn.Module, mesh, *, min_size: int = MIN_SHARD_SIZE) -> nn.Module:
    """Put ``model`` under FSDP2 on ``mesh`` in place and return it: ``fully_shard``
    per residual block, per tower (the image tower; the text tower's block stack)
    and at the root. Every rank must hold the same parameters (the same seed).

    Parameters of fewer than ``min_size`` elements, the 0-dim ``logit_scale`` and
    ``logit_bias`` among them, stay whole on every rank (FSDP2 ignores them): a train
    step averages their gradients over the mesh itself (``sync_replicated_grads``).
    The model must be called as ``model(image, text, ...)`` so that the root's hooks
    run; the train step does."""
    from torch.distributed.fsdp import fully_shard

    from ..models.blocks import ResidualAttentionBlock
    from ..models.vit import VisionTransformer

    # the ViT and text towers read their blocks' parameters only inside the blocks'
    # forwards, which FSDP2's hooks need; the other towers are not checked yet
    if getattr(model.cfg, "audio_cfg", None) is not None or not isinstance(
            getattr(model, "visual", None), VisionTransformer):
        raise NotImplementedError("training under a mesh is ported for the ViT towers only "
                                  "(not yet NaFlex, Swin, ModifiedResNet, ConvNeXt, EVA, ViTamin or "
                                  "CLAP)")
    ignored = {p for p in model.parameters() if p.ndim == 0 or p.numel() < min_size}
    for block in [m for m in model.modules() if isinstance(m, ResidualAttentionBlock)]:
        fully_shard(block, mesh=mesh, ignored_params=ignored)
    for tower in (model.visual, model.transformer):
        fully_shard(tower, mesh=mesh, ignored_params=ignored)
    fully_shard(model, mesh=mesh, ignored_params=ignored)
    return model


def sync_replicated_grads(params: Iterable[torch.Tensor], group=None) -> None:
    """Average over the processes of ``group`` (the default group) the gradients of
    the parameters FSDP2 left whole, in place: one all-reduce per dtype."""
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for p in params:
        if p.grad is not None and not is_sharded(p):
            by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    n = dist.get_world_size(group)
    for grads in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=group)
        flat.div_(n)
        torch._foreach_copy_(grads, [f.view_as(g) for f, g in
                                     zip(flat.split([g.numel() for g in grads]), grads)])


def shard_batch(batch, mesh):
    """This rank's rows of a global batch (a tensor or a dict of them, the same on
    every rank): the split by rank that makes the global batch the concatenation of
    the mesh's ranks' batches."""
    if isinstance(batch, dict):
        return {k: shard_batch(v, mesh) for k, v in batch.items()}
    n, size = batch.shape[0], mesh.size()
    if n % size:
        raise ValueError(f"a global batch of {n} does not split over {size} ranks")
    per = n // size
    return batch[mesh.get_rank() * per:(mesh.get_rank() + 1) * per]
