"""Checkpoints of the train state (counterpart of ``save_native``/``load_native`` in
``open_clip_tpu/checkpoint.py``): one ``torch.save`` file holding the model's
state dict, the optimizer's state, the step and the epoch. A file is written
under a temporary name and renamed, so a reader never sees half of one.

Under FSDP2 the file holds whole tensors all the same: saving gathers each sharded
parameter and moment (every rank takes part) and the primary writes; loading reads
the whole file on every rank and keeps each rank's shards. A file written by one
process loads under a mesh and back.
"""

from __future__ import annotations

import os
import re
from pathlib import Path
from typing import Optional

import torch

from .parallel.distributed import is_primary
from .parallel.mesh import full_tensor, is_sharded, local_tensor
from .train.train_step import TrainState


def _is_sharded_model(model) -> bool:
    return any(is_sharded(p) for p in model.parameters())


def save_native(path, state: TrainState, epoch: int) -> None:
    """Write ``state`` to ``path`` (tensors are saved from the CPU). Under a mesh every
    rank calls it and the primary writes."""
    model = state.model
    if _is_sharded_model(model):
        from torch.distributed.checkpoint.state_dict import (StateDictOptions,
                                                             get_model_state_dict)

        weights = get_model_state_dict(
            model, options=StateDictOptions(full_state_dict=True, cpu_offload=True))
    else:
        weights = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    moments = {k: [full_tensor(t).detach().cpu() for t in state.opt_state[k]]
               for k in ("mu", "nu")}
    if not is_primary():
        return
    payload = {"step": state.step, "epoch": epoch, "model": weights,
               "optimizer": {"count": state.opt_state["count"], **moments}}
    path = Path(path)
    tmp = path.with_name(path.name + ".tmp")
    torch.save(payload, tmp)
    os.replace(tmp, path)


def _load_moment_(mine: torch.Tensor, saved: torch.Tensor) -> None:
    """Copy a whole saved tensor into ``mine``, keeping only this rank's shard of it
    where ``mine`` is sharded (no communication: every rank read the same file)."""
    if is_sharded(mine):
        from torch.distributed.tensor import distribute_tensor

        saved = distribute_tensor(saved.to(mine.device, mine.dtype), mine.device_mesh,
                                  mine.placements, src_data_rank=None)
    local_tensor(mine).copy_(local_tensor(saved))


def load_native(path, like: TrainState) -> int:
    """Load the checkpoint at ``path`` into ``like`` in place (its model and optimizer
    state keep their devices, dtypes and sharding); returns the epoch the checkpoint
    closed. Under a mesh every rank calls it."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    if _is_sharded_model(like.model):
        from torch.distributed.checkpoint.state_dict import (StateDictOptions,
                                                             set_model_state_dict)

        set_model_state_dict(like.model, payload["model"],
                             options=StateDictOptions(full_state_dict=True))
    else:
        like.model.load_state_dict(payload["model"], strict=True)
    opt = payload["optimizer"]
    for key in ("mu", "nu"):
        if len(opt[key]) != len(like.opt_state[key]):
            raise ValueError(f"checkpoint holds {len(opt[key])} optimizer tensors, "
                             f"the model has {len(like.opt_state[key])}")
        with torch.no_grad():
            for mine, saved in zip(like.opt_state[key], opt[key]):
                _load_moment_(mine, saved)
    like.opt_state["count"] = int(opt["count"])
    like.step = int(payload["step"])
    return int(payload["epoch"])


def get_latest_checkpoint(ckpt_dir) -> Optional[str]:
    """The ``epoch_N.pt`` with the highest N in ``ckpt_dir``, or None."""
    found = []
    for p in Path(ckpt_dir).glob("epoch_*.pt"):
        m = re.fullmatch(r"epoch_(\d+)\.pt", p.name)
        if m:
            found.append((int(m.group(1)), p))
    return str(max(found)[1]) if found else None
