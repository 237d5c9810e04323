"""Checkpoints of the train state (counterpart of ``save_native``/``load_native`` in
``open_clip_tpu/checkpoint.py``): one ``torch.save`` file holding the model's
state dict, the optimizer's state, the step and the epoch. A file is written
under a temporary name and renamed, so a reader never sees half of one.
"""

from __future__ import annotations

import os
import re
from pathlib import Path
from typing import Optional

import torch

from .train.train_step import TrainState


def save_native(path, state: TrainState, epoch: int) -> None:
    """Write ``state`` to ``path`` (tensors are saved from the CPU)."""
    path = Path(path)
    cpu = lambda ts: [t.detach().cpu() for t in ts]
    payload = {
        "step": state.step,
        "epoch": epoch,
        "model": {k: v.detach().cpu() for k, v in state.model.state_dict().items()},
        "optimizer": {"count": state.opt_state["count"], "mu": cpu(state.opt_state["mu"]),
                      "nu": cpu(state.opt_state["nu"])},
    }
    tmp = path.with_name(path.name + ".tmp")
    torch.save(payload, tmp)
    os.replace(tmp, path)


def load_native(path, like: TrainState) -> int:
    """Load the checkpoint at ``path`` into ``like`` in place (its model and optimizer
    state keep their devices and dtypes); returns the epoch the checkpoint closed."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    like.model.load_state_dict(payload["model"], strict=True)
    opt = payload["optimizer"]
    for key in ("mu", "nu"):
        if len(opt[key]) != len(like.opt_state[key]):
            raise ValueError(f"checkpoint holds {len(opt[key])} optimizer tensors, "
                             f"the model has {len(like.opt_state[key])}")
        with torch.no_grad():
            for mine, saved in zip(like.opt_state[key], opt[key]):
                mine.copy_(saved)
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
