"""Checkpoints (counterpart of ``open_clip_tpu/checkpoint.py``).

Reference weights: ``read_state_dict`` reads a ``.pt``/``.bin`` (``torch.load``), a
``.safetensors`` (the port's own reader) or an ``.npz`` (a flat state dict) into
name -> tensor or array; ``load_checkpoint`` converts it into the JAX package's
param tree (``convert.torch_clip_to_params``, or the CLAP converters) and
``merge_params_`` carries that tree through ``params_from_jax`` into the model with
the JAX package's ``merge_params`` rules: a key the model has and the file lacks
raises ``KeyError`` (``logit_bias`` excepted), a key the model lacks raises under
``strict`` and is dropped with a warning otherwise, a position embedding of another
length is resized (``ops/pos_embed.py``), a logit scale or bias of another rank is
reshaped, and any other shape that differs raises ``ValueError``. Loaded values
take the dtype of the model's own.

Train state (``save_native``/``load_native``): one ``torch.save`` file holding the
model's state dict, the optimizer's state, the step and the epoch. A file is written
under a temporary name and renamed, so a reader never sees half of one.

Under FSDP2 the file holds whole tensors all the same: saving gathers each sharded
parameter and moment (every rank takes part) and the primary writes; loading reads
the whole file on every rank and keeps each rank's shards. A file written by one
process loads under a mesh and back.
"""

from __future__ import annotations

import logging
import os
import re
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from .convert import params_from_jax, torch_clip_to_params
from .ops.pos_embed import resize_text_pos_embed, resize_vision_pos_embed
from .parallel.distributed import is_primary
from .parallel.mesh import full_tensor, is_sharded, local_tensor
from .train.train_step import TrainState


logger = logging.getLogger(__name__)


def read_state_dict(path) -> Dict[str, Any]:
    """A reference checkpoint file -> name -> tensor (``.pt``, ``.bin``,
    ``.safetensors``) or array (``.npz``, read as a flat state dict). A ``.pt``
    that wraps its weights under ``state_dict`` or ``model`` is unwrapped."""
    path = str(path)
    if path.endswith(".safetensors"):
        from ._safetensors import load_file

        return load_file(path)
    if path.endswith(".npz"):
        with np.load(path) as f:
            return dict(f)
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(ckpt, dict) and "state_dict" in ckpt:
        ckpt = ckpt["state_dict"]
    elif isinstance(ckpt, dict) and isinstance(ckpt.get("model"), dict):
        ckpt = ckpt["model"]
    return dict(ckpt)


def checkpoint_to_params(sd: Dict[str, Any], cfg) -> Dict[str, Any]:
    """A reference state dict -> the JAX package's param tree for ``cfg``: a CLAP
    model's through the CLAP converters (transformers' ``ClapModel`` keys told
    apart by ``audio_model.``/``audio_projection.``), any other through
    ``torch_clip_to_params``. The keys it could not place are dropped (logged)."""
    if cfg.audio_cfg is not None:
        from .models.clap import hf_clap_to_params, torch_clap_to_params

        if any(k.removeprefix("module.").startswith(("audio_model.", "audio_projection."))
               for k in sd):
            tree = hf_clap_to_params(sd, cfg)
        else:
            tree = torch_clap_to_params(sd, cfg)
    else:
        tree = torch_clip_to_params(sd, cfg)
    tree.pop("_unconverted", None)
    return tree


def _reconcile(name: str, cur: torch.Tensor, val: torch.Tensor, cfg) -> torch.Tensor:
    """``val`` brought to ``cur``'s shape where the JAX package's ``_reconcile`` does."""
    if name == "visual.positional_embedding":
        num_prefix = 1 if cfg.vision_cfg.class_token else 0
        old_side = int(round(np.sqrt(val.shape[0] - num_prefix)))
        logger.info("resizing %s %s -> %s", name, tuple(val.shape), tuple(cur.shape))
        return resize_vision_pos_embed(val, cfg.vision_cfg.grid_size, (old_side, old_side),
                                       num_prefix=num_prefix)
    if name == "positional_embedding":  # the text tower's
        logger.info("resizing %s %s -> %s", name, tuple(val.shape), tuple(cur.shape))
        return resize_text_pos_embed(val, cur.shape[0])
    if name in ("logit_scale", "logit_bias") and val.ndim != cur.ndim:
        return val.reshape(cur.shape)
    raise ValueError(f"shape mismatch for {name}: checkpoint {tuple(val.shape)} vs model "
                     f"{tuple(cur.shape)}")


def _report(kind: str, names, strict: bool) -> None:
    if not names:
        return
    msg = f"{kind}: {names[:10]}{'...' if len(names) > 10 else ''}"
    if strict:
        raise KeyError(msg)
    logger.warning(msg)


@torch.no_grad()
def merge_params_(model, tree: Dict[str, Any], strict: bool = True):
    """Load a JAX-layout param ``tree`` into ``model`` in place, by the JAX package's
    ``merge_params`` rules (see the module's docstring); returns the model. An empty
    subtree holds no weights and is not counted as unexpected: the text converter
    leaves an empty ``visual`` in every CLAP tree, which makes the JAX package's
    strict load of a CLAP checkpoint raise (ROADMAP, the reference's faults)."""
    tree = {k: v for k, v in tree.items() if not (isinstance(v, dict) and not v)}
    loaded = params_from_jax(tree, model.cfg)
    own = model.state_dict()
    missing = [k for k in own if k not in loaded and k != "logit_bias"] if strict else []
    unexpected = [k for k in loaded if k not in own]
    _report("missing keys when loading checkpoint", missing, strict)
    _report("unexpected checkpoint keys dropped", unexpected, strict)
    for name, cur in own.items():
        if name not in loaded:
            continue
        val = loaded[name]
        if val.shape != cur.shape:
            val = _reconcile(name, cur, val, model.cfg)
        cur.copy_(val.to(cur.dtype))
    return model


def load_checkpoint(model, path, strict: bool = True):
    """Load the reference checkpoint at ``path`` into ``model`` in place; returns it."""
    return merge_params_(model, checkpoint_to_params(read_state_dict(path), model.cfg), strict)


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
