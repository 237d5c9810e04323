"""Training CLI: ``python -m open_clip_tpu_torch.train.main <flags>`` (counterpart of
``open_clip_tpu/train/main.py``).

Experiment naming and logging, the model (from ``--pretrained``, and tower-only
loads from ``--pretrained-image``/``--pretrained-audio``), the optimizer (with
``--layer-decay`` and the ``--lock-*`` tower locking) and schedule, data, resume
(which takes precedence over the pretrained weights), and the epoch loop (train, evaluate at ``--val-frequency`` and after the last epoch,
on the ``--ema`` weights where the run keeps them, then a checkpoint per
``--save-frequency``, ``--save-most-recent`` and ``--delete-previous-checkpoint``), with ``results.jsonl`` and
``params.txt`` in the log directory. Without train data the run only evaluates
(``--val-data``, ``--imagenet-val``, ``--audio-zeroshot-dataset``) and returns the
metrics. Image train data
(``--train-data`` tar shards or a CSV) needs ``--device-preprocess``: the host decodes
JPEGs to uint8 canvases, and the step crops and normalizes them on the device. One
device a process: the CUDA card of the local rank unless ``--device`` says otherwise. Several
processes (torchrun's environment, or the ``--dist-*`` flags) join one process
group first (NCCL on the cards, gloo on the CPU), build the same model from the same
seed and train it on a (data, fsdp) mesh under FSDP2, each on its own
``--batch-size`` rows; only the primary writes the files and logs. Writers other
than JSONL and remote sync are not ported yet.

    torchrun --nproc-per-node 4 -m open_clip_tpu_torch.train.main --mesh-fsdp 2 ...
"""

from __future__ import annotations

import json
import logging
import os
import random
import sys
from datetime import datetime
from pathlib import Path

import numpy as np
import torch

from ..checkpoint import (checkpoint_to_params, get_latest_checkpoint, load_native,
                          read_state_dict, save_native)
from ..convert import params_from_jax
from ..data import get_data
from ..data.audio import audio_transform_v2
from ..factory import create_model, get_tokenizer, naflex_audio_preprocess, resolve_device
from ..models import blocks
from ..models.naflex_vit import is_naflex
from ..parallel.distributed import (barrier, broadcast_object_from_primary,
                                    broadcast_scalar_from_primary, init_distributed)
from ..parallel.mesh import create_mesh, shard_model
from ..transform import make_device_train_preprocess, merge_preprocess_dict
from .optim import OptimizerCfg, apply_trainable_mask, create_optimizer, trainable_mask
from .params import parse_args
from .scheduler import create_scheduler
from .train_loop import evaluate, train_one_epoch
from .train_step import (TrainState, create_train_state, ema_weights, loss_type_for,
                         make_train_step)

logger = logging.getLogger(__name__)


class JsonlWriter:
    def __init__(self, path):
        self.path = path

    def log(self, metrics, step):
        with open(self.path, "a") as fh:
            fh.write(json.dumps({"step": step, **{k: float(v) for k, v in metrics.items()}}) + "\n")


def random_seed(seed: int = 42) -> None:
    random.seed(seed)
    np.random.seed(seed % (2 ** 31))
    torch.manual_seed(seed)


def _data_tokenizer(args, model):
    """The model's tokenizer. Synthetic data repeats one fixed caption, so where the
    tokenizer needs a vocabulary that is not in the repository (SigLIP's
    sentencepiece models), its ids are a fixed row of ``context_length`` ids instead,
    and the run says so; real data needs the real tokenizer and raises."""
    try:
        return get_tokenizer(args.model)
    except NotImplementedError as err:
        if not args.dataset_type.startswith("synthetic"):
            raise
        text_cfg = model.cfg.text_cfg
        logger.warning("%s; the synthetic caption is token ids 1..%d", err,
                       text_cfg.context_length)
        ids = torch.arange(1, text_cfg.context_length + 1) % text_cfg.vocab_size
        return lambda texts: ids.expand(len(texts), -1)


@torch.no_grad()
def load_tower_(model, path, tower: str, flag: str) -> None:
    """Replace one tower's weights with the checkpoint's (the JAX CLI swaps the
    tower's subtree): every tensor of the tower must come from the file."""
    tree = checkpoint_to_params(read_state_dict(path), model.cfg)
    if tower not in tree:
        raise ValueError(f"{flag}: checkpoint has no {tower} tower")
    loaded = {k: v for k, v in params_from_jax(tree, model.cfg).items()
              if k.startswith(tower + ".")}
    own = {k: v for k, v in model.state_dict().items() if k.startswith(tower + ".")}
    missing = sorted(set(own) - set(loaded))
    if missing:
        raise KeyError(f"{flag}: the checkpoint's {tower} tower lacks {missing[:10]}")
    for k, cur in own.items():
        if loaded[k].shape != cur.shape:
            raise ValueError(f"{flag}: shape mismatch for {k}: checkpoint "
                             f"{tuple(loaded[k].shape)} vs model {tuple(cur.shape)}")
        cur.copy_(loaded[k].to(cur.dtype))
    logger.info("loaded the %s tower from %s", tower, path)


def save_epoch_checkpoints(state: TrainState, ckpt_dir: Path, completed: int, args) -> None:
    """The JAX CLI's checkpoints at the end of an epoch: ``epoch_N.pt`` per
    ``--save-frequency`` (and after the last epoch); with ``--save-most-recent``
    ``epoch_latest.pt``, a link swapped to the checkpoint just written or, in an
    epoch without one, a checkpoint of its own; with ``--delete-previous-checkpoint``
    the checkpoint ``--save-frequency`` epochs back is deleted. Under a mesh every
    rank calls it, and the primary touches the files."""
    primary = args.rank == 0
    saved = None
    if completed % args.save_frequency == 0 or completed == args.epochs:
        saved = ckpt_dir / f"epoch_{completed}.pt"
        save_native(saved, state, epoch=completed)  # every rank gathers, the primary writes
        barrier()
        logger.info("saved checkpoint %s", saved)
    if args.save_most_recent:
        latest = ckpt_dir / "epoch_latest.pt"
        if saved is not None:
            if primary:
                link = ckpt_dir / ".latest_tmp"
                if link.is_symlink() or link.exists():
                    link.unlink()
                os.symlink(saved.name, link)
                os.replace(link, latest)  # the swap is atomic
        else:
            if primary and latest.is_symlink():
                latest.unlink()
            save_native(latest, state, epoch=completed)
        barrier()
    if args.delete_previous_checkpoint:
        prev_epoch = completed - args.save_frequency
        prev = ckpt_dir / f"epoch_{prev_epoch}.pt"
        if primary and prev_epoch > 0 and prev.exists():
            prev.unlink()
        barrier()


def main(args=None):
    """Train as the flags say and return the ``TrainState``, or, with no train data,
    evaluate and return the metrics. ``--use-switchback`` and ``--remat-policy`` set
    ``models/blocks.py``'s ``MLP_LINEAR_IMPL`` and ``REMAT_POLICY`` for the run, and
    the run restores them when it ends."""
    args = parse_args(args)
    saved = blocks.MLP_LINEAR_IMPL, blocks.REMAT_POLICY
    blocks.MLP_LINEAR_IMPL = "switchback" if args.use_switchback else "dense"
    blocks.REMAT_POLICY = args.remat_policy
    try:
        return _run(args)
    finally:
        blocks.MLP_LINEAR_IMPL, blocks.REMAT_POLICY = saved


def _run(args):
    device = resolve_device(args.device)
    # the process group comes before anything that only the primary does
    args.rank, args.world_size = init_distributed(
        args.dist_coordinator, args.dist_num_processes, args.dist_process_id,
        device=device.type)
    primary = args.rank == 0
    logging.basicConfig(level=logging.DEBUG if args.debug else (
                            logging.INFO if primary else logging.WARNING),
                        format="%(asctime)s | %(levelname)s | %(message)s")
    args.device = str(resolve_device(args.device))  # cuda: the local rank's card

    if args.name is None:
        args.name = broadcast_object_from_primary("-".join([
            datetime.now().strftime("%Y_%m_%d-%H_%M_%S"),
            f"model_{args.model.replace('/', '-')}", f"lr_{args.lr}", f"b_{args.batch_size}"]))
    log_dir = Path(args.logs) / args.name
    ckpt_dir = log_dir / "checkpoints"
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    if primary:
        with open(log_dir / "params.txt", "w") as fh:
            for k in sorted(vars(args)):
                fh.write(f"{k}: {getattr(args, k)}\n")

    random_seed(args.seed)  # the same seed on every rank: the same initial weights
    model = create_model(args.model, args.pretrained or None, precision=args.precision,
                         device=args.device, seed=args.seed,
                         force_quick_gelu=args.force_quick_gelu,
                         force_custom_text=args.force_custom_text,
                         force_patch_dropout=args.force_patch_dropout,
                         force_image_size=(tuple(args.force_image_size)
                                           if args.force_image_size else None),
                         force_context_length=args.force_context_length)
    for flag, tower in (("pretrained_image", "visual"), ("pretrained_audio", "audio")):
        if getattr(args, flag):
            load_tower_(model, getattr(args, flag), tower, "--" + flag.replace("_", "-"))
    mesh = None
    if args.world_size > 1:
        mesh = create_mesh(data=args.mesh_data, fsdp=args.mesh_fsdp, device=device.type)
        shard_model(model, mesh)
    logger.info("processes=%d backend=%s mesh=%s", args.world_size,
                torch.distributed.get_backend() if torch.distributed.is_initialized() else None,
                dict(zip(mesh.mesh_dim_names, mesh.shape)) if mesh is not None else None)
    if model.preprocess_cfg is not None:
        model.preprocess_cfg = merge_preprocess_dict(model.preprocess_cfg, {
            "mean": tuple(args.image_mean) if args.image_mean else None,
            "std": tuple(args.image_std) if args.image_std else None,
            "interpolation": args.image_interpolation, "resize_mode": args.image_resize_mode})
    device_pp = None
    if args.device_preprocess:
        if model.preprocess_cfg is None or is_naflex(model.cfg.vision_cfg):
            raise ValueError("--device-preprocess supports image towers that take image "
                             "tensors (not audio or NaFlex patch dicts)")
        device_pp = make_device_train_preprocess(model.preprocess_cfg, aug_cfg=args.aug_cfg)
    audio_pp = audio_val_pp = None
    acfg = model.cfg.audio_cfg
    if acfg is not None and acfg.model_type == "naflexvit":
        audio_pp = audio_val_pp = naflex_audio_preprocess(acfg)
    elif acfg is not None:
        aug = dict(data_fill=args.audio_fill, data_trunc=args.audio_trunc,
                   int16_normalize=args.audio_int16_normalize)
        audio_pp = audio_transform_v2(acfg, is_train=True, audio_aug_cfg=aug)
        audio_val_pp = audio_transform_v2(acfg, is_train=False)  # the factory's pair
    if args.dataset_type.endswith("-naflex") and not (
            model.cfg.vision_cfg is not None and is_naflex(model.cfg.vision_cfg)):
        raise ValueError(f"dataset type {args.dataset_type!r} makes NaFlex patch dicts, which "
                         f"only a naflexvit tower takes ({args.model} takes image tensors)")
    tokenizer = _data_tokenizer(args, model)
    data = get_data(args, model.preprocess_cfg, tokenizer, audio_pp, audio_val_pp)
    if not data:
        raise ValueError("no data: give --train-data, a synthetic --dataset-type, "
                         "--val-data, --imagenet-val or --audio-zeroshot-dataset")
    writer = JsonlWriter(log_dir / "results.jsonl") if primary else None
    if "train" not in data:  # evaluation only
        metrics = evaluate(model, data, 0, args, tokenizer=tokenizer, writer=writer)
        logger.info("eval: %s", metrics)
        return metrics

    steps_per_epoch = max(data["train"].num_batches, 1)
    total_steps = steps_per_epoch * args.epochs
    cooldown = {}
    if args.lr_scheduler == "const-cooldown" and args.epochs_cooldown and not args.skip_scheduler:
        cooldown = {"cooldown_steps": steps_per_epoch * args.epochs_cooldown,
                    "cooldown_power": args.lr_cooldown_power,
                    "cooldown_end_lr": args.lr_cooldown_end}
    schedule = create_scheduler("const" if args.skip_scheduler else args.lr_scheduler,
                                args.lr, args.warmup, total_steps, **cooldown)
    opt_cfg = OptimizerCfg(opt=args.opt, lr=args.lr, wd=args.wd, beta1=args.beta1,
                           beta2=args.beta2, eps=args.eps, momentum=args.momentum,
                           grad_clip_norm=args.grad_clip_norm,
                           wd_exclude_patterns=tuple(args.wd_exclude_patterns or ()),
                           layer_decay=args.layer_decay, image_layer_decay=args.image_layer_decay,
                           text_layer_decay=args.text_layer_decay,
                           audio_layer_decay=args.audio_layer_decay)
    # the depth of a tower without stacked blocks, as the JAX CLI gives it
    vcfg = model.cfg.vision_cfg
    num_layers = vcfg.layers if vcfg is not None and not vcfg.is_resnet else None
    optimizer = create_optimizer(opt_cfg, model, schedule, num_layers=num_layers)
    if args.lock_image or args.lock_text:
        optimizer = apply_trainable_mask(optimizer, trainable_mask(
            model, lock_image=args.lock_image,
            lock_image_unlocked_groups=args.lock_image_unlocked_groups,
            lock_text=args.lock_text, lock_text_unlocked_layers=args.lock_text_unlocked_layers))
    state = create_train_state(model, optimizer, ema=args.ema is not None)

    start_epoch = 0
    if args.resume:
        resume_path = get_latest_checkpoint(ckpt_dir) if args.resume == "latest" else args.resume
        if resume_path:
            logger.info("resuming from %s", resume_path)
            start_epoch = load_native(resume_path, like=state)
            start_epoch = int(broadcast_scalar_from_primary(start_epoch))

    step_fn = make_train_step(model.cfg, optimizer,
                              loss_type=loss_type_for(model.cfg, siglip=args.siglip),
                              mesh=mesh, local_loss=args.local_loss, dist_impl=args.loss_dist_impl,
                              remat=args.grad_checkpointing, accum_steps=args.accum_freq,
                              ema_decay=args.ema, device_preprocess=device_pp,
                              preprocess_seed=args.seed,
                              naflex_loss_scale=args.naflex_loss_scale,
                              reference_batch_size=args.batch_size)
    # a checkpoint taken in the middle of an epoch resumes past the batches it trained on
    resume_skip = max(0, state.step - start_epoch * steps_per_epoch)

    for epoch in range(start_epoch, args.epochs):
        logger.info("=> epoch %d", epoch)
        data["train"].set_epoch(epoch)
        state = train_one_epoch(state, step_fn, data["train"].dataloader, epoch, args, schedule,
                                writer, skip_steps=resume_skip if epoch == start_epoch else 0)
        completed = epoch + 1
        if any(k in data for k in ("val", "imagenet-val", "imagenet-v2", "audio-zeroshot")) and (
                completed % args.val_frequency == 0 or completed == args.epochs):
            with ema_weights(state):  # the EMA weights where the run keeps them
                metrics = evaluate(model, data, completed, args, tokenizer=tokenizer,
                                   writer=writer)
            logger.info("eval: %s", metrics)
        save_epoch_checkpoints(state, ckpt_dir, completed, args)
    return state


if __name__ == "__main__":
    try:
        main(sys.argv[1:])
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
