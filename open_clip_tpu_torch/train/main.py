"""Training CLI: ``python -m open_clip_tpu_torch.train.main <flags>`` (counterpart of
``open_clip_tpu/train/main.py``).

Experiment naming and logging, the model, optimizer and schedule, data, resume,
and the epoch loop (train, then a checkpoint per ``--save-frequency``), with
``results.jsonl`` and ``params.txt`` in the log directory. One process, one
device: the CUDA card unless ``--device`` says otherwise. Evaluation, writers
other than JSONL, remote sync and meshes are not ported yet.
"""

from __future__ import annotations

import json
import logging
import random
import sys
from datetime import datetime
from pathlib import Path

import numpy as np
import torch

from ..checkpoint import get_latest_checkpoint, load_native, save_native
from ..data import get_data
from ..data.audio import audio_transform_v2
from ..factory import create_model, get_tokenizer, resolve_device
from .optim import OptimizerCfg, create_optimizer
from .params import parse_args
from .scheduler import create_scheduler
from .train_loop import train_one_epoch
from .train_step import TrainState, create_train_state, make_train_step

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


def main(args=None) -> TrainState:
    args = parse_args(args)
    logging.basicConfig(level=logging.DEBUG if args.debug else logging.INFO,
                        format="%(asctime)s | %(levelname)s | %(message)s")
    args.device = str(resolve_device(args.device))

    if args.name is None:
        args.name = "-".join([datetime.now().strftime("%Y_%m_%d-%H_%M_%S"),
                              f"model_{args.model.replace('/', '-')}", f"lr_{args.lr}",
                              f"b_{args.batch_size}"])
    log_dir = Path(args.logs) / args.name
    ckpt_dir = log_dir / "checkpoints"
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    with open(log_dir / "params.txt", "w") as fh:
        for k in sorted(vars(args)):
            fh.write(f"{k}: {getattr(args, k)}\n")

    random_seed(args.seed)
    model = create_model(args.model, precision=args.precision, device=args.device, seed=args.seed)
    audio_pp = None
    if model.cfg.audio_cfg is not None:
        audio_pp = audio_transform_v2(model.cfg.audio_cfg, is_train=True, audio_aug_cfg=dict(
            data_fill=args.audio_fill, data_trunc=args.audio_trunc,
            int16_normalize=args.audio_int16_normalize))
    data = get_data(args, model.preprocess_cfg, get_tokenizer(args.model), audio_pp)
    writer = JsonlWriter(log_dir / "results.jsonl")

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
                           beta2=args.beta2, eps=args.eps, grad_clip_norm=args.grad_clip_norm,
                           wd_exclude_patterns=tuple(args.wd_exclude_patterns or ()))
    optimizer = create_optimizer(opt_cfg, model, schedule)
    state = create_train_state(model, optimizer)

    start_epoch = 0
    if args.resume:
        resume_path = get_latest_checkpoint(ckpt_dir) if args.resume == "latest" else args.resume
        if resume_path:
            logger.info("resuming from %s", resume_path)
            start_epoch = load_native(resume_path, like=state)

    step_fn = make_train_step(model.cfg, optimizer, loss_type="clip",
                              remat=args.grad_checkpointing, accum_steps=args.accum_freq,
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
        if completed % args.save_frequency == 0 or completed == args.epochs:
            path = ckpt_dir / f"epoch_{completed}.pt"
            save_native(path, state, epoch=completed)
            logger.info("saved checkpoint %s", path)
    return state


if __name__ == "__main__":
    main(sys.argv[1:])
