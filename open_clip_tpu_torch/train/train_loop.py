"""Epoch loop (counterpart of ``open_clip_tpu/train/train_loop.py``).

``train_one_epoch`` drives the train step over the host data pipeline. Each batch
(image tensors, or NaFlex patch dicts of tensors) goes to the model's device with
a non-blocking copy (from pinned memory where the dataset pins it), and the host waits for the device only at the metric cadence,
where it reads the loss. Under several processes the caller passes the writer on the
primary only and ``None`` elsewhere, and logs at INFO on the primary only. Evaluation
is not ported yet.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Callable, Iterable, Optional

from .train_step import TrainState

logger = logging.getLogger(__name__)


class AverageMeter:
    """Running average."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = self.sum = self.count = self.avg = 0.0

    def update(self, val, n=1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


def to_device(x, device):
    """A tensor, or a (nested) dict of tensors, on ``device``; the copy does not block."""
    if isinstance(x, dict):
        return {k: to_device(v, device) for k, v in x.items()}
    return x.to(device, non_blocking=True)


def train_one_epoch(state: TrainState, step_fn: Callable, dataloader: Iterable, epoch: int,
                    args: Any, schedule: Optional[Callable] = None, writer=None,
                    skip_steps: int = 0) -> TrainState:
    """One pass over ``dataloader``. ``skip_steps`` batches are drawn and dropped
    first (a resume in the middle of an epoch). The writer's records carry the
    running means of the host's time per batch: ``train/data_time`` (drawing the
    batch and queueing its copy) and ``train/batch_time`` (the whole iteration)."""
    batch_time = AverageMeter()
    data_time = AverageMeter()
    loss_m = AverageMeter()
    log_every = getattr(args, "log_every_n_steps", 100)
    metric_every = getattr(args, "log_metric_every_n_steps", None) or log_every
    ema_samples = max(1, getattr(args, "train_loss_ema_samples", 50000) or 50000)
    loss_ema = None
    device = state.model.device

    end = time.perf_counter()
    pending = None
    for i, batch in enumerate(dataloader):
        if i < skip_steps:
            end = time.perf_counter()
            continue
        batch = to_device(batch, device)
        data_time.update(time.perf_counter() - end)
        state, metrics = step_fn(state, batch)
        pending = metrics

        if (i % metric_every) == 0 or (i % log_every) == 0:
            # the host waits for the device here and nowhere else in the loop; the
            # metrics are the step's means over the ranks, the samples every rank's
            bs = batch["text"].shape[0] * getattr(args, "world_size", 1)
            loss = float(metrics["loss"])
            loss_m.update(loss, n=bs)
            alpha = min(1.0, bs * metric_every / ema_samples)
            loss_ema = loss if loss_ema is None else loss_ema * (1 - alpha) + loss * alpha
            scale = float(metrics["logit_scale"])
            # the lr this step was taken with: the optimizer reads its count before the step
            lr = float(schedule(state.step - 1)) if schedule is not None else float("nan")
            if (i % log_every) == 0:
                logger.info("epoch %d step %d loss %.4f (ema %.4f) logit_scale %.2f lr %.2e "
                            "data %.3fs batch %.3fs", epoch, i, loss, loss_ema, scale, lr,
                            data_time.avg, batch_time.avg)
            if writer is not None:
                writer.log({"train/loss": loss, "train/loss_ema": loss_ema,
                            "train/logit_scale": scale, "train/lr": lr,
                            "train/grad_norm": float(metrics["grad_norm"]),
                            "train/data_time": data_time.avg,
                            "train/batch_time": batch_time.avg}, step=state.step)
        batch_time.update(time.perf_counter() - end)
        end = time.perf_counter()

    if pending is not None:
        float(pending["loss"])  # the epoch ends when the device has finished its last step
    return state
