"""Epoch loop and evaluation (counterpart of ``open_clip_tpu/train/train_loop.py``).

``train_one_epoch`` drives the train step over the host data pipeline. The batches
(image tensors, uint8 canvases, NaFlex patch dicts of tensors) come through
``data.wds.device_prefetch``: a background thread pins each one and copies it to the
model's device without blocking, a few batches ahead, and the host waits for the
device only at the metric cadence, where it reads the loss. Under several processes
the caller passes the writer on the primary only and ``None`` elsewhere, and logs at
INFO on the primary only.

``evaluate`` is the JAX function's: zero-shot over the class folders
(``zero_shot.py``), then the val loader through ``make_eval_step`` (normalized
features and the in-batch symmetric cross-entropy in fp32) with two batches in
flight, the features drained to the host as it goes, reassembled in global order
across processes and ranked by ``metrics.get_clip_metrics``. A model sharded by
FSDP2 is called as a module on every rank the same number of times
(``in_lockstep``), so that its parameter gathers pair up.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Callable, Dict, Iterable, Iterator, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..data.wds import device_prefetch
from .metrics import get_clip_metrics
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


def train_one_epoch(state: TrainState, step_fn: Callable, dataloader: Iterable, epoch: int,
                    args: Any, schedule: Optional[Callable] = None, writer=None,
                    skip_steps: int = 0) -> TrainState:
    """One pass over ``dataloader``. ``skip_steps`` batches are drawn and dropped
    first (a resume in the middle of an epoch). The writer's records carry the
    running means of the host's time per batch: ``train/data_time`` (waiting for the
    prefetched batch) and ``train/batch_time`` (the whole iteration)."""
    batch_time = AverageMeter()
    data_time = AverageMeter()
    loss_m = AverageMeter()
    log_every = getattr(args, "log_every_n_steps", 100)
    metric_every = getattr(args, "log_metric_every_n_steps", None) or log_every
    ema_samples = max(1, getattr(args, "train_loss_ema_samples", 50000) or 50000)
    loss_ema = None
    # the depth bounds the batches held on the card, whatever the decode workers
    loader = device_prefetch(dataloader, state.model.device,
                             depth=min(3, max(1, getattr(args, "workers", 2) or 1)))

    end = time.perf_counter()
    pending = None
    for i, batch in enumerate(loader):
        if i < skip_steps:
            end = time.perf_counter()
            continue
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


def in_lockstep(batches: Iterable, model, placeholder: Callable[[], Dict]
                ) -> Iterator[Tuple[Dict, bool]]:
    """(batch, False) for each of ``batches``; then, where the model is sharded over
    several processes, (``placeholder()``, True) until every process's ``batches``
    are done. A sharded forward gathers the parameters with collectives, so every
    process calls the model as often as the others, though rank-split loaders may
    hold a batch more or less; the caller drops a placeholder's results."""
    from ..parallel.distributed import host_psum, world
    from ..parallel.mesh import is_sharded

    if world()[1] == 1 or not any(is_sharded(p) for p in model.parameters()):
        for batch in batches:
            yield batch, False
        return
    it = iter(batches)
    while True:
        batch = next(it, None)
        if host_psum([batch is not None])[0] == 0:
            return
        yield (batch, False) if batch is not None else (placeholder(), True)


def placeholder_batch(model, text: bool = True) -> Dict[str, torch.Tensor]:
    """One zero image (and token row) for ``in_lockstep``."""
    size = model.cfg.vision_cfg.image_size
    size = size if isinstance(size, (tuple, list)) else (size, size)
    batch = {"image": torch.zeros(1, *size, 3, device=model.device)}
    if text:
        batch["text"] = torch.zeros(1, model.cfg.text_cfg.context_length, dtype=torch.long,
                                    device=model.device)
    return batch


def make_eval_step() -> Callable[[Any, Dict], Dict[str, torch.Tensor]]:
    """``step(model, batch)`` -> normalized ``primary_features`` and ``text_features``,
    ``logit_scale`` and ``loss``, the in-batch cross-entropy of both directions in
    fp32. The model is called as a module, so that FSDP2's hooks gather its shards."""

    @torch.no_grad()
    def step(model, batch) -> Dict[str, torch.Tensor]:
        out = model(batch.get("audio", batch.get("image")), batch["text"])
        primary = out.get("image_features", out.get("audio_features"))
        txf = out["text_features"]
        scale = out["logit_scale"]
        logits = scale * primary.float() @ txf.float().T
        labels = torch.arange(primary.shape[0], device=logits.device)
        loss = 0.5 * (F.cross_entropy(logits, labels) + F.cross_entropy(logits.T, labels))
        return {"primary_features": primary, "text_features": txf, "logit_scale": scale,
                "loss": loss}

    return step


def evaluate(model, data: Dict[str, Any], epoch: int, args: Any, tokenizer=None,
             writer=None) -> Dict[str, float]:
    """Zero-shot accuracy and val retrieval, the JAX keys: ``imagenet-zeroshot-val-top1``
    and ``-top5``, ``clip_val_loss`` (``audio_val_loss`` for CLAP),
    ``{image_to_text,text_to_image}_{R@1,R@5,R@10,mean_rank,median_rank}``,
    ``num_samples`` and ``epoch``. Under several processes the rank-split loaders'
    features come back in global order (by each batch's ``index``, else by stride) and
    the sums over ``host_psum``. GenLIP and CoCa models have no port and raise."""
    from ..parallel.distributed import host_gather_by_index, host_gather_stride, host_psum
    from .zero_shot import zero_shot_eval

    cfg = model.cfg
    if hasattr(cfg, "trunk_cfg") or getattr(cfg, "multimodal_cfg", None) is not None:
        raise NotImplementedError("evaluation of GenLIP and CoCa models is not ported")
    metrics: Dict[str, float] = dict(zero_shot_eval(model, data, epoch, args, tokenizer=tokenizer))
    if "audio-zeroshot" in data:
        from .audio_zero_shot import audio_zero_shot_eval, parse_templates

        metrics.update(audio_zero_shot_eval(
            model, data, epoch, args, tokenizer=tokenizer,
            templates=parse_templates(getattr(args, "audio_zeroshot_template", None))))

    if "val" in data:
        eval_step = make_eval_step()
        all_imf, all_txf, all_idx = [], [], []
        loss_sum, n, scale = 0.0, 0, None
        primary_key = "image"
        pending = []

        def drain(res, bs, idx):
            nonlocal loss_sum, n, scale
            all_imf.append(res["primary_features"].float().cpu().numpy())
            all_txf.append(res["text_features"].float().cpu().numpy())
            if idx is not None:
                all_idx.append(idx)
            loss_sum += float(res["loss"]) * bs
            scale = float(res["logit_scale"])
            n += bs

        # two batches in flight on the card; the features come to the host as it goes
        for batch, placeholder in in_lockstep(device_prefetch(data["val"].dataloader, model.device),
                                              model, lambda: placeholder_batch(model)):
            if placeholder:
                eval_step(model, batch)
                continue
            if "audio" in batch:
                primary_key = "audio"
            idx = batch.pop("index", None)
            pending.append((eval_step(model, batch), batch["text"].shape[0], idx))
            if len(pending) > 2:
                drain(*pending.pop(0))
        for item in pending:
            drain(*item)
        loss_sum, n = host_psum([loss_sum, n])
        if n and all_imf:
            imf, txf = np.concatenate(all_imf), np.concatenate(all_txf)
            if all_idx:
                gidx = np.concatenate(all_idx)
                imf, txf = host_gather_by_index(imf, gidx), host_gather_by_index(txf, gidx)
            else:
                imf, txf = host_gather_stride(imf), host_gather_stride(txf)
            metrics[f"{'clip' if primary_key == 'image' else primary_key}_val_loss"] = \
                float(loss_sum / n)
            metrics.update(get_clip_metrics(
                [imf], [txf], scale,
                chunk_size=getattr(args, "val_retrieval_chunk_size", None) or 4096))
            metrics["num_samples"] = int(n)

    metrics["epoch"] = epoch
    if writer is not None:
        writer.log({f"val/{k}": v for k, v in metrics.items()}, step=epoch)
    return metrics
