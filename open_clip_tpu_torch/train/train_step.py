"""Train steps (counterpart of ``open_clip_tpu/train/train_step.py``).

    state = create_train_state(model, optimizer)
    step = make_train_step(model.cfg, optimizer, ...)
    state, metrics = step(state, batch)

The JAX package's step is a pure function of an immutable state; the port's
updates the model's parameters and the optimizer's moments in place and returns
the same ``TrainState`` object with ``step`` advanced, which saves a copy of
every weight per step. Master weights keep their own dtype (fp32 under
``amp_bf16``) and the towers compute in the model's compute dtype: every
projection casts its weight to the activation's dtype (``ops/layers.py:linear``).

Gradient accumulation is the GradCache construction: phase 1 computes every
microbatch's features without gradients and one loss backward with respect to
the features; phase 2 runs each microbatch's forward again and backpropagates
the cached feature gradients. That gives the gradient of the full batch.

Under a mesh (``parallel.mesh``: the model under ``shard_model``) every rank takes
its own rows, the loss is gathered over the mesh's ranks when there is more than
one, FSDP2 averages the sharded gradients over the ranks and the step averages the
ones it left whole (``sync_replicated_grads``); the reported loss is the mean over
the ranks, the JAX step's ``pmean``.

The metrics are tensors on the model's device; reading them waits for the step.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..config import CLIPModelCfg
from ..loss import SIGLIP_DIST_IMPLS, clip_loss, siglip_loss
from ..models import blocks
from ..models.clip import LOGIT_SCALE_MAX, CLIPModel, clamp_logit_scale, clip_forward
from ..parallel.mesh import is_sharded, sync_replicated_grads
from .optim import Optimizer

UNPORTED_LOSSES = ("coca", "distill", "genlip", "genlap")


def loss_type_for(cfg, *, distill: bool = False, siglip: bool = False) -> str:
    """The loss a config trains with (the JAX package's ``task.loss_type_for``):
    distillation when asked, GenLIP/GenLAP by their config, siglip when asked, CoCa
    for a config with a multimodal decoder, else clip."""
    if distill:
        return "distill"
    if hasattr(cfg, "trunk_cfg"):
        return "genlap" if getattr(cfg, "audio_cfg", None) is not None else "genlip"
    if siglip:
        return "siglip"
    if getattr(cfg, "multimodal_cfg", None) is not None:
        return "coca"
    return "clip"


@dataclass
class TrainState:
    step: int
    model: CLIPModel
    opt_state: Dict
    # the exponential moving average of the parameters (``--ema``), in their order
    ema: Optional[List[torch.Tensor]] = None

    @property
    def params(self) -> List[torch.Tensor]:
        """The model's parameters in the optimizer's order."""
        return [p for _, p in self.model.named_parameters()]


def create_train_state(model: CLIPModel, optimizer: Optimizer, ema: bool = False) -> TrainState:
    """Step 0 with the optimizer's zero state and, with ``ema``, a copy of the
    parameters to average. The model is the caller's and is trained in place."""
    for p in model.parameters():
        p.requires_grad_(True)
    state = TrainState(step=0, model=model, opt_state={})
    state.opt_state = optimizer.init(state.params)
    if ema:
        if any(is_sharded(p) for p in state.params):
            raise NotImplementedError("the EMA of sharded parameters is not ported yet")
        state.ema = [p.detach().clone() for p in state.params]
    return state


@torch.no_grad()
def update_ema_(ema: List[torch.Tensor], params: List[torch.Tensor], decay: float) -> None:
    """e <- e * d + p * (1 - d), in the EMA's dtype, with d and 1 - d in float32 as
    the JAX step has them."""
    d = np.float32(decay)
    torch._foreach_mul_(ema, float(d))
    part = torch._foreach_mul([p.detach().to(e.dtype) for p, e in zip(params, ema)],
                              float(np.float32(1.0) - d))
    torch._foreach_add_(ema, part)


@contextlib.contextmanager
def ema_weights(state: TrainState):
    """While open, the model holds the EMA weights (evaluation on them); the raw
    weights come back when it closes. Without an EMA copy it changes nothing."""
    if state.ema is None:
        yield state.model
        return
    raw = [p.detach().clone() for p in state.params]
    with torch.no_grad():
        torch._foreach_copy_([p.data for p in state.params], state.ema)
    try:
        yield state.model
    finally:
        with torch.no_grad():
            torch._foreach_copy_([p.data for p in state.params], raw)


def _features(model: CLIPModel, batch, remat: bool,
              gen: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(primary, text) features; a CLAP batch's audio features take the image slot.
    The model is called as a module, so that FSDP2's hooks run under a mesh. ``gen``
    draws the patch-dropout noise."""
    key = "audio" if "audio" in batch else "image"
    out = model(batch[key], batch["text"], train=True, remat=remat, generator=gen)
    return out[f"{key}_features"], out["text_features"]


def _seed(preprocess_seed: int, step: int) -> int:
    """The seed of a step's draws: a function of (seed, step, rank) alone, so that a
    resumed run draws what an uninterrupted one would."""
    rank = dist.get_rank() if dist.is_initialized() else 0
    return (preprocess_seed * 1_000_003 + step) * 4099 + rank


def make_train_step(cfg: CLIPModelCfg, optimizer: Optimizer, *, loss_type: str = "clip",
                    mesh=None, local_loss: bool = True, dist_impl: str = "bidir",
                    remat: bool = False, accum_steps: int = 1,
                    ema_decay: Optional[float] = None,
                    freeze_bn_stats: bool = False,
                    clamp_scale: float = LOGIT_SCALE_MAX,
                    device_preprocess: Optional[Callable] = None,
                    preprocess_seed: int = 0,
                    naflex_loss_scale: str = "none",
                    reference_batch_size: Optional[int] = None
                    ) -> Callable[[TrainState, Dict], Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """Build ``step(state, batch) -> (state, metrics)`` for a batch
    ``{"image": (B, H, W, 3) normalized NHWC, "text": (B, L) token ids}``; for a
    ``naflexvit_*`` tower ``image`` is a NaFlex patch dict of (B, N, ...) tensors, and
    a CLAP model takes ``{"audio": {"waveform", "longer"}, "text"}`` (HTSAT ignores
    ``remat``, as in the JAX package). The compute dtype is the model's
    (``create_model(precision=...)``). ``loss_type`` is "clip" (InfoNCE) or "siglip"
    (the sigmoid loss with the model's ``logit_bias``, which a clip step refuses).
    ``naflex_loss_scale`` ("none", "linear", "sqrt") scales the loss of a patch-dict
    batch by (its batch size / ``reference_batch_size``), or by the root of that, so
    that the small batches of the long token-budget buckets do not dominate.

    ``mesh``: the ``DeviceMesh`` the model was sharded on (``parallel.mesh``). Each
    rank passes its own rows; over a mesh of more than one rank the loss is the
    gathered one (the JAX rule, "only when the batch is split", applied to the port's
    batch, which every rank of the mesh splits), ``clip_loss``'s ``local_loss`` form
    or ``siglip_loss``'s ``dist_impl``. Under GradCache (``accum_steps > 1``) each rank
    cuts its own rows into microbatches where the JAX step cuts the global batch;
    phase 1's loss runs on every rank's features of all its microbatches, gathered,
    and GradCache is exact, so the gradient is the same. Phase 2 reduces the
    gradients once, after the last microbatch.

    ``device_preprocess`` (``transform.make_device_train_preprocess``): the batch's
    ``image`` is then the uint8 canvas, and ``device_preprocess(gen, image)`` crops
    and normalizes it on the device before the forward, once for the whole batch
    (before GradCache's cut). ``gen`` is a ``torch.Generator`` on the batch's device
    seeded from (``preprocess_seed``, the state's step, the rank), so that a resumed
    run draws the crops an uninterrupted one would.

    A ViT with ``patch_dropout`` draws each microbatch's patch noise from a
    generator seeded the same way (and apart from the crop's).

    ``ema_decay``: after the update and the logit-scale clamp, the state's EMA copy
    (``create_train_state(ema=True)``) moves to ``e * d + p * (1 - d)``."""
    if loss_type in UNPORTED_LOSSES:
        raise NotImplementedError(f"the {loss_type} train step is not ported yet "
                                  "(clip and siglip are)")
    if loss_type not in ("clip", "siglip"):
        raise ValueError(f"unknown loss_type {loss_type!r}")
    if freeze_bn_stats:
        raise NotImplementedError("frozen batch-norm statistics belong to the ResNet towers, "
                                  "which are not ported yet")
    if loss_type == "clip" and cfg.init_logit_bias is not None:
        raise NotImplementedError("a logit bias belongs to the siglip step: pass "
                                  "loss_type='siglip'")
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be at least 1, got {accum_steps}")
    if ema_decay is not None and mesh is not None:
        raise NotImplementedError("the EMA of the weights under a mesh is not ported yet")
    if naflex_loss_scale not in ("none", "linear", "sqrt"):
        raise ValueError(f"unknown naflex_loss_scale {naflex_loss_scale!r}")
    if loss_type == "siglip" and dist_impl not in SIGLIP_DIST_IMPLS:
        raise ValueError(f"unknown siglip dist_impl {dist_impl!r}")
    if mesh is not None and (blocks.MLP_LINEAR_IMPL != "dense" or blocks.REMAT_POLICY != "none"):
        raise NotImplementedError("SwitchBack and the remat presets are not ported under a mesh "
                                  "yet (full remat is)")
    # every rank of the mesh holds its own rows, and the mesh spans the default group
    group = dist.group.WORLD if mesh is not None and mesh.size() > 1 else None

    def _loss(model: CLIPModel, imf: torch.Tensor, txf: torch.Tensor) -> torch.Tensor:
        """fp32 scale = exp(logit_scale) and, for siglip, the fp32 logit bias."""
        scale = model.logit_scale.float().exp()
        if loss_type == "siglip":
            bias = None if model.logit_bias is None else model.logit_bias.float()
            return siglip_loss(imf, txf, scale, bias, group=group, dist_impl=dist_impl)
        return clip_loss(imf, txf, scale, group=group, local_loss=local_loss)

    def _preprocess(state: TrainState, batch):
        image = batch.get("image")
        if device_preprocess is None or image is None or isinstance(image, dict):
            return batch
        gen = torch.Generator(device=image.device)
        gen.manual_seed(_seed(preprocess_seed, state.step))
        return {**batch, "image": device_preprocess(gen, image)}

    def _dropout_gen(state: TrainState, batch, micro: int = 0) -> Optional[torch.Generator]:
        """The patch-dropout generator of microbatch ``micro`` (GradCache's two passes
        over a microbatch make it afresh, so both draw the same patches)."""
        vcfg = cfg.vision_cfg
        if vcfg is None or not vcfg.patch_dropout or isinstance(batch.get("image"), dict):
            return None
        gen = torch.Generator(device=batch["image"].device)
        gen.manual_seed(_seed(preprocess_seed, state.step) * 64 + 32 + micro)
        return gen

    def _loss_ratio(batch, n: int) -> float:
        if naflex_loss_scale == "none" or not isinstance(batch.get("image"), dict):
            return 1.0
        if not reference_batch_size:
            raise ValueError("naflex loss scaling needs the reference batch size")
        ratio = n / reference_batch_size
        return ratio if naflex_loss_scale == "linear" else ratio ** 0.5

    def _apply_updates(state: TrainState, loss: torch.Tensor):
        model = state.model
        params = state.params
        outside = model.params_outside_loss()
        for name, p in model.named_parameters():
            if p.grad is None and name in outside:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in params]
        if any(g is None for g in grads):
            missing = [n for n, p in model.named_parameters() if p.grad is None]
            raise RuntimeError(f"no gradient reached {missing}")
        loss = loss.detach()
        if mesh is not None:
            sync_replicated_grads(params)
            loss = loss.clone()
            dist.all_reduce(loss)
            loss /= dist.get_world_size()
        grad_norm = optimizer.update_(params, grads, state.opt_state)
        clamp_logit_scale(model, clamp_scale)
        if ema_decay is not None:
            if state.ema is None:
                raise ValueError("ema_decay needs a state made with create_train_state(ema=True)")
            update_ema_(state.ema, params, ema_decay)
        with torch.no_grad():
            metrics = {"loss": loss,
                       "logit_scale": model.logit_scale.detach().float().exp(),
                       "grad_norm": grad_norm}
        for p in params:
            p.grad = None
        state.step += 1
        return state, metrics

    def simple_step(state: TrainState, batch):
        model = state.model
        batch = _preprocess(state, batch)
        imf, txf = _features(model, batch, remat, _dropout_gen(state, batch))
        loss = _loss(model, imf, txf) * _loss_ratio(batch, imf.shape[0])
        loss.backward()
        return _apply_updates(state, loss)

    def accum_step(state: TrainState, batch):
        """GradCache accumulation over ``accum_steps`` equal slices of the batch."""
        model = state.model
        batch = _preprocess(state, batch)
        n = batch["text"].shape[0]
        if n % accum_steps:
            raise ValueError(f"batch of {n} does not split into {accum_steps} microbatches")
        size = n // accum_steps

        def rows(v, i):  # a patch or waveform dict is sliced entry by entry
            if isinstance(v, dict):
                return {k: rows(x, i) for k, x in v.items()}
            return v[i * size:(i + 1) * size]

        micro = [{k: rows(v, i) for k, v in batch.items()} for i in range(accum_steps)]
        # phase 1: features without gradients, one loss backward w.r.t. the features
        with torch.no_grad():
            feats = [_features(model, mb, remat, _dropout_gen(state, mb, i))
                     for i, mb in enumerate(micro)]
        all_imf = torch.cat([f[0] for f in feats]).requires_grad_()
        all_txf = torch.cat([f[1] for f in feats]).requires_grad_()
        loss = _loss(model, all_imf, all_txf)
        loss = loss * _loss_ratio(batch, n)  # the cached feature gradients carry the ratio
        loss.backward()  # fills the features' grads and the logit scale's (and bias')
        # phase 2: each microbatch's forward again, with the cached feature gradients;
        # under a mesh the gradients are reduced after the last microbatch only
        for i, mb in enumerate(micro):
            if mesh is not None:
                model.set_requires_gradient_sync(i == accum_steps - 1)
            imf, txf = _features(model, mb, remat, _dropout_gen(state, mb, i))
            part = slice(i * size, (i + 1) * size)
            torch.autograd.backward([imf, txf], [all_imf.grad[part].to(imf.dtype),
                                                 all_txf.grad[part].to(txf.dtype)])
        return _apply_updates(state, loss)

    return accum_step if accum_steps > 1 else simple_step


@torch.no_grad()
def eval_forward(model: CLIPModel, batch) -> Dict[str, torch.Tensor]:
    """Features and logit scale for validation."""
    return clip_forward(model, batch.get("audio", batch.get("image")), batch.get("text"),
                        train=False)
