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

CoCa (``loss_type="coca"``) adds the caption term: the decoder's hidden states at
positions :-1 predict the text at 1: (pad labels ignored) through the chunked
linear cross-entropy on ``text_decoder.text_projection`` (``ops/fused_ce.py``), so
the (B, L, vocab) logits never exist whole. Under GradCache the caption term is a
sum over samples, so each microbatch's phase-2 forward also backpropagates its own
caption loss over ``accum_steps``. Distillation (``loss_type="distill"``, a
``teacher`` model) adds the KL between the teacher's and the student's logits of
the batch; the teacher's features come from its eval forward under ``no_grad``,
and under GradCache the term joins the loss of the cached features.

A ModifiedResNet trains its batch norms in train mode, as the JAX step does: the
forward normalizes by each batch's statistics and records them, and after the
optimizer's update (and the EMA, which so averages the statistics of before the
step) they are folded into the running statistics with momentum 0.1
(``models/resnet.py:merge_bn_stats_``). ``freeze_bn_stats`` normalizes by the
running statistics instead and leaves them alone; GradCache normalizes each
microbatch by its own statistics and leaves the running ones alone too (with a
warning, as in the JAX package).

Under a mesh (``parallel.mesh``: the model under ``shard_model``) every rank takes
its own rows, the loss is gathered over the mesh's ranks when there is more than
one, FSDP2 averages the sharded gradients over the ranks and the step averages the
ones it left whole (``sync_replicated_grads``); the reported loss is the mean over
the ranks, the JAX step's ``pmean``.

The metrics are tensors on the model's device; reading them waits for the step.
"""

from __future__ import annotations

import contextlib
import logging
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..config import CLIPModelCfg
from ..loss import SIGLIP_DIST_IMPLS, clip_loss, distill_kl, siglip_loss
from ..models import blocks
from ..models.clip import LOGIT_SCALE_MAX, CLIPModel, clamp_logit_scale, clip_forward
from ..models.convnext import is_convnext
from ..models.resnet import merge_bn_stats_
from ..ops.fused_ce import fused_linear_cross_entropy
from ..parallel.mesh import is_sharded, sync_replicated_grads
from .optim import Optimizer

logger = logging.getLogger(__name__)

GEN_LOSSES = ("genlip", "genlap")
LOSS_TYPES = ("clip", "siglip", "coca", "distill") + GEN_LOSSES


def loss_type_for(cfg, *, distill: bool = False, siglip: bool = False) -> str:
    """The loss a config trains with (the JAX package's ``task.loss_type_for``):
    distillation when asked, GenLIP/GenLAP by their config (a ``GenLipModelCfg`` or
    ``GenLapModelCfg``, or a ``CLIPModelCfg`` read from such a config), siglip when
    asked, CoCa for a config with a multimodal decoder, else clip."""
    if distill:
        return "distill"
    if hasattr(cfg, "trunk_cfg"):
        return "genlap" if getattr(cfg, "audio_cfg", None) is not None else "genlip"
    if getattr(cfg, "genlap_cfg", None) is not None:
        return "genlap"
    if getattr(cfg, "genlip_cfg", None) is not None:
        return "genlip"
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
              gen: Optional[torch.Generator] = None, **kw) -> Tuple[torch.Tensor, ...]:
    """(primary, text) features; a CLAP batch's audio features take the image slot.
    The model is called as a module, so that FSDP2's hooks run under a mesh. ``gen``
    draws the patch-dropout or drop-path noise. ``kw``: a ResNet's ``bn_eval`` and
    ``stats_sink``; a CoCa model runs without its decoder, or with
    ``return_hidden=True`` returns the decoder's hidden states third."""
    key = "audio" if "audio" in batch else "image"
    if model.cfg.multimodal_cfg is not None:
        kw = kw or {"decode": False}
    out = model(batch[key], batch["text"], train=True, remat=remat, generator=gen, **kw)
    feats = (out[f"{key}_features"], out["text_features"])
    return feats + (out["hidden"],) if "hidden" in out else feats


def caption_loss(model: CLIPModel, hidden: torch.Tensor, text: torch.Tensor) -> torch.Tensor:
    """CoCa's caption term (the JAX step's): the hidden states at positions :-1
    predict ``text[:, 1:]``, pad labels ignored, through the chunked linear
    cross-entropy on ``text_decoder.text_projection``."""
    pad_id = model.cfg.text_cfg.pad_id
    tgt = text[:, 1:].long()
    labels = torch.where(tgt == pad_id, -100, tgt).reshape(-1)
    hid = hidden[:, :-1]
    return fused_linear_cross_entropy(hid.reshape(-1, hid.shape[-1]),
                                      model.text_decoder.text_projection.t(), labels)


@torch.no_grad()
def teacher_features(teacher: CLIPModel, batch) -> Tuple[torch.Tensor, ...]:
    """The teacher's float32 (image, text) features and exp(logit scale), from its
    eval forward (no patch dropout; a CoCa teacher without its decoder)."""
    coca = {"decode": False} if teacher.cfg.multimodal_cfg is not None else {}
    out = teacher(batch["image"], batch["text"], train=False, **coca)
    return (out["image_features"].float(), out["text_features"].float(),
            teacher.logit_scale.float().exp())


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
                    reference_batch_size: Optional[int] = None,
                    caption_loss_weight: float = 2.0, clip_loss_weight: float = 1.0,
                    teacher: Optional[CLIPModel] = None
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

    A ViT with ``patch_dropout`` draws each microbatch's patch noise, a ConvNeXt with
    a drop-path rate its keep masks, from a generator seeded the same way (and apart
    from the crop's).

    ``freeze_bn_stats`` (a ModifiedResNet; the CLI's ``--lock-image`` with
    ``--lock-image-freeze-bn-stats``): the batch norms use their running statistics
    and the step leaves them as they are; else the step folds each batch's into them
    (see the module's docstring). Other towers ignore it, as in the JAX package.

    ``ema_decay``: after the update and the logit-scale clamp, the state's EMA copy
    (``create_train_state(ema=True)``) moves to ``e * d + p * (1 - d)``.

    "coca" (a config with ``multimodal_cfg``): the loss is ``clip_loss_weight`` x
    InfoNCE + ``caption_loss_weight`` x the caption term; "distill": InfoNCE plus
    the KL to ``teacher`` (a ``CLIPModel``, frozen). Their metrics also hold
    ``contrastive_loss`` and ``caption_loss`` or ``distill_loss``.

    "genlip" / "genlap" (``cfg`` a ``GenLipModelCfg`` / ``GenLapModelCfg``; the batch
    ``{"image" | "audio": patch dict, "text": ids}``): the model's own caption loss
    (``genlip_forward(compute_loss=True)``), drop path drawn from a generator on the
    model's device seeded as the patch dropout's; ``logit_scale`` in the metrics is
    0. Accumulation averages the plain gradients of the microbatches (the loss is a
    sum over samples: no GradCache pass). CoCa, distillation, GenLIP and GenLAP are
    not ported under a mesh yet."""
    if loss_type not in LOSS_TYPES:
        raise ValueError(f"unknown loss_type {loss_type!r}")
    if loss_type in ("coca", "distill") + GEN_LOSSES and mesh is not None:
        raise NotImplementedError(f"the {loss_type} train step under a mesh is not ported yet")
    gen = loss_type in GEN_LOSSES
    if gen != hasattr(cfg, "trunk_cfg") or (
            gen and (loss_type == "genlap") != hasattr(cfg, "audio_cfg")):
        raise ValueError(f"the {loss_type} step does not train this config "
                         f"(loss_type_for gives {loss_type_for(cfg)!r})")
    if gen:
        return _make_gen_step(cfg, optimizer, loss_type, remat=remat, accum_steps=accum_steps,
                              ema_decay=ema_decay, preprocess_seed=preprocess_seed)
    if loss_type == "coca" and cfg.multimodal_cfg is None:
        raise ValueError("the coca step needs a CoCa config (multimodal_cfg)")
    if loss_type == "distill" and teacher is None:
        raise ValueError("the distill step needs a teacher model")
    if loss_type != "siglip" and cfg.init_logit_bias is not None:
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
    resnet = cfg.vision_cfg is not None and cfg.vision_cfg.is_resnet
    if resnet and accum_steps > 1:
        logger.warning("grad accumulation with a ResNet tower: BN running stats are not updated "
                       "under the GradCache path; they stay at their initial/loaded values")

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
        noise = vcfg is not None and (vcfg.patch_dropout or (
            is_convnext(vcfg) and (vcfg.timm_drop_path or 0.0) > 0.0))
        if not noise or isinstance(batch.get("image"), dict):
            return None
        gen = torch.Generator(device=batch["image"].device)
        gen.manual_seed(_seed(preprocess_seed, state.step) * 64 + 32 + micro)
        return gen

    def _bn(sink: Optional[list] = None) -> Dict:
        """A ResNet forward's batch-norm arguments (none for other towers)."""
        return {"bn_eval": freeze_bn_stats, "stats_sink": sink} if resnet else {}

    def _loss_ratio(batch, n: int) -> float:
        if naflex_loss_scale == "none" or not isinstance(batch.get("image"), dict):
            return 1.0
        if not reference_batch_size:
            raise ValueError("naflex loss scaling needs the reference batch size")
        ratio = n / reference_batch_size
        return ratio if naflex_loss_scale == "linear" else ratio ** 0.5

    def _apply_updates(state: TrainState, loss: torch.Tensor, aux: Optional[Dict] = None):
        return apply_updates_(state, optimizer, loss, aux, mesh=mesh, ema_decay=ema_decay,
                              clamp_scale=clamp_scale)

    def simple_step(state: TrainState, batch):
        model = state.model
        batch = _preprocess(state, batch)
        gen = _dropout_gen(state, batch)
        aux = {}
        sink = [] if resnet and not freeze_bn_stats else None
        if loss_type == "coca":
            imf, txf, hidden = _features(model, batch, remat, gen, return_hidden=True)
            closs = _loss(model, imf, txf)
            cap = caption_loss(model, hidden, batch["text"])
            loss = clip_loss_weight * closs + caption_loss_weight * cap
            aux = {"contrastive_loss": closs, "caption_loss": cap}
        else:
            imf, txf = _features(model, batch, remat, gen, **_bn(sink))
            loss = _loss(model, imf, txf) * _loss_ratio(batch, imf.shape[0])
            if loss_type == "distill":
                dloss = distill_kl(imf, txf, model.logit_scale.exp(),
                                   *teacher_features(teacher, batch))
                aux = {"contrastive_loss": loss, "distill_loss": dloss}
                loss = loss + dloss
        loss.backward()
        state, metrics = _apply_updates(state, loss, aux)
        if sink:  # train-mode batch norm: after the update, as in the JAX step
            merge_bn_stats_(sink)
        return state, metrics

    def accum_step(state: TrainState, batch):
        """GradCache accumulation over ``accum_steps`` equal slices of the batch."""
        model = state.model
        batch = _preprocess(state, batch)
        micro = microbatches(batch, accum_steps)
        n = batch["text"].shape[0]
        size = n // accum_steps
        # phase 1: features without gradients, one loss backward w.r.t. the features
        with torch.no_grad():
            feats = [_features(model, mb, remat, _dropout_gen(state, mb, i), **_bn())
                     for i, mb in enumerate(micro)]
        all_imf = torch.cat([f[0] for f in feats]).requires_grad_()
        all_txf = torch.cat([f[1] for f in feats]).requires_grad_()
        loss = _loss(model, all_imf, all_txf)
        aux = {}
        if loss_type == "distill":  # the KL joins the loss of the cached features
            t_feats = [teacher_features(teacher, mb) for mb in micro]
            dloss = distill_kl(all_imf, all_txf, model.logit_scale.exp(),
                               torch.cat([f[0] for f in t_feats]),
                               torch.cat([f[1] for f in t_feats]), t_feats[0][2])
            aux = {"contrastive_loss": loss, "distill_loss": dloss}
            loss = loss + dloss
        loss = loss * _loss_ratio(batch, n)  # the cached feature gradients carry the ratio
        contrastive_w = clip_loss_weight if loss_type == "coca" else 1.0
        # fills the features' grads and the logit scale's (and bias')
        (contrastive_w * loss).backward()
        # phase 2: each microbatch's forward again, with the cached feature gradients
        # (and CoCa's caption loss of the microbatch); under a mesh the gradients are
        # reduced after the last microbatch only
        cap_sum = 0.0
        for i, mb in enumerate(micro):
            if mesh is not None:
                model.set_requires_gradient_sync(i == accum_steps - 1)
            part = slice(i * size, (i + 1) * size)
            out = _features(model, mb, remat, _dropout_gen(state, mb, i), **_bn(),
                            **({"return_hidden": True} if loss_type == "coca" else {}))
            tensors = [out[0], out[1]]
            grads = [all_imf.grad[part].to(out[0].dtype), all_txf.grad[part].to(out[1].dtype)]
            if loss_type == "coca":
                cap = caption_loss(model, out[2], mb["text"])
                tensors.append(caption_loss_weight * cap / accum_steps)
                grads.append(None)
                cap_sum = cap_sum + cap.detach()
            torch.autograd.backward(tensors, grads)
        if loss_type == "coca":
            aux = {"contrastive_loss": loss, "caption_loss": cap_sum / accum_steps}
            loss = clip_loss_weight * loss + caption_loss_weight * cap_sum / accum_steps
        return _apply_updates(state, loss, aux)

    return accum_step if accum_steps > 1 else simple_step


def microbatches(batch, accum_steps: int) -> List[Dict]:
    """``batch`` cut into ``accum_steps`` equal slices of rows; a patch or waveform
    dict is sliced entry by entry."""
    n = batch["text"].shape[0]
    if n % accum_steps:
        raise ValueError(f"batch of {n} does not split into {accum_steps} microbatches")
    size = n // accum_steps

    def rows(v, i):
        if isinstance(v, dict):
            return {k: rows(x, i) for k, x in v.items()}
        return v[i * size:(i + 1) * size]

    return [{k: rows(v, i) for k, v in batch.items()} for i in range(accum_steps)]


def apply_updates_(state: TrainState, optimizer: Optimizer, loss: torch.Tensor,
                   aux: Optional[Dict] = None, *, mesh=None, ema_decay: Optional[float] = None,
                   clamp_scale: float = LOGIT_SCALE_MAX):
    """The end of every step: zero gradients for the parameters outside the loss,
    under a mesh the replicated gradients' and the loss's average over the ranks,
    the optimizer's update, the logit-scale clamp, the EMA; then the metrics (a
    model without a logit scale reports 0, as the JAX step does), the gradients
    cleared and the step advanced."""
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
    scale = getattr(model, "logit_scale", None)
    if scale is not None:
        clamp_logit_scale(model, clamp_scale)
    if ema_decay is not None:
        if state.ema is None:
            raise ValueError("ema_decay needs a state made with create_train_state(ema=True)")
        update_ema_(state.ema, params, ema_decay)
    with torch.no_grad():
        metrics = {"loss": loss,
                   "logit_scale": (scale.detach().float().exp() if scale is not None
                                   else loss.new_zeros((), dtype=torch.float32)),
                   "grad_norm": grad_norm,
                   **{k: v.detach() for k, v in (aux or {}).items()}}
    for p in params:
        p.grad = None
    state.step += 1
    return state, metrics


def gen_loss(model, batch, *, remat: bool = False, generator: Optional[torch.Generator] = None
             ) -> torch.Tensor:
    """GenLIP's or GenLAP's caption loss of a batch, in training mode."""
    prefix = batch["audio"] if "audio" in batch else batch["image"]
    return model(prefix, batch["text"], compute_loss=True, train=True, remat=remat,
                 generator=generator)["loss"]


def _make_gen_step(cfg, optimizer: Optimizer, loss_type: str, *, remat: bool, accum_steps: int,
                   ema_decay: Optional[float], preprocess_seed: int):
    """``make_train_step``'s "genlip" / "genlap" step."""
    drop = cfg.trunk_cfg.drop_path_rate > 1e-6

    def _gen(state: TrainState, micro: int) -> Optional[torch.Generator]:
        if not drop:
            return None
        gen = torch.Generator(device=state.model.device)
        gen.manual_seed(_seed(preprocess_seed, state.step) * 64 + 32 + micro)
        return gen

    def simple_step(state: TrainState, batch):
        loss = gen_loss(state.model, batch, remat=remat, generator=_gen(state, 0))
        loss.backward()
        return apply_updates_(state, optimizer, loss, ema_decay=ema_decay)

    def accum_step(state: TrainState, batch):
        """The JAX ``gen_accum_step``: the gradients of ``accum_steps`` equal slices
        summed, then scaled by 1 / ``accum_steps``; the loss their mean."""
        total = 0.0
        for i, mb in enumerate(microbatches(batch, accum_steps)):
            loss = gen_loss(state.model, mb, remat=remat, generator=_gen(state, i))
            loss.backward()
            total = total + loss.detach()
        inv = 1.0 / accum_steps
        with torch.no_grad():
            torch._foreach_mul_([p.grad for p in state.params if p.grad is not None], inv)
        return apply_updates_(state, optimizer, total * inv, ema_decay=ema_decay)

    return accum_step if accum_steps > 1 else simple_step


@torch.no_grad()
def eval_forward(model: CLIPModel, batch) -> Dict[str, torch.Tensor]:
    """Features and logit scale for validation."""
    return clip_forward(model, batch.get("audio", batch.get("image")), batch.get("text"),
                        train=False)
