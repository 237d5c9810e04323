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

The metrics are tensors on the model's device; reading them waits for the step.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import torch

from ..config import CLIPModelCfg
from ..loss import clip_loss
from ..models.clip import LOGIT_SCALE_MAX, CLIPModel, clamp_logit_scale, clip_forward
from .optim import AdamW

UNPORTED_LOSSES = ("siglip", "coca", "distill", "genlip", "genlap")


@dataclass
class TrainState:
    step: int
    model: CLIPModel
    opt_state: Dict

    @property
    def params(self) -> List[torch.Tensor]:
        """The model's parameters in the optimizer's order."""
        return [p for _, p in self.model.named_parameters()]


def create_train_state(model: CLIPModel, optimizer: AdamW) -> TrainState:
    """Step 0 with zero moments. The model is the caller's and is trained in place."""
    for p in model.parameters():
        p.requires_grad_(True)
    state = TrainState(step=0, model=model, opt_state={})
    state.opt_state = optimizer.init(state.params)
    return state


def _features(model: CLIPModel, batch, remat: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """(primary, text) features; a CLAP batch's audio features take the image slot."""
    key = "audio" if "audio" in batch else "image"
    out = clip_forward(model, batch[key], batch["text"], train=True, remat=remat)
    return out[f"{key}_features"], out["text_features"]


def make_train_step(cfg: CLIPModelCfg, optimizer: AdamW, *, loss_type: str = "clip",
                    remat: bool = False, accum_steps: int = 1,
                    ema_decay: Optional[float] = None,
                    clamp_scale: float = LOGIT_SCALE_MAX,
                    device_preprocess: Optional[Callable] = None,
                    naflex_loss_scale: str = "none",
                    reference_batch_size: Optional[int] = None
                    ) -> Callable[[TrainState, Dict], Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """Build ``step(state, batch) -> (state, metrics)`` for a batch
    ``{"image": (B, H, W, 3) normalized NHWC, "text": (B, L) token ids}``; for a
    ``naflexvit_*`` tower ``image`` is a NaFlex patch dict of (B, N, ...) tensors, and
    a CLAP model takes ``{"audio": {"waveform", "longer"}, "text"}`` (HTSAT ignores
    ``remat``, as in the JAX package). The compute dtype is the model's
    (``create_model(precision=...)``).
    ``naflex_loss_scale`` ("none", "linear", "sqrt") scales the loss of a patch-dict
    batch by (its batch size / ``reference_batch_size``), or by the root of that, so
    that the small batches of the long token-budget buckets do not dominate."""
    if loss_type in UNPORTED_LOSSES:
        raise NotImplementedError(f"the {loss_type} train step is not ported yet (clip is)")
    if loss_type != "clip":
        raise ValueError(f"unknown loss_type {loss_type!r}")
    if ema_decay is not None:
        raise NotImplementedError("EMA of the weights is not ported yet")
    if device_preprocess is not None:
        raise NotImplementedError("the on-device training preprocess is not ported yet")
    if cfg.init_logit_bias is not None:
        raise NotImplementedError("a logit bias belongs to the siglip step, not ported yet")
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be at least 1, got {accum_steps}")
    if naflex_loss_scale not in ("none", "linear", "sqrt"):
        raise ValueError(f"unknown naflex_loss_scale {naflex_loss_scale!r}")

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
        grad_norm = optimizer.update_(params, grads, state.opt_state)
        clamp_logit_scale(model, clamp_scale)
        with torch.no_grad():
            metrics = {"loss": loss.detach(),
                       "logit_scale": model.logit_scale.detach().float().exp(),
                       "grad_norm": grad_norm}
        for p in params:
            p.grad = None
        state.step += 1
        return state, metrics

    def simple_step(state: TrainState, batch):
        model = state.model
        imf, txf = _features(model, batch, remat)
        loss = clip_loss(imf, txf, model.logit_scale.float().exp())
        loss = loss * _loss_ratio(batch, imf.shape[0])
        loss.backward()
        return _apply_updates(state, loss)

    def accum_step(state: TrainState, batch):
        """GradCache accumulation over ``accum_steps`` equal slices of the batch."""
        model = state.model
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
            feats = [_features(model, mb, remat) for mb in micro]
        all_imf = torch.cat([f[0] for f in feats]).requires_grad_()
        all_txf = torch.cat([f[1] for f in feats]).requires_grad_()
        loss = clip_loss(all_imf, all_txf, model.logit_scale.float().exp())
        loss = loss * _loss_ratio(batch, n)  # the cached feature gradients carry the ratio
        loss.backward()  # fills all_imf.grad, all_txf.grad and logit_scale.grad
        # phase 2: each microbatch's forward again, with the cached feature gradients
        for i, mb in enumerate(micro):
            imf, txf = _features(model, mb, remat)
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
