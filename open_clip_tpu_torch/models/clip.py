"""CLIP and CLAP models (counterpart of ``open_clip_tpu/models/clip.py``).

``CLIPModel`` is an ``nn.Module`` holding both towers under the reference
checkpoint's names (``visual.*``, the text tower's parts at the top level, or the
modern text tower as ``text.*``, ``logit_scale``). The vision tower is a ViT, a
NaFlex ViT (``naflexvit_*``) or a Swin tower (``swin_*``). A CLAP config (one with
``audio_cfg``) holds ``audio``, the HTSAT or NaFlex audio tower of
``models/clap.py``, in place of ``visual``; HTSAT's ``bn0`` uses stored statistics
in training too, so serving and training run the same forward.
The functions ``encode_image``, ``encode_text``, ``encode_audio``, ``clip_forward``
and ``get_logits`` take the model as their first argument, as the JAX functions
take (params, cfg); the model's methods call them.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from ..config import CLIPModelCfg
from . import clap
from . import text as text_mod
from .naflex_vit import NaFlexVit, is_naflex, parse_naflex_cfg
from .swin import SwinTransformer, is_swin
from .vit import VisionTransformer

DEFAULT_LOGIT_SCALE = math.log(1.0 / 0.07)
LOGIT_SCALE_MAX = math.log(100.0)


def check_model_cfg(cfg: CLIPModelCfg) -> None:
    """Raise for the model families that are not ported (towers raise for their own).
    ``custom_text`` only names the text tower's keys in an exported state dict and
    changes nothing the model computes, so it is accepted."""
    first = cfg.audio_cfg if cfg.audio_cfg is not None else cfg.vision_cfg
    unported = [name for name, on in (
        ("CoCa decoder", cfg.multimodal_cfg is not None),
        ("NaFlex audio tower", cfg.audio_naflex_cfg is not None),
        ("GenLIP/GenLAP", cfg.genlip_cfg is not None or cfg.genlap_cfg is not None),
        ("model without both towers", first is None or cfg.text_cfg is None)) if on]
    if unported:
        raise NotImplementedError(f"not ported yet: {', '.join(unported)}")
    if cfg.audio_cfg is not None:
        clap.check_audio_cfg(cfg.audio_cfg)


class CLIPModel(nn.Module):
    def __init__(self, cfg: CLIPModelCfg, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        check_model_cfg(cfg)
        self.cfg = cfg
        self.compute_dtype = compute_dtype
        act = "quick_gelu" if cfg.quick_gelu else "gelu"
        if cfg.audio_cfg is not None:
            self.audio = clap.AudioTower(cfg.audio_cfg, cfg.embed_dim)
        elif is_naflex(cfg.vision_cfg):
            self.visual = NaFlexVit(parse_naflex_cfg(cfg.vision_cfg), cfg.embed_dim, act)
        elif is_swin(cfg.vision_cfg):
            self.visual = SwinTransformer(cfg.vision_cfg, cfg.embed_dim)
        else:
            self.visual = VisionTransformer(cfg.vision_cfg, cfg.embed_dim, act)
        text_mod.add_text_tower(self, cfg.text_cfg, cfg.embed_dim, act)
        self.logit_scale = nn.Parameter(torch.empty(()))
        self.logit_bias = None if cfg.init_logit_bias is None else nn.Parameter(torch.empty(()))
        self.preprocess_cfg = None  # set by the factory

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator) -> None:
        """Random weights with the JAX package's ``init_clip`` distributions."""
        cfg = self.cfg
        (self.audio if cfg.audio_cfg is not None else self.visual).init_weights(gen)
        text_mod.init_text_tower(self, cfg.text_cfg, gen)
        self.logit_scale.fill_(DEFAULT_LOGIT_SCALE if cfg.init_logit_scale is None
                               else cfg.init_logit_scale)
        if self.logit_bias is not None:
            self.logit_bias.fill_(cfg.init_logit_bias)

    @property
    def device(self) -> torch.device:
        return self.logit_scale.device

    def encode_image(self, image, normalize: bool = False) -> torch.Tensor:
        return encode_image(self, image, normalize=normalize)

    def encode_text(self, text, normalize: bool = False) -> torch.Tensor:
        return encode_text(self, text, normalize=normalize)

    def encode_audio(self, audio, normalize: bool = False) -> torch.Tensor:
        return encode_audio(self, audio, normalize=normalize)

    def params_outside_loss(self) -> set:
        """Parameters the contrastive loss does not reach; a train step gives them
        zero gradients, as ``jax.grad`` does."""
        return clap.params_outside_loss(self) if self.cfg.audio_cfg is not None else set()

    def get_logits(self, image, text):
        return get_logits(self, image, text)

    def forward(self, image=None, text=None, *, train: bool = False, remat: bool = False,
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        return clip_forward(self, image, text, train=train, remat=remat, generator=generator)


def _as_tensor(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x, device=device)


def _l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """L2-normalise the last axis in fp32; result in x.dtype."""
    x32 = x.float()
    return (x32 / torch.linalg.vector_norm(x32, dim=-1, keepdim=True).clamp_min(eps)).to(x.dtype)


def encode_image(model: CLIPModel, image, *, normalize: bool = False, train: bool = False,
                 remat: bool = False, generator: Optional[torch.Generator] = None
                 ) -> torch.Tensor:
    """(B, H, W, 3) normalized NHWC images, or a NaFlex patch dict for a ``naflexvit_*``
    tower, -> (B, embed_dim) features. ``train`` turns on what only training does
    (a ViT's patch dropout, its noise drawn from ``generator``); ``remat`` recomputes
    each block in the backward pass."""
    if model.cfg.audio_cfg is not None:
        raise ValueError("a CLAP model encodes audio: use encode_audio")
    if isinstance(image, dict):
        if not is_naflex(model.cfg.vision_cfg):
            raise ValueError(
                "got a NaFlex patch-dict batch but the model's vision tower is not a "
                "naflexvit_* — use a naflex model (e.g. naflex_ViT-B-16) or image-tensor data")
        image = {k: _as_tensor(v, model.device) for k, v in image.items()}
    else:
        image = _as_tensor(image, model.device)
    pooled = model.visual(image, model.compute_dtype, train=train, remat=remat,
                          generator=generator)
    return _l2_normalize(pooled) if normalize else pooled


def encode_text(model: CLIPModel, text, *, normalize: bool = False,
                remat: bool = False) -> torch.Tensor:
    """(B, L) token ids -> (B, embed_dim) features."""
    ids = _as_tensor(text, model.device).long()
    pooled = text_mod.apply_text_tower(model, model.cfg.text_cfg, ids, model.compute_dtype,
                                       remat=remat)
    return _l2_normalize(pooled) if normalize else pooled


def encode_audio(model: CLIPModel, audio, *, normalize: bool = False) -> torch.Tensor:
    """A waveform dict (or a bare (B, T) waveform), or a mel patch dict for a
    naflexvit tower, -> (B, embed_dim) features."""
    if model.cfg.audio_cfg is None:
        raise ValueError("encode_audio needs a CLAP model (a config with audio_cfg)")
    return clap.encode_audio(model, audio, normalize=normalize)


def clip_forward(model: CLIPModel, image=None, text=None, *, train: bool = False,
                 remat: bool = False, generator: Optional[torch.Generator] = None
                 ) -> Dict[str, torch.Tensor]:
    """Dict output of the reference ``CLIP.forward(output_dict=True)``. For a CLAP
    model ``image`` is the audio batch and the output is ``clap_forward``'s (HTSAT
    has no remat, as in the JAX package)."""
    if model.cfg.audio_cfg is not None:
        return clap.clap_forward(model, image, text, remat=remat)
    out: Dict[str, torch.Tensor] = {}
    if image is not None:
        out["image_features"] = encode_image(model, image, normalize=True, train=train,
                                             remat=remat, generator=generator)
    if text is not None:
        out["text_features"] = encode_text(model, text, normalize=True, remat=remat)
    out["logit_scale"] = model.logit_scale.float().exp()
    if model.logit_bias is not None:
        out["logit_bias"] = model.logit_bias.float()
    return out


def get_logits(model: CLIPModel, image, text):
    """(logits_per_image, logits_per_text)."""
    out = clip_forward(model, image, text)
    logits = out["logit_scale"] * out["image_features"].float() @ out["text_features"].float().T
    if "logit_bias" in out:
        logits = logits + out["logit_bias"]
    return logits, logits.T


@torch.no_grad()
def clamp_logit_scale(model: CLIPModel, max_val: float = LOGIT_SCALE_MAX) -> None:
    """Clamp the temperature after an optimizer step, in place."""
    model.logit_scale.clamp_(max=max_val)
