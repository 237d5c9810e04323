"""CLIP and CLAP models (counterpart of ``open_clip_tpu/models/clip.py``).

``CLIPModel`` is an ``nn.Module`` holding both towers under the reference
checkpoint's names (``visual.*``, the text tower's parts at the top level, or the
modern text tower as ``text.*``, ``logit_scale``). The vision tower is a ViT, a
NaFlex ViT (``naflexvit_*``), a Swin tower (``swin_*``), a ModifiedResNet (a config
whose ``layers`` is a tuple: the RN50 family, ``models/resnet.py``), a ConvNeXt
(``convnext_*``, ``models/convnext.py``), an EVA tower (``eva_*``, ``eva02_*`` and
PE-Core's ``vit_pe_core_*``, ``models/eva.py``) or a ViTamin (``vitamin_*``,
``models/vitamin.py``). A CoCa config (one with
``multimodal_cfg``) adds the multimodal decoder ``text_decoder`` of
``models/coca.py``; its forward is ``coca_forward`` and ``generate`` captions. A CLAP config (one with
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
from .convnext import ConvNeXt, is_convnext
from .eva import Eva, is_eva
from .naflex_vit import NaFlexVit, is_naflex, parse_naflex_cfg
from .resnet import ModifiedResNet
from .swin import SwinTransformer, is_swin
from .vit import VisionTransformer
from .vitamin import ViTamin, is_vitamin

DEFAULT_LOGIT_SCALE = math.log(1.0 / 0.07)
LOGIT_SCALE_MAX = math.log(100.0)


def check_model_cfg(cfg: CLIPModelCfg) -> None:
    """Raise for the model families that are not ported (towers raise for their own)
    and for the GenLIP and GenLAP configs, which build their own models.
    ``custom_text`` only names the text tower's keys in an exported state dict and
    changes nothing the model computes, so it is accepted."""
    if cfg.genlip_cfg is not None or cfg.genlap_cfg is not None:
        raise ValueError("a GenLIP or GenLAP config builds models/genlip.py:GenLipModel or "
                         "models/genlap.py:GenLapModel (factory.model_from_config), not CLIPModel")
    first = cfg.audio_cfg if cfg.audio_cfg is not None else cfg.vision_cfg
    unported = [name for name, on in (
        ("NaFlex audio tower", cfg.audio_naflex_cfg is not None),
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
        elif cfg.vision_cfg.is_resnet:
            self.visual = ModifiedResNet(cfg.vision_cfg, cfg.embed_dim)
        elif is_convnext(cfg.vision_cfg):
            self.visual = ConvNeXt(cfg.vision_cfg, cfg.embed_dim)
        elif is_eva(cfg.vision_cfg):
            self.visual = Eva(cfg.vision_cfg, cfg.embed_dim)
        elif is_vitamin(cfg.vision_cfg):
            self.visual = ViTamin(cfg.vision_cfg, cfg.embed_dim)
        elif is_swin(cfg.vision_cfg):
            self.visual = SwinTransformer(cfg.vision_cfg, cfg.embed_dim)
        else:
            self.visual = VisionTransformer(cfg.vision_cfg, cfg.embed_dim, act)
        text_mod.add_text_tower(self, cfg.text_cfg, cfg.embed_dim, act)
        if cfg.multimodal_cfg is not None:
            from .coca import MultimodalDecoder

            self.text_decoder = MultimodalDecoder(cfg.multimodal_cfg, cfg.text_cfg.vocab_size, act)
        self.logit_scale = nn.Parameter(torch.empty(()))
        self.logit_bias = None if cfg.init_logit_bias is None else nn.Parameter(torch.empty(()))
        self.preprocess_cfg = None  # set by the factory

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator) -> None:
        """Random weights with the JAX package's ``init_clip`` distributions."""
        cfg = self.cfg
        (self.audio if cfg.audio_cfg is not None else self.visual).init_weights(gen)
        text_mod.init_text_tower(self, cfg.text_cfg, gen)
        if cfg.multimodal_cfg is not None:
            self.text_decoder.init_weights(gen)
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
        """Parameters the contrastive loss does not reach (a ResNet's running
        statistics among them); a train step gives them zero gradients, as
        ``jax.grad`` does."""
        if self.cfg.audio_cfg is not None:
            return clap.params_outside_loss(self)
        if isinstance(self.visual, ModifiedResNet):
            return {f"visual.{n}" for n, _ in self.visual.named_parameters()
                    if n.endswith(("running_mean", "running_var"))}
        return set()

    def get_logits(self, image, text):
        return get_logits(self, image, text)

    def forward(self, image=None, text=None, *, train: bool = False, remat: bool = False,
                generator: Optional[torch.Generator] = None, **kw) -> Dict[str, torch.Tensor]:
        """``kw``: ``return_hidden`` and ``decode`` of ``coca_forward``, or a ResNet's
        ``bn_eval`` and ``stats_sink`` (``clip_forward``)."""
        return clip_forward(self, image, text, train=train, remat=remat, generator=generator,
                            **kw)

    def generate(self, image, *, seed: Optional[int] = None,
                 generator: Optional[torch.Generator] = None, **kw) -> torch.Tensor:
        """Caption images (CoCa configs), the JAX ``CLIPModel.generate``: beam search
        by default (``generation_type="beam_search"``, or any ``num_beams``), else
        ``coca.generate``'s greedy or sampled decode, which draws from ``generator``
        or, given ``seed``, a generator on the model's device seeded with it."""
        if self.cfg.multimodal_cfg is None:
            raise ValueError("generate() requires a CoCa config (multimodal_cfg)")
        from . import coca

        gt = kw.pop("generation_type", "beam_search")
        if gt == "beam_search" or "num_beams" in kw:
            return coca.generate_beam(self, image, **kw)
        if generator is None and seed is not None:
            generator = torch.Generator(device=self.device)
            generator.manual_seed(seed)
        return coca.generate(self, image, generator, generation_type=gt, **kw)


def _as_tensor(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x, device=device)


def _l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """L2-normalise the last axis in fp32; result in x.dtype."""
    x32 = x.float()
    return (x32 / torch.linalg.vector_norm(x32, dim=-1, keepdim=True).clamp_min(eps)).to(x.dtype)


def encode_image(model: CLIPModel, image, *, normalize: bool = False, train: bool = False,
                 remat: bool = False, generator: Optional[torch.Generator] = None,
                 bn_eval: bool = False, stats_sink: Optional[list] = None) -> torch.Tensor:
    """(B, H, W, 3) normalized NHWC images, or a NaFlex patch dict for a ``naflexvit_*``
    tower, -> (B, embed_dim) features. ``train`` turns on what only training does
    (a ViT's patch dropout, a ConvNeXt's drop path, their noise drawn from
    ``generator``; a ResNet's batch statistics, unless ``bn_eval``, recorded in
    ``stats_sink``); ``remat`` recomputes each block in the backward pass."""
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
    bn = ({"bn_eval": bn_eval, "stats_sink": stats_sink}
          if isinstance(model.visual, ModifiedResNet) else {})
    pooled = model.visual(image, model.compute_dtype, train=train, remat=remat,
                          generator=generator, **bn)
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
                 remat: bool = False, generator: Optional[torch.Generator] = None,
                 bn_eval: bool = False, stats_sink: Optional[list] = None, **coca_kw
                 ) -> Dict[str, torch.Tensor]:
    """Dict output of the reference ``CLIP.forward(output_dict=True)``. For a CLAP
    model ``image`` is the audio batch and the output is ``clap_forward``'s (HTSAT
    has no remat, as in the JAX package); a CoCa model's is ``coca_forward``'s,
    which takes ``coca_kw``. ``bn_eval`` and ``stats_sink``: ``encode_image``'s."""
    if model.cfg.multimodal_cfg is not None:
        from .coca import coca_forward

        return coca_forward(model, image, text, train=train, remat=remat, generator=generator,
                            **coca_kw)
    if coca_kw:
        raise TypeError(f"{sorted(coca_kw)} belong to a CoCa model's forward")
    if model.cfg.audio_cfg is not None:
        return clap.clap_forward(model, image, text, remat=remat)
    out: Dict[str, torch.Tensor] = {}
    if image is not None:
        out["image_features"] = encode_image(model, image, normalize=True, train=train,
                                             remat=remat, generator=generator, bn_eval=bn_eval,
                                             stats_sink=stats_sink)
    if text is not None:
        out["text_features"] = encode_text(model, text, normalize=True, remat=remat)
    out["logit_scale"] = model.logit_scale.float().exp()
    if model.logit_bias is not None:
        out["logit_bias"] = model.logit_bias.float()
    return out


def get_logits(model: CLIPModel, image, text):
    """(logits_per_image, logits_per_text)."""
    out = clip_forward(model, image, text,
                       **({"decode": False} if model.cfg.multimodal_cfg is not None else {}))
    logits = out["logit_scale"] * out["image_features"].float() @ out["text_features"].float().T
    if "logit_bias" in out:
        logits = logits + out["logit_bias"]
    return logits, logits.T


@torch.no_grad()
def clamp_logit_scale(model: CLIPModel, max_val: float = LOGIT_SCALE_MAX) -> None:
    """Clamp the temperature after an optimizer step, in place."""
    model.logit_scale.clamp_(max=max_val)
