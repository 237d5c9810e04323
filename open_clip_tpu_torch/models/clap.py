"""CLAP: contrastive language-audio pretraining (counterpart of
``open_clip_tpu/models/clap.py``).

The audio tower is the HTSAT encoder (``models/htsat.py``) followed by an
optional L2 ``pre_norm`` and the 2-layer MLP projection with ``proj_act``; the text
tower is the CLIP text tower on the model itself, as in ``models/clip.py``. Module
names follow the reference checkpoint (``audio.encoder.*``, ``audio.proj.0``,
``audio.proj.2``). The Whisper and NaFlex-ViT audio encoders are not ported and
raise.
"""

from __future__ import annotations

import math
from typing import Dict, Set

import torch
from torch import nn

from ..config import CLIPAudioCfg
from ..ops.layers import ACT_FNS, linear
from .htsat import HTSAT

HTSAT_CONFIGS = {
    "tiny": dict(embed_dim=96, depths=(2, 2, 6, 2), num_heads=(4, 8, 16, 32)),
    "base": dict(embed_dim=128, depths=(2, 2, 12, 2), num_heads=(4, 8, 16, 32)),
    "large": dict(embed_dim=256, depths=(2, 2, 12, 2), num_heads=(4, 8, 16, 32)),
}


def check_audio_cfg(acfg: CLIPAudioCfg) -> None:
    """Raise for the audio towers that are not ported."""
    mt = acfg.model_type.lower()
    if mt in ("whisper", "naflexvit"):
        raise NotImplementedError(f"the {acfg.model_type} audio encoder is not ported yet "
                                  "(HTSAT is)")
    if mt != "htsat":
        raise ValueError(f"unsupported audio model type {acfg.model_type!r}")
    if acfg.model_name not in HTSAT_CONFIGS:
        raise ValueError(f"unknown HTSAT size {acfg.model_name!r}; one of {sorted(HTSAT_CONFIGS)}")


class _Act(nn.Module):
    def __init__(self, name: str):
        super().__init__()
        self.fn = torch.relu if name == "relu" else ACT_FNS["gelu"]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fn(x)


class AudioTower(nn.Module):
    """HTSAT encoder, optional L2 pre-norm, 2-layer MLP projection (``proj.0``, ``proj.2``)."""

    def __init__(self, acfg: CLIPAudioCfg, embed_dim: int):
        super().__init__()
        check_audio_cfg(acfg)
        self.cfg = acfg
        self.encoder = HTSAT(acfg, **HTSAT_CONFIGS[acfg.model_name])
        width = self.encoder.num_features
        self.proj = nn.Sequential(nn.Linear(width, embed_dim), _Act(acfg.proj_act),
                                  nn.Linear(embed_dim, embed_dim))

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator) -> None:
        self.encoder.init_weights(gen)
        for lin in (self.proj[0], self.proj[2]):
            bound = 1.0 / math.sqrt(lin.in_features)
            lin.weight.uniform_(-bound, bound, generator=gen)
            lin.bias.uniform_(-bound, bound, generator=gen)

    def forward(self, audio: Dict[str, torch.Tensor], compute_dtype: torch.dtype = torch.float32,
                apply_proj: bool = True) -> torch.Tensor:
        from .clip import _l2_normalize

        features = self.encoder(audio, compute_dtype)
        if self.cfg.pre_norm:
            features = _l2_normalize(features)
        if apply_proj:
            fc1, act, fc2 = self.proj
            h = act(linear(features, fc1.weight, fc1.bias, transposed=True))
            features = linear(h, fc2.weight, fc2.bias, transposed=True)
        return features


def encode_audio(model, audio, *, normalize: bool = False) -> torch.Tensor:
    """A waveform dict ({"waveform": (B, T) fp32, "longer": (B,) bool}) or a bare
    (B, T) waveform -> (B, embed_dim) features."""
    from .clip import _as_tensor, _l2_normalize

    if not isinstance(audio, dict):
        audio = {"waveform": audio}
    audio = {k: _as_tensor(v, model.device) for k, v in audio.items()}
    feats = model.audio(audio, model.compute_dtype, apply_proj=not model.cfg.audio_cfg.training_head)
    return _l2_normalize(feats) if normalize else feats


def clap_forward(model, audio=None, text=None) -> Dict[str, torch.Tensor]:
    """The reference ``CLAP.forward`` as a dict: normalized ``audio_features`` and
    ``text_features``, ``logit_scale`` (and ``logit_bias``)."""
    from .clip import encode_text

    out: Dict[str, torch.Tensor] = {}
    if audio is not None:
        out["audio_features"] = encode_audio(model, audio, normalize=True)
    if text is not None:
        out["text_features"] = encode_text(model, text, normalize=True)
    out["logit_scale"] = model.logit_scale.float().exp()
    if model.logit_bias is not None:
        out["logit_bias"] = model.logit_bias.float()
    return out


def params_outside_loss(model) -> Set[str]:
    """Names of the parameters that the contrastive loss does not reach: HTSAT's
    token-semantic head (``tscam_conv``) and classifier (``head``). Under ``jit``
    their gradients are zeros; the train step gives them zeros here too."""
    return {n for n, _ in model.named_parameters()
            if n.startswith(("audio.encoder.tscam_conv.", "audio.encoder.head."))}
