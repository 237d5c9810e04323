"""GenLAP (counterpart of ``open_clip_tpu/models/genlap.py``): GenLIP's trunk and text
side (``models/genlip.py``) over a mel-spectrogram NaFlex prefix.

``AudioNaFlexCfg`` holds the mel and patch settings that the NaFlex audio patchify
(``data/naflex_audio.py``), the NaFlex audio encoder of CLAP
(``models/naflex_audio.py``) and GenLAP share. The prefix is a patch dict
{"patches" (B, N, in_chans*patch_freq*patch_time), "patch_coord" (B, N, 2) (freq,
time), "patch_valid" (B, N)}, embedded by a linear ``patch_embed`` (the reference's
``audio_embed``). Its MRoPE positions depend on the geometry
(``build_audio_position_ids``): full-height strips (one frequency token) put the
time on all three axes, else (0, freq, time). ``GenLapModel`` is ``GenLipModel``
with that prefix: ``encode_audio``, the joint forward, the packed caption loss
(``pack_prefix``), ``prefix_cache``, ``score_captions`` and ``generate`` (against
the audio cache). ``visual_proj`` is the reference's ``audio_proj``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch

from . import genlip as G


@dataclass
class AudioNaFlexCfg:
    sample_rate: int = 48000
    window_size: int = 1024
    hop_size: int = 480
    fmin: int = 50
    fmax: int = 14000
    n_mels: int = 64
    patch_freq: int = 64
    patch_time: int = 4
    in_chans: int = 1
    input_norm: bool = False
    pre_norm: bool = False
    proj_bias: bool = True
    patch_pad_mode: str = "floor"

    @property
    def patch_dim(self) -> int:
        return self.in_chans * self.patch_freq * self.patch_time

    @property
    def freq_tokens(self) -> int:
        assert self.n_mels % self.patch_freq == 0
        return self.n_mels // self.patch_freq

    @property
    def is_1d_time(self) -> bool:
        return self.freq_tokens == 1


@dataclass
class GenLapModelCfg:
    embed_dim: int
    audio_cfg: AudioNaFlexCfg
    text_cfg: G.GenLipTextCfg
    trunk_cfg: G.GenLipTrunkCfg
    rope_1d: Optional[bool] = None

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "GenLapModelCfg":
        return cls(embed_dim=d["embed_dim"],
                   audio_cfg=G._from_fields(AudioNaFlexCfg, d.get("audio_naflex_cfg")),
                   text_cfg=G._from_fields(G.GenLipTextCfg, d.get("text_cfg")),
                   trunk_cfg=G._from_fields(G.GenLipTrunkCfg, d.get("genlap_cfg")))

    @property
    def use_rope_1d(self) -> bool:
        return self.audio_cfg.is_1d_time if self.rope_1d is None else self.rope_1d


def _max_position(patch_coord: torch.Tensor, patch_valid: torch.Tensor,
                  rope_1d: bool) -> torch.Tensor:
    """(B,) the largest valid time (1-D) or frequency-or-time (axial) position."""
    freq, time = patch_coord[..., 0].long(), patch_coord[..., 1].long()
    pv = patch_valid.bool()
    zero = torch.zeros_like(time)
    if rope_1d:
        return torch.where(pv, time, zero).amax(dim=1)
    return torch.maximum(torch.where(pv, freq, zero).amax(dim=1),
                         torch.where(pv, time, zero).amax(dim=1))


def build_audio_position_ids(patch_coord: torch.Tensor, patch_valid: torch.Tensor,
                             text_valid: Optional[torch.Tensor] = None,
                             rope_1d: bool = False) -> torch.Tensor:
    """(3, B, Ni + Lt) integer positions of [audio ; text]. 1-D: time on all three
    axes; axial: (0, freq, time). Text positions continue after the largest valid
    audio position."""
    b, ni, _ = patch_coord.shape
    freq, time = patch_coord[..., 0].long(), patch_coord[..., 1].long()
    audio = time[None].expand(3, b, ni) if rope_1d else torch.stack([torch.zeros_like(time),
                                                                     freq, time])
    if text_valid is None or text_valid.shape[1] == 0:
        return audio
    start = _max_position(patch_coord, patch_valid, rope_1d) + 1
    return torch.cat([audio, G.text_position_ids(start, text_valid.shape[1])], dim=2)


class GenLapModel(G.GenLipModel):
    """``GenLipModel`` over a mel patch prefix; ``encode_audio`` in place of
    ``encode_image``."""

    prefix_key = "audio"

    def _patch_settings(self):
        a = self.cfg.audio_cfg
        return a.patch_dim, a.input_norm, a.pre_norm, a.proj_bias

    def prefix_position_ids(self, prefix: Dict[str, torch.Tensor]) -> torch.Tensor:
        return build_audio_position_ids(prefix["patch_coord"], prefix["patch_valid"],
                                        rope_1d=self.cfg.use_rope_1d)

    def text_start(self, prefix: Dict[str, torch.Tensor]) -> torch.Tensor:
        return _max_position(prefix["patch_coord"], prefix["patch_valid"],
                             self.cfg.use_rope_1d) + 1

    def encode_audio(self, audio, normalize: bool = False, remat: bool = False) -> torch.Tensor:
        return G.encode_prefix(self, self._inputs(audio), normalize=normalize, remat=remat)

    def generate(self, audio, **kw) -> torch.Tensor:
        """Caption clips against the audio cache (the JAX ``GenLapModel.generate``,
        which has no uncached form)."""
        if not kw.pop("kv_cache", True):
            raise ValueError("GenLAP decodes against its audio prefix cache only")
        return super().generate(audio, **kw)

    def encode_image(self, image, normalize: bool = False, remat: bool = False):
        raise ValueError("a GenLAP model encodes audio: use encode_audio")

    def patch_features(self, image, remat: bool = False):
        raise ValueError("patch_features belongs to GenLIP's image prefix")


def torch_genlap_to_params(sd) -> Dict[str, Any]:
    """A reference NaFlexGenLap state dict -> the JAX package's GenLAP tree: GenLIP's
    converter after ``audio_embed.*`` -> ``patch_embed.*`` and ``audio_proj.*`` ->
    ``visual.proj.*``."""
    from ..convert import normalize_torch_state_dict

    renamed = {}
    for k, v in normalize_torch_state_dict(sd).items():
        if k.startswith("audio_embed."):
            k = "patch_embed." + k[len("audio_embed."):]
        elif k.startswith("audio_proj."):
            k = "visual.proj." + k[len("audio_proj."):]
        renamed[k] = v
    return G.torch_genlip_to_params(renamed)
