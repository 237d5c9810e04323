"""The audio geometry of GenLAP (counterpart of two names of
``open_clip_tpu/models/genlap.py``): ``AudioNaFlexCfg``, the mel and patch settings
that the NaFlex audio patchify (``data/naflex_audio.py``) and encoder
(``models/naflex_audio.py``) share, and ``build_audio_position_ids``, the MRoPE
positions of mel patches. The GenLAP model itself is not ported.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch


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


def build_audio_position_ids(patch_coord: torch.Tensor, patch_valid: torch.Tensor,
                             text_valid: Optional[torch.Tensor] = None,
                             rope_1d: bool = False) -> torch.Tensor:
    """(3, B, Ni + Lt) integer positions of [audio ; text]. 1-D: time on all three
    axes; axial: (0, freq, time). Text positions continue after the largest valid
    audio position."""
    b, ni, _ = patch_coord.shape
    freq, time = patch_coord[..., 0].long(), patch_coord[..., 1].long()
    pv = patch_valid.bool()
    zero = torch.zeros_like(time)
    if rope_1d:
        audio = time[None].expand(3, b, ni)
        max_pos = torch.where(pv, time, zero).amax(dim=1)
    else:
        audio = torch.stack([zero, freq, time])
        max_pos = torch.maximum(torch.where(pv, freq, zero).amax(dim=1),
                                torch.where(pv, time, zero).amax(dim=1))
    if text_valid is None or text_valid.shape[1] == 0:
        return audio
    lt = text_valid.shape[1]
    text = (max_pos[:, None] + 1) + torch.arange(lt, device=time.device)[None, :]
    return torch.cat([audio, text[None].expand(3, b, lt)], dim=2)
