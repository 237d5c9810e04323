"""NaFlex audio patchify on the host, in numpy (counterpart of
``open_clip_tpu/data/naflex_audio.py``).

(waveform, sample rate) -> a log-mel -> variable-length (freq, time) patch tokens in
the NaFlex patch-dict contract (``patches``, ``patch_coord``, ``patch_valid``),
padded to ``max_audio_tokens``: the input of the NaFlex audio encoder
(``models/naflex_audio.py``). The same numpy as the JAX package's, so the two agree
bit for bit.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np

from ..models.genlap import AudioNaFlexCfg
from ..ops.audio import mel_filter_bank
from .audio import resample_poly

MEL_SILENCE_DB = -100.0


def _np_log_mel(wav: np.ndarray, cfg: AudioNaFlexCfg) -> np.ndarray:
    """(T,) waveform -> (frames, n_mels) dB mel: a reflect-padded Hann STFT."""
    n_fft, hop = cfg.window_size, cfg.hop_size
    window = np.hanning(n_fft + 1)[:-1].astype(np.float32)
    pad = n_fft // 2
    x = np.pad(wav.astype(np.float32), (pad, pad), mode="reflect")
    n_frames = 1 + (len(x) - n_fft) // hop
    idx = np.arange(n_frames)[:, None] * hop + np.arange(n_fft)[None, :]
    frames = x[idx] * window
    mag2 = np.abs(np.fft.rfft(frames, axis=-1)) ** 2
    filters = mel_filter_bank(cfg.sample_rate, n_fft, cfg.n_mels, cfg.fmin, cfg.fmax)
    mel = mag2 @ filters.T
    return 10.0 * np.log10(np.maximum(mel, 1e-10)).astype(np.float32)


def mel_to_patches(mel: np.ndarray, patch_freq: int, patch_time: int, in_chans: int = 1,
                   pad_mode: str = "floor") -> Dict[str, np.ndarray]:
    """(T, n_mels) or (C, T, n_mels) log-mel -> the patch dict. Time rounds up to whole
    patches; the last patch is filled with the clip's minimum ("floor"), silence, or
    its last frame ("repeat"). Tokens run frequency-major."""
    if mel.ndim == 2:
        mel = mel[None]
    c, t, n_mels = mel.shape
    assert c == in_chans and n_mels % patch_freq == 0
    f = n_mels // patch_freq
    tt = max(1, math.ceil(t / patch_time))
    pad_frames = tt * patch_time - t
    if pad_frames > 0:
        if pad_mode == "repeat" and t > 0:
            tail = np.broadcast_to(mel[:, -1:, :], (c, pad_frames, n_mels))
        else:
            fill = float(mel.min()) if pad_mode == "floor" and t > 0 else MEL_SILENCE_DB
            tail = np.full((c, pad_frames, n_mels), fill, dtype=mel.dtype)
        mel = np.concatenate([mel, tail], axis=1)
    mel = mel.reshape(c, tt, patch_time, f, patch_freq).transpose(3, 1, 0, 4, 2)
    patches = np.ascontiguousarray(mel).reshape(f * tt, c * patch_freq * patch_time)
    freq_idx = np.repeat(np.arange(f), tt)
    time_idx = np.tile(np.arange(tt), f)
    return {
        "patches": patches.astype(np.float32),
        "patch_coord": np.stack([freq_idx, time_idx], axis=1).astype(np.int32),
        "patch_valid": np.ones(f * tt, dtype=bool),
    }


class AudioNaFlexPatchify:
    """(waveform, sample_rate) -> patch dict: a mono mix, a linear-interpolation
    resample to the config's rate, a pad to one window, the log-mel, a cap at
    ``max_audio_tokens`` by whole time columns, the patches, and a pad to
    ``max_audio_tokens``."""

    def __init__(self, cfg: AudioNaFlexCfg, max_audio_tokens: Optional[int] = None):
        if max_audio_tokens is not None and max_audio_tokens < cfg.freq_tokens:
            raise ValueError(f"max_audio_tokens={max_audio_tokens} < freq_tokens={cfg.freq_tokens}")
        self.cfg = cfg
        self.max_audio_tokens = max_audio_tokens

    def __call__(self, audio_data: Tuple[np.ndarray, int]) -> Dict[str, np.ndarray]:
        wav, sr = audio_data
        wav = np.asarray(wav, dtype=np.float32)
        if wav.ndim == 2:
            wav = wav.mean(axis=0)
        if sr != self.cfg.sample_rate:
            wav = resample_poly(wav, sr, self.cfg.sample_rate)
        if wav.shape[-1] < self.cfg.window_size:
            wav = np.pad(wav, (0, self.cfg.window_size - wav.shape[-1]))
        mel = _np_log_mel(wav, self.cfg)
        if self.max_audio_tokens is not None:
            max_time = max(1, self.max_audio_tokens // self.cfg.freq_tokens)
            mel = mel[:max_time * self.cfg.patch_time]
        out = mel_to_patches(mel, self.cfg.patch_freq, self.cfg.patch_time, self.cfg.in_chans,
                             pad_mode=self.cfg.patch_pad_mode)
        if self.max_audio_tokens is not None:
            out = pad_patch_dict(out, self.max_audio_tokens)
        return out


def pad_patch_dict(d: Dict[str, np.ndarray], n: int) -> Dict[str, np.ndarray]:
    """Cut or zero-pad (invalid) a patch dict to ``n`` tokens."""
    cur = d["patches"].shape[0]
    if cur >= n:
        return {k: v[:n] for k, v in d.items()}
    pad = n - cur
    return {
        "patches": np.concatenate([d["patches"], np.zeros((pad, d["patches"].shape[1]), np.float32)]),
        "patch_coord": np.concatenate([d["patch_coord"], np.zeros((pad, 2), np.int32)]),
        "patch_valid": np.concatenate([d["patch_valid"], np.zeros(pad, bool)]),
    }


def naflex_audio_eval_seq_len(cfg: AudioNaFlexCfg, seconds: float = 10.0) -> int:
    """The token count of ``seconds`` of audio."""
    d = AudioNaFlexPatchify(cfg)((np.zeros(int(round(seconds * cfg.sample_rate)), np.float32),
                                  cfg.sample_rate))
    return int(d["patches"].shape[0])
