"""Audio front end: STFT, mel filter banks and the CLAP log-mel spectrogram
(counterpart of ``open_clip_tpu/ops/audio.py``).

The filter banks are the JAX package's numpy (librosa conventions: slaney mel scale
and area normalisation by default, HTK on request), built once per configuration.
The STFT is one fp32 product of the reflect-padded frames with a windowed
real-DFT basis, as in the JAX package, which runs it at ``Precision.HIGHEST``
because the power spectrum squares every error: here that product and the mel
product run under ``true_fp32``, which turns TF32 off for them whatever the
caller's settings. On the card they are cuBLAS products of tensors made on the
card; the waveform never goes back to the host.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def hz_to_mel(f, htk: bool = False):
    f = np.asanyarray(f, dtype=np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + f / 700.0)
    # slaney: linear below 1 kHz, logarithmic above
    f_min, f_sp = 0.0, 200.0 / 3
    mel = (f - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(f >= min_log_hz,
                    min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep, mel)


def mel_to_hz(m, htk: bool = False):
    m = np.asanyarray(m, dtype=np.float64)
    if htk:
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * m
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs)


@functools.lru_cache(maxsize=16)
def mel_filter_bank(sample_rate: int, n_fft: int, n_mels: int, fmin: float = 0.0,
                    fmax: Optional[float] = None, htk: bool = False,
                    norm: Optional[str] = "slaney") -> np.ndarray:
    """(n_mels, n_fft//2 + 1) triangular filter bank, librosa.filters.mel semantics."""
    fmax = fmax if fmax is not None else sample_rate / 2.0
    n_freqs = n_fft // 2 + 1
    fft_freqs = np.linspace(0.0, sample_rate / 2.0, n_freqs)
    mel_pts = np.linspace(hz_to_mel(fmin, htk), hz_to_mel(fmax, htk), n_mels + 2)
    hz_pts = mel_to_hz(mel_pts, htk)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    if norm == "slaney":
        weights *= (2.0 / (hz_pts[2:n_mels + 2] - hz_pts[:n_mels]))[:, None]
    return weights.astype(np.float32)


def _hann_window(n_fft: int, win_length: int) -> np.ndarray:
    """Periodic Hann of ``win_length``, zero-padded centred to ``n_fft``."""
    window = np.hanning(win_length + 1)[:-1].astype(np.float32)
    if win_length < n_fft:
        pad = (n_fft - win_length) // 2
        window = np.pad(window, (pad, n_fft - win_length - pad))
    return window


@functools.lru_cache(maxsize=16)
def _dft_basis(n_fft: int, win_length: int) -> np.ndarray:
    """(n_fft, 2 * n_bins) windowed real-DFT basis, [cos | -sin] columns: ``frames @
    basis`` gives [Re(rfft(frames * window)) | Im(...)]."""
    n_bins = n_fft // 2 + 1
    k = np.arange(n_fft)[:, None]
    f = np.arange(n_bins)[None, :]
    ang = 2.0 * np.pi * k * f / n_fft
    window = _hann_window(n_fft, win_length)[:, None].astype(np.float64)
    return np.concatenate([np.cos(ang) * window, -np.sin(ang) * window], axis=1).astype(np.float32)


_CONSTANTS = {}


def _on(array: np.ndarray, device: torch.device, key) -> torch.Tensor:
    """A numpy table as a tensor on ``device``, made once per (table, device) (as a
    normal tensor even under ``inference_mode``, so that training can use it later)."""
    t = _CONSTANTS.get((key, device))
    if t is None:
        with torch.inference_mode(False):
            t = _CONSTANTS[(key, device)] = torch.from_numpy(array).to(device)
    return t


@contextlib.contextmanager
def true_fp32():
    """fp32 products in full fp32 (no TF32) inside the block, restored after it."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def frame_signal(x: torch.Tensor, n_fft: int, hop_length: int) -> torch.Tensor:
    """(..., T) -> (..., n_frames, n_fft) overlapping frames, a strided view."""
    return x.unfold(-1, n_fft, hop_length)


def stft_magnitude(audio: torch.Tensor, n_fft: int, hop_length: int,
                   win_length: Optional[int] = None, center: bool = True, power: float = 2.0,
                   pad_mode: str = "reflect") -> torch.Tensor:
    """|STFT|^power with a periodic Hann window, torch.stft conventions:
    (..., T) -> (..., n_frames, n_fft//2 + 1), fp32, the DFT as one true-fp32 product."""
    win_length = win_length or n_fft
    x = audio.float()
    if center:
        lead = x.shape[:-1]
        pad = n_fft // 2
        x = F.pad(x.reshape(-1, 1, x.shape[-1]), (pad, pad), mode=pad_mode).reshape(*lead, -1)
    frames = frame_signal(x, n_fft, hop_length)
    basis = _on(_dft_basis(n_fft, win_length), x.device, ("dft", n_fft, win_length))
    with true_fp32():
        spec = frames @ basis
    n_bins = n_fft // 2 + 1
    mag2 = spec[..., :n_bins] ** 2 + spec[..., n_bins:] ** 2
    if power == 2.0:
        return mag2
    mag = torch.sqrt(mag2.clamp_min(0.0))
    return mag if power == 1.0 else mag ** power


def log_mel_clap(audio: torch.Tensor, sample_rate: int = 48000, n_fft: int = 1024,
                 hop_length: int = 480, n_mels: int = 64, fmin: float = 50, fmax: float = 14000,
                 ref: float = 1.0, amin: float = 1e-10,
                 top_db: Optional[float] = None) -> torch.Tensor:
    """CLAP/HTSAT log-mel (torchlibrosa Spectrogram + LogmelFilterBank semantics: power
    spectrogram, slaney mel, 10*log10 power to dB): (..., T) -> (..., n_frames, n_mels)."""
    mag2 = stft_magnitude(audio, n_fft=n_fft, hop_length=hop_length, center=True, power=2.0)
    filters = _on(mel_filter_bank(sample_rate, n_fft, n_mels, fmin, fmax), mag2.device,
                  ("mel", sample_rate, n_fft, n_mels, fmin, fmax))
    with true_fp32():
        mel = mag2 @ filters.T
    db = 10.0 * torch.log10(mel.clamp_min(amin))
    db = db - 10.0 * float(np.log10(max(amin, ref)))
    if top_db is not None:
        db = torch.maximum(db, db.amax(dim=(-2, -1), keepdim=True) - top_db)
    return db
