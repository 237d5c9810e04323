"""Audio preprocessing and synthetic audio data, on the host (counterpart of
``open_clip_tpu/data/audio.py``).

``AudioPreprocess`` takes (waveform, sample rate) and gives the fixed-length clip
the HTSAT towers take: a mono mix, a linear-interpolation resample
(``resample_poly``), an optional int16 round trip, then truncation (a random window
in training, the start in evaluation) or filling (``repeatpad``, ``repeat``,
``pad``) to ``clip_samples``. Its output is a numpy dict ``{"waveform", "longer"}``;
the log-mel runs on the card inside the model. The fusion mode (``data_trunc=
"fusion"``, the four-view mel stack) and the webdataset audio pipeline are not
ported and raise.
"""

from __future__ import annotations

import random
from dataclasses import asdict, dataclass, is_dataclass
from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch


@dataclass
class AudioAugmentationCfg:
    data_trunc: str = "rand_trunc"
    data_fill: str = "repeatpad"
    enable_fusion: bool = False
    int16_normalize: bool = False


def _cfg_dict(audio_cfg) -> Dict[str, Any]:
    return asdict(audio_cfg) if is_dataclass(audio_cfg) else dict(audio_cfg)


def int16_roundtrip(x: np.ndarray) -> np.ndarray:
    x = np.clip(x, -1.0, 1.0)
    return ((x * 32767.0).astype(np.int16) / 32767.0).astype(np.float32)


def resample_poly(wav: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Linear-interpolation resample (the JAX package's host resampler)."""
    if sr_in == sr_out:
        return wav
    n_out = int(round(len(wav) * sr_out / sr_in))
    x_out = np.arange(n_out) * (sr_in / sr_out)
    return np.interp(x_out, np.arange(len(wav)), wav).astype(np.float32)


class AudioPreprocess:
    """(waveform, sr) -> {"waveform": (clip_samples,) float32, "longer": bool}."""

    def __init__(self, audio_cfg, data_fill: str = "repeatpad", data_trunc: str = "rand_trunc",
                 int16_normalize: bool = False):
        if data_trunc == "fusion":
            raise NotImplementedError("audio fusion (data_trunc='fusion') is not ported yet")
        if data_trunc not in ("rand_trunc", "trunc"):
            raise ValueError(f"unsupported audio truncation mode {data_trunc!r}")
        if data_fill not in ("repeat", "repeatpad", "pad"):
            raise ValueError(f"unsupported audio fill mode {data_fill!r}")
        self.cfg = _cfg_dict(audio_cfg)
        self.data_fill = data_fill
        self.data_trunc = data_trunc
        self.int16_normalize = int16_normalize
        self.target_sr = self.cfg.get("sample_rate", 48000)
        self.clip_samples = self.cfg.get("clip_samples", 480000)

    def _fill(self, wav: np.ndarray) -> np.ndarray:
        n = self.clip_samples
        if self.data_fill == "repeat":
            return np.tile(wav, int(np.ceil(n / len(wav))))[:n]
        if self.data_fill == "repeatpad":
            wav = np.tile(wav, max(n // len(wav), 1))
        return np.pad(wav, (0, n - len(wav)))

    def __call__(self, audio_data: Tuple[np.ndarray, int]) -> Dict[str, np.ndarray]:
        wav, sr = audio_data
        wav = np.asarray(wav, dtype=np.float32)
        if wav.ndim == 2:
            wav = wav.mean(axis=0)
        if sr != self.target_sr:
            wav = resample_poly(wav, sr, self.target_sr)
        if self.int16_normalize:
            wav = int16_roundtrip(wav)
        n = self.clip_samples
        if len(wav) > n:
            start = random.randint(0, len(wav) - n) if self.data_trunc == "rand_trunc" else 0
            wav, longer = wav[start:start + n], True
        else:
            wav, longer = self._fill(wav), False
        return {"waveform": wav.astype(np.float32), "longer": np.asarray(longer)}


def audio_transform_v2(audio_cfg, is_train: bool = False, audio_aug_cfg=None) -> AudioPreprocess:
    """The training transform truncates at random, the evaluation one at the start."""
    cfg = _cfg_dict(audio_cfg)
    if isinstance(audio_aug_cfg, dict):
        audio_aug_cfg = AudioAugmentationCfg(**audio_aug_cfg)
    elif audio_aug_cfg is None:
        audio_aug_cfg = AudioAugmentationCfg()
    if audio_aug_cfg.enable_fusion or cfg.get("enable_fusion", False):
        raise NotImplementedError("audio fusion is not ported yet")
    return AudioPreprocess(cfg, data_fill=audio_aug_cfg.data_fill,
                           data_trunc=audio_aug_cfg.data_trunc if is_train else "trunc",
                           int16_normalize=audio_aug_cfg.int16_normalize)


def collate_audio(samples) -> Dict[str, torch.Tensor]:
    """AudioPreprocess outputs -> {"waveform": (B, T) float32, "longer": (B,) bool}."""
    return {k: torch.from_numpy(np.stack([s[k] for s in samples])) for k in samples[0]}


class SyntheticAudioDataset:
    """A 440 Hz tone of ``seconds`` and one fixed caption, repeated over the batch, as
    the JAX class makes them, as host tensors (the loop's prefetch pins them)."""

    def __init__(self, preprocess: AudioPreprocess, tokenizer, dataset_size: int = 100,
                 batch_size: int = 8, seconds: float = 2.0,
                 caption: str = "a synthetic tone for smoke testing"):
        sr = preprocess.target_sr
        t = np.arange(int(sr * seconds)) / sr
        wav = (0.1 * np.sin(2 * np.pi * 440.0 * t)).astype(np.float32)
        sample = preprocess((wav, sr))
        self.batch_size = batch_size
        self.num_samples = dataset_size
        text = torch.as_tensor(np.asarray(tokenizer([caption]), dtype=np.int32))
        self._batch = {"audio": collate_audio([sample] * batch_size),
                       "text": text.expand(batch_size, -1).contiguous()}

    def set_epoch(self, epoch: int) -> None:
        pass

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        for _ in range(max(1, self.num_samples // self.batch_size)):
            yield {"audio": {k: v.clone() for k, v in self._batch["audio"].items()},
                   "text": self._batch["text"].clone()}


def make_wds_audio_pipeline(*args, **kwargs):
    raise NotImplementedError("the webdataset audio pipeline is not ported yet "
                              "(--dataset-type synthetic-audio is)")
