"""Audio preprocessing and synthetic audio data, on the host (counterpart of
``open_clip_tpu/data/audio.py``).

``AudioPreprocess`` takes (waveform, sample rate) and gives the fixed-length clip
the HTSAT towers take: a mono mix, a linear-interpolation resample
(``resample_poly``), an optional int16 round trip, then truncation (a random window
in training, the start in evaluation) or filling (``repeatpad``, ``repeat``,
``pad``) to ``clip_samples``. Its output is a numpy dict ``{"waveform", "longer"}``;
the log-mel runs on the card inside the model. (The naflexvit towers take the mel
patch dicts of ``data/naflex_audio.py`` instead.) The fusion mode (``data_trunc=
"fusion"``, the four-view mel stack) is not ported and raises.

Real audio comes from webdataset tar shards (``make_wds_audio_pipeline``: a
caption and an audio member per sample) decoded by ``decode_audio_bytes``. WAV
decodes through a numpy RIFF reader that gives what ``scipy.io.wavfile.read`` gives
(8-bit unsigned, 16-, 24- and 32-bit PCM, 32- and 64-bit float, (C, T) for several
channels), scaled as the JAX package scales it: 16- and 32-bit (and 24-bit,
which reads as left-justified 32-bit) PCM to [-1, 1), anything else only cast to
float32, so 8-bit audio stays 0..255 (ROADMAP, faults of the reference). Other
codecs need a decoder library and raise.
"""

from __future__ import annotations

import random
import struct
from dataclasses import asdict, dataclass, is_dataclass
from typing import Any, Dict, Iterator, List, Optional, Tuple

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
    the JAX class makes them, as host tensors (the loop's prefetch pins them).
    ``preprocess`` is an ``AudioPreprocess`` or, for a naflexvit tower, an
    ``AudioNaFlexPatchify``."""

    def __init__(self, preprocess: AudioPreprocess, tokenizer, dataset_size: int = 100,
                 batch_size: int = 8, seconds: float = 2.0,
                 caption: str = "a synthetic tone for smoke testing"):
        sr = getattr(preprocess, "target_sr", None) or preprocess.cfg.sample_rate
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


_WAVE_FORMAT_PCM, _WAVE_FORMAT_FLOAT, _WAVE_FORMAT_EXTENSIBLE = 0x0001, 0x0003, 0xFFFE


def read_wav(data: bytes) -> Tuple[int, np.ndarray]:
    """(sample rate, samples) of a RIFF (or big-endian RIFX) WAV, as
    ``scipy.io.wavfile.read`` returns them: uint8, int16, int32 (24-bit samples
    left-justified in it), int64 (40- to 64-bit) or float32/float64, (T,) or
    (T, channels)."""
    head = data[:4]
    if head not in (b"RIFF", b"RIFX") or data[8:12] != b"WAVE":
        raise ValueError(f"not a WAV file (RIFF/RIFX header, WAVE type): {bytes(data[:12])!r}")
    end = "<" if head == b"RIFF" else ">"
    pos, fmt, samples = 12, None, None
    while pos + 8 <= len(data):
        cid = data[pos:pos + 4]
        size = struct.unpack(end + "I", data[pos + 4:pos + 8])[0]
        body = data[pos + 8:pos + 8 + size]
        if cid == b"fmt ":
            tag, channels, rate, _, block_align, bits = struct.unpack(end + "HHIIHH", body[:16])
            if tag == _WAVE_FORMAT_EXTENSIBLE and len(body) >= 40:
                tag = struct.unpack(end + "H", body[24:26])[0]  # the subformat GUID's tag
            fmt = (tag, channels, rate, block_align, bits)
        elif cid == b"data":
            if fmt is None:
                raise ValueError("WAV data chunk before its fmt chunk")
            samples = body
            break
        pos += 8 + size + (size & 1)  # chunks are word-aligned
    if fmt is None or samples is None:
        raise ValueError("WAV file without a fmt and a data chunk")
    tag, channels, rate, block_align, bits = fmt
    width = block_align // channels
    if tag == _WAVE_FORMAT_FLOAT and width in (4, 8):
        wav = np.frombuffer(samples, dtype=f"{end}f{width}", count=len(samples) // width)
    elif tag == _WAVE_FORMAT_PCM and width in (1, 2, 4):
        dtype = "u1" if width == 1 else f"{end}i{width}"
        wav = np.frombuffer(samples, dtype=dtype, count=len(samples) // width)
    elif tag == _WAVE_FORMAT_PCM and width in (3, 5, 6, 7):
        # left-justified in the next wider integer, as scipy reads them
        wide = 4 if width == 3 else 8
        n = len(samples) // width
        raw = np.frombuffer(samples, dtype=np.uint8, count=n * width).reshape(n, width)
        buf = np.zeros((n, wide), dtype=np.uint8)
        if end == "<":
            buf[:, wide - width:] = raw
        else:
            buf[:, :width] = raw
        wav = buf.view(f"{end}i{wide}").reshape(n)
    elif tag == _WAVE_FORMAT_PCM and width == 8:
        wav = np.frombuffer(samples, dtype=f"{end}i8", count=len(samples) // 8)
    else:
        raise ValueError(f"unsupported WAV format: tag {tag:#06x}, {bits} bits in {width} bytes")
    wav = wav.astype(wav.dtype.newbyteorder("="))
    if channels > 1:
        wav = wav[:len(wav) // channels * channels].reshape(-1, channels)
    return rate, wav


def decode_audio_bytes(data: bytes, ext: str) -> Tuple[np.ndarray, int]:
    """(float32 waveform, (T,) or (C, T), sample rate) of an audio member. WAV only:
    16- and 32-bit PCM scaled to [-1, 1), other sample types cast to float32 as they
    are. Other codecs raise, as the JAX package does without its decoder library."""
    if ext in ("wav",):
        sr, wav = read_wav(data)
        if wav.dtype == np.int16:
            wav = wav.astype(np.float32) / 32768.0
        elif wav.dtype == np.int32:
            wav = wav.astype(np.float32) / 2147483648.0
        else:
            wav = wav.astype(np.float32)
        if wav.ndim == 2:
            wav = wav.T  # (C, T)
        return wav, sr
    raise RuntimeError(f"cannot decode .{ext} audio without soundfile")


def make_wds_audio_pipeline(cfg, preprocess, tokenizer, audio_ext: Optional[str] = None):
    """The webdataset pipeline with an audio member in place of the image: batches
    ``{"audio": {key: (B, ...) tensor}, "text": (B, L) int32}`` of CPU tensors, in
    the JAX pipeline's order (the shard order of ``WdsPipeline``, the same
    swap-shuffle buffer, one stream). ``audio_ext`` is the preferred member suffix;
    the other audio suffixes still match. A sample that fails to decode or
    preprocess is skipped without a word, as in the JAX package (ROADMAP, faults of
    the reference)."""
    from .wds import AUDIO_EXTS, WdsPipeline, extract_caption, iterate_tar_samples

    exts = ((audio_ext,) if audio_ext else ()) + tuple(e for e in AUDIO_EXTS if e != audio_ext)

    class AudioWds(WdsPipeline):
        def _audio_samples(self, epoch: int) -> Iterator[Dict[str, Any]]:
            rng = random.Random(self.cfg.seed * 7919 + epoch)
            buf: List[Dict[str, Any]] = []
            for shard in self._my_shards(epoch):
                for sample in iterate_tar_samples(shard):
                    caption = extract_caption(sample, self.cfg.caption_key)
                    pair = next(((sample[e], e) for e in exts if e in sample), None)
                    if caption is None or pair is None:
                        continue
                    rec = {"audio_bytes": pair[0], "audio_ext": pair[1], "caption": caption}
                    if self.cfg.shuffle_samples:
                        if len(buf) < self.cfg.shuffle_samples:
                            buf.append(rec)
                            continue
                        idx = rng.randrange(len(buf))
                        buf[idx], rec = rec, buf[idx]
                    yield rec
            rng.shuffle(buf)
            yield from buf

        def __iter__(self) -> Iterator[Dict[str, Any]]:
            auds, caps = [], []
            for rec in self._audio_samples(self.epoch):
                try:
                    out = self.preprocess(decode_audio_bytes(rec["audio_bytes"], rec["audio_ext"]))
                except Exception:  # noqa: BLE001 — the JAX pipeline's fault tolerance
                    continue
                auds.append(out)
                caps.append(rec["caption"])
                if len(auds) == self.cfg.batch_size:
                    yield self._collate_audio(auds, caps)
                    auds, caps = [], []
            if auds and self.cfg.partial_batches:
                yield self._collate_audio(auds, caps)

        def _collate_audio(self, auds, caps) -> Dict[str, Any]:
            return {"audio": collate_audio(auds), "text": torch.from_numpy(self._tokens(caps))}

    return AudioWds(cfg, preprocess, tokenizer)
