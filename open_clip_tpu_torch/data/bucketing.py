"""Length bucketing of a sample stream (counterpart of ``open_clip_tpu/data/bucketing.py``).

The stream is reordered so that samples of similar length sit together, which
cuts the padding of token-budget NaFlex batches. Only the order changes: the
samples and the number of steps stay. The bucketer pools ``pool`` samples, sorts
them by the sum of its length functions, cuts the sorted pool into runs of
``chunk`` and shuffles the runs with ``random.Random(seed + epoch * 131)``, so
that an epoch's order is a function of (seed, epoch) and the stream, the JAX
package's order for the same inputs. With ``prefetch_pools`` a background thread
fills and sorts the pools ahead of the consumer; an exception there is raised in
the consumer.
"""

from __future__ import annotations

import math
import queue
import random
import struct
import threading
from typing import Callable, Dict, Iterable, List, Optional, Sequence

import numpy as np

Sample = Dict[str, object]


class CaptionLength:
    """The caption's token count: a token array's last dimension, or the number of
    non-zero ids that ``tokenizer`` gives a text (its padding id is 0)."""

    def __init__(self, key: str = "caption", tokenizer: Optional[Callable] = None):
        self.key = key
        self.tokenizer = tokenizer

    def __call__(self, sample: Sample) -> int:
        value = sample.get(self.key)
        if value is None:
            return 0
        if hasattr(value, "shape"):
            return int(value.shape[-1] if value.ndim else 0)
        if isinstance(value, (bytes, str)) and self.tokenizer is not None:
            text = value.decode("utf-8", "ignore") if isinstance(value, bytes) else value
            return int((np.asarray(self.tokenizer([text]))[0] != 0).sum())
        return len(value) if hasattr(value, "__len__") else 0


def _wav_header_frames(raw: bytes):
    """(frames, sample rate) from a RIFF/WAVE header, or None. The bucketer runs
    before the decode, so lengths come from the header; other containers give None."""
    if len(raw) < 44 or raw[:4] != b"RIFF" or raw[8:12] != b"WAVE":
        return None
    pos = 12
    sample_rate = None
    block_align = None
    while pos + 8 <= len(raw):
        cid = raw[pos:pos + 4]
        size = struct.unpack_from("<I", raw, pos + 4)[0]
        if cid == b"fmt " and pos + 24 <= len(raw):
            sample_rate = struct.unpack_from("<I", raw, pos + 12)[0]
            block_align = struct.unpack_from("<H", raw, pos + 20)[0]
        elif cid == b"data" and sample_rate and block_align:
            return size // max(block_align, 1), sample_rate
        pos += 8 + size + (size & 1)
    return None


class AudioTokenLength:
    """The NaFlex audio-patch count of a clip before the patchify: frames at the
    target rate, time patches rounded up, times the frequency patches, at most
    ``max_audio_tokens`` (0: no cap)."""

    def __init__(self, audio_key: str = "audio", freq_tokens: int = 1, patch_time: int = 1,
                 hop_size: int = 1, window_size: int = 0, sample_rate: int = 0,
                 max_audio_tokens: int = 0):
        self.audio_key = audio_key
        self.freq_tokens = max(1, int(freq_tokens))
        self.patch_time = max(1, int(patch_time))
        self.hop_size = max(1, int(hop_size))
        self.window_size = max(0, int(window_size))
        self.sample_rate = int(sample_rate)
        self.max_audio_tokens = max(0, int(max_audio_tokens))

    def __call__(self, sample: Sample) -> int:
        audio = sample.get(self.audio_key)
        if isinstance(audio, (bytes, bytearray)):
            parsed = _wav_header_frames(bytes(audio))
            if parsed is None:
                return 0
            num_samples, sr = parsed
        elif isinstance(audio, (tuple, list)) and audio and hasattr(audio[0], "shape"):
            num_samples, sr = audio[0].shape[-1], (audio[1] if len(audio) > 1 else 0)
        elif hasattr(audio, "shape"):
            num_samples, sr = audio.shape[-1], 0
        else:
            return 0
        if self.sample_rate and sr and sr != self.sample_rate:
            num_samples = num_samples * self.sample_rate / sr
        num_samples = max(num_samples, self.window_size)
        frames = int(num_samples // self.hop_size) + 1
        tokens = self.freq_tokens * max(1, math.ceil(frames / self.patch_time))
        return min(tokens, self.max_audio_tokens) if self.max_audio_tokens else tokens


class LengthBucketer:
    """Pool, sort by summed length, chunk, shuffle the chunks with a (seed, epoch)
    generator; ``set_epoch`` selects the epoch."""

    def __init__(self, length_fns: Optional[Sequence[Callable[[Sample], int]]] = None,
                 pool: int = 2048, chunk: int = 128, seed: int = 42, prefetch_pools: int = 0):
        self.length_fns = list(length_fns) if length_fns else [CaptionLength()]
        self.pool = max(1, int(pool))
        self.chunk = max(1, int(chunk))
        self.seed = int(seed)
        self.epoch = 0
        self.prefetch_pools = max(0, int(prefetch_pools))

    def set_epoch(self, epoch: int) -> None:
        self.epoch = int(epoch)

    def _length(self, sample: Sample) -> int:
        return sum(fn(sample) for fn in self.length_fns)

    def _flush(self, buffer: List[Sample], rng: random.Random) -> List[Sample]:
        buffer.sort(key=self._length)  # stable: equal lengths keep the stream's order
        chunks = [buffer[i:i + self.chunk] for i in range(0, len(buffer), self.chunk)]
        rng.shuffle(chunks)
        return [s for chunk in chunks for s in chunk]

    def _pools(self, src: Iterable[Sample], rng: random.Random, stop=None):
        buffer: List[Sample] = []
        for sample in src:
            if stop is not None and stop.is_set():
                return
            buffer.append(sample)
            if len(buffer) >= self.pool:
                yield self._flush(buffer, rng)
                buffer = []
        if buffer:
            yield self._flush(buffer, rng)

    def __call__(self, src: Iterable[Sample]):
        rng = random.Random(self.seed + self.epoch * 131)
        if self.prefetch_pools > 0:
            yield from _prefetch(lambda stop: self._pools(src, rng, stop),
                                 maxsize=self.prefetch_pools)
            return
        for pool in self._pools(src, rng):
            yield from pool


def _prefetch(make_pools: Callable, maxsize: int, poll: float = 1.0):
    """Pools made on a background thread, drained through a queue of ``maxsize``;
    the thread's exception is raised here once its pools are drained."""
    pending: "queue.Queue" = queue.Queue(maxsize=maxsize)
    stop = threading.Event()
    box: Dict[str, BaseException] = {}
    sentinel = object()

    def put(item) -> bool:
        while True:
            try:
                pending.put(item, timeout=poll)
                return True
            except queue.Full:
                if stop.is_set():
                    return False

    def producer():
        try:
            for pool in make_pools(stop):
                if not put(pool):
                    return
        except BaseException as e:  # noqa: BLE001 — raised on the consumer side
            box["exc"] = e
        finally:
            put(sentinel)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        while True:
            pool = pending.get()
            if pool is sentinel:
                break
            yield from pool
    finally:
        stop.set()
        try:
            while True:
                pending.get_nowait()
        except queue.Empty:
            pass
    if "exc" in box:
        raise box["exc"]
