"""WebDataset-format tar pipeline on the host (counterpart of ``open_clip_tpu/data/wds.py``).

Brace-expanded shard lists with ``::`` sources and weights, the shard order of
(seed, epoch), the rank and worker split, a seeded sample shuffle buffer, resampled
mode, nothrow tar reading, and ``epoch_batches`` that caps and pads every rank's
epoch to the same number of steps: the JAX pipeline's samples in its order.

Images go through the host stage of ``transform.py`` (JPEG bytes -> uint8, or the
val stage's normalized float32) on the native decoder (``native/``). With
``native_decode_threads > 0`` whole batches decode on that many threads of the
library in this process; otherwise ``num_workers > 1`` forks decode workers. A
non-zero decode status is a counted decode failure (too many in a row raise); a
sample whose image is not a JPEG raises ``NotImplementedError`` with its key, since
there is no PIL tier to decode it. Batches are ``{"image", "text"}`` CPU tensors;
``device_prefetch`` pins them in this process and copies them to the model's device
without blocking, from a background thread. Workers never touch CUDA, so the
nvJPEG decoder (which runs on the card) refuses forked workers.
"""

from __future__ import annotations

import json
import logging
import os
import queue as queue_mod
import random
import re
import tarfile
import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

logger = logging.getLogger(__name__)

_BRACE_RE = re.compile(r"\{(\d+)\.\.(\d+)\}")
ERROR_LOG_EVERY = 100

IMAGE_EXTS = ("jpg", "jpeg", "png", "webp", "bmp", "tiff")
JPEG_EXTS = ("jpg", "jpeg")
AUDIO_EXTS = ("flac", "wav", "mp3", "ogg", "m4a")
TEXT_EXTS = ("txt", "text", "caption")


def _brace_expand(url: str) -> List[str]:
    """Expand '{00000..00099}' ranges (the webdataset shard-list convention)."""
    m = _BRACE_RE.search(url)
    if not m:
        return [url]
    lo, hi = m.group(1), m.group(2)
    out = []
    for i in range(int(lo), int(hi) + 1):
        out.extend(_brace_expand(url[: m.start()] + str(i).zfill(len(lo)) + url[m.end():]))
    return out


def expand_urls(urls, weights: Optional[str] = None) -> Tuple[List[str], Optional[List[float]]]:
    """'::'-separated sources, each brace-expanded; a source's weight applies to each
    of its shards, so a source's sampling mass is its weight times its shard count."""
    if not isinstance(urls, str):
        return list(urls), None
    sources = urls.split("::")
    wlist = weights.split("::") if weights is not None else None
    if wlist is not None and len(wlist) != len(sources):
        raise ValueError(f"{len(wlist)} weights for {len(sources)} shard sources")
    all_urls: List[str] = []
    all_weights: List[float] = []
    for i, src in enumerate(sources):
        expanded = _brace_expand(src)
        all_urls.extend(expanded)
        if wlist is not None:
            all_weights.extend([float(wlist[i])] * len(expanded))
    return all_urls, (all_weights if wlist is not None else None)


def get_dataset_size(shards) -> Tuple[Optional[int], int]:
    """(samples from a ``sizes.json`` or ``__len__`` beside the shards or None, shards)."""
    shards_list, _ = expand_urls(shards)
    dirname = os.path.dirname(shards_list[0])
    total = None
    sizes_path = os.path.join(dirname, "sizes.json")
    len_path = os.path.join(dirname, "__len__")
    if os.path.exists(sizes_path):
        with open(sizes_path) as fh:
            sizes = json.load(fh)
        total = sum(int(sizes[os.path.basename(s)]) for s in shards_list
                    if os.path.basename(s) in sizes)
    elif os.path.exists(len_path):
        with open(len_path) as fh:
            total = int(fh.read())
    return total, len(shards_list)


def iterate_tar_samples(path: str) -> Iterator[Dict[str, Any]]:
    """Tar members grouped by basename -> {'__key__', '__url__', ext: bytes}. A corrupt
    shard logs and stops; the samples read before the fault are kept."""
    try:
        with tarfile.open(path, mode="r|*") as tf:
            current_key = None
            sample: Dict[str, Any] = {}
            for member in tf:
                if not member.isfile() or member.name.startswith("."):
                    continue
                base, dot, ext = member.name.partition(".")
                if not dot:
                    continue
                if base != current_key:
                    if current_key is not None and sample:
                        yield sample
                    current_key = base
                    sample = {"__key__": base, "__url__": path}
                data = tf.extractfile(member)
                if data is not None:
                    sample[ext.lower()] = data.read()
            if current_key is not None and sample:
                yield sample
    except (tarfile.TarError, OSError) as e:
        logger.warning("tar shard %s failed: %r — skipping rest of shard", path, e)


def extract_caption(sample: Dict[str, Any], caption_key: str = "txt") -> Optional[str]:
    """The caption of a sample: a member ('txt'), a json field ('json:field') or a
    weighted choice of json fields ('json:a=2::b=1')."""
    if caption_key.startswith("json"):
        _, _, spec = caption_key.partition(":")
        blob = sample.get("json")
        if blob is None:
            return None
        obj = json.loads(blob)
        if not spec:
            return obj.get("caption") or obj.get("text")
        fields, weights = [], []
        for part in spec.split("::"):
            name, _, w = part.partition("=")
            fields.append(name)
            weights.append(float(w) if w else 1.0)
        avail = [(f, w) for f, w in zip(fields, weights) if obj.get(f)]
        if not avail:
            return None
        names, ws = zip(*avail)
        return obj[random.choices(names, weights=ws)[0]]
    for k in (caption_key, *TEXT_EXTS):
        if k in sample:
            v = sample[k]
            return v.decode("utf-8") if isinstance(v, bytes) else str(v)
    return None


def check_jpeg(key: str, ext: str) -> None:
    """Raise for an image member the native stage cannot decode."""
    if ext not in JPEG_EXTS:
        raise NotImplementedError(
            f"sample {key!r}: image member '.{ext}' is not a JPEG; only JPEG images are "
            "decoded (by the native stage; there is no PIL tier)")


@dataclass
class WdsConfig:
    urls: str = ""
    weights: Optional[str] = None
    resampled: bool = False
    shuffle_shards: int = 2000
    shuffle_samples: int = 5000
    batch_size: int = 64
    caption_key: str = "txt"
    seed: int = 0
    world_size: int = 1
    rank: int = 0
    num_workers: int = 2
    partial_batches: bool = False
    max_consecutive_failures: int = 10
    # > 0: decode whole batches on this many threads of the native library, in this
    # process and in the single-stream order (needs a stage with ``native_canvas``)
    native_decode_threads: int = 0
    # cap and pad each epoch to exactly this many batches; None: the shards' content
    epoch_batches: Optional[int] = None


class WdsPipeline:
    """Batches ``{"image": (B, H, W, 3) uint8 or float32, "text": (B, L) int32}`` of CPU
    tensors from tar shards. The shard order is a function of (seed, epoch); shards
    split over ranks, then over workers, round-robin."""

    def __init__(self, cfg: WdsConfig, preprocess: Callable, tokenizer: Callable):
        self.cfg = cfg
        self.preprocess = preprocess  # JPEG bytes -> HWC array
        self.tokenizer = tokenizer
        self.urls, self.weights = expand_urls(cfg.urls, cfg.weights)
        if not self.urls:
            raise ValueError("no shards found")
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _shard_order(self, epoch: int) -> List[str]:
        rng = random.Random(self.cfg.seed + epoch)
        if self.cfg.resampled:
            n = max(len(self.urls), 1)
            if self.weights:
                return rng.choices(self.urls, weights=self.weights, k=n)
            return rng.choices(self.urls, k=n)
        order = list(self.urls)
        if self.cfg.shuffle_shards:
            rng.shuffle(order)
        return order

    def _my_shards(self, epoch: int) -> List[str]:
        order = self._shard_order(epoch)
        return order[self.cfg.rank:: self.cfg.world_size] or order[:1]

    def _samples(self, epoch: int, worker_id: int = 0, num_workers: int = 1
                 ) -> Iterator[Dict[str, Any]]:
        rng = random.Random(self.cfg.seed * 7919 + epoch * 131 + worker_id)
        buf: List[Dict[str, Any]] = []
        shards = self._my_shards(epoch)
        if num_workers > 1:
            shards = shards[worker_id::num_workers]
        for shard in shards:
            for sample in iterate_tar_samples(shard):
                caption = extract_caption(sample, self.cfg.caption_key)
                ext = next((e for e in IMAGE_EXTS if e in sample), None)
                if caption is None or ext is None:
                    continue
                rec = {"image_bytes": sample[ext], "ext": ext, "caption": caption,
                       "__key__": sample["__key__"]}
                if self.cfg.shuffle_samples:
                    if len(buf) < self.cfg.shuffle_samples:
                        buf.append(rec)
                        continue
                    idx = rng.randrange(len(buf))
                    buf[idx], rec = rec, buf[idx]
                yield rec
        rng.shuffle(buf)
        yield from buf

    def _one_pass(self, epoch: int) -> Iterator[Dict[str, np.ndarray]]:
        if self.cfg.native_decode_threads > 0 and getattr(self.preprocess, "native_canvas", None):
            return self._batches_native(epoch)
        if self.cfg.num_workers > 1:
            return _multiprocess_batches(self, epoch, self.cfg.num_workers)
        return self._batches_for_worker(epoch, 0, 1)

    def _passes(self) -> Iterator[Dict[str, np.ndarray]]:
        """The epoch's numpy batches; with ``epoch_batches`` exactly that many, a short
        pass continuing into a reshuffled pass keyed off a shifted epoch."""
        n = self.cfg.epoch_batches
        if not n:
            yield from self._one_pass(self.epoch)
            return
        count = 0
        for cycle in range(1000):  # bound: a pass yielding 1 batch at n=1000
            got = False
            for b in self._one_pass(self.epoch + cycle * 7919):
                got = True
                yield b
                count += 1
                if count >= n:
                    return
            if not got:
                raise RuntimeError(
                    "webdataset stream produced no batches for this rank/worker split "
                    f"(epoch {self.epoch}); cannot pad to epoch_batches={n}")

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        for batch in self._passes():
            yield {k: torch.from_numpy(v) for k, v in batch.items()}

    def _count_failure(self, failures: int, err) -> int:
        failures += 1
        if failures % ERROR_LOG_EVERY == 1:
            logger.warning("decode failure (%d consecutive): %s", failures, err)
        if failures >= self.cfg.max_consecutive_failures:
            raise RuntimeError(f"{failures} consecutive decode failures (last: {err})")
        return failures

    def _batches_native(self, epoch: int) -> Iterator[Dict[str, np.ndarray]]:
        """Whole batches through the library's thread pool (the GIL is released), in
        the single-worker stream order. Failed slots drop out; the next chunk tops
        the batch back up to ``batch_size``."""
        from ..native import decode_resize_batch

        cfg = self.cfg
        canvas = int(self.preprocess.native_canvas)
        images: List[np.ndarray] = []
        captions: List[str] = []
        chunk_bytes: List[bytes] = []
        chunk_caps: List[str] = []
        failures = 0

        def flush():
            nonlocal failures
            decoded, status = decode_resize_batch(chunk_bytes, canvas,
                                                  nthreads=cfg.native_decode_threads)
            whole = None
            if not images and len(status) == cfg.batch_size and not any(status):
                failures = 0  # a clean batch ships as the library's buffer, uncopied
                whole = {"image": decoded, "text": self._tokens(chunk_caps)}
            else:
                for i, rc in enumerate(status):
                    if rc == 0:
                        images.append(decoded[i])
                        captions.append(chunk_caps[i])
                        failures = 0
                    else:
                        failures = self._count_failure(failures, f"native status {rc}")
            chunk_bytes.clear()
            chunk_caps.clear()
            return whole

        for rec in self._samples(epoch, 0, 1):
            check_jpeg(rec["__key__"], rec["ext"])
            chunk_bytes.append(bytes(rec["image_bytes"]))
            chunk_caps.append(rec["caption"])
            if len(chunk_bytes) + len(images) >= cfg.batch_size:
                whole = flush()
                if whole is not None:
                    yield whole
            while len(images) >= cfg.batch_size:
                yield self._collate(images[:cfg.batch_size], captions[:cfg.batch_size])
                del images[:cfg.batch_size]
                del captions[:cfg.batch_size]
        if chunk_bytes:
            whole = flush()
            if whole is not None:
                yield whole
        while len(images) >= cfg.batch_size:
            yield self._collate(images[:cfg.batch_size], captions[:cfg.batch_size])
            del images[:cfg.batch_size]
            del captions[:cfg.batch_size]
        if images and cfg.partial_batches:
            yield self._collate(images, captions)

    def _batches_for_worker(self, epoch: int, worker_id: int, num_workers: int
                            ) -> Iterator[Dict[str, np.ndarray]]:
        """One image at a time through the stage, over this worker's shards."""
        cfg = self.cfg
        images: List[np.ndarray] = []
        captions: List[str] = []
        failures = 0
        for rec in self._samples(epoch, worker_id, num_workers):
            check_jpeg(rec["__key__"], rec["ext"])
            try:
                arr = self.preprocess(rec["image_bytes"])
                failures = 0
            except ValueError as e:  # a failed decode: counted, skipped
                failures = self._count_failure(failures, e)
                continue
            images.append(arr)
            captions.append(rec["caption"])
            if len(images) == cfg.batch_size:
                yield self._collate(images, captions)
                images, captions = [], []
        if images and cfg.partial_batches:
            yield self._collate(images, captions)

    def _tokens(self, captions: List[str]) -> np.ndarray:
        return np.asarray(self.tokenizer(captions), dtype=np.int32)

    def _collate(self, images: List[np.ndarray], captions: List[str]) -> Dict[str, np.ndarray]:
        return {"image": np.stack(images, axis=0), "text": self._tokens(captions)}


def _worker_main(pipeline: WdsPipeline, epoch: int, worker_id: int, num_workers: int, q) -> None:
    """A decode worker: its batches into its queue, then a sentinel; an exception is
    sent to the parent, which raises it."""
    try:
        for batch in pipeline._batches_for_worker(epoch, worker_id, num_workers):
            q.put(("batch", batch))
        q.put(("done", None))
    except BaseException as e:  # noqa: BLE001 — re-raised in the parent
        q.put(("error", f"{type(e).__name__}: {e}"))


def _multiprocess_batches(pipeline: WdsPipeline, epoch: int, num_workers: int,
                          queue_depth: int = 4) -> Iterator[Dict[str, np.ndarray]]:
    """``num_workers`` forked decode workers, a bounded queue each, read round-robin:
    the order is fixed for a given (seed, epoch, num_workers). The workers get numpy
    batches and run no CUDA call, so forking after the parent has initialised CUDA is
    safe; the parent pins."""
    import multiprocessing as mp

    from ..native import decoder

    if decoder() == "nvjpeg":
        raise RuntimeError("the nvJPEG decoder runs on the card, which forked decode workers "
                           "must not touch: decode in this process (--native-decode-threads N, "
                           "or --workers 1)")
    ctx = mp.get_context("fork")
    queues = [ctx.Queue(maxsize=queue_depth) for _ in range(num_workers)]
    procs = [ctx.Process(target=_worker_main, args=(pipeline, epoch, w, num_workers, queues[w]),
                         daemon=True) for w in range(num_workers)]
    for p in procs:
        p.start()
    active = list(range(num_workers))
    try:
        while active:
            for w in list(active):
                kind, payload = queues[w].get()
                if kind == "batch":
                    yield payload
                elif kind == "done":
                    active.remove(w)
                else:
                    raise RuntimeError(f"wds decode worker {w} failed: {payload}")
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(timeout=5)


class PrefetchIterator:
    """Iterate ``iterable`` on a background thread, ``depth`` items ahead, applying
    ``transfer`` there; an exception in the thread is raised in the consumer."""

    def __init__(self, iterable: Iterable, depth: int = 4, transfer: Optional[Callable] = None):
        self.iterable = iterable
        self.depth = depth
        self.transfer = transfer

    def __iter__(self):
        q: queue_mod.Queue = queue_mod.Queue(maxsize=self.depth)
        sentinel = object()
        err: List[BaseException] = []
        stop = threading.Event()
        transfer = self.transfer

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue_mod.Full:
                    continue
            return False

        def worker():
            try:
                for item in self.iterable:
                    if transfer is not None:
                        item = transfer(item)
                    if not put(item):
                        return
            except BaseException as e:  # noqa: BLE001 — raised in the consumer
                err.append(e)
            finally:
                put(sentinel)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    if err:
                        raise err[0]
                    return
                yield item
        finally:  # a consumer that stops early releases the thread
            stop.set()
            t.join(timeout=10)


def to_device(x, device, pin: bool = False):
    """Tensors (nested in dicts) on ``device``, copied without blocking, pinned first
    when ``pin``; anything that is not a tensor (a batch's numpy ``index``) stays."""
    if isinstance(x, dict):
        return {k: to_device(v, device, pin) for k, v in x.items()}
    if not isinstance(x, torch.Tensor):
        return x
    if pin and x.device.type == "cpu" and not x.is_pinned():
        x = x.pin_memory()
    return x.to(device, non_blocking=True)


def device_prefetch(iterable: Iterable, device, depth: int = 2) -> PrefetchIterator:
    """``iterable``'s batches on ``device``, ``depth`` ahead: a background thread of
    this process pins each CPU batch and queues its copy to the card, so that the
    host's decode and the copy overlap the steps."""
    device = torch.device(device)
    pin = device.type == "cuda"
    return PrefetchIterator(iterable, depth=depth, transfer=lambda b: to_device(b, device, pin))
