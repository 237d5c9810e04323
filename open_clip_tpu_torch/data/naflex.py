"""NaFlex token-budget batching and the patchify transform (counterpart of
``open_clip_tpu/data/naflex.py``).

Every (seq_len, patch_size) bucket is one shape: the scheduler draws a
deterministic per-epoch list of (patch_size, seq_len, batch_size) with the batch
size inversely proportional to the sequence length, and the transform turns one
image into a patch dict padded to the bucket's length:

    {"patches": (N, P*P*3) float32, "patch_coord": (N, 2) int32 (y, x),
     "patch_valid": (N,) bool}

The scheduler draws with Python's ``random.Random`` exactly as the JAX package's
does, so the two give the same schedule for the same seed and epoch. The JAX
transform takes a PIL image; this one takes a uint8 (H, W, 3) tensor or array (or
a (B, H, W, 3) batch of equally sized images) and works on the tensor's own
device, so a server can run it on the card. ``NaFlexWdsPipeline`` makes the
batches from webdataset shards.
"""

from __future__ import annotations

import itertools
import math
import random
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..constants import OPENAI_DATASET_MEAN, OPENAI_DATASET_STD


@dataclass
class NaFlexDataConfig:
    patch_sizes: Tuple[int, ...] = (16,)
    patch_size_probs: Optional[Tuple[float, ...]] = None
    seq_lens: Tuple[int, ...] = (128, 256, 576, 784, 1024)
    seq_len_probs: Optional[Tuple[float, ...]] = None
    max_tokens_per_batch: int = 16384
    batch_divisor: int = 8
    pad_multiple: Optional[int] = None
    eval_seq_len: int = 576
    eval_patch_size: Optional[int] = None
    seed: int = 0

    def resolve(self) -> "NaFlexDataConfig":
        ps = tuple(self.patch_sizes)
        psp = self.patch_size_probs or tuple(1.0 / len(ps) for _ in ps)
        sl = tuple(self.seq_lens)
        slp = self.seq_len_probs or tuple(1.0 / len(sl) for _ in sl)
        assert abs(sum(psp) - 1.0) < 1e-6 and abs(sum(slp) - 1.0) < 1e-6
        return NaFlexDataConfig(
            patch_sizes=ps, patch_size_probs=psp, seq_lens=sl, seq_len_probs=slp,
            max_tokens_per_batch=self.max_tokens_per_batch, batch_divisor=self.batch_divisor,
            pad_multiple=self.pad_multiple, eval_seq_len=self.eval_seq_len,
            eval_patch_size=self.eval_patch_size or ps[0], seed=self.seed,
        )


def calculate_batch_size(seq_len: int, max_tokens: int, divisor: int = 8, min_batch: int = 1) -> int:
    """Batch size inversely proportional to seq_len, rounded down to the divisor."""
    raw = max_tokens / seq_len
    rounded = int(raw // divisor) * divisor
    return max(rounded, min_batch)


class NaFlexBatchScheduler:
    """Deterministic per-epoch schedule of (patch_size, seq_len, batch_size) tuples:
    a function of (seed, epoch) alone, so every reader derives the same one."""

    def __init__(self, cfg: NaFlexDataConfig, num_batches: int):
        self.cfg = cfg.resolve()
        self.num_batches = num_batches

    def schedule(self, epoch: int) -> List[Tuple[int, int, int]]:
        rng = random.Random(self.cfg.seed * 100003 + epoch)
        out = []
        for _ in range(self.num_batches):
            p = rng.choices(self.cfg.patch_sizes, weights=self.cfg.patch_size_probs)[0]
            s = rng.choices(self.cfg.seq_lens, weights=self.cfg.seq_len_probs)[0]
            b = calculate_batch_size(s, self.cfg.max_tokens_per_batch, self.cfg.batch_divisor)
            out.append((p, s, b))
        return out


def _target_grid(w: int, h: int, patch: int, max_seq_len: int) -> Tuple[int, int]:
    """Largest aspect-preserving (gw, gh) with gw*gh <= max_seq_len."""
    scale = math.sqrt(max_seq_len * patch * patch / (w * h))
    scale = min(scale, 1.0) if w * h <= max_seq_len * patch * patch else scale
    gw = max(1, int(w * scale / patch))
    gh = max(1, int(h * scale / patch))
    while gw * gh > max_seq_len:
        if gw >= gh:
            gw -= 1
        else:
            gh -= 1
    return gw, gh


class NaFlexTransform:
    """uint8 (H, W, 3) image -> patch dict padded to ``max_seq_len``; a (B, H, W, 3)
    batch of equally sized images gives the batched dict. One instance per
    (max_seq_len, patch_size) bucket.

    The image is resized to the bucket's grid with the antialiased bicubic filter
    of the port's ``transform.py`` (Keys' a = -0.5, PIL's), rounded and clamped to
    the 0..255 levels as PIL's uint8 result is, and normalized. An image that
    already has the grid's size is not touched."""

    def __init__(self, max_seq_len: int, patch_size: int, mean=OPENAI_DATASET_MEAN,
                 std=OPENAI_DATASET_STD, interpolation: str = "bicubic"):
        self.max_seq_len = max_seq_len
        self.patch_size = patch_size
        self.mean = tuple(mean)
        self.std = tuple(std)
        self.mode = interpolation if interpolation in ("bicubic", "bilinear") else "bicubic"

    def __call__(self, img) -> Dict[str, torch.Tensor]:
        img = torch.as_tensor(np.asarray(img) if not isinstance(img, torch.Tensor) else img)
        if img.dtype != torch.uint8 or img.ndim not in (3, 4) or img.shape[-1] != 3:
            raise ValueError(f"NaFlexTransform takes uint8 (H, W, 3) or (B, H, W, 3) images, "
                             f"got {img.dtype} {tuple(img.shape)}")
        single = img.ndim == 3
        x = (img[None] if single else img).permute(0, 3, 1, 2).float()  # NCHW, 0..255
        b, _, h, w = x.shape
        p = self.patch_size
        gw, gh = _target_grid(w, h, p, self.max_seq_len)
        if (h, w) != (gh * p, gw * p):
            x = F.interpolate(x, size=(gh * p, gw * p), mode=self.mode, antialias=True,
                              align_corners=False)
            x = x.round().clamp(0.0, 255.0)
        mean = torch.tensor(self.mean, dtype=torch.float32, device=x.device)[:, None, None]
        std = torch.tensor(self.std, dtype=torch.float32, device=x.device)[:, None, None]
        x = ((x / 255.0 - mean) / std).permute(0, 2, 3, 1)  # (B, gh*p, gw*p, 3)
        n = gh * gw
        patches = x.reshape(b, gh, p, gw, p, 3).permute(0, 1, 3, 2, 4, 5).reshape(b, n, p * p * 3)
        ys, xs = torch.meshgrid(torch.arange(gh, device=x.device),
                                torch.arange(gw, device=x.device), indexing="ij")
        coords = torch.stack([ys.reshape(-1), xs.reshape(-1)], dim=-1).to(torch.int32)

        max_len = self.max_seq_len
        out_patches = torch.zeros((b, max_len, p * p * 3), dtype=torch.float32, device=x.device)
        out_coords = torch.zeros((b, max_len, 2), dtype=torch.int32, device=x.device)
        out_valid = torch.zeros((b, max_len), dtype=torch.bool, device=x.device)
        out_patches[:, :n] = patches
        out_coords[:, :n] = coords
        out_valid[:, :n] = True
        out = {"patches": out_patches, "patch_coord": out_coords, "patch_valid": out_valid}
        return {k: v[0] for k, v in out.items()} if single else out


def collate_naflex(samples: Sequence[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """Stack patch dicts (equal shapes within a bucket)."""
    return {k: torch.stack([torch.as_tensor(s[k]) for s in samples], dim=0) for k in samples[0]}


def naflex_transform_factory(cfg: NaFlexDataConfig, mean=None, std=None) -> Callable:
    """(max_seq_len, patch_size) -> transform, cached per bucket."""
    cache: Dict[Tuple[int, int], NaFlexTransform] = {}
    kw = {}
    if mean is not None:
        kw["mean"] = mean
    if std is not None:
        kw["std"] = std

    def get(seq_len: int, patch_size: int) -> NaFlexTransform:
        key = (seq_len, patch_size)
        if key not in cache:
            cache[key] = NaFlexTransform(seq_len, patch_size, **kw)
        return cache[key]

    return get


class NaFlexWdsPipeline:
    """NaFlex batches from webdataset shards, the JAX package's pipeline: the
    per-epoch schedule of (patch_size, seq_len, batch_size) drives one transform per
    bucket over the shard stream (``wds_pipeline._samples``, after the optional
    ``bucketer`` of ``data/bucketing.py``). Batches are ``{"image": patch dict,
    "text": (B, L) int32 tokens}``; the stream ending inside a batch ends the epoch.

    Each image is decoded whole: a JPEG by the native stage (``decode_full_batch``,
    ``decode_threads`` threads), a PNG by ``native/png.py``. A sample that fails to
    decode is skipped and the batch takes the next one (the JAX pipeline's
    skip-and-replenish); an image that is neither a JPEG nor a PNG raises with its
    key. With a CUDA ``device`` and the nvJPEG decoder the image is decoded into the
    card's memory and resized there (``route`` says which route ran); otherwise the
    patch dicts are made on the host."""

    def __init__(self, wds_pipeline, data_cfg: NaFlexDataConfig, num_batches: int,
                 tokenizer: Callable, mean=None, std=None, bucketer=None, device=None,
                 decode_threads: int = 0):
        self.inner = wds_pipeline
        self.cfg = data_cfg.resolve()
        self.scheduler = NaFlexBatchScheduler(self.cfg, num_batches)
        self.factory = naflex_transform_factory(self.cfg, mean=mean, std=std)
        self.tokenizer = tokenizer
        self.bucketer = bucketer
        self.device = torch.device(device) if device is not None else torch.device("cpu")
        self.decode_threads = decode_threads
        self.epoch = 0

    @property
    def route(self) -> str:
        from ..native.decode import full_decode_route

        return full_decode_route(self.device)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch
        self.inner.set_epoch(epoch)
        if self.bucketer is not None:
            self.bucketer.set_epoch(epoch)

    def _decode(self, recs: List[Dict]) -> List[Optional[torch.Tensor]]:
        """Each record's (H, W, 3) uint8 image on the transform's device, or None
        where its decode failed."""
        from ..native.decode import decode_full_batch
        from ..native.png import decode_png, is_png
        from .wds import check_image

        for rec in recs:
            check_image(rec["__key__"], rec.get("ext", ""), rec["image_bytes"])
        out: List[Optional[torch.Tensor]] = [None] * len(recs)
        jpegs = [i for i, rec in enumerate(recs) if not is_png(rec["image_bytes"])]
        if jpegs:
            images, _ = decode_full_batch([bytes(recs[i]["image_bytes"]) for i in jpegs],
                                          self.decode_threads, device=self.device)
            for i, image in zip(jpegs, images):
                out[i] = None if image is None else torch.as_tensor(image)
        for i, rec in enumerate(recs):
            if is_png(rec["image_bytes"]):
                try:
                    out[i] = torch.from_numpy(decode_png(rec["image_bytes"], rec["__key__"]))
                except ValueError:
                    continue
        return [None if x is None else x.to(self.device) for x in out]

    def __iter__(self) -> Iterator[Dict]:
        schedule = self.scheduler.schedule(self.epoch)
        stream = self.inner._samples(self.epoch)
        if self.bucketer is not None:
            stream = iter(self.bucketer(stream))
        for patch_size, seq_len, batch_size in schedule:
            transform = self.factory(seq_len, patch_size)
            dicts, captions = [], []
            while len(dicts) < batch_size:
                recs = list(itertools.islice(stream, batch_size - len(dicts)))
                if not recs:
                    return
                for rec, image in zip(recs, self._decode(recs)):
                    if image is not None:
                        dicts.append(transform(image))
                        captions.append(rec["caption"])
            yield {"image": collate_naflex(dicts),
                   "text": torch.as_tensor(np.asarray(self.tokenizer(captions), dtype=np.int32))}


class SyntheticNaFlexDataset:
    """NaFlex patch-dict batches of one blank 96x64 image and one fixed caption, for
    smoke and throughput runs: one bucket per schedule entry. Batches are host
    tensors (the loop's prefetch pins them)."""

    def __init__(self, data_cfg: NaFlexDataConfig, tokenizer: Callable, num_batches: int = 4,
                 caption: str = "a synthetic caption"):
        self.cfg = data_cfg.resolve()
        self.scheduler = NaFlexBatchScheduler(self.cfg, num_batches)
        self.factory = naflex_transform_factory(self.cfg)
        self.tokenizer = tokenizer
        self.caption = caption
        self.num_batches = num_batches
        self.epoch = 0
        self._img = torch.zeros(64, 96, 3, dtype=torch.uint8)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _repeat(self, x: torch.Tensor, n: int) -> torch.Tensor:
        return x.expand(n, *x.shape).contiguous()

    def __iter__(self) -> Iterator[Dict]:
        text = torch.as_tensor(self.tokenizer([self.caption])).to(torch.int32)[0]
        for patch_size, seq_len, batch_size in self.scheduler.schedule(self.epoch):
            d = self.factory(seq_len, patch_size)(self._img)
            yield {"image": {k: self._repeat(v, batch_size) for k, v in d.items()},
                   "text": self._repeat(text, batch_size)}
