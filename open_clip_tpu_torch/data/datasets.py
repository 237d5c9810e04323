"""Datasets and ``get_data`` (counterpart of ``open_clip_tpu/data/datasets.py``).

Synthetic sources (``synthetic`` image tensors, ``synthetic-naflex`` NaFlex patch
dicts in token-budget buckets from ``data/naflex.py``, ``synthetic-audio`` waveform
dicts for CLAP from ``data/audio.py``) and real image data: ``webdataset`` tar
shards (``data/wds.py``), a ``csv`` of image paths and captions (``CsvDataset``),
and ImageNet-style class folders for zero-shot (``make_imagenet_val``). Real images
are JPEGs decoded by the native stage (``native/``: libjpeg, or nvJPEG) and PNGs
(``native/png.py``). ``webdataset-naflex`` makes NaFlex patch dicts from tar shards
(``NaFlexWdsPipeline``, with ``--length-bucketing``'s ``data/bucketing.py``). Real
audio comes from ``webdataset-audio`` tar shards (``data/audio.py``), and a folder of
WAVs per class makes the ``audio-zeroshot`` split (``train/audio_zero_shot.py``).

``SyntheticDataset`` yields the JAX class's batches: a blank image, normalised
with the model's mean and std, and one fixed caption, repeated over the batch (or,
for ``--device-preprocess``, the blank uint8 canvas that the step crops). The JAX
class draws its blank image with PIL; here the zero uint8 image is normalised
directly, which gives the same values.

Batches are CPU tensors; the train loop's ``device_prefetch`` pins them and copies
them to the card without blocking. A train batch holds ``--batch-size * --accum-freq`` rows,
which the step cuts into ``--accum-freq`` microbatches, and ``num_batches`` counts
against that batch (times the world size for the sharded sources).
"""

from __future__ import annotations

import csv
import math
import os
import random
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional

import numpy as np
import torch

from ..transform import (PreprocessCfg, default_canvas_size, host_val_transform,
                         uint8_image_transform_v2)
from .wds import WdsConfig, WdsPipeline, check_image, get_dataset_size


@dataclass
class DataInfo:
    dataloader: Iterable
    num_samples: int = 0
    num_batches: int = 0

    def set_epoch(self, epoch: int) -> None:
        setter = getattr(self.dataloader, "set_epoch", None)
        if setter is not None:
            setter(epoch)


def _read_image(path: str) -> bytes:
    """The bytes of a JPEG or PNG file; any other raises (there is no PIL tier)."""
    with open(path, "rb") as fh:
        data = fh.read()
    check_image(path, os.path.splitext(path)[1].lstrip(".").lower(), data)
    return data


class CsvDataset:
    """A CSV/TSV of (image path, caption); paths are relative to the file's directory.
    Training shuffles with (seed, epoch) and then takes its rank's stride of the
    order, dropping the last partial batch; evaluation keeps the file's order and the
    partial tail and splits whole batches round-robin over ranks, each batch with its
    rows' global ``index`` (so features reassemble in order)."""

    def __init__(self, input_filename: str, preprocess: Callable, tokenizer: Callable,
                 img_key: str = "filepath", caption_key: str = "title", sep: str = "\t",
                 batch_size: int = 64, shuffle: bool = False, seed: int = 0,
                 partial_batches: bool = False, world_size: int = 1, rank: int = 0):
        with open(input_filename, newline="") as fh:
            rows = [(r[img_key], r[caption_key]) for r in csv.DictReader(fh, delimiter=sep)]
        if not rows:
            raise ValueError(f"no rows in {input_filename}")
        self.rows = rows
        self.world_size = max(1, world_size)
        self.rank = rank
        self.root = os.path.dirname(os.path.abspath(input_filename))
        self.preprocess = preprocess  # JPEG bytes -> HWC array
        self.tokenizer = tokenizer
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.partial_batches = partial_batches
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        return len(self.rows)

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        order = list(range(len(self.rows)))
        if self.shuffle:
            random.Random(self.seed + self.epoch).shuffle(order)
            if self.world_size > 1:
                order = order[self.rank:: self.world_size]
        chunks = [order[i: i + self.batch_size] for i in range(0, len(order), self.batch_size)]
        if chunks and len(chunks[-1]) < self.batch_size and not self.partial_batches:
            chunks = chunks[:-1]
        split_eval = not self.shuffle and self.world_size > 1
        if split_eval:
            chunks = chunks[self.rank:: self.world_size]
        for chunk in chunks:
            images: List[np.ndarray] = []
            captions: List[str] = []
            for i in chunk:
                path, caption = self.rows[i]
                if not os.path.isabs(path):
                    path = os.path.join(self.root, path)
                images.append(self.preprocess(_read_image(path)))
                captions.append(caption)
            batch = {"image": torch.from_numpy(np.stack(images)),
                     "text": torch.as_tensor(np.asarray(self.tokenizer(captions), dtype=np.int32))}
            if split_eval:
                batch["index"] = np.asarray(chunk, dtype=np.int64)
            yield batch


class SyntheticDataset:
    """Blank image and fixed caption batches, for throughput and smoke runs. Each
    epoch yields ``dataset_size // batch_size`` copies of the one batch. With
    ``canvas`` the image is the blank uint8 canvas of the device-preprocess path."""

    def __init__(self, preprocess_cfg: PreprocessCfg, tokenizer: Callable,
                 caption: str = "a synthetic caption for smoke testing",
                 dataset_size: int = 100, batch_size: int = 64,
                 canvas: Optional[int] = None):
        if canvas:
            image = torch.zeros(batch_size, canvas, canvas, 3, dtype=torch.uint8)
        else:
            h, w = preprocess_cfg.size_hw
            mean = torch.tensor(preprocess_cfg.mean, dtype=torch.float32)
            std = torch.tensor(preprocess_cfg.std, dtype=torch.float32)
            pixel = (torch.zeros(3) - mean) / std  # a black uint8 image, normalised
            image = pixel.expand(batch_size, h, w, 3).contiguous()
        self.batch_size = batch_size
        self.num_samples = dataset_size
        text = torch.as_tensor(tokenizer([caption])).to(torch.int32)
        self._batch = {"image": image, "text": text.expand(batch_size, -1).contiguous()}

    def set_epoch(self, epoch: int) -> None:
        pass

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        for _ in range(max(1, self.num_samples // self.batch_size)):
            yield {k: v.clone() for k, v in self._batch.items()}


def _infer_dataset_type(path: str) -> str:
    ext = path.split(".")[-1].lower()
    if ext in ("csv", "tsv"):
        return "csv"
    if ext == "tar":
        return "webdataset"
    raise ValueError(f"cannot infer dataset type from {path!r}")


def get_data(args: Any, preprocess_cfg: PreprocessCfg, tokenizer: Callable,
             audio_preprocess: Optional[Callable] = None,
             audio_val_preprocess: Optional[Callable] = None) -> Dict[str, DataInfo]:
    """The data dict of the JAX ``get_data``: ``"train"`` (``--train-data`` or a
    synthetic type), ``"val"`` (``--val-data``), ``"imagenet-val"`` and
    ``"imagenet-v2"`` (class folders). ``args`` carries the JAX names, ``world_size``
    and ``rank`` among them (set once the process group exists).

    Real image train data needs ``--device-preprocess``: its host stage is the uint8
    canvas, and the crop runs in the step; the host PIL train tier has no counterpart.
    Val images are normalized on the host (``transform.host_val_transform``).
    ``synthetic-audio`` takes the CLAP model's training ``audio_preprocess``;
    ``webdataset-audio`` takes it for training and ``audio_val_preprocess`` for
    ``--val-data``, which also makes ``"audio-zeroshot"`` from
    ``--audio-zeroshot-dataset``."""
    get = lambda k, d=None: getattr(args, k, d)  # noqa: E731
    world, rank = get("world_size", 1) or 1, get("rank", 0) or 0
    device_pp = bool(get("device_preprocess", False))
    data: Dict[str, DataInfo] = {}

    def build(split_path: str, is_train: bool) -> DataInfo:
        dstype = get("dataset_type", "auto")
        batch_size = args.batch_size
        if is_train:  # the step cuts the batch into accum_freq microbatches of batch_size
            batch_size *= max(1, get("accum_freq", 1) or 1)
        if dstype == "synthetic-audio":
            from .audio import SyntheticAudioDataset

            if audio_preprocess is None:
                raise ValueError("--dataset-type synthetic-audio needs a CLAP model (audio_cfg)")
            n = get("train_num_samples") or 100
            ds = SyntheticAudioDataset(audio_preprocess, tokenizer, dataset_size=n,
                                       batch_size=batch_size)
            return DataInfo(ds, num_samples=n, num_batches=max(1, n // batch_size))
        if dstype == "webdataset-audio":
            from .audio import make_wds_audio_pipeline

            pp = audio_preprocess if is_train else audio_val_preprocess
            if pp is None:
                raise ValueError("--dataset-type webdataset-audio needs a CLAP model (audio_cfg)")
            cfg = WdsConfig(urls=split_path, batch_size=batch_size,
                            caption_key=get("wds_caption_key", "txt"), seed=get("seed", 0),
                            world_size=world, rank=rank, shuffle_shards=2000 if is_train else 0,
                            partial_batches=not is_train)
            n = get("train_num_samples") or 0
            return DataInfo(make_wds_audio_pipeline(cfg, pp, tokenizer,
                                                    audio_ext=get("audio_ext", None)),
                            num_samples=n, num_batches=n // (batch_size * world) if n else 0)
        if dstype == "synthetic-naflex":
            from .naflex import NaFlexDataConfig, SyntheticNaFlexDataset

            ncfg = NaFlexDataConfig(
                seq_lens=tuple(get("naflex_seq_lens", (128, 256))),
                patch_sizes=tuple(get("naflex_patch_sizes", (16,))),
                max_tokens_per_batch=get("naflex_max_tokens", 16384),
                batch_divisor=get("naflex_batch_divisor", 8),
                seed=get("seed", 0),
            )
            n = get("train_num_samples") or 100
            nb = max(1, n // batch_size)
            ds = SyntheticNaFlexDataset(ncfg, tokenizer, num_batches=nb)
            return DataInfo(ds, num_samples=n, num_batches=nb)
        if dstype == "webdataset-naflex":
            from .bucketing import CaptionLength, LengthBucketer
            from .naflex import NaFlexDataConfig, NaFlexWdsPipeline

            wcfg = WdsConfig(urls=split_path, batch_size=batch_size,
                             caption_key=get("wds_caption_key", "txt"), seed=get("seed", 0),
                             world_size=world, rank=rank, shuffle_shards=2000 if is_train else 0,
                             shuffle_samples=get("wds_shuffle_buffer", 5000) if is_train else 0)
            probs = lambda k: tuple(get(k)) if get(k) else None  # noqa: E731
            ncfg = NaFlexDataConfig(
                seq_lens=tuple(get("naflex_seq_lens", (128, 256, 576, 784, 1024))),
                seq_len_probs=probs("naflex_seq_len_probs"),
                patch_sizes=tuple(get("naflex_patch_sizes", (16,))),
                patch_size_probs=probs("naflex_patch_size_probs"),
                max_tokens_per_batch=get("naflex_max_tokens", 16384),
                batch_divisor=get("naflex_batch_divisor", 8),
                pad_multiple=get("naflex_pad_multiple", None), seed=get("seed", 0))
            n = get("train_num_samples") or 0
            nb = max(1, n * ncfg.seq_lens[0] // max(ncfg.max_tokens_per_batch, 1)) if n else 8
            bucketer = None
            if is_train and get("length_bucketing", False):
                bucketer = LengthBucketer([CaptionLength(key="caption", tokenizer=tokenizer)],
                                          pool=get("bucket_pool", 2048),
                                          chunk=get("bucket_chunk", 128), seed=get("seed", 0),
                                          prefetch_pools=get("bucket_prefetch_pools", 0))
            ds = NaFlexWdsPipeline(WdsPipeline(wcfg, None, tokenizer), ncfg, nb, tokenizer,
                                   bucketer=bucketer, device=get("device"),
                                   decode_threads=get("native_decode_threads", 0))
            return DataInfo(ds, num_samples=n, num_batches=nb)
        if dstype == "synthetic":
            canvas = default_canvas_size(preprocess_cfg) if device_pp else None
            ds = SyntheticDataset(preprocess_cfg, tokenizer,
                                  dataset_size=get("train_num_samples") or 100,
                                  batch_size=batch_size, canvas=canvas)
            n = ds.num_samples
            return DataInfo(ds, num_samples=n, num_batches=max(1, n // batch_size))
        if dstype == "auto":
            dstype = _infer_dataset_type(split_path)
        if is_train:
            if not device_pp:
                raise NotImplementedError(
                    "image train data needs --device-preprocess: the host stage makes uint8 "
                    "canvases and the random resized crop runs on the device (the host PIL "
                    "train tier is not ported)")
            pp = uint8_image_transform_v2(preprocess_cfg, is_train=True)
        else:
            pp = host_val_transform(preprocess_cfg)
        if dstype == "csv":
            ds = CsvDataset(split_path, pp, tokenizer, img_key=get("csv_img_key", "filepath"),
                            caption_key=get("csv_caption_key", "title"),
                            sep=get("csv_separator", "\t"), batch_size=batch_size,
                            shuffle=is_train, seed=get("seed", 0), partial_batches=not is_train,
                            world_size=world, rank=rank)
            if is_train:  # sample-stride split, partial batch dropped
                nb = len(range(rank, len(ds), world)) // batch_size
            else:  # whole-batch round-robin split, tail kept
                nb = len(range(rank, math.ceil(len(ds) / batch_size), world))
            return DataInfo(ds, num_samples=len(ds), num_batches=nb)
        if dstype == "webdataset":
            num_samples = get("train_num_samples") if is_train else get("val_num_samples")
            if not num_samples:
                num_samples = get_dataset_size(split_path)[0] or 0
            # a rank's steps an epoch count against the global batch
            num_batches = num_samples // (batch_size * world) if num_samples else 0
            cfg = WdsConfig(
                urls=split_path,
                weights=get("train_data_upsampling_factors") if is_train else None,
                resampled=bool(get("dataset_resampled", False)) and is_train,
                batch_size=batch_size, caption_key=get("wds_caption_key", "txt"),
                seed=get("seed", 0), world_size=world, rank=rank,
                shuffle_shards=2000 if is_train else 0,
                shuffle_samples=get("wds_shuffle_buffer", 5000) if is_train else 0,
                partial_batches=not is_train,
                num_workers=get("workers", 2) if is_train else 1,
                native_decode_threads=get("native_decode_threads", 0) if is_train else 0,
                epoch_batches=num_batches if is_train and num_batches else None,
            )
            return DataInfo(WdsPipeline(cfg, pp, tokenizer), num_samples=num_samples,
                            num_batches=num_batches)
        raise ValueError(f"unsupported dataset type {dstype!r}")

    if get("train_data") or str(get("dataset_type", "")).startswith("synthetic"):
        data["train"] = build(get("train_data") or "", is_train=True)
    if get("val_data"):
        data["val"] = build(get("val_data"), is_train=False)
    for key, flag in (("imagenet-val", "imagenet_val"), ("imagenet-v2", "imagenet_v2")):
        if get(flag):
            data[key] = make_imagenet_val(get(flag), host_val_transform(preprocess_cfg),
                                          args.batch_size, world_size=world, rank=rank)
    if get("audio_zeroshot_dataset"):
        from ..train.audio_zero_shot import build_audio_zero_shot_dataset

        if audio_val_preprocess is None:
            raise ValueError("--audio-zeroshot-dataset needs a CLAP model (audio_cfg)")
        loader = build_audio_zero_shot_dataset(get("audio_zeroshot_dataset"), audio_val_preprocess,
                                               batch_size=args.batch_size, world_size=world,
                                               rank=rank)
        data["audio-zeroshot"] = DataInfo(loader, num_samples=getattr(loader, "num_samples", 0))
    return data


class _ImageFolder:
    """``root/<class dir>/<image>``: the sorted class dirs are the labels 0, 1, ...;
    a rank takes the ``rank::world_size`` slice of the sorted items."""

    def __init__(self, root: str, preprocess: Callable, batch_size: int, world_size: int,
                 rank: int):
        classes = sorted(d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d)))
        self.items: List = []
        for li, c in enumerate(classes):
            cdir = os.path.join(root, c)
            self.items.extend((os.path.join(cdir, f), li) for f in sorted(os.listdir(cdir)))
        if world_size > 1:
            self.items = self.items[rank::world_size]
        self.preprocess = preprocess
        self.batch_size = batch_size

    def set_epoch(self, epoch):
        pass

    def __len__(self):
        return len(self.items)

    def __iter__(self):
        for i in range(0, len(self.items), self.batch_size):
            chunk = self.items[i: i + self.batch_size]
            images = np.stack([self.preprocess(_read_image(path)) for path, _ in chunk])
            yield {"image": torch.from_numpy(images),
                   "label": torch.tensor([li for _, li in chunk], dtype=torch.int32)}


def make_imagenet_val(root: str, preprocess: Callable, batch_size: int,
                      world_size: int = 1, rank: int = 0) -> DataInfo:
    """An ImageNet-style val folder as ``{"image", "label"}`` batches (the last one
    partial); ``zero_shot.run_zero_shot_classifier`` sums the ranks' top-k counts."""
    ds = _ImageFolder(root, preprocess, batch_size, world_size, rank)
    return DataInfo(ds, num_samples=len(ds), num_batches=math.ceil(len(ds) / batch_size))
