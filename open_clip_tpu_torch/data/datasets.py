"""Training data (counterpart of ``open_clip_tpu/data/datasets.py``): the three
synthetic datasets, ``synthetic`` (image tensors), ``synthetic-naflex`` (NaFlex
patch dicts in token-budget buckets, ``data/naflex.py``) and ``synthetic-audio``
(waveform dicts for CLAP, ``data/audio.py``). Real datasets (webdataset, CSV,
webdataset audio) are not ported yet and raise.

``SyntheticDataset`` yields the JAX class's batches: a blank image, normalised
with the model's mean and std, and one fixed caption, repeated over the batch.
The JAX class draws its blank image with PIL; here the zero uint8 image is
normalised directly, which gives the same values. Batches are host tensors in
pinned memory where a CUDA card is present, so the loop's copy to the card can
be non-blocking.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, Iterator, Optional

import torch

from ..transform import PreprocessCfg


@dataclass
class DataInfo:
    dataloader: Iterable
    num_samples: int = 0
    num_batches: int = 0

    def set_epoch(self, epoch: int) -> None:
        setter = getattr(self.dataloader, "set_epoch", None)
        if setter is not None:
            setter(epoch)


class SyntheticDataset:
    """Blank image and fixed caption batches, for throughput and smoke runs. Each
    epoch yields ``dataset_size // batch_size`` copies of the one batch."""

    def __init__(self, preprocess_cfg: PreprocessCfg, tokenizer: Callable,
                 caption: str = "a synthetic caption for smoke testing",
                 dataset_size: int = 100, batch_size: int = 64, pin_memory: bool = False):
        h, w = preprocess_cfg.size_hw
        mean = torch.tensor(preprocess_cfg.mean, dtype=torch.float32)
        std = torch.tensor(preprocess_cfg.std, dtype=torch.float32)
        pixel = (torch.zeros(3) - mean) / std  # a black uint8 image, normalised
        self.batch_size = batch_size
        self.num_samples = dataset_size
        self.pin_memory = pin_memory
        text = torch.as_tensor(tokenizer([caption])).to(torch.int32)
        self._batch = {"image": pixel.expand(batch_size, h, w, 3).contiguous(),
                       "text": text.expand(batch_size, -1).contiguous()}

    def set_epoch(self, epoch: int) -> None:
        pass

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        for _ in range(max(1, self.num_samples // self.batch_size)):
            yield {k: torch.empty_like(v, pin_memory=self.pin_memory).copy_(v)
                   for k, v in self._batch.items()}


def get_data(args: Any, preprocess_cfg: PreprocessCfg, tokenizer: Callable,
             audio_preprocess: Optional[Callable] = None) -> Dict[str, DataInfo]:
    """{"train": DataInfo} for ``--dataset-type synthetic``, ``synthetic-naflex`` and
    ``synthetic-audio`` (which takes the CLAP model's training ``audio_preprocess``).
    ``args`` carries the JAX function's names, ``world_size`` and ``rank`` among them
    (set once the process group exists): each synthetic source gives every rank its
    own ``--batch-size`` rows a step, as in the JAX package, so the counts are per
    process."""
    dstype = getattr(args, "dataset_type", "auto")
    get = lambda k, d: getattr(args, k, d)  # noqa: E731
    pin = torch.device(args.device).type == "cuda"
    batch_size = args.batch_size
    if dstype == "synthetic-audio":
        from .audio import SyntheticAudioDataset

        if audio_preprocess is None:
            raise ValueError("--dataset-type synthetic-audio needs a CLAP model (audio_cfg)")
        n = get("train_num_samples", None) or 100
        ds = SyntheticAudioDataset(audio_preprocess, tokenizer, dataset_size=n,
                                   batch_size=batch_size, pin_memory=pin)
        return {"train": DataInfo(ds, num_samples=n, num_batches=max(1, n // batch_size))}
    if dstype == "synthetic-naflex":
        from .naflex import NaFlexDataConfig, SyntheticNaFlexDataset

        ncfg = NaFlexDataConfig(
            seq_lens=tuple(get("naflex_seq_lens", (128, 256))),
            patch_sizes=tuple(get("naflex_patch_sizes", (16,))),
            max_tokens_per_batch=get("naflex_max_tokens", 16384),
            batch_divisor=get("naflex_batch_divisor", 8),
            seed=get("seed", 0),
        )
        n = get("train_num_samples", None) or 100
        nb = max(1, n // batch_size)
        ds = SyntheticNaFlexDataset(ncfg, tokenizer, num_batches=nb, pin_memory=pin)
        return {"train": DataInfo(ds, num_samples=n, num_batches=nb)}
    if dstype != "synthetic":
        raise NotImplementedError(f"dataset type {dstype!r} is not ported yet "
                                  "(synthetic, synthetic-naflex and synthetic-audio are)")
    ds = SyntheticDataset(preprocess_cfg, tokenizer,
                          dataset_size=getattr(args, "train_num_samples", None) or 100,
                          batch_size=batch_size, pin_memory=pin)
    n = ds.num_samples
    return {"train": DataInfo(ds, num_samples=n, num_batches=max(1, n // batch_size))}
