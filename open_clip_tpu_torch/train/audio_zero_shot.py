"""Zero-shot audio classification (counterpart of ``open_clip_tpu/train/audio_zero_shot.py``).

A template-ensemble text classifier over class names, then top-1/top-5 over a
loader of ``{"audio": waveform or patch dict, "label": (B,) ints}`` batches.
``build_audio_zero_shot_dataset`` makes such a loader from a folder of WAV files
per class (``root/<class name>/*.wav``, read with the standard library's
``wave``); an HF dataset id needs a download and raises, naming the dataset.
"""

from __future__ import annotations

import logging
import os
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..zero_shot_classifier import build_zero_shot_classifier

logger = logging.getLogger(__name__)

ESC50_TEMPLATES = (
    lambda c: f"a sound of {c}.",
    lambda c: f"this is a sound of {c}.",
)


def parse_templates(spec: Optional[str]):
    """``--audio-zeroshot-template`` -> template callables: ``{}`` marks the class
    name, ``|`` separates templates, no ``{}`` means the class name goes last."""
    if not spec:
        return None
    return tuple((lambda c, p=part: p.replace("{}", c)) if "{}" in part else
                 (lambda c, p=part: p + c) for part in spec.split("|"))


def accuracy(logits: torch.Tensor, labels: torch.Tensor, topk=(1,)):
    """Top-k hit counts."""
    order = logits.argsort(dim=-1, descending=True)
    return [float((order[:, :k] == labels[:, None]).any(dim=1).sum()) for k in topk]


@torch.no_grad()
def run_audio_zero_shot(model, classifier: torch.Tensor, dataloader) -> Dict[str, float]:
    clf = classifier.float()
    top1 = top5 = n = 0.0
    for batch in dataloader:
        feats = model.encode_audio(batch["audio"], normalize=True)
        logits = 100.0 * feats.float() @ clf
        labels = torch.as_tensor(batch["label"], device=logits.device).long()
        a1, a5 = accuracy(logits, labels, topk=(1, min(5, clf.shape[1])))
        top1, top5, n = top1 + a1, top5 + a5, n + logits.shape[0]
    from ..parallel.distributed import host_psum

    top1, top5, n = host_psum([top1, top5, n])  # the ranks' loaders hold their strides
    return {"top1": top1 / max(n, 1), "top5": top5 / max(n, 1)}


def audio_zero_shot_eval(model, data: Dict[str, Any], epoch: int, args: Any = None,
                         tokenizer=None, classnames: Optional[Sequence[str]] = None,
                         templates: Optional[Sequence[Callable]] = None) -> Dict[str, float]:
    """Top-1/top-5 over ``data["audio-zeroshot"]`` (a ``DataInfo`` whose loader has
    ``classnames``) at the zero-shot cadence."""
    results: Dict[str, float] = {}
    if "audio-zeroshot" not in data:
        return results
    get = (lambda k, d=None: getattr(args, k, d)) if args is not None else (lambda k, d=None: d)
    freq = get("zeroshot_frequency", 1) or 1
    epochs = get("epochs", 1) or 1
    if epoch % freq != 0 and epoch != epochs:
        return results
    split = data["audio-zeroshot"]
    loader = getattr(split, "dataloader", split)
    classnames = classnames or getattr(loader, "classnames", None)
    if classnames is None:
        logger.warning("audio zero-shot split has no classnames; skipping")
        return results
    if tokenizer is None:
        from ..factory import get_tokenizer

        tokenizer = get_tokenizer(get("model", "") or "")
    classifier = build_zero_shot_classifier(model, tokenizer, classnames,
                                            templates or ESC50_TEMPLATES, num_classes_per_batch=10)
    metrics = run_audio_zero_shot(model, classifier, loader)
    results["audio-zeroshot-top1"] = metrics["top1"]
    results["audio-zeroshot-top5"] = metrics["top5"]
    return results


def _read_wav(path: str) -> Tuple[np.ndarray, int]:
    """(mono float32 waveform, sample rate) of a PCM WAV through the standard
    library's ``wave``: 16- and 32-bit integers scaled to [-1, 1), 8-bit unsigned
    centred and scaled to [-1, 1) (which ``decode_audio_bytes`` does not do: ROADMAP,
    faults of the reference), a 32-bit frame read as float32 where that gives
    finite values within +-4, several channels averaged."""
    import wave

    with wave.open(path, "rb") as w:
        sr, nch, width = w.getframerate(), w.getnchannels(), w.getsampwidth()
        raw = w.readframes(w.getnframes())
    if width == 2:
        wav = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
    elif width == 4:
        # wave gives no format code: int32 PCM reads as huge or odd float32 values
        as_f = np.frombuffer(raw, np.float32)
        if np.isfinite(as_f).all() and (np.abs(as_f) <= 4.0).all():
            wav = as_f.astype(np.float32)
        else:
            wav = np.frombuffer(raw, np.int32).astype(np.float32) / 2147483648.0
    elif width == 1:
        wav = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported WAV sample width {width} in {path}")
    if nch > 1:
        wav = wav.reshape(-1, nch).mean(axis=1)
    return wav, sr


class _FolderLoader:
    """``{"audio", "label"}`` batches of a rank's stride of (path, label) items."""

    def __init__(self, items, classnames, preprocess, batch_size: int, world_size: int,
                 rank: int):
        self.items = items[rank::world_size]
        self.classnames = classnames
        self.num_samples = len(items)
        self.preprocess = preprocess
        self.batch_size = batch_size

    def set_epoch(self, epoch: int) -> None:
        pass

    def _batch(self, auds, labels):
        return {"audio": {k: np.stack([a[k] for a in auds]) for k in auds[0]},
                "label": np.asarray(labels, dtype=np.int32)}

    def __iter__(self):
        auds, labels = [], []
        for path, label in self.items:
            auds.append(self.preprocess(_read_wav(path)))
            labels.append(label)
            if len(auds) == self.batch_size:
                yield self._batch(auds, labels)
                auds, labels = [], []
        if auds:
            yield self._batch(auds, labels)


def build_folder_audio_zero_shot_dataset(root: str, preprocess, batch_size: int = 8,
                                         world_size: int = 1, rank: int = 0) -> _FolderLoader:
    """``root/<class dir>/*.wav`` -> a loader with ``classnames``: the sorted class
    dirs are the labels 0, 1, ..., their names with ``_`` as spaces the class names;
    a rank takes the ``rank::world_size`` stride of the sorted items, and
    ``run_audio_zero_shot`` sums the ranks' counts."""
    classes = sorted(d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d)))
    if not classes:
        raise ValueError(f"no class directories under {root}")
    items = [(os.path.join(root, c, f), li) for li, c in enumerate(classes)
             for f in sorted(os.listdir(os.path.join(root, c)))
             if f.lower().endswith((".wav", ".wave"))]
    if not items:
        raise ValueError(f"no .wav files under {root}/<class>/")
    return _FolderLoader(items, [c.replace("_", " ") for c in classes], preprocess, batch_size,
                         world_size, rank)


def build_audio_zero_shot_dataset(spec: str, preprocess, batch_size: int = 8,
                                  world_size: int = 1, rank: int = 0):
    """``--audio-zeroshot-dataset``: a local directory (or ``folder:<dir>``) is a WAV
    folder; anything else names an HF dataset, which needs a download and raises (the
    ``--audio-zeroshot-split`` and ``-*-key`` flags, which only an HF dataset reads,
    are accepted and change nothing)."""
    if spec.startswith("folder:"):
        spec = spec[len("folder:"):]
    if os.path.isdir(spec):
        return build_folder_audio_zero_shot_dataset(spec, preprocess, batch_size=batch_size,
                                                    world_size=world_size, rank=rank)
    raise NotImplementedError(
        f"audio zero-shot dataset {spec!r}: not a local folder of <class>/*.wav, and HF "
        "datasets need a download, which is not ported")
