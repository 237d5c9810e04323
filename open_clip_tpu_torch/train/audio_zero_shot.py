"""Zero-shot audio classification (counterpart of ``open_clip_tpu/train/audio_zero_shot.py``).

A template-ensemble text classifier over class names, then top-1/top-5 over a
loader of ``{"audio": waveform dict, "label": (B,) ints}`` batches. Making such a
loader from a folder of WAV files or an HF dataset waits for audio files in the
repo, and raises.
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Dict, Optional, Sequence

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


def build_audio_zero_shot_dataset(spec: str, preprocess, **kwargs):
    raise NotImplementedError("audio zero-shot datasets (a WAV folder, an HF dataset) are not "
                              "ported yet; pass a loader of {'audio', 'label'} batches")
