"""ImageNet-style zero-shot evaluation (counterpart of ``open_clip_tpu/train/zero_shot.py``).

The template-ensemble classifier (``IMAGENET_CLASSNAMES`` x
``OPENAI_IMAGENET_TEMPLATES``) is built once an evaluation, then each batch of the
class-folder loader is scored on the model's device: 100 x normalized image features
@ classifier, top-1 and top-5 hits. Under several processes each loader holds its
rank's slice and the hit counts are summed with ``host_psum``. Features come from
calls of the model as a module (``model(image)``, ``model(None, text)``), so that
under FSDP2 the root's hooks gather the parameters, and every rank makes as many
calls as the others (``train_loop.in_lockstep``).
"""

from __future__ import annotations

import logging
from typing import Any, Dict

import torch

from ..parallel.distributed import host_psum
from ..zero_shot_classifier import build_zero_shot_classifier
from ..zero_shot_metadata import IMAGENET_CLASSNAMES, OPENAI_IMAGENET_TEMPLATES
from ..data.wds import device_prefetch
from .train_loop import in_lockstep, placeholder_batch

logger = logging.getLogger(__name__)


class ModuleCalls:
    """``encode_image``/``encode_text`` (normalized) through ``model(...)``: what
    ``build_zero_shot_classifier`` calls, made safe for a model under FSDP2."""

    def __init__(self, model):
        self.model = model

    def encode_image(self, image, normalize: bool = True) -> torch.Tensor:
        return self.model(image)["image_features"]

    def encode_text(self, text, normalize: bool = True) -> torch.Tensor:
        return self.model(None, torch.as_tensor(text, device=self.model.device))["text_features"]


def accuracy(logits, labels, topk=(1,)):
    """Top-k hit counts: label among the k largest logits of its row."""
    logits = torch.as_tensor(logits)
    labels = torch.as_tensor(labels, device=logits.device).long()
    order = logits.topk(max(topk), dim=-1).indices
    return [float((order[:, :k] == labels[:, None]).any(dim=1).sum()) for k in topk]


@torch.no_grad()
def run_zero_shot_classifier(model, classifier: torch.Tensor, dataloader) -> Dict[str, float]:
    """Top-1/top-5 accuracy of ``classifier`` (embed_dim, classes) over a loader of
    ``{"image", "label"}`` batches, summed over the processes."""
    calls = ModuleCalls(model)
    clf = classifier.float()
    top1 = top5 = n = 0.0
    batches = device_prefetch(dataloader, model.device)
    for batch, placeholder in in_lockstep(batches, model, lambda: placeholder_batch(model, False)):
        logits = 100.0 * calls.encode_image(batch["image"]).float() @ clf
        if placeholder:
            continue
        a1, a5 = accuracy(logits, batch["label"], topk=(1, min(5, clf.shape[1])))
        top1, top5, n = top1 + a1, top5 + a5, n + logits.shape[0]
    top1, top5, n = host_psum([top1, top5, n])
    return {"top1": float(top1 / max(n, 1)), "top5": float(top5 / max(n, 1))}


@torch.no_grad()
def zero_shot_eval(model, data: Dict[str, Any], epoch: int, args: Any = None,
                   tokenizer=None) -> Dict[str, float]:
    """``imagenet-zeroshot-val-top1/5`` and ``imagenetv2-zeroshot-val-top1/5`` for the
    splits in ``data``, at epochs that ``--zeroshot-frequency`` divides and the last."""
    results: Dict[str, float] = {}
    splits = [k for k in ("imagenet-val", "imagenet-v2") if k in data]
    if not splits:
        return results
    freq = getattr(args, "zeroshot_frequency", 1) or 1
    epochs = getattr(args, "epochs", 1) or 1
    if epoch % freq != 0 and epoch != epochs:
        return results
    if tokenizer is None:
        from ..factory import get_tokenizer

        tokenizer = get_tokenizer(getattr(args, "model", ""))
    logger.info("building zero-shot imagenet classifier")
    classifier = build_zero_shot_classifier(ModuleCalls(model), tokenizer, IMAGENET_CLASSNAMES,
                                            OPENAI_IMAGENET_TEMPLATES, num_classes_per_batch=10)
    for split in splits:
        metrics = run_zero_shot_classifier(model, classifier, data[split].dataloader)
        prefix = "imagenet-zeroshot-val-" if split == "imagenet-val" else "imagenetv2-zeroshot-val-"
        results[prefix + "top1"] = metrics["top1"]
        results[prefix + "top5"] = metrics["top5"]
    return results

