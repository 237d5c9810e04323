"""Zero-shot classifier construction (counterpart of ``open_clip_tpu/zero_shot_classifier.py``).

For each class, embed every templated prompt, average the normalized embeddings
and normalize again; the classes stack into an (embed_dim, num_classes) matrix.
"""

from __future__ import annotations

from itertools import islice
from typing import Callable, Optional, Sequence, Union

import torch


def batched(iterable, n):
    it = iter(iterable)
    while batch := tuple(islice(it, n)):
        yield batch


@torch.no_grad()
def build_zero_shot_classifier(model, tokenizer, classnames: Sequence[str],
                               templates: Sequence[Union[Callable, str]],
                               num_classes_per_batch: Optional[int] = 10) -> torch.Tensor:
    """(embed_dim, num_classes) classifier on the model's device, built in class batches."""
    if not templates or not classnames:
        raise ValueError("need at least one class name and one template")
    use_format = isinstance(templates[0], str)

    def one_batch(batch_classnames):
        texts = [t.format(c=c) if use_format else t(c) for c in batch_classnames for t in templates]
        emb = model.encode_text(tokenizer(texts), normalize=True)
        emb = emb.reshape(len(batch_classnames), len(templates), -1).mean(dim=1)
        emb = emb / torch.linalg.vector_norm(emb.float(), dim=-1, keepdim=True)
        return emb.T

    if num_classes_per_batch:
        return torch.cat([one_batch(b) for b in batched(classnames, num_classes_per_batch)], dim=1)
    return one_batch(list(classnames))
