"""Zero-shot metadata: ImageNet-1k class names and the OpenAI prompt templates
(``zero_shot_metadata_data.json``, the JAX package's data). Templates hold a
``{c}`` placeholder and are exposed as callables, as in the reference."""

import json
from pathlib import Path

with open(Path(__file__).parent / "zero_shot_metadata_data.json") as _fh:
    _DATA = json.load(_fh)

IMAGENET_CLASSNAMES = tuple(_DATA["imagenet_classnames"])


def _to_callable(template: str):
    return lambda c, _t=template: _t.replace("{c}", c)


OPENAI_IMAGENET_TEMPLATES = tuple(_to_callable(t) for t in _DATA["openai_imagenet_templates"])
SIMPLE_IMAGENET_TEMPLATES = tuple(_to_callable(t) for t in _DATA["simple_imagenet_templates"])
