"""The pretrained-weight registry (counterpart of ``open_clip_tpu/pretrained.py``).

``pretrained_data.json`` maps (model, tag) to where the reference's released
weights live (a Hugging Face hub repo, or a URL) and to the preprocess settings
they were trained with. The port downloads nothing: ``pretrained_location`` names
the file a tag needs, and ``create_model`` raises with it; a local file path always
works without the registry.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List

from .constants import HF_SAFE_WEIGHTS_NAME, HF_WEIGHTS_NAME

_DATA_PATH = os.path.join(os.path.dirname(__file__), "pretrained_data.json")

with open(_DATA_PATH) as _fh:
    _PRETRAINED: Dict[str, Dict[str, Dict[str, Any]]] = json.load(_fh)

# mean and std as tuples, so that preprocess configs compare and hash
for _tags in _PRETRAINED.values():
    for _entry in _tags.values():
        _pp = _entry.get("preprocess_cfg", {})
        for _k in ("mean", "std"):
            if isinstance(_pp.get(_k), list):
                _pp[_k] = tuple(_pp[_k])


def register_pretrained(model: str, tag: str, cfg: Dict[str, Any]) -> None:
    """Add or replace a registry entry."""
    _PRETRAINED.setdefault(model, {})[tag.lower()] = cfg


def list_pretrained(as_str: bool = False) -> List:
    """Every (model, tag) pair, or ``model.tag`` strings."""
    out = [(m, t) for m in _PRETRAINED for t in _PRETRAINED[m]]
    return [f"{m}.{t}" for m, t in out] if as_str else out


def list_pretrained_models_by_tag(tag: str) -> List[str]:
    return [m for m in _PRETRAINED if tag.lower() in _PRETRAINED[m]]


def list_pretrained_tags_by_model(model: str) -> List[str]:
    return list(_PRETRAINED.get(model, {}))


def is_pretrained_cfg(model: str, tag: str) -> bool:
    return tag.lower() in _PRETRAINED.get(model, {})


def get_pretrained_cfg(model: str, tag: str) -> Dict[str, Any]:
    return dict(_PRETRAINED.get(model, {}).get(tag.lower(), {}))


def get_pretrained_url(model: str, tag: str) -> str:
    return get_pretrained_cfg(model, tag).get("url", "")


def pretrained_location(cfg: Dict[str, Any]) -> str:
    """Where a registry entry's weights live, in words: the hub repo and file (the
    safetensors file first, as the JAX package's download tries them), or the URL."""
    hf_hub = cfg.get("hf_hub", "")
    if hf_hub:
        parts = hf_hub.rstrip("/").split("/")
        repo = "/".join(parts[:2])
        files = [parts[2]] if len(parts) > 2 else [HF_SAFE_WEIGHTS_NAME, HF_WEIGHTS_NAME]
        return f"Hugging Face hub repo {repo!r}, file {' or '.join(repr(f) for f in files)}"
    if cfg.get("url"):
        return f"URL {cfg['url']}"
    return "no location (the entry has neither hf_hub nor url)"
