"""A model directory in the Hugging Face hub layout (counterpart of
``open_clip_tpu/push_to_hf_hub.py``).

``save_for_hf`` writes ``open_clip_config.json`` (``model_cfg`` and
``preprocess_cfg``) and ``open_clip_model.safetensors`` in the reference
checkpoint's layout (``convert.reference_state_dict`` with ``custom_text``), through
the port's own safetensors writer, so that ``create_model("local-dir:<dir>")`` here,
the JAX package and the reference load it. As in the JAX package that layout covers
the native ViT and text towers only; for any other tower it raises. Uploading needs
the network and is not ported.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Dict, Optional

from ._safetensors import save_file
from .constants import HF_CONFIG_NAME, HF_SAFE_WEIGHTS_NAME
from .convert import reference_state_dict


def save_for_hf(model, save_directory, *, model_config: Optional[Dict[str, Any]] = None,
                preprocess_cfg: Optional[Dict[str, Any]] = None) -> str:
    """Write the model's config and weights into ``save_directory``; returns it."""
    d = Path(save_directory)
    sd = reference_state_dict(model, custom_text=True)
    d.mkdir(parents=True, exist_ok=True)
    save_file(sd, d / HF_SAFE_WEIGHTS_NAME)
    if model_config is None:
        model_config = model.cfg.to_dict()
    if preprocess_cfg is None and getattr(model, "preprocess_cfg", None) is not None:
        preprocess_cfg = dataclasses.asdict(model.preprocess_cfg)
    with open(d / HF_CONFIG_NAME, "w") as fh:
        json.dump({"model_cfg": model_config, "preprocess_cfg": preprocess_cfg or {}}, fh,
                  indent=2)
    return str(d)


def push_to_hf_hub(model, repo_id: str, **kwargs) -> None:
    raise NotImplementedError(f"uploading to the Hugging Face hub ({repo_id!r}) is not ported: "
                              "write the directory with save_for_hf and upload it elsewhere")
