"""Model factory (counterpart of ``open_clip_tpu/factory.py``): ``create_model``,
``create_model_and_transforms`` and ``get_tokenizer``.

Models are built on the card unless the caller asks for another device:
``device=None`` means CUDA, and raises where CUDA is absent; there is no quiet
fallback to the CPU. Weights are random, drawn from a ``torch.Generator``
seeded by ``seed`` with the JAX package's init distributions; no checkpoint is
loaded yet (``pretrained=`` raises). The model comes back with every parameter
trainable; it has no dropout, and its one batch norm (HTSAT's ``bn0`` in CLAP models)
uses its stored statistics in training too, so serving and training run the same
forward, and callers that only serve run it under ``torch.inference_mode()``.
"""

from __future__ import annotations

from typing import Optional

import torch

from .config import get_model_config, parse_model_cfg
from .convert import convert_params_dtype_
from .models.clip import CLIPModel
from .tokenizer import DEFAULT_CONTEXT_LENGTH, SimpleTokenizer
from .transform import PreprocessCfg, make_device_preprocess

# compute dtype per precision (the JAX package's map; the short-attention kernel
# takes fp32 and bf16, so the fp16 precisions are not offered)
_PRECISION_DTYPES = {
    "fp32": torch.float32,
    "bf16": torch.bfloat16,
    "amp": torch.bfloat16,
    "amp_bf16": torch.bfloat16,
    "pure_bf16": torch.bfloat16,
}


def resolve_device(device=None) -> torch.device:
    """``None`` -> the current CUDA device, raising where CUDA is absent."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available: the port runs on the GPU by default; "
                               "pass device='cpu' to run its plain PyTorch path on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


def create_model(model_name: str, pretrained: Optional[str] = None, precision: str = "fp32",
                 device=None, seed: int = 0) -> CLIPModel:
    """Build a model with random weights from ``seed`` on ``device`` (CUDA by default)."""
    if pretrained:
        raise NotImplementedError("pretrained weights are not ported yet; "
                                  "models are built with random weights from `seed`")
    if precision not in _PRECISION_DTYPES:
        raise ValueError(f"unknown precision {precision!r}; one of {sorted(_PRECISION_DTYPES)}")
    device = resolve_device(device)
    cfg = parse_model_cfg(model_name)
    dtype = _PRECISION_DTYPES[precision]
    model = CLIPModel(cfg, compute_dtype=dtype)
    model.init_weights(torch.Generator().manual_seed(seed))
    if precision.startswith("pure_"):
        convert_params_dtype_(model, dtype)
    if cfg.vision_cfg is not None:
        model.preprocess_cfg = PreprocessCfg(size=cfg.vision_cfg.image_size)
    return model.to(device)


def create_model_and_transforms(model_name: str, pretrained: Optional[str] = None, **kwargs):
    """(model, preprocess_train, preprocess_val). For an image model
    ``preprocess_val`` is the device-side preprocess (uint8 NHWC on the model's device
    -> normalized NHWC); the image training transform is not ported yet, so
    ``preprocess_train`` is None. For a CLAP model both are the host
    ``AudioPreprocess`` of ``data/audio.py`` ((waveform, sample rate) -> fixed-length
    waveform dict): a random window for training, the clip's start for evaluation."""
    model = create_model(model_name, pretrained, **kwargs)
    if model.cfg.audio_cfg is not None:
        from .data.audio import audio_transform_v2

        return (model, audio_transform_v2(model.cfg.audio_cfg, is_train=True),
                audio_transform_v2(model.cfg.audio_cfg, is_train=False))
    return model, None, make_device_preprocess(model.preprocess_cfg)


def get_tokenizer(model_name: str = "", context_length: Optional[int] = None) -> SimpleTokenizer:
    """The CLIP BPE tokenizer at the model config's context length."""
    raw = get_model_config(model_name) if model_name else None
    text_cfg = (raw or {}).get("text_cfg", {})
    if text_cfg.get("hf_tokenizer_name") or text_cfg.get("tokenizer_type"):
        raise NotImplementedError(f"tokenizer of {model_name!r} is not ported yet")
    if context_length is None:
        context_length = text_cfg.get("context_length", DEFAULT_CONTEXT_LENGTH)
    return SimpleTokenizer(context_length=context_length, **text_cfg.get("tokenizer_kwargs", {}))
