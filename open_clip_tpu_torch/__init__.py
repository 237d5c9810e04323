"""open_clip_tpu_torch: the PyTorch and CUDA port of open_clip_tpu, for NVIDIA Hopper.

Serving slice: ViT CLIP models (ViT-B-32 first) from ``create_model_and_transforms``
through the device-side preprocess, ``encode_image``/``encode_text`` and
``build_zero_shot_classifier``. Attention at CLIP lengths runs on a hand-written
CUDA kernel (``ops/short_attention.py``). Entry points build on the GPU unless
given ``device="cpu"``. The package imports neither JAX nor ``open_clip_tpu``.
"""

from .config import CLIPModelCfg, CLIPTextCfg, CLIPVisionCfg, get_model_config, list_models
from .constants import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    INCEPTION_MEAN,
    INCEPTION_STD,
    OPENAI_DATASET_MEAN,
    OPENAI_DATASET_STD,
)
from .convert import convert_params_dtype_, params_from_jax
from .factory import create_model, create_model_and_transforms, get_tokenizer
from .models.clip import CLIPModel, clip_forward, encode_image, encode_text, get_logits
from .tokenizer import DEFAULT_CONTEXT_LENGTH, SimpleTokenizer, tokenize
from .transform import PreprocessCfg, make_device_preprocess
from .zero_shot_classifier import build_zero_shot_classifier
from .zero_shot_metadata import (
    IMAGENET_CLASSNAMES,
    OPENAI_IMAGENET_TEMPLATES,
    SIMPLE_IMAGENET_TEMPLATES,
)

__all__ = [
    "CLIPModelCfg", "CLIPTextCfg", "CLIPVisionCfg", "get_model_config", "list_models",
    "IMAGENET_MEAN", "IMAGENET_STD", "INCEPTION_MEAN", "INCEPTION_STD",
    "OPENAI_DATASET_MEAN", "OPENAI_DATASET_STD",
    "convert_params_dtype_", "params_from_jax",
    "create_model", "create_model_and_transforms", "get_tokenizer",
    "CLIPModel", "clip_forward", "encode_image", "encode_text", "get_logits",
    "DEFAULT_CONTEXT_LENGTH", "SimpleTokenizer", "tokenize",
    "PreprocessCfg", "make_device_preprocess",
    "build_zero_shot_classifier",
    "IMAGENET_CLASSNAMES", "OPENAI_IMAGENET_TEMPLATES", "SIMPLE_IMAGENET_TEMPLATES",
]
