"""open_clip_tpu_torch: the PyTorch and CUDA port of open_clip_tpu, for NVIDIA Hopper.

Serving: ViT CLIP models (ViT-B-32 first) from ``create_model_and_transforms``
through the device-side preprocess, ``encode_image``/``encode_text`` and
``build_zero_shot_classifier``; NaFlex models (``naflex_ViT-B-16``) take patch dicts
from ``data.naflex.NaFlexTransform``; Swin towers (``swin_base_patch4_window7_224``)
take images; CLAP models (``CLAP-HTSAT-tiny``) take waveform dicts from
``data.audio.AudioPreprocess`` into ``encode_audio``, with the log-mel on the card.
Weights: ``create_model(name, pretrained=<file>)`` and ``local-dir:<dir>`` load the
reference's ``.pt``/``.bin``/``.safetensors``/``.npz`` checkpoints (``checkpoint.py``,
``convert.py``), ``convert.load_big_vision_weights`` big_vision SigLIP files, and
``save_for_hf`` writes a model directory. Training: ``clip_loss``,
``create_optimizer`` (AdamW, with layer-wise lr decay and tower locking),
``make_train_step`` and the CLI ``python -m open_clip_tpu_torch.train.main``. Attention runs on hand-written CUDA
kernels, forward and backward: at CLIP lengths ``ops/short_attention.py``, at 512
tokens and more ``ops/flash_attention.py``, in Swin windows
``ops/window_attention.py`` and ``ops/swin_attention.py``; LayerNorm's backward can
(``ops/fused_ln.py``). Entry
points build on the GPU unless given ``device="cpu"``. The package imports neither JAX nor ``open_clip_tpu``.
"""

from .config import (
    CLIPAudioCfg,
    CLIPModelCfg,
    CLIPTextCfg,
    CLIPVisionCfg,
    add_model_config,
    get_model_config,
    list_models,
)
from .constants import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    INCEPTION_MEAN,
    INCEPTION_STD,
    OPENAI_DATASET_MEAN,
    OPENAI_DATASET_STD,
)
from .convert import convert_params_dtype_, params_from_jax
from .factory import (create_model, create_model_and_transforms, create_model_from_pretrained,
                      get_tokenizer, load_checkpoint)
from .loss import clip_loss
from .pretrained import (get_pretrained_cfg, get_pretrained_url, list_pretrained,
                         list_pretrained_models_by_tag, list_pretrained_tags_by_model)
from .push_to_hf_hub import save_for_hf
from .models.clip import (
    CLIPModel,
    clip_forward,
    encode_audio,
    encode_image,
    encode_text,
    get_logits,
)
from .train.optim import OptimizerCfg, create_optimizer
from .train.scheduler import const_lr, cosine_lr, create_scheduler
from .train.train_step import TrainState, create_train_state, make_train_step
from .tokenizer import DEFAULT_CONTEXT_LENGTH, SimpleTokenizer, tokenize
from .transform import PreprocessCfg, make_device_preprocess
from .zero_shot_classifier import build_zero_shot_classifier
from .zero_shot_metadata import (
    IMAGENET_CLASSNAMES,
    OPENAI_IMAGENET_TEMPLATES,
    SIMPLE_IMAGENET_TEMPLATES,
)

__all__ = [
    "CLIPAudioCfg", "CLIPModelCfg", "CLIPTextCfg", "CLIPVisionCfg", "add_model_config", "get_model_config",
    "list_models",
    "IMAGENET_MEAN", "IMAGENET_STD", "INCEPTION_MEAN", "INCEPTION_STD",
    "OPENAI_DATASET_MEAN", "OPENAI_DATASET_STD",
    "convert_params_dtype_", "params_from_jax",
    "create_model", "create_model_and_transforms", "create_model_from_pretrained",
    "get_tokenizer", "load_checkpoint", "save_for_hf",
    "get_pretrained_cfg", "get_pretrained_url", "list_pretrained",
    "list_pretrained_models_by_tag", "list_pretrained_tags_by_model",
    "clip_loss", "OptimizerCfg", "create_optimizer", "const_lr", "cosine_lr", "create_scheduler",
    "TrainState", "create_train_state", "make_train_step",
    "CLIPModel", "clip_forward", "encode_audio", "encode_image", "encode_text", "get_logits",
    "DEFAULT_CONTEXT_LENGTH", "SimpleTokenizer", "tokenize",
    "PreprocessCfg", "make_device_preprocess",
    "build_zero_shot_classifier",
    "IMAGENET_CLASSNAMES", "OPENAI_IMAGENET_TEMPLATES", "SIMPLE_IMAGENET_TEMPLATES",
]
