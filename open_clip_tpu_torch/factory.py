"""Model factory (counterpart of ``open_clip_tpu/factory.py``): ``create_model``,
``create_model_and_transforms``, ``create_model_from_pretrained``,
``load_checkpoint`` and ``get_tokenizer``.

Models are built on the card unless the caller asks for another device:
``device=None`` means CUDA, and raises where CUDA is absent; there is no quiet
fallback to the CPU. Weights are drawn from a ``torch.Generator`` seeded by
``seed`` with the JAX package's init distributions, then, where ``pretrained``
names a checkpoint file (``.pt``, ``.bin``, ``.safetensors``, ``.npz``) or the model
name is ``local-dir:<dir>`` (``open_clip_config.json`` and
``open_clip_model.safetensors`` or ``open_clip_pytorch_model.bin``), loaded from it
on the CPU (``checkpoint.load_checkpoint``) before the model moves to its device;
``pure_bf16`` casts after the load. A registry tag (``pretrained.py``) sets the
preprocess and ``quick_gelu`` as in the JAX package, then raises: the port
downloads nothing, and the message names the file the tag needs. ``hf-hub:`` names
raise for the same reason. The model comes back with every parameter trainable; it
has no dropout, and its one batch norm (HTSAT's ``bn0`` in CLAP models) uses its
stored statistics in training too, so serving and training run the same forward,
and callers that only serve run it under ``torch.inference_mode()``.
"""

from __future__ import annotations

import json
import logging
import os
from pathlib import Path
from typing import Any, Dict, Optional, Tuple, Union

import torch

from .checkpoint import load_checkpoint as _load_checkpoint_into
from .config import CLIPModelCfg, get_model_config
from .constants import HF_CONFIG_NAME, HF_SAFE_WEIGHTS_NAME, HF_WEIGHTS_NAME
from .convert import convert_params_dtype_
from .models.clip import CLIPModel
from .tokenizer import DEFAULT_CONTEXT_LENGTH, SimpleTokenizer
from .models.naflex_vit import is_naflex
from .pretrained import get_pretrained_cfg, list_pretrained_tags_by_model, pretrained_location
from .transform import (PreprocessCfg, make_device_preprocess, merge_preprocess_dict,
                        uint8_image_transform_v2)

logger = logging.getLogger(__name__)

HF_HUB_PREFIX = "hf-hub:"
LOCAL_DIR_PREFIX = "local-dir:"

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


def _resolve(model_name: str, pretrained: Optional[str]):
    """(config dict, the registry entry or model directory's preprocess overlay,
    the checkpoint path or None) for a model name and ``pretrained``."""
    if model_name.startswith(HF_HUB_PREFIX):
        raise NotImplementedError(
            f"{model_name}: loading from the Hugging Face hub is not ported (no download); "
            f"put the repo's {HF_CONFIG_NAME} and {HF_SAFE_WEIGHTS_NAME} in a directory and "
            f"pass 'local-dir:<dir>'")
    if model_name.startswith(LOCAL_DIR_PREFIX):
        d = Path(model_name[len(LOCAL_DIR_PREFIX):])
        with open(d / HF_CONFIG_NAME) as fh:
            hub_cfg = json.load(fh)
        if pretrained is None:
            pretrained = next((str(d / f) for f in (HF_SAFE_WEIGHTS_NAME, HF_WEIGHTS_NAME)
                               if (d / f).exists()), None)
        return hub_cfg["model_cfg"], {"preprocess_cfg": hub_cfg.get("preprocess_cfg", {})}, \
            pretrained
    raw = get_model_config(model_name)
    if raw is None:
        raise RuntimeError(f"Model config for {model_name} not found.")
    if not pretrained or os.path.exists(pretrained):
        return raw, {}, pretrained or None
    entry = get_pretrained_cfg(model_name, pretrained)
    if not entry:
        raise RuntimeError(f"Pretrained weights ({pretrained}) not found for model {model_name}. "
                           f"Available tags: {list_pretrained_tags_by_model(model_name)}")
    return raw, entry, None


def _build_preprocess_cfg(cfg: CLIPModelCfg, pretrained_cfg: Dict[str, Any]) -> PreprocessCfg:
    base = PreprocessCfg()
    if cfg.vision_cfg is not None:
        base.size = cfg.vision_cfg.image_size
    overlay = dict(pretrained_cfg.get("preprocess_cfg", {}))
    overlay.pop("quick_gelu", None)
    return merge_preprocess_dict(base, overlay)


def create_model(model_name: str, pretrained: Optional[str] = None, precision: str = "fp32",
                 device=None, seed: int = 0, force_quick_gelu: bool = False,
                 force_custom_text: bool = False, force_patch_dropout: Optional[float] = None,
                 force_image_size: Optional[Union[int, Tuple[int, int]]] = None,
                 force_context_length: Optional[int] = None,
                 require_pretrained: bool = False) -> CLIPModel:
    """Build a model from ``seed`` and load ``pretrained`` into it (a checkpoint path;
    a registry tag raises after reading its settings), on ``device`` (CUDA by
    default). The ``force_*`` overrides change the config before the model is built;
    a checkpoint's position embeddings are resized to a forced image size or context
    length. A GenLIP or GenLAP config builds ``GenLipModel`` or ``GenLapModel``
    (``_create_generative``)."""
    if precision not in _PRECISION_DTYPES:
        raise ValueError(f"unknown precision {precision!r}; one of {sorted(_PRECISION_DTYPES)}")
    device = resolve_device(device)
    if not model_name.startswith((HF_HUB_PREFIX, LOCAL_DIR_PREFIX)):
        model_name = model_name.replace("/", "-")
    raw, pretrained_cfg, ckpt_path = _resolve(model_name, pretrained)
    if pretrained and ckpt_path is None and not model_name.startswith(LOCAL_DIR_PREFIX):
        raise NotImplementedError(
            f"pretrained tag {pretrained!r} of {model_name}: downloading is not ported; its "
            f"weights are at {pretrained_location(pretrained_cfg)}: fetch the file and pass "
            "its path as pretrained=")
    dtype = _PRECISION_DTYPES[precision]
    if raw.get("genlip_cfg") is not None or raw.get("genlap_cfg") is not None:
        return _create_generative(raw, ckpt_path, dtype, seed, device)
    cfg = CLIPModelCfg.from_dict(raw)
    if pretrained_cfg.get("preprocess_cfg", {}).get("quick_gelu") and not cfg.quick_gelu:
        force_quick_gelu = True
    if force_quick_gelu:
        cfg.quick_gelu = True
    if force_custom_text:
        cfg.custom_text = True
    if force_patch_dropout is not None and cfg.vision_cfg is not None:
        cfg.vision_cfg.patch_dropout = force_patch_dropout
    if force_image_size is not None and cfg.vision_cfg is not None:
        cfg.vision_cfg.image_size = force_image_size
    if force_context_length is not None and cfg.text_cfg is not None:
        cfg.text_cfg.context_length = force_context_length
    if require_pretrained and not ckpt_path:
        raise RuntimeError(f"pretrained weights required but not resolved for {model_name}")

    model = CLIPModel(cfg, compute_dtype=dtype)
    model.init_weights(torch.Generator().manual_seed(seed))
    if ckpt_path:
        logger.info("loading pretrained weights from %s", ckpt_path)
        _load_checkpoint_into(model, ckpt_path)
    if precision.startswith("pure_"):
        convert_params_dtype_(model, dtype)
    if cfg.vision_cfg is not None:
        model.preprocess_cfg = _build_preprocess_cfg(cfg, pretrained_cfg)
    return model.to(device)


def model_from_config(raw: Dict[str, Any], compute_dtype: torch.dtype = torch.float32):
    """The uninitialised module a config dict builds: ``GenLapModel``,
    ``GenLipModel`` or ``CLIPModel``."""
    if raw.get("genlap_cfg") is not None:
        from .models.genlap import GenLapModel, GenLapModelCfg

        return GenLapModel(GenLapModelCfg.from_dict(raw), compute_dtype)
    if raw.get("genlip_cfg") is not None:
        from .models.genlip import GenLipModel, GenLipModelCfg

        return GenLipModel(GenLipModelCfg.from_dict(raw), compute_dtype)
    return CLIPModel(CLIPModelCfg.from_dict(raw), compute_dtype)


def _create_generative(raw: Dict[str, Any], ckpt_path: Optional[str], dtype: torch.dtype,
                       seed: int, device: torch.device):
    """GenLIP/GenLAP as the JAX ``_create_genlip`` builds them: the ``force_*``
    overrides do not apply, the precision sets the compute dtype only (the weights
    stay float32), and a checkpoint file replaces every weight."""
    model = model_from_config(raw, dtype)
    model.init_weights(torch.Generator().manual_seed(seed))
    if ckpt_path:
        logger.info("loading pretrained weights from %s", ckpt_path)
        _load_checkpoint_into(model, ckpt_path)
    return model.to(device)


def create_model_and_transforms(model_name: str, pretrained: Optional[str] = None, *,
                                image_mean=None, image_std=None,
                                image_interpolation: Optional[str] = None,
                                image_resize_mode: Optional[str] = None, **kwargs):
    """(model, preprocess_train, preprocess_val). For an image model
    ``preprocess_val`` is the device-side preprocess (uint8 NHWC on the model's device
    -> normalized NHWC), and ``preprocess_train`` the host canvas stage
    (``transform.uint8_image_transform_v2``: JPEG bytes -> uint8 canvas through the
    native decoder), which pairs with ``make_device_train_preprocess`` in the
    train step (``make_train_step(device_preprocess=...)``); a NaFlex model's is None
    (its images become patch dicts). The ``image_*`` arguments override the model's
    preprocess settings. For a CLAP model both are the host
    ``AudioPreprocess`` of ``data/audio.py`` ((waveform, sample rate) -> fixed-length
    waveform dict): a random window for training, the clip's start for evaluation;
    for a naflexvit audio tower both are the host ``AudioNaFlexPatchify`` at the
    token count of a 10 s clip ((waveform, sample rate) -> mel patch dict); GenLIP and
    GenLAP take ``generative_transforms``."""
    model = create_model(model_name, pretrained, **kwargs)
    if hasattr(model.cfg, "trunk_cfg"):
        return (model, *generative_transforms(model))
    if model.cfg.audio_cfg is not None and model.cfg.audio_cfg.model_type == "naflexvit":
        pp = naflex_audio_preprocess(model.cfg.audio_cfg)
        return model, pp, pp
    if model.cfg.audio_cfg is not None:
        from .data.audio import audio_transform_v2

        return (model, audio_transform_v2(model.cfg.audio_cfg, is_train=True),
                audio_transform_v2(model.cfg.audio_cfg, is_train=False))
    cfg = model.preprocess_cfg = merge_preprocess_dict(model.preprocess_cfg, {
        "mean": image_mean, "std": image_std, "interpolation": image_interpolation,
        "resize_mode": image_resize_mode})
    train = None if is_naflex(model.cfg.vision_cfg) else uint8_image_transform_v2(cfg, True)
    return model, train, make_device_preprocess(cfg)


def generative_transforms(model):
    """(train, val) transforms of GenLIP and GenLAP, the JAX package's: GenLAP's mel
    patchify padded to a 10 s clip's token count, and for GenLIP a factory
    ``(seq_len, patch_size=None) -> NaFlexTransform`` of the bucket."""
    if hasattr(model.cfg, "audio_cfg"):
        from .data.naflex_audio import AudioNaFlexPatchify, naflex_audio_eval_seq_len

        acfg = model.cfg.audio_cfg
        pp = AudioNaFlexPatchify(acfg, max_audio_tokens=naflex_audio_eval_seq_len(acfg))
        return pp, pp
    from .data.naflex import NaFlexTransform

    def bucket(seq_len: int, patch_size: Optional[int] = None) -> NaFlexTransform:
        return NaFlexTransform(seq_len, patch_size or model.cfg.vision_cfg.patch_size)

    return bucket, bucket


def naflex_audio_preprocess(audio_cfg):
    """The patchify of a naflexvit audio tower, padded to a 10 s clip's token count."""
    from .data.naflex_audio import AudioNaFlexPatchify, naflex_audio_eval_seq_len
    from .models.naflex_audio import audio_naflex_cfg_from_clip_audio

    acfg = audio_naflex_cfg_from_clip_audio(audio_cfg)
    return AudioNaFlexPatchify(acfg, max_audio_tokens=naflex_audio_eval_seq_len(acfg))


def create_model_from_pretrained(model_name: str, pretrained: Optional[str] = None, *,
                                 return_transform: bool = True, **kwargs):
    """(model, preprocess_val) for inference, or the model alone; the weights must
    load."""
    model = create_model(model_name, pretrained, require_pretrained=True, **kwargs)
    if not return_transform:
        return model
    return model, (None if model.preprocess_cfg is None
                   else make_device_preprocess(model.preprocess_cfg))


def load_checkpoint(model: CLIPModel, path, strict: bool = True) -> CLIPModel:
    """Load a reference checkpoint file into ``model`` in place."""
    return _load_checkpoint_into(model, path, strict=strict)


def get_tokenizer(model_name: str = "", context_length: Optional[int] = None) -> SimpleTokenizer:
    """The CLIP BPE tokenizer at the model config's context length, checked against
    the config's special-token ids (``validate_special_tokens``)."""
    raw = get_model_config(model_name) if model_name else None
    text_cfg = (raw or {}).get("text_cfg", {})
    if text_cfg.get("hf_tokenizer_name") or text_cfg.get("tokenizer_type"):
        vocab = text_cfg.get("hf_tokenizer_name") or text_cfg["tokenizer_type"]
        if text_cfg.get("tokenizer_type") == "tiktoken":
            name = text_cfg.get("tiktoken_name", "cl100k_base")
            vocab = f"tiktoken {name}: the file {name}.tiktoken and the tiktoken package"
        raise NotImplementedError(
            f"tokenizer of {model_name!r} is not ported yet: it needs the vocabulary "
            f"{vocab!r}, which is not in the repository (feed token ids instead)")
    if context_length is None:
        context_length = text_cfg.get("context_length", DEFAULT_CONTEXT_LENGTH)
    tok = SimpleTokenizer(context_length=context_length, **text_cfg.get("tokenizer_kwargs", {}))
    validate_special_tokens(text_cfg, tok)
    return tok


def validate_special_tokens(text_cfg: Dict[str, Any], tokenizer) -> None:
    """Raise where the config's special-token ids disagree with the tokenizer's: a
    wrong ``eos_id`` pools the wrong positions, and ``variable_text`` needs a
    tokenizer with a pad id of its own (the CLIP BPE tokenizer has none)."""
    pool_type = text_cfg.get("pool_type", "argmax")
    if pool_type == "eos" or (text_cfg.get("text_arch") == "modern" and pool_type == "argmax"):
        eos_id = text_cfg.get("eos_id")
        if eos_id is None:
            raise ValueError("pool_type='eos' requires text_cfg.eos_id (must match the "
                             "tokenizer eos/eot id)")
        tok_eos = getattr(tokenizer, "eot_token_id", None)
        if tok_eos is not None and int(tok_eos) != int(eos_id):
            raise ValueError(f"text_cfg.eos_id ({eos_id}) != tokenizer eos/eot id ({tok_eos}); "
                             "eos pooling would index the wrong positions")
    tok_pad = getattr(tokenizer, "pad_token_id", None)
    if text_cfg.get("variable_text", False) and tok_pad is None:
        raise ValueError("variable_text=True requires a tokenizer with a reserved pad_token_id")
    pad_id = text_cfg.get("pad_id")
    if pad_id is not None and tok_pad is not None and int(tok_pad) != int(pad_id):
        raise ValueError(f"text_cfg.pad_id ({pad_id}) != tokenizer pad id ({tok_pad}); "
                         "pad masks and padding would disagree")
