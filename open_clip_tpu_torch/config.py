"""Model configuration dataclasses and the model-config registry.

Schema-compatible with the reference open_clip JSON model configs and with the
JAX package's ``config.py``. The audio section parses into ``CLIPAudioCfg`` (the
HTSAT towers are ported); the CoCa decoder, NaFlex-audio, GenLIP and GenLAP
sections are kept as raw dicts: those families are not ported, and a model that
has one raises at build time.
"""

from __future__ import annotations

import dataclasses
import json
import logging
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple, Union

logger = logging.getLogger(__name__)


def _filter_cfg(cls, d: Dict[str, Any]) -> Dict[str, Any]:
    """Keep the keys that are fields of ``cls``, warning on the others."""
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = sorted(set(d) - names)
    if unknown:
        logger.warning("%s: unknown config keys %s", cls.__name__, unknown)
    return {k: v for k, v in d.items() if k in names}


@dataclass
class CLIPVisionCfg:
    layers: Union[Tuple[int, int, int, int], List[int], int] = 12
    width: int = 768
    head_width: int = 64
    mlp_ratio: float = 4.0
    patch_size: Optional[int] = 16
    image_size: Union[Tuple[int, int], int] = 224
    image_seq_len: Optional[int] = None

    ls_init_value: Optional[float] = None
    patch_dropout: float = 0.0
    attentional_pool: Union[bool, str] = False
    attn_pooler_queries: int = 256
    attn_pooler_heads: int = 8
    no_ln_pre: bool = False
    pos_embed_type: str = "learnable"
    final_ln_after_pool: bool = False
    pool_type: str = "tok"
    output_tokens: bool = False
    act_kwargs: Optional[dict] = None
    norm_kwargs: Optional[dict] = None

    block_type: Optional[str] = None
    qk_norm: bool = False
    scaled_cosine_attn: bool = False
    scale_heads: bool = False
    scale_attn_inner: bool = False
    scale_attn: bool = False
    scale_fc: bool = False

    class_token: bool = True
    conv_stem_channels: Optional[Tuple[int, ...]] = None
    conv_stem_strides: Optional[Tuple[int, ...]] = None

    timm_model_name: Optional[str] = None
    timm_model_pretrained: bool = False
    timm_pool: str = "avg"
    timm_proj: str = "linear"
    timm_proj_bias: bool = False
    timm_drop: float = 0.0
    timm_drop_path: Optional[float] = None
    timm_model_kwargs: Optional[dict] = None

    def __post_init__(self):
        if isinstance(self.layers, list):
            self.layers = tuple(self.layers)

    @property
    def is_resnet(self) -> bool:
        return isinstance(self.layers, (tuple, list))

    @property
    def heads(self) -> int:
        return self.width // self.head_width

    @property
    def norm_eps(self) -> float:
        return float((self.norm_kwargs or {}).get("eps", 1e-5))

    @property
    def grid_size(self) -> Tuple[int, int]:
        ih, iw = to_2tuple(self.image_size)
        ph, pw = to_2tuple(self.patch_size)
        return ih // ph, iw // pw


@dataclass
class CLIPTextCfg:
    text_arch: str = "clip"
    context_length: int = 77
    variable_text: bool = False
    vocab_size: int = 49408
    hf_tokenizer_name: Optional[str] = None
    tokenizer_mode: Optional[str] = None
    tokenizer_kwargs: Optional[dict] = None

    width: int = 512
    heads: int = 8
    layers: int = 12
    mlp_ratio: float = 4.0
    ls_init_value: Optional[float] = None
    embed_cls: bool = False
    pad_id: int = 0
    bos_id: Optional[int] = None
    eos_id: Optional[int] = None
    tokenizer_type: str = ""
    tiktoken_name: str = "cl100k_base"
    no_causal_mask: bool = False
    final_ln_after_pool: bool = False
    pool_type: str = "argmax"
    proj_bias: bool = False
    proj_type: str = "linear"
    output_tokens: bool = False
    act_kwargs: Optional[dict] = None
    norm_kwargs: Optional[dict] = None

    block_type: Optional[str] = None
    qk_norm: bool = False
    scaled_cosine_attn: bool = False
    scale_heads: bool = False
    scale_attn_inner: bool = False
    scale_attn: bool = False
    scale_fc: bool = False

    attention_mode: str = "causal"
    pos_embed: str = "rope"
    rope_temperature: float = 10000.0
    mlp_type: str = "swiglu"
    norm_type: Optional[str] = None
    norm_eps: float = 1e-6
    attn_gated: bool = False
    pre_norm: bool = False
    norm_placement: str = "pre"
    zero_init_residual: bool = False
    reg_tokens: int = 0
    value_residual: bool = False
    attention_bias: Optional[bool] = None
    mlp_bias: Optional[bool] = None
    gate_bias: Optional[bool] = None

    hf_model_name: Optional[str] = None
    hf_model_pretrained: bool = True
    hf_proj_type: str = "mlp"
    hf_pooler_type: str = "mean_pooler"
    hf_model_config: Optional[dict] = None

    @property
    def ln_eps(self) -> float:
        return float((self.norm_kwargs or {}).get("eps", 1e-5))


@dataclass
class CLIPAudioCfg:
    """Audio tower config (the JAX package's ``CLIPAudioCfg``)."""

    model_type: str = "HTSAT"  # HTSAT | whisper | naflexvit
    model_name: str = "tiny"
    audio_length: int = 1024
    clip_samples: int = 480000
    sample_rate: int = 48000
    mel_bins: int = 64
    window_size: int = 1024
    hop_size: int = 480
    fmin: int = 50
    fmax: int = 14000
    class_num: int = 527
    enable_fusion: bool = False
    fusion_type: str = "aff_2d"
    pre_norm: bool = False
    proj_act: str = "gelu"
    training_head: bool = False
    pretrained: bool = False

    # NaFlexClap (model_type == "naflexvit"): spectrogram-ViT encoder geometry
    patch_freq: int = 64
    patch_time: int = 4
    in_chans: int = 1
    patch_pad_mode: str = "floor"
    rope_type: str = "axial"
    audio_seq_len: Optional[int] = None
    naflexvit_cfg: Optional[dict] = None


@dataclass
class CLIPModelCfg:
    """Top-level model config: what a ``model_configs/*.json`` file contains."""

    embed_dim: int = 512
    vision_cfg: Optional[CLIPVisionCfg] = None
    text_cfg: Optional[CLIPTextCfg] = None
    multimodal_cfg: Optional[dict] = None
    audio_cfg: Optional[CLIPAudioCfg] = None
    audio_naflex_cfg: Optional[dict] = None
    genlip_cfg: Optional[dict] = None
    genlap_cfg: Optional[dict] = None
    quick_gelu: bool = False
    custom_text: bool = False
    init_logit_scale: Optional[float] = None
    init_logit_bias: Optional[float] = None

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "CLIPModelCfg":
        d = dict(d)
        vision = d.pop("vision_cfg", None)
        text = d.pop("text_cfg", None)
        audio = d.pop("audio_cfg", None)
        out = cls(**_filter_cfg(cls, d))
        if vision is not None:
            out.vision_cfg = CLIPVisionCfg(**_filter_cfg(CLIPVisionCfg, vision))
        if text is not None:
            out.text_cfg = CLIPTextCfg(**_filter_cfg(CLIPTextCfg, text))
        if audio is not None:
            out.audio_cfg = CLIPAudioCfg(**_filter_cfg(CLIPAudioCfg, audio))
        return out

    def to_dict(self) -> Dict[str, Any]:
        """The config as a model-config dict, as the JAX package's ``to_dict`` writes
        it: the towers without their None fields, the flags only where set."""
        def clean(dc):
            return {k: v for k, v in dataclasses.asdict(dc).items() if v is not None}

        d: Dict[str, Any] = {"embed_dim": self.embed_dim}
        for name in ("vision_cfg", "text_cfg", "audio_cfg"):
            if getattr(self, name) is not None:
                d[name] = clean(getattr(self, name))
        if self.multimodal_cfg is not None:
            d["multimodal_cfg"] = dict(self.multimodal_cfg)
        for k in ("quick_gelu", "custom_text"):
            if getattr(self, k):
                d[k] = True
        for k in ("init_logit_scale", "init_logit_bias"):
            if getattr(self, k) is not None:
                d[k] = getattr(self, k)
        return d


def to_2tuple(x) -> Tuple:
    if isinstance(x, (tuple, list)):
        assert len(x) == 2
        return tuple(x)
    return (x, x)


def add_model_config(path_or_dict, name: Optional[str] = None) -> None:
    """Register a model config from a JSON file or a dict (a dict needs ``name``)."""
    from .model_configs import BUILTIN_MODEL_CONFIGS

    if isinstance(path_or_dict, dict):
        if not name:
            raise ValueError("name required when adding a config dict")
        BUILTIN_MODEL_CONFIGS[name] = dict(path_or_dict)
        return
    path = Path(path_or_dict)
    with open(path) as fh:
        BUILTIN_MODEL_CONFIGS[name or path.stem] = json.load(fh)


def list_models() -> List[str]:
    from .model_configs import BUILTIN_MODEL_CONFIGS

    return sorted(BUILTIN_MODEL_CONFIGS, key=lambda s: s.lower())


def get_model_config(model_name: str) -> Optional[Dict[str, Any]]:
    """A deep copy of the raw config dict, or None; ``/`` in names reads as ``-``."""
    from .model_configs import BUILTIN_MODEL_CONFIGS

    cfg = BUILTIN_MODEL_CONFIGS.get(model_name.replace("/", "-"))
    return json.loads(json.dumps(cfg)) if cfg is not None else None


def parse_model_cfg(model_name: str, **overrides) -> CLIPModelCfg:
    raw = get_model_config(model_name)
    if raw is None:
        raise RuntimeError(f"Model config for {model_name} not found; "
                           f"available: {', '.join(list_models())}")
    raw.update({k: v for k, v in overrides.items() if v is not None})
    return CLIPModelCfg.from_dict(raw)
