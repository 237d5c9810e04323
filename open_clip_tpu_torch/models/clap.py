"""CLAP: contrastive language-audio pretraining (counterpart of
``open_clip_tpu/models/clap.py``).

The audio tower is the HTSAT encoder (``models/htsat.py``) on waveform dicts, or
the NaFlex spectrogram ViT (``models/naflex_audio.py``, ``model_type ==
"naflexvit"``) on mel patch dicts, followed by an optional L2 ``pre_norm`` and the
2-layer MLP projection with ``proj_act``; the text tower is the model's, as in
``models/clip.py`` (the CLIP tower or the modern one). Module names follow the
reference checkpoint (``audio.encoder.*``, ``audio.proj.0``, ``audio.proj.2``). The
Whisper audio encoder is not ported and raises; neither package converts a
reference checkpoint of a NaFlex audio tower.
"""

from __future__ import annotations

import math
from typing import Dict, Set

import torch
from torch import nn

from ..config import CLIPAudioCfg
from ..ops.layers import ACT_FNS, linear
from .htsat import HTSAT
from .naflex_audio import NaFlexAudioEncoder

HTSAT_CONFIGS = {
    "tiny": dict(embed_dim=96, depths=(2, 2, 6, 2), num_heads=(4, 8, 16, 32)),
    "base": dict(embed_dim=128, depths=(2, 2, 12, 2), num_heads=(4, 8, 16, 32)),
    "large": dict(embed_dim=256, depths=(2, 2, 12, 2), num_heads=(4, 8, 16, 32)),
}


def check_audio_cfg(acfg: CLIPAudioCfg) -> None:
    """Raise for the audio towers that are not ported."""
    mt = acfg.model_type.lower()
    if mt == "whisper":
        raise NotImplementedError(f"the {acfg.model_type} audio encoder is not ported yet "
                                  "(HTSAT and naflexvit are)")
    if mt == "naflexvit":
        return
    if mt != "htsat":
        raise ValueError(f"unsupported audio model type {acfg.model_type!r}")
    if acfg.model_name not in HTSAT_CONFIGS:
        raise ValueError(f"unknown HTSAT size {acfg.model_name!r}; one of {sorted(HTSAT_CONFIGS)}")


class _Act(nn.Module):
    def __init__(self, name: str):
        super().__init__()
        self.fn = torch.relu if name == "relu" else ACT_FNS["gelu"]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fn(x)


def is_naflex_audio(acfg: CLIPAudioCfg) -> bool:
    return acfg.model_type.lower() == "naflexvit"


class AudioTower(nn.Module):
    """HTSAT or NaFlex audio encoder, optional L2 pre-norm, 2-layer MLP projection
    (``proj.0``, ``proj.2``)."""

    def __init__(self, acfg: CLIPAudioCfg, embed_dim: int):
        super().__init__()
        check_audio_cfg(acfg)
        self.cfg = acfg
        self.encoder = (NaFlexAudioEncoder(acfg) if is_naflex_audio(acfg)
                        else HTSAT(acfg, **HTSAT_CONFIGS[acfg.model_name]))
        width = self.encoder.num_features
        self.proj = nn.Sequential(nn.Linear(width, embed_dim), _Act(acfg.proj_act),
                                  nn.Linear(embed_dim, embed_dim))

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator) -> None:
        self.encoder.init_weights(gen)
        for lin in (self.proj[0], self.proj[2]):
            bound = 1.0 / math.sqrt(lin.in_features)
            lin.weight.uniform_(-bound, bound, generator=gen)
            lin.bias.uniform_(-bound, bound, generator=gen)

    def forward(self, audio: Dict[str, torch.Tensor], compute_dtype: torch.dtype = torch.float32,
                apply_proj: bool = True, remat: bool = False) -> torch.Tensor:
        """``remat`` recomputes the NaFlex encoder's blocks in the backward pass; HTSAT
        takes none, as in the JAX package."""
        from .clip import _l2_normalize

        if is_naflex_audio(self.cfg):
            features = self.encoder(audio, compute_dtype, remat=remat)
        else:
            features = self.encoder(audio, compute_dtype)
        if self.cfg.pre_norm:
            features = _l2_normalize(features)
        if apply_proj:
            fc1, act, fc2 = self.proj
            h = act(linear(features, fc1.weight, fc1.bias, transposed=True))
            features = linear(h, fc2.weight, fc2.bias, transposed=True)
        return features


def encode_audio(model, audio, *, normalize: bool = False, remat: bool = False) -> torch.Tensor:
    """A waveform dict ({"waveform": (B, T) fp32, "longer": (B,) bool}) or a bare
    (B, T) waveform (HTSAT), or a mel patch dict (naflexvit) -> (B, embed_dim)
    features."""
    from .clip import _as_tensor, _l2_normalize

    if not isinstance(audio, dict):
        audio = {"waveform": audio}
    if is_naflex_audio(model.cfg.audio_cfg) and "patches" not in audio:
        raise ValueError("a naflexvit audio tower takes the mel patch dict of "
                         "data.naflex_audio.AudioNaFlexPatchify, not a waveform")
    audio = {k: _as_tensor(v, model.device) for k, v in audio.items()}
    feats = model.audio(audio, model.compute_dtype, apply_proj=not model.cfg.audio_cfg.training_head,
                        remat=remat)
    return _l2_normalize(feats) if normalize else feats


def clap_forward(model, audio=None, text=None, *, remat: bool = False) -> Dict[str, torch.Tensor]:
    """The reference ``CLAP.forward`` as a dict: normalized ``audio_features`` and
    ``text_features``, ``logit_scale`` (and ``logit_bias``)."""
    from .clip import encode_text

    out: Dict[str, torch.Tensor] = {}
    if audio is not None:
        out["audio_features"] = encode_audio(model, audio, normalize=True, remat=remat)
    if text is not None:
        out["text_features"] = encode_text(model, text, normalize=True, remat=remat)
    out["logit_scale"] = model.logit_scale.float().exp()
    if model.logit_bias is not None:
        out["logit_bias"] = model.logit_bias.float()
    return out


def params_outside_loss(model) -> Set[str]:
    """Names of the parameters that the contrastive loss does not reach: HTSAT's
    token-semantic head (``tscam_conv``) and classifier (``head``); the NaFlex
    encoder has none. Under ``jit`` their gradients are zeros; the train step gives
    them zeros here too."""
    return {n for n, _ in model.named_parameters()
            if n.startswith(("audio.encoder.tscam_conv.", "audio.encoder.head."))}


def torch_clap_to_params(sd, cfg) -> Dict[str, object]:
    """A reference CLAP state dict (``audio.encoder.*``, ``audio.proj.*``, ``text.*``,
    ``logit_*``) -> the JAX package's tree (numpy leaves), as its
    ``torch_clap_to_params`` makes it; HTSAT only (Whisper is not ported)."""
    from ..convert import normalize_torch_state_dict, torch_clip_to_params
    from .htsat import torch_htsat_to_params

    sd = normalize_torch_state_dict(sd)
    tree = torch_clip_to_params({k: v for k, v in sd.items() if not k.startswith("audio.")}, cfg)
    mt = cfg.audio_cfg.model_type.lower()
    if mt == "naflexvit":  # the JAX package has no converter for it either
        raise NotImplementedError("CLAP checkpoints with a naflexvit audio tower have no "
                                  "converter (in the JAX package neither)")
    if mt != "htsat":
        raise NotImplementedError(f"CLAP checkpoints with a {cfg.audio_cfg.model_type} audio "
                                  "tower are not ported yet (HTSAT is)")
    tree["audio"] = {"encoder": torch_htsat_to_params(sd, prefix="audio.encoder."),
                     "proj": _proj_tree(sd, "audio.proj")}
    return tree


def _proj_tree(sd, prefix: str) -> Dict[str, object]:
    out = {}
    for fc, idx in (("fc1", 0), ("fc2", 2)):
        out[fc] = {"kernel": sd[f"{prefix}.{idx}.weight"].T}
        if sd.get(f"{prefix}.{idx}.bias") is not None:
            out[fc]["bias"] = sd[f"{prefix}.{idx}.bias"]
    return out


_HF_BLOCK_SWAPS = (
    ("layernorm_before.", "norm1."),
    ("layernorm_after.", "norm2."),
    ("attention.self.relative_position_bias_table", "attn.relative_position_bias_table"),
    ("attention.output.dense.", "attn.proj."),
    ("intermediate.dense.", "mlp.fc1."),
    ("output.dense.", "mlp.fc2."),
)


def convert_hf_clap_state_dict(sd) -> Dict[str, object]:
    """Keys of transformers' ``ClapModel`` -> the reference CLAP's (the JAX package's
    ``convert_hf_clap_state_dict``): the separate q/k/v projections concatenated into
    the fused qkv, the block submodules renamed, ``logit_scale_a`` as the one scale."""
    import re

    import numpy as np

    from ..convert import _np

    sd = {k.removeprefix("module."): v for k, v in sd.items()}
    out: Dict[str, object] = {}
    qkv_re = re.compile(r"audio_model\.audio_encoder\.layers\.(\d+)\.blocks\.(\d+)\.attention\."
                        r"self\.(query|key|value)\.(weight|bias)")
    block_re = re.compile(r"audio_model\.audio_encoder\.layers\.(\d+)\.blocks\.(\d+)\.(.+)")
    grouped: Dict[tuple, Dict[str, object]] = {}
    for k, v in sd.items():
        m = qkv_re.match(k)
        if m:
            li, bi, name, param = m.groups()
            grouped.setdefault((li, bi, param), {})[name] = v
    for (li, bi, param), t in grouped.items():
        if all(n in t for n in ("query", "key", "value")):
            out[f"audio.encoder.layers.{li}.blocks.{bi}.attn.qkv.{param}"] = np.concatenate(
                [_np(t["query"]), _np(t["key"]), _np(t["value"])], axis=0)
    renames = (("audio_model.audio_encoder.batch_norm.", "audio.encoder.bn0."),
               ("audio_model.audio_encoder.patch_embed.", "audio.encoder.patch_embed."),
               ("audio_model.audio_encoder.norm.", "audio.encoder.norm."))
    for k, v in sd.items():
        if qkv_re.match(k):
            continue
        if k == "logit_scale_a":
            out["logit_scale"] = v
        elif k.endswith((".position_ids", ".token_type_ids", "num_batches_tracked",
                         "relative_position_index", "attn_mask")):
            continue
        elif any(k.startswith(old) for old, _ in renames):
            old, new = next((o, n) for o, n in renames if k.startswith(o))
            out[k.replace(old, new, 1)] = v
        elif block_re.match(k):
            li, bi, suffix = block_re.match(k).groups()
            for old, new in _HF_BLOCK_SWAPS:
                if suffix.startswith(old):
                    out[f"audio.encoder.layers.{li}.blocks.{bi}.{suffix.replace(old, new, 1)}"] = v
                    break
        elif k.startswith("audio_model.audio_encoder.layers."):
            out[k.replace("audio_model.audio_encoder.layers.", "audio.encoder.layers.", 1)] = v
        else:
            for old, new in (("audio_projection.linear1.", "audio.proj.0."),
                             ("audio_projection.linear2.", "audio.proj.2."),
                             ("text_model.", "text.transformer."),
                             ("text_projection.linear1.", "text.proj.0."),
                             ("text_projection.linear2.", "text.proj.2.")):
                if k.startswith(old):
                    out[k.replace(old, new, 1)] = v
                    break
    return out


def hf_clap_audio_to_params(sd) -> Dict[str, object]:
    """The audio half of ``hf_clap_to_params``: a transformers ``ClapModel`` state
    dict -> ``{"audio": {"encoder", "proj"}, "logit_scale"}`` in the JAX package's
    tree (numpy leaves). Its checkpoints hold no token-semantic head (``tscam_conv``,
    ``head``); the JAX package merges them over an init tree, not strictly."""
    from ..convert import _np
    from .htsat import torch_htsat_to_params

    ref = {k: _np(v) for k, v in convert_hf_clap_state_dict(sd).items()}
    return {"logit_scale": ref["logit_scale"].reshape(()),
            "audio": {"encoder": torch_htsat_to_params(
                          {k: v for k, v in ref.items() if k.startswith("audio.encoder.")},
                          prefix="audio.encoder."),
                      "proj": _proj_tree(ref, "audio.proj")}}


def hf_clap_to_params(sd, cfg) -> Dict[str, object]:
    """A transformers ``ClapModel`` state dict -> the JAX package's tree. Its text
    tower is a Hugging Face RoBERTa, which the port does not build: the audio half
    converts (``hf_clap_audio_to_params``), the whole raises."""
    raise NotImplementedError("transformers ClapModel checkpoints carry a Hugging Face RoBERTa "
                              "text tower, which is not ported yet")
