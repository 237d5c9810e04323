"""The NaFlex audio encoder of CLAP (counterpart of ``open_clip_tpu/models/naflex_audio.py``).

A spectrogram ViT on the GenLIP trunk (``models/genlip.py``): a linear embedding
of the mel patches of ``data/naflex_audio.py``'s patch dict, (freq, time) axial
MRoPE (1-D time for full-height strips unless ``rope_type`` is "axial"),
bidirectional attention over the valid patches, then the MAP attention pool of
``models/naflex_vit.py`` with an MLP of 4 x width. The audio tower
(``models/clap.py``) projects its (B, width) output.

The trunk's settings come from ``audio_cfg.naflexvit_cfg`` as the JAX package
reads them (``_trunk_cfg_from_audio``): it reads ``embed_dim``, ``depth``,
``num_heads``, ``mlp_ratio``/``intermediate_size``, ``mrope_section``,
``attn_gated``, ``swiglu_mlp``, ``ls_init_value``, ``norm_type``, ``qk_norm``,
``attention_bias``, ``mlp_bias`` and ``hidden_act``, and nothing else: the
``init_values``, ``reg_tokens``, ``pre_norm`` and ``attn_pool_mlp_ratio`` that
the naflexclap configs also set change nothing, in the JAX package as here
(ROADMAP, faults of the reference).
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from ..config import CLIPAudioCfg
from ..ops.layers import linear
from .genlap import AudioNaFlexCfg, build_audio_position_ids
from .genlip import GenLipTrunk, GenLipTrunkCfg, mrope_cos_sin, trunk_mask
from .naflex_vit import AttentionPoolLatent


def _trunk_cfg_from_audio(acfg: CLIPAudioCfg) -> GenLipTrunkCfg:
    kw = dict(acfg.naflexvit_cfg or {})
    width = kw.get("embed_dim", 512)
    heads = kw.get("num_heads", width // 64)
    head_dim = width // heads
    third = head_dim // 2 // 3
    sec = kw.get("mrope_section", (head_dim // 2 - 2 * third, third, third))
    return GenLipTrunkCfg(
        width=width,
        depth=kw.get("depth", 12),
        num_heads=heads,
        intermediate_size=kw.get("intermediate_size", int(width * kw.get("mlp_ratio", 4.0))),
        text_embed_dim=width,
        mrope_section=tuple(sec),
        gated_attention=kw.get("attn_gated", False),
        use_swiglu_ffn=kw.get("swiglu_mlp", kw.get("use_swiglu_ffn", False)),
        ls_init_value=kw.get("ls_init_value", 0.0),
        norm_type=kw.get("norm_type", "layernorm"),
        qk_norm=kw.get("qk_norm", False),
        attention_bias=kw.get("attention_bias", True),
        mlp_bias=kw.get("mlp_bias", True),
        hidden_act=kw.get("hidden_act", "gelu"),
    )


def audio_naflex_cfg_from_clip_audio(acfg: CLIPAudioCfg) -> AudioNaFlexCfg:
    """The mel and patch geometry of a naflexvit audio tower, which the encoder and
    the patchify share."""
    return AudioNaFlexCfg(
        sample_rate=acfg.sample_rate, window_size=acfg.window_size, hop_size=acfg.hop_size,
        fmin=acfg.fmin, fmax=acfg.fmax, n_mels=acfg.mel_bins,
        patch_freq=acfg.patch_freq, patch_time=acfg.patch_time, in_chans=acfg.in_chans,
    )


class NaFlexAudioEncoder(nn.Module):
    """patch dict {"patches" (B, N, in_chans*patch_freq*patch_time), "patch_coord"
    (B, N, 2) (freq, time), "patch_valid" (B, N)} -> (B, width)."""

    def __init__(self, acfg: CLIPAudioCfg):
        super().__init__()
        self.acfg = acfg
        self.tcfg = t = _trunk_cfg_from_audio(acfg)
        ncfg = audio_naflex_cfg_from_clip_audio(acfg)
        self.num_features = t.width
        self.patch_embed = nn.ModuleDict({"proj": nn.Linear(ncfg.patch_dim, t.width)})
        self.trunk = GenLipTrunk(t)
        self.attn_pool = AttentionPoolLatent(t.width, t.num_heads, int(t.width * 4.0),
                                             t.layer_norm_eps, "gelu")

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator) -> None:
        """Distributions of the JAX ``init_naflex_audio_encoder``."""
        self.trunk.init_weights(gen)
        proj = self.patch_embed["proj"]
        proj.weight.normal_(0.0, 0.02, generator=gen)
        proj.bias.zero_()
        self.attn_pool.init_weights(gen)

    def forward(self, audio: Dict[str, torch.Tensor], compute_dtype: torch.dtype = torch.float32,
                *, remat: bool = False) -> torch.Tensor:
        t, acfg = self.tcfg, self.acfg
        pv = audio["patch_valid"].bool()
        proj = self.patch_embed["proj"]
        x = linear(audio["patches"].to(compute_dtype), proj.weight, proj.bias, transposed=True)
        hd = t.width // t.num_heads
        mask = trunk_mask(0, pv, x.shape[1], hd, t.num_heads)
        rope_1d = (acfg.mel_bins // acfg.patch_freq) == 1 and acfg.rope_type != "axial"
        pos = build_audio_position_ids(audio["patch_coord"], pv, rope_1d=rope_1d)
        cos, sin = mrope_cos_sin(pos, hd, t.mrope_section, t.rope_theta, True)
        x = self.trunk(x, mask, cos, sin, remat=remat)
        return self.attn_pool(x, pv)

