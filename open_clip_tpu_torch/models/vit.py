"""Vision Transformer tower (counterpart of ``open_clip_tpu/models/vit.py``, plain path).

Images flow as NHWC. The patch embedding is patchify (a reshape with the JAX
package's ``(ph, pw, 3)`` flatten order) followed by one matmul, as in the JAX
package; the class token, learned positional embedding (added in the compute
dtype after the class token), ``ln_pre``, the block stack, ``ln_post`` and the
``tok``/``avg`` pool and projection follow ``apply_vision_tower``.
"""

from __future__ import annotations

import torch
from torch import nn

from ..config import CLIPVisionCfg, to_2tuple
from ..ops.layers import linear
from .blocks import LayerNorm, Transformer, check_block_options


def patchify(x: torch.Tensor, patch_size) -> torch.Tensor:
    """(B, H, W, C) NHWC -> (B, gh*gw, ph*pw*C) patch tokens; trailing pixels that do
    not fill a patch are dropped, as a strided convolution would."""
    ph, pw = to_2tuple(patch_size)
    b, h, w, c = x.shape
    gh, gw = h // ph, w // pw
    x = x[:, : gh * ph, : gw * pw]
    x = x.reshape(b, gh, ph, gw, pw, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, gh * gw, ph * pw * c)


class PatchEmbed(nn.Module):
    """Patch embedding kernel in the patchify layout (ph*pw*in_chans, width), stored
    under the reference's convolution name (``conv1.weight`` in the ViT,
    ``patch_embed.proj.weight`` in the Swin towers). A reference checkpoint's
    convolution weight (width, in_chans, ph, pw) is re-laid out when it is loaded."""

    def __init__(self, patch_size, width: int, in_chans: int = 3, bias: bool = False):
        super().__init__()
        ph, pw = to_2tuple(patch_size)
        self.patch_size = (ph, pw)
        self.weight = nn.Parameter(torch.empty(ph * pw * in_chans, width))
        self.bias = nn.Parameter(torch.empty(width)) if bias else None

    def forward(self, patches: torch.Tensor) -> torch.Tensor:
        """(B, N, ph*pw*in_chans) patch tokens (``patchify``) -> (B, N, width)."""
        return linear(patches, self.weight, self.bias)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        w = state_dict.get(prefix + "weight")
        if w is not None and w.ndim == 4:  # (out, in, kh, kw) -> (kh*kw*in, out)
            state_dict[prefix + "weight"] = w.permute(2, 3, 1, 0).reshape(-1, w.shape[0])
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)


def check_vision_cfg(cfg: CLIPVisionCfg) -> None:
    """Raise for the vision-tower variants that are not ported. (A ``naflexvit_*``
    timm name never gets here: ``models/naflex_vit.py`` is that tower.)"""
    unported = []
    if cfg.timm_model_name:
        unported.append(f"timm tower {cfg.timm_model_name!r}")
    if cfg.is_resnet:
        unported.append("ModifiedResNet")
    if cfg.attentional_pool:
        unported.append("attentional pool")
    if cfg.pool_type not in ("tok", "avg"):
        unported.append(f"pool_type {cfg.pool_type!r}")
    if cfg.pos_embed_type != "learnable":
        unported.append(f"pos_embed_type {cfg.pos_embed_type!r}")
    if not cfg.class_token or cfg.conv_stem_channels:
        unported.append("class-token-free or conv-stem trunk")
    if unported:
        raise NotImplementedError(f"vision tower not ported yet: {', '.join(unported)}")
    check_block_options(cfg)


class VisionTransformer(nn.Module):
    def __init__(self, cfg: CLIPVisionCfg, embed_dim: int, act: str = "gelu"):
        super().__init__()
        check_vision_cfg(cfg)
        self.cfg = cfg
        width = cfg.width
        gh, gw = cfg.grid_size
        self.conv1 = PatchEmbed(cfg.patch_size, width)
        self.class_embedding = nn.Parameter(torch.empty(width))
        self.positional_embedding = nn.Parameter(torch.empty(gh * gw + 1, width))
        self.ln_pre = None if cfg.no_ln_pre else LayerNorm(width, eps=cfg.norm_eps)
        self.transformer = Transformer(width, cfg.layers, cfg.heads, int(width * cfg.mlp_ratio),
                                       act=act, ls_init_value=cfg.ls_init_value,
                                       norm_eps=cfg.norm_eps)
        self.ln_post = LayerNorm(width, eps=cfg.norm_eps)
        self.proj = nn.Parameter(torch.empty(width, embed_dim))

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator) -> None:
        scale = self.cfg.width ** -0.5
        for p in (self.conv1.weight, self.class_embedding, self.positional_embedding):
            p.normal_(0.0, scale, generator=gen)
        for ln in (self.ln_pre, self.ln_post):
            if ln is not None:
                ln.weight.fill_(1.0)
                ln.bias.zero_()
        self.transformer.init_weights(gen, "vision")
        self.proj.normal_(0.0, scale, generator=gen)

    def forward(self, x: torch.Tensor, compute_dtype: torch.dtype = torch.float32, *,
                train: bool = False, remat: bool = False) -> torch.Tensor:
        """(B, H, W, 3) normalized NHWC -> pooled, projected (B, embed_dim)."""
        cfg = self.cfg
        if train and cfg.patch_dropout > 0.0:
            raise NotImplementedError("patch dropout in training is not ported yet")
        x = self.conv1(patchify(x.to(compute_dtype), cfg.patch_size))
        cls = self.class_embedding.to(compute_dtype).expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1)
        x = x + self.positional_embedding[: x.shape[1]].to(compute_dtype)
        if self.ln_pre is not None:
            x = self.ln_pre(x)
        x = self.transformer(x, remat=remat)
        if cfg.final_ln_after_pool:
            pooled = self.ln_post(_global_pool(cfg, x))
        else:
            pooled = _global_pool(cfg, self.ln_post(x))
        return linear(pooled, self.proj)


def _global_pool(cfg: CLIPVisionCfg, x: torch.Tensor) -> torch.Tensor:
    return x[:, 1:].mean(dim=1) if cfg.pool_type == "avg" else x[:, 0]
