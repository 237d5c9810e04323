"""Vision Transformer tower (counterpart of ``open_clip_tpu/models/vit.py``, plain path).

Images flow as NHWC. The patch embedding is patchify (a reshape with the JAX
package's ``(ph, pw, 3)`` flatten order) followed by one matmul, as in the JAX
package; the class token (when the trunk has one), learned positional embedding
(added in the compute dtype after the class token), ``ln_pre``, the block stack,
``ln_post`` and the ``tok``/``avg``/``map`` pool and projection follow
``apply_vision_tower``. The timm trunks the JAX package builds natively (SigLIP's,
timm CLIP's and the gap ViTs) resolve to this tower by name.
"""

from __future__ import annotations

import dataclasses
import re

import torch
from torch import nn

from ..config import CLIPVisionCfg, to_2tuple
from ..ops.layers import linear
from .blocks import LayerNorm, Transformer, check_block_options
from .naflex_vit import AttentionPoolLatent


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


_SIGLIP_SIZES = {"base": (768, 12, 12, 4.0), "large": (1024, 24, 16, 4.0),
                 "so400m": (1152, 27, 16, 4304 / 1152), "giantopt": (1536, 40, 16, 4.0)}
_CLIP_SIZES = {"base": (768, 12, 12, 4.0), "large": (1024, 24, 16, 4.0),
               "huge": (1280, 32, 16, 4.0)}
_GAP_SIZES = {"medium": (512, 12, 8, 4.0), "base": (768, 12, 12, 4.0)}


def resolve_timm_vision_cfg(cfg: CLIPVisionCfg) -> CLIPVisionCfg:
    """A timm tower name as the native ViT's config (the JAX package's
    ``resolve_timm_vision_cfg``): ``vit_*_siglip_*`` has no class token, no ``ln_pre``,
    a MAP head (``avg`` only when ``timm_pool`` asks for ``gap``) and eps 1e-6;
    ``vit_*_clip_*`` is the class-token ViT with eps 1e-6; ``vit_*_gap_*`` pools the
    tokens' mean and normalises after pooling. A trunk from timm has a patch-embedding
    bias (see ``VisionTransformer``). Other timm names raise, MobileCLIP's
    ``vit_base_mci`` among them (the JAX package builds its conv stem, the port not)."""
    name = cfg.timm_model_name or ""
    families = ((r"vit_([a-z0-9]+)_patch(\d+)_clip(?:_quickgelu)?_?(\d+)?", "clip", _CLIP_SIZES,
                 dict(class_token=True, pool_type="tok")),
                (r"vit_([a-z0-9]+)_patch(\d+)_gap_?(\d+)?", "gap", _GAP_SIZES,
                 dict(class_token=False, no_ln_pre=True, pool_type="avg",
                      final_ln_after_pool=True)),
                (r"vit_([a-z0-9]+)_patch(\d+)_siglip(?:_\w+)?_?(\d+)?", "siglip", _SIGLIP_SIZES,
                 dict(class_token=False, no_ln_pre=True,
                      pool_type="avg" if cfg.timm_pool == "gap" else "map")))
    for pattern, family, sizes, options in families:
        m = re.match(pattern, name)
        if not m:
            continue
        if m.group(1) not in sizes:
            raise NotImplementedError(f"vision tower not ported yet: unknown {family} vit size "
                                      f"{m.group(1)!r}")
        width, layers, heads, mlp_ratio = sizes[m.group(1)]
        # the resolution: the name's suffix, else the config's square size, else 224
        res = int(m.group(3)) if m.group(3) else (
            cfg.image_size if isinstance(cfg.image_size, int) else 224)
        return dataclasses.replace(
            cfg, timm_model_name=None, layers=layers, width=width, head_width=width // heads,
            mlp_ratio=mlp_ratio, patch_size=int(m.group(2)), image_size=cfg.image_size or res,
            norm_kwargs={"eps": 1e-6}, **options)
    raise NotImplementedError(f"vision tower not ported yet: timm tower {name!r}")


def check_vision_cfg(cfg: CLIPVisionCfg) -> CLIPVisionCfg:
    """Raise for the vision-tower variants that are not ported; return the config the
    tower is built from (a timm name resolved). A ``naflexvit_*`` timm name never gets
    here: ``models/naflex_vit.py`` is that tower."""
    if cfg.timm_model_name:
        cfg = resolve_timm_vision_cfg(cfg)
    unported = []
    if cfg.is_resnet:
        unported.append("ModifiedResNet")
    if cfg.attentional_pool:
        unported.append("attentional pool")
    if cfg.pool_type not in ("tok", "avg", "map"):
        unported.append(f"pool_type {cfg.pool_type!r}")
    if cfg.pos_embed_type != "learnable":
        unported.append(f"pos_embed_type {cfg.pos_embed_type!r}")
    if cfg.conv_stem_channels:
        unported.append("conv-stem trunk")
    if unported:
        raise NotImplementedError(f"vision tower not ported yet: {', '.join(unported)}")
    check_block_options(cfg)
    return cfg


class VisionTransformer(nn.Module):
    """The ViT tower. A class-token-free trunk (SigLIP's) has no ``class_embedding``;
    a ``map`` pool is the MAP head ``attn_pool`` (one latent query, its MLP at 4x the
    width for every size, GELU, as in the JAX package); a timm trunk with
    ``timm_proj == "none"`` has no ``proj`` and its pooled width is the embedding."""

    def __init__(self, cfg: CLIPVisionCfg, embed_dim: int, act: str = "gelu"):
        super().__init__()
        from_timm = bool(cfg.timm_model_name)
        no_proj = from_timm and cfg.timm_proj == "none"
        cfg = check_vision_cfg(cfg)
        self.cfg = cfg
        width = cfg.width
        gh, gw = cfg.grid_size
        self.conv1 = PatchEmbed(cfg.patch_size, width, bias=from_timm or not cfg.class_token)
        self.class_embedding = nn.Parameter(torch.empty(width)) if cfg.class_token else None
        self.positional_embedding = nn.Parameter(
            torch.empty(gh * gw + int(cfg.class_token), width))
        self.ln_pre = None if cfg.no_ln_pre else LayerNorm(width, eps=cfg.norm_eps)
        self.transformer = Transformer(width, cfg.layers, cfg.heads, int(width * cfg.mlp_ratio),
                                       act=act, ls_init_value=cfg.ls_init_value,
                                       norm_eps=cfg.norm_eps)
        self.ln_post = LayerNorm(width, eps=cfg.norm_eps)
        self.attn_pool = (AttentionPoolLatent(width, cfg.heads, int(width * 4.0), cfg.norm_eps,
                                              "gelu") if cfg.pool_type == "map" else None)
        self.proj = None if no_proj else nn.Parameter(torch.empty(width, embed_dim))

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator) -> None:
        scale = self.cfg.width ** -0.5
        for p in (self.conv1.weight, self.class_embedding, self.positional_embedding):
            if p is not None:
                p.normal_(0.0, scale, generator=gen)
        if self.conv1.bias is not None:
            self.conv1.bias.zero_()
        for ln in (self.ln_pre, self.ln_post):
            if ln is not None:
                ln.weight.fill_(1.0)
                ln.bias.zero_()
        self.transformer.init_weights(gen, "vision")
        if self.attn_pool is not None:
            self.attn_pool.init_weights(gen)
        if self.proj is not None:
            self.proj.normal_(0.0, scale, generator=gen)

    def forward(self, x: torch.Tensor, compute_dtype: torch.dtype = torch.float32, *,
                train: bool = False, remat: bool = False) -> torch.Tensor:
        """(B, H, W, 3) normalized NHWC -> pooled, projected (B, embed_dim)."""
        cfg = self.cfg
        if train and cfg.patch_dropout > 0.0:
            raise NotImplementedError("patch dropout in training is not ported yet")
        x = self.conv1(patchify(x.to(compute_dtype), cfg.patch_size))
        if self.class_embedding is not None:
            cls = self.class_embedding.to(compute_dtype).expand(x.shape[0], 1, -1)
            x = torch.cat([cls, x], dim=1)
        x = x + self.positional_embedding[: x.shape[1]].to(compute_dtype)
        if self.ln_pre is not None:
            x = self.ln_pre(x)
        x = self.transformer(x, remat=remat)
        if self.attn_pool is not None:
            x = self.ln_post(x)
            pooled = self.attn_pool(x, torch.ones(x.shape[:2], dtype=torch.bool, device=x.device))
        elif cfg.final_ln_after_pool:
            pooled = self.ln_post(_global_pool(cfg, x))
        else:
            pooled = _global_pool(cfg, self.ln_post(x))
        return pooled if self.proj is None else linear(pooled, self.proj)


def _global_pool(cfg: CLIPVisionCfg, x: torch.Tensor) -> torch.Tensor:
    if cfg.pool_type == "avg":
        return x[:, int(cfg.class_token):].mean(dim=1)
    return x[:, 0]
