"""NaFlex variable-resolution ViT (counterpart of ``open_clip_tpu/models/naflex_vit.py``).

The tower takes a patch dict in place of an image tensor:

    {"patches":     (B, N, P*P*3)  float, flattened patch pixels,
     "patch_coord": (B, N, 2)      int, (y, x) patch-grid coordinates,
     "patch_valid": (B, N)         bool, the padding mask}

Every (seq_len, batch) bucket of the token-budget batching is one shape. Padding
travels as a (B, L) key-validity vector down to the attention, where the flash
kernels mask it in-kernel at the long bucket lengths (the dense path folds it into
a bias), and into the masked pooling.

Components: a linear patch embedding; a learned 2-D position grid sampled
bilinearly at each sample's fractional patch coordinates; optional register and
class tokens; an optional pre-norm; the block stack of ``models/blocks.py`` (or
SwiGLU blocks); a final norm; masked average, class-token or attention-pool
(``map``) pooling; and the projection ``head``. Everything besides the attention
is plain PyTorch. Parameter names follow the JAX param tree (``patch_embed``,
``pos_embed``, ``norm``, ``attn_pool.*``, ``head``), with the blocks under
``transformer.resblocks`` as in the other towers.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..config import CLIPVisionCfg
from ..ops.attention import dense_attention
from ..ops.layers import ACT_FNS, linear
from .blocks import Attention, LayerNorm, Transformer

NEG_INF = torch.finfo(torch.float32).min

_SIZES = {
    # width, layers, heads
    "tiny": (192, 12, 3),
    "small": (384, 12, 6),
    "medium": (512, 12, 8),
    "betwixt": (640, 12, 10),
    "base": (768, 12, 12),
    "large": (1024, 24, 16),
    "so150m": (880, 18, 13),
    "so150m2": (832, 21, 13),
    "so400m": (1152, 27, 16),
}


@dataclass
class NaFlexVitCfg:
    width: int = 768
    layers: int = 12
    heads: int = 12
    patch_size: int = 16
    mlp_ratio: float = 4.0
    pos_grid: Tuple[int, int] = (16, 16)
    pool: str = "map"  # map | avg | tok
    class_token: bool = False
    swiglu_mlp: bool = False
    attn_pool_mlp_ratio: float = 4.0
    reg_tokens: int = 0
    norm_eps: float = 1e-6
    ls_init_value: Optional[float] = None
    proj_bias: bool = True
    pre_norm: bool = False  # only configs converted from a native ViT carry a pre-block norm


def is_naflex(vision_cfg: CLIPVisionCfg) -> bool:
    return bool(vision_cfg.timm_model_name) and vision_cfg.timm_model_name.startswith("naflexvit")


def parse_naflex_cfg(vision_cfg: CLIPVisionCfg) -> NaFlexVitCfg:
    """The tower's config from the model-name scheme ``naflexvit_<size>_patch<P>_<pool>``
    and the overrides in ``timm_model_kwargs``."""
    name = vision_cfg.timm_model_name or "naflexvit_base_patch16_map"
    m = re.match(r"naflexvit_([a-z0-9]+)_patch(\d+)_(\w+)", name)
    if not m:
        raise ValueError(f"cannot parse naflex model name {name!r}")
    size, patch, tail = m.group(1), int(m.group(2)), m.group(3)
    if size not in _SIZES:
        raise ValueError(f"unknown naflex size {size!r}; known: {sorted(_SIZES)}")
    width, layers, heads = _SIZES[size]
    pool = "map" if "map" in tail else ("avg" if "gap" in tail else "tok")
    reg = re.search(r"reg(\d+)", tail)
    kw = dict(vision_cfg.timm_model_kwargs or {})
    return NaFlexVitCfg(
        width=kw.get("embed_dim", width),
        layers=kw.get("depth", layers),
        heads=kw.get("num_heads", heads),
        patch_size=kw.get("patch_size", patch),
        mlp_ratio=kw.get("mlp_ratio", 4.0),
        pos_grid=tuple(kw.get("pos_embed_grid_size", (16, 16))),
        pool=vision_cfg.timm_pool or pool,
        swiglu_mlp=kw.get("swiglu_mlp", False),
        attn_pool_mlp_ratio=kw.get("attn_pool_mlp_ratio", 4.0),
        reg_tokens=kw.get("reg_tokens", int(reg.group(1)) if reg else 0),
        class_token=kw.get("class_token", False),
        pre_norm=kw.get("pre_norm", False),
    )


def sample_pos_embed(grid: torch.Tensor, coords: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Bilinearly sample the learned (gh, gw, W) grid at per-sample fractional positions.

    ``coords`` are integer patch-grid coordinates; each sample's extent is its largest
    valid coordinate + 1, so the grid stretches to that sample's aspect ratio: the
    resize-to-target-grid and gather of an interpolated position embedding, in one
    shape for the whole batch. fp32; returns (B, N, W)."""
    gh, gw, width = grid.shape
    cy = coords[..., 0].float()
    cx = coords[..., 1].float()
    zero = torch.zeros((), dtype=torch.float32, device=coords.device)
    h_ext = torch.where(valid, cy, zero).amax(dim=1, keepdim=True) + 1.0  # (B, 1)
    w_ext = torch.where(valid, cx, zero).amax(dim=1, keepdim=True) + 1.0

    # patch centres on grid coordinates (the align_corners=False convention)
    fy = (cy + 0.5) / h_ext * gh - 0.5
    fx = (cx + 0.5) / w_ext * gw - 0.5
    y0 = fy.floor().clamp(0, gh - 1)
    x0 = fx.floor().clamp(0, gw - 1)
    y1 = (y0 + 1).clamp(0, gh - 1)
    x1 = (x0 + 1).clamp(0, gw - 1)
    wy = (fy - y0).clamp(0.0, 1.0)[..., None]
    wx = (fx - x0).clamp(0.0, 1.0)[..., None]

    # The four neighbours' weights go into one (B, N, gh*gw) interpolation matrix and
    # the sampling is a matrix product with the flattened grid: the same sum as four
    # gathers blended pairwise, but its gradient with respect to the grid is a
    # product too, where a gather's is a sorted scatter-add over B*N rows.
    cells = torch.arange(gh * gw, device=grid.device)

    def hot(yy, xx, weight):
        return ((yy * gw + xx).long()[..., None] == cells) * weight

    interp = (hot(y0, x0, (1 - wy) * (1 - wx)) + hot(y0, x1, (1 - wy) * wx)
              + hot(y1, x0, wy * (1 - wx)) + hot(y1, x1, wy * wx))
    return interp @ grid.float().reshape(gh * gw, width)


def _torch_linear_init_(lin: nn.Linear, gen: torch.Generator) -> None:
    """``nn.Linear``'s default: uniform(+-1/sqrt(fan_in)) for the weight and the bias."""
    bound = lin.in_features ** -0.5
    lin.weight.uniform_(-bound, bound, generator=gen)
    if lin.bias is not None:
        lin.bias.uniform_(-bound, bound, generator=gen)


def _ln_init_(ln: nn.LayerNorm) -> None:
    ln.weight.fill_(1.0)
    ln.bias.zero_()


class SwiGLUMlp(nn.Module):
    def __init__(self, width: int, hidden: int):
        super().__init__()
        self.w12 = nn.Linear(width, 2 * hidden)
        self.w3 = nn.Linear(hidden, width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        u, g = linear(x, self.w12.weight, self.w12.bias, transposed=True).chunk(2, dim=-1)
        return linear(u * nn.functional.silu(g), self.w3.weight, self.w3.bias, transposed=True)


class SwiGLUBlock(nn.Module):
    """x = x + attn(ln_1(x)); x = x + w3(u * silu(g)) with (u, g) = w12(ln_2(x))."""

    def __init__(self, width: int, heads: int, hidden: int, norm_eps: float):
        super().__init__()
        self.ln_1 = LayerNorm(width, eps=norm_eps)
        self.attn = Attention(width, heads)
        self.ln_2 = LayerNorm(width, eps=norm_eps)
        self.mlp = SwiGLUMlp(width, hidden)

    def forward(self, x: torch.Tensor, *, key_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x + self.attn(self.ln_1(x), key_valid=key_valid)
        return x + self.mlp(self.ln_2(x))

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator) -> None:
        width = self.attn.out_proj.in_features
        _ln_init_(self.ln_1)
        _ln_init_(self.ln_2)
        bound = math.sqrt(6.0 / (width + 3 * width))
        self.attn.in_proj_weight.uniform_(-bound, bound, generator=gen)
        self.attn.in_proj_bias.zero_()
        for lin in (self.attn.out_proj, self.mlp.w12, self.mlp.w3):
            _torch_linear_init_(lin, gen)


class SwiGLUTransformer(nn.Module):
    def __init__(self, width: int, layers: int, heads: int, hidden: int, norm_eps: float):
        super().__init__()
        self.resblocks = nn.ModuleList(
            SwiGLUBlock(width, heads, hidden, norm_eps) for _ in range(layers))

    def forward(self, x: torch.Tensor, *, remat: bool = False,
                key_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        for block in self.resblocks:
            if remat and torch.is_grad_enabled():
                x = checkpoint(block, x, key_valid=key_valid, use_reentrant=False)
            else:
                x = block(x, key_valid=key_valid)
        return x

    def init_weights(self, gen: torch.Generator, scheme: str = "vision") -> None:
        for block in self.resblocks:
            block.init_weights(gen)


class AttentionPoolLatent(nn.Module):
    """One learned latent query attends over the valid tokens; a projection and a
    residual MLP follow. Its one-query attention is dense in the JAX package too."""

    def __init__(self, width: int, heads: int, hidden: int, norm_eps: float, act: str):
        super().__init__()
        self.heads = heads
        self.latent = nn.Parameter(torch.empty(width))
        self.q = nn.Linear(width, width)
        self.kv = nn.Linear(width, 2 * width)
        self.proj = nn.Linear(width, width)
        self.norm = LayerNorm(width, eps=norm_eps)
        self.mlp = nn.ModuleDict({"c_fc": nn.Linear(width, hidden),
                                  "c_proj": nn.Linear(hidden, width)})
        self.act = ACT_FNS[act]

    def forward(self, x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        b, n, width = x.shape
        hd = width // self.heads
        latent = self.latent.to(x.dtype).expand(b, 1, width)
        q = linear(latent, self.q.weight, self.q.bias, transposed=True).reshape(b, 1, self.heads, hd)
        k, v = linear(x, self.kv.weight, self.kv.bias, transposed=True).chunk(2, dim=-1)
        k = k.reshape(b, n, self.heads, hd)
        v = v.reshape(b, n, self.heads, hd)
        bias = torch.where(valid, 0.0, NEG_INF).float()[:, None, None, :]
        out = dense_attention(q, k, v, bias).reshape(b, 1, width)
        out = linear(out, self.proj.weight, self.proj.bias, transposed=True)
        fc, pr = self.mlp["c_fc"], self.mlp["c_proj"]
        h = self.act(linear(self.norm(out), fc.weight, fc.bias, transposed=True))
        out = out + linear(h, pr.weight, pr.bias, transposed=True)
        return out[:, 0]

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator) -> None:
        self.latent.normal_(0.0, self.latent.shape[0] ** -0.5, generator=gen)
        for lin in (self.q, self.kv, self.proj, self.mlp["c_fc"], self.mlp["c_proj"]):
            _torch_linear_init_(lin, gen)
        _ln_init_(self.norm)


class NaFlexVit(nn.Module):
    def __init__(self, cfg: NaFlexVitCfg, embed_dim: int, act: str = "gelu"):
        super().__init__()
        self.cfg = cfg
        width = cfg.width
        self.patch_embed = nn.Linear(cfg.patch_size * cfg.patch_size * 3, width)
        self.pos_embed = nn.Parameter(torch.empty(*cfg.pos_grid, width))
        self.norm_pre = LayerNorm(width, eps=cfg.norm_eps) if cfg.pre_norm else None
        self.cls_token = nn.Parameter(torch.empty(width)) if cfg.class_token else None
        self.reg_tokens = (nn.Parameter(torch.empty(cfg.reg_tokens, width))
                           if cfg.reg_tokens else None)
        hidden = int(width * cfg.mlp_ratio)
        if cfg.swiglu_mlp:
            self.transformer = SwiGLUTransformer(width, cfg.layers, cfg.heads, hidden, cfg.norm_eps)
        else:
            self.transformer = Transformer(width, cfg.layers, cfg.heads, hidden, act=act,
                                           ls_init_value=cfg.ls_init_value, norm_eps=cfg.norm_eps)
        self.norm = LayerNorm(width, eps=cfg.norm_eps)
        self.attn_pool = (AttentionPoolLatent(width, cfg.heads, int(width * cfg.attn_pool_mlp_ratio),
                                              cfg.norm_eps, act) if cfg.pool == "map" else None)
        self.head = nn.Linear(width, embed_dim, bias=cfg.proj_bias)

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator) -> None:
        """Distributions of the JAX package's ``init_naflex_vit``."""
        scale = self.cfg.width ** -0.5
        self.patch_embed.weight.normal_(0.0, scale, generator=gen)
        self.patch_embed.bias.zero_()
        self.pos_embed.normal_(0.0, 0.02, generator=gen)
        _ln_init_(self.norm)
        if self.norm_pre is not None:
            _ln_init_(self.norm_pre)
        for tokens in (self.cls_token, self.reg_tokens):
            if tokens is not None:
                tokens.normal_(0.0, 1e-6, generator=gen)
        self.transformer.init_weights(gen, "vision")
        if self.attn_pool is not None:
            self.attn_pool.init_weights(gen)
        self.head.weight.normal_(0.0, scale, generator=gen)
        if self.head.bias is not None:
            self.head.bias.zero_()

    def forward_tokens(self, batch: Dict[str, torch.Tensor],
                       compute_dtype: torch.dtype = torch.float32, *,
                       remat: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """patch dict -> (pooled (B, embed_dim), tokens (B, N, W))."""
        cfg = self.cfg
        patches = batch["patches"].to(compute_dtype)
        valid = batch["patch_valid"].bool()
        b = patches.shape[0]

        x = linear(patches, self.patch_embed.weight, self.patch_embed.bias, transposed=True)
        x = x + sample_pos_embed(self.pos_embed, batch["patch_coord"], valid).to(compute_dtype)

        num_prefix = 0
        key_valid = valid
        for tokens in (self.reg_tokens, self.cls_token):  # the class token ends up first
            if tokens is not None:
                t = tokens.to(compute_dtype).reshape(-1, tokens.shape[-1])
                x = torch.cat([t.expand(b, -1, -1), x], dim=1)
                key_valid = torch.cat([key_valid.new_ones(b, t.shape[0]), key_valid], dim=1)
                num_prefix += t.shape[0]
        if self.norm_pre is not None:
            x = self.norm_pre(x)

        x = self.transformer(x, remat=remat, key_valid=key_valid)
        x = self.norm(x)
        tokens = x[:, num_prefix:]

        if cfg.pool == "map":
            pooled = self.attn_pool(tokens, valid)
        elif cfg.pool == "avg":
            w = valid.float()[..., None]
            pooled = ((tokens.float() * w).sum(1) / w.sum(1).clamp_min(1.0)).to(tokens.dtype)
        else:  # tok
            pooled = x[:, 0]
        return linear(pooled, self.head.weight, self.head.bias, transposed=True), tokens

    def forward(self, batch: Dict[str, torch.Tensor], compute_dtype: torch.dtype = torch.float32,
                *, train: bool = False, remat: bool = False) -> torch.Tensor:
        """patch dict -> pooled, projected (B, embed_dim). ``train`` changes nothing:
        the tower has no dropout."""
        return self.forward_tokens(batch, compute_dtype, remat=remat)[0]


def vit_params_to_naflex(state: Dict[str, torch.Tensor], grid: Tuple[int, int],
                             prefix: str = "visual.") -> Dict[str, torch.Tensor]:
    """Fold a plain ``VisionTransformer``'s state dict into the NaFlex layout (the JAX
    package's ``vit_params_to_naflex``): the class token absorbs the position
    embedding's first row, the patch kernel becomes the linear embedding with a zero
    bias, and ``proj`` the bias-free ``head``. The target config needs
    ``class_token``, ``pre_norm``, pool ``tok`` and ``proj_bias=False``."""
    pe = state[prefix + "positional_embedding"]
    width = pe.shape[-1]
    out = {
        prefix + "patch_embed.weight": state[prefix + "conv1.weight"].T.contiguous(),
        prefix + "patch_embed.bias": torch.zeros(width, dtype=pe.dtype),
        prefix + "cls_token": state[prefix + "class_embedding"] + pe[0],
        prefix + "pos_embed": pe[1:].reshape(grid[0], grid[1], width).clone(),
        prefix + "head.weight": state[prefix + "proj"].T.contiguous(),
    }
    for src, dst in (("ln_pre", "norm_pre"), ("ln_post", "norm")):
        for leaf in ("weight", "bias"):
            out[f"{prefix}{dst}.{leaf}"] = state[f"{prefix}{src}.{leaf}"]
    for key, value in state.items():
        if key.startswith(prefix + "transformer."):
            out[key] = value
    return out
