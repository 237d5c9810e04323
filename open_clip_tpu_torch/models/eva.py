"""EVA image towers: EVA01, EVA02 and the Perception Encoder's core towers
(counterpart of ``open_clip_tpu/models/eva.py``).

timm's Eva architecture as the JAX package builds it natively:

- EVA01-giant and EVA02-enormous: pre-LN blocks whose attention is one fused qkv
  product without a bias, to which a learned q bias, a zero k bias and a learned v
  bias are added after the product in the product's dtype; a GELU MLP.
- EVA02 (base, large): separate q, k and v projections (k without a bias), a SwiGLU
  MLP with an inner LayerNorm (``scale_mlp``), and 2-D axial rotary embeddings
  (``rope_table``) on the patch tokens of q and k, in fp32 and rounded once to the
  compute dtype before the attention kernel; the class token passes through.
- PE-Core: the fused qkv with rope, a GELU MLP, and the MAP pool (the NaFlex tower's
  ``AttentionPoolLatent``, every key valid, GELU) in place of the class token.

Every tower embeds patches by one product on ``patchify``'s (p, p, 3) layout, adds the
class token and ``pos_embed`` (class token included), runs the blocks, the final
``norm``, the pool and ``head``, the CLIP projection (the registry's ``timm_proj`` is
null). Names follow the JAX tree (``patch_embed``, ``cls_token``, ``pos_embed``,
``norm1``, ``attn.q_bias``, ``mlp.fc1_g``, ``attn_pool.latent``, ``head``), with the
layer-stacked ``blocks`` held one module a block under ``transformer.resblocks``, so
that the weight-decay mask, layer decay and tower locking of ``train/optim.py`` read
them as the JAX rules read the stacked leaves. With ``remat`` each block is
recomputed in the backward pass under ``blocks.REMAT_POLICY``, as the JAX
``jax.checkpoint(body, policy=remat_policy())``. A timm checkpoint
(``visual.trunk.*``) converts through ``timm_eva_to_params``.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config import CLIPVisionCfg
from ..ops.attention import dot_product_attention
from ..ops.layers import gelu, linear
from .blocks import LayerNorm, remat_call
from .htsat import _trunc_normal_
from .naflex_vit import AttentionPoolLatent, _ln_init_, _torch_linear_init_
from .vit import PatchEmbed, patchify


class EvaCfg(NamedTuple):
    dim: int
    depth: int
    heads: int
    patch: int
    mlp_hidden: int
    swiglu: bool
    fused_qkv: bool
    rope: bool
    scale_mlp: bool
    image_size: int
    ref_feat_shape: Optional[Tuple[int, int]] = None
    norm_eps: float = 1e-6
    pool: str = "tok"  # "tok" (the class token) | "map" (AttentionPoolLatent: PE-Core)


def _eva02_hidden(dim: int) -> int:
    # timm: mlp_ratio = 4 * 2/3, hidden rounded to a multiple of 32 (EVA02 paper)
    return int(round(dim * 4 * 2 / 3 / 32) * 32)


# the JAX package's table: timm's eva.py entry points and the PE paper's T/S/B/L/G sizes
EVA_CONFIGS = {
    "eva_giant_patch14_224": EvaCfg(1408, 40, 16, 14, 6144, False, True, False, False, 224),
    "eva_giant_patch14_336": EvaCfg(1408, 40, 16, 14, 6144, False, True, False, False, 336),
    "eva02_base_patch16_clip_224": EvaCfg(
        768, 12, 12, 16, _eva02_hidden(768), True, False, True, True, 224, (16, 16)),
    "eva02_large_patch14_clip_224": EvaCfg(
        1024, 24, 16, 14, _eva02_hidden(1024), True, False, True, True, 224, (16, 16)),
    "eva02_large_patch14_clip_336": EvaCfg(
        1024, 24, 16, 14, _eva02_hidden(1024), True, False, True, True, 336, (16, 16)),
    "eva02_enormous_patch14_clip_224": EvaCfg(
        1792, 64, 16, 14, 15360, False, True, False, False, 224),
    "vit_pe_core_tiny_patch16_384": EvaCfg(
        192, 12, 3, 16, 768, False, True, True, False, 384, pool="map"),
    "vit_pe_core_small_patch16_384": EvaCfg(
        384, 12, 6, 16, 1536, False, True, True, False, 384, pool="map"),
    "vit_pe_core_base_patch16_224": EvaCfg(
        768, 12, 12, 16, 3072, False, True, True, False, 224, pool="map"),
    "vit_pe_core_large_patch14_336": EvaCfg(
        1024, 24, 16, 14, 4096, False, True, True, False, 336, pool="map"),
    "vit_pe_core_gigantic_patch14_448": EvaCfg(
        1536, 50, 16, 14, 8960, False, True, True, False, 448, pool="map"),
}


def is_eva(vision_cfg: Optional[CLIPVisionCfg]) -> bool:
    name = (vision_cfg.timm_model_name or "") if vision_cfg is not None else ""
    return name.startswith(("eva_", "eva02_", "vit_pe_core_"))


def resolve_eva_cfg(vision_cfg: CLIPVisionCfg) -> EvaCfg:
    name = vision_cfg.timm_model_name
    if name not in EVA_CONFIGS:
        raise NotImplementedError(f"vision tower not ported yet: EVA variant {name!r} has no "
                                  "config in the JAX package's table")
    ecfg = EVA_CONFIGS[name]
    img = vision_cfg.image_size if isinstance(vision_cfg.image_size, int) else ecfg.image_size
    return ecfg._replace(image_size=img or ecfg.image_size)


@functools.lru_cache(maxsize=16)
def rope_table(gh: int, gw: int, head_dim: int,
               ref: Optional[Tuple[int, int]], temperature: float = 10000.0) -> np.ndarray:
    """(gh*gw, 2*head_dim) sin||cos table, built in float64 and cast to float32: per
    position, interleaved-pair frequencies, y-axis bands then x-axis bands, the
    coordinates rescaled to ``ref`` (timm ``build_rotary_pos_embed``, in_pixels=False)."""
    n_bands = head_dim // 4
    bands = 1.0 / (temperature ** (np.arange(n_bands, dtype=np.float64) / n_bands))
    ty, tx = np.meshgrid(np.arange(gh, dtype=np.float64),
                         np.arange(gw, dtype=np.float64), indexing="ij")
    if ref is not None:
        ty = ty / gh * ref[0]
        tx = tx / gw * ref[1]
    t = np.stack([ty.reshape(-1), tx.reshape(-1)], axis=-1)  # (N, 2)
    grid = (t[:, :, None] * bands[None, None, :]).reshape(-1, 2 * n_bands)
    grid = np.repeat(grid, 2, axis=-1)  # interleave pairs -> (N, head_dim)
    return np.concatenate([np.sin(grid), np.cos(grid)], axis=-1).astype(np.float32)


def apply_rope(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """x (B, N, H, hd) patch tokens, ``table`` (N, 2*hd): x*cos + rot(x)*sin with the
    interleaved-pair rotation, in fp32, rounded once to x.dtype."""
    hd = x.shape[-1]
    sin = table[:, :hd][None, :, None, :]
    cos = table[:, hd:][None, :, None, :]
    xf = x.float()
    x2 = xf.unflatten(-1, (hd // 2, 2))
    rot = torch.stack([-x2[..., 1], x2[..., 0]], dim=-1).flatten(-2)
    return (xf * cos + rot * sin).to(x.dtype)


class EvaAttention(nn.Module):
    def __init__(self, dim: int, heads: int, fused_qkv: bool):
        super().__init__()
        self.heads = heads
        self.qkv = self.q = self.k = self.v = None
        if fused_qkv:
            self.qkv = nn.Linear(dim, 3 * dim, bias=False)
            self.q_bias = nn.Parameter(torch.empty(dim))
            self.v_bias = nn.Parameter(torch.empty(dim))
        else:
            self.q = nn.Linear(dim, dim)
            self.k = nn.Linear(dim, dim, bias=False)
            self.v = nn.Linear(dim, dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, rope: Optional[torch.Tensor]) -> torch.Tensor:
        b, l, d = x.shape
        shape = (b, l, self.heads, d // self.heads)
        if self.qkv is not None:  # the zero k bias inside the fused bias
            bias = torch.cat([self.q_bias, torch.zeros_like(self.q_bias), self.v_bias])
            qkv = linear(x, self.qkv.weight, bias, transposed=True)
            q, k, v = qkv.view(b, l, 3, *shape[2:]).unbind(2)
        else:
            q, k, v = (linear(x, m.weight, m.bias, transposed=True).view(shape)
                       for m in (self.q, self.k, self.v))
        if rope is not None:  # the patch tokens only: the class token passes through
            q = torch.cat([q[:, :1], apply_rope(q[:, 1:], rope)], dim=1)
            k = torch.cat([k[:, :1], apply_rope(k[:, 1:], rope)], dim=1)
        out = dot_product_attention(q, k, v).reshape(b, l, d)
        return linear(out, self.proj.weight, self.proj.bias, transposed=True)


class EvaMlp(nn.Module):
    """SwiGLU (``fc1_g``, ``fc1_x``, the inner ``norm`` with ``scale_mlp``) or GELU."""

    def __init__(self, dim: int, hidden: int, swiglu: bool, scale_mlp: bool, eps: float):
        super().__init__()
        self.fc1 = self.fc1_g = self.fc1_x = self.norm = None
        if swiglu:
            self.fc1_g, self.fc1_x = nn.Linear(dim, hidden), nn.Linear(dim, hidden)
            if scale_mlp:
                self.norm = LayerNorm(hidden, eps=eps)
        else:
            self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.fc1 is not None:
            h = gelu(linear(x, self.fc1.weight, self.fc1.bias, transposed=True))
        else:
            g = linear(x, self.fc1_g.weight, self.fc1_g.bias, transposed=True)
            h = F.silu(g) * linear(x, self.fc1_x.weight, self.fc1_x.bias, transposed=True)
            if self.norm is not None:
                h = self.norm(h)
        return linear(h, self.fc2.weight, self.fc2.bias, transposed=True)


class EvaBlock(nn.Module):
    def __init__(self, cfg: EvaCfg):
        super().__init__()
        self.norm1 = LayerNorm(cfg.dim, eps=cfg.norm_eps)
        self.attn = EvaAttention(cfg.dim, cfg.heads, cfg.fused_qkv)
        self.norm2 = LayerNorm(cfg.dim, eps=cfg.norm_eps)
        self.mlp = EvaMlp(cfg.dim, cfg.mlp_hidden, cfg.swiglu, cfg.scale_mlp, cfg.norm_eps)

    def forward(self, x: torch.Tensor, rope: Optional[torch.Tensor]) -> torch.Tensor:
        x = x + self.attn(self.norm1(x), rope)
        return x + self.mlp(self.norm2(x))


class Eva(nn.Module):
    def __init__(self, vision_cfg: CLIPVisionCfg, embed_dim: int):
        super().__init__()
        cfg = self.cfg = resolve_eva_cfg(vision_cfg)
        g = cfg.image_size // cfg.patch
        self.patch_embed = PatchEmbed(cfg.patch, cfg.dim, bias=True)
        self.cls_token = nn.Parameter(torch.empty(cfg.dim))
        self.pos_embed = nn.Parameter(torch.empty(g * g + 1, cfg.dim))
        self.transformer = nn.Module()
        self.transformer.resblocks = nn.ModuleList(EvaBlock(cfg) for _ in range(cfg.depth))
        self.norm = LayerNorm(cfg.dim, eps=cfg.norm_eps)
        self.attn_pool = (AttentionPoolLatent(cfg.dim, cfg.heads, int(cfg.dim * 4.0), cfg.norm_eps,
                                              "gelu") if cfg.pool == "map" else None)
        self.head = nn.Linear(cfg.dim, embed_dim)
        rope = (torch.from_numpy(rope_table(g, g, cfg.dim // cfg.heads, cfg.ref_feat_shape))
                if cfg.rope else None)
        self.register_buffer("rope", rope, persistent=False)

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator) -> None:
        """The JAX ``init_eva`` distributions: the patch and fused qkv kernels
        N(0, 0.02) clipped to +-2 std, the class token, position and latent
        embeddings N(0, 0.02), zero q/v and patch biases, LayerNorms at the identity,
        ``nn.Linear``'s default for every other linear."""
        for m in self.modules():
            if isinstance(m, nn.Linear):
                _torch_linear_init_(m, gen)
            elif isinstance(m, nn.LayerNorm):
                _ln_init_(m)
        _trunc_normal_(self.patch_embed.weight, gen)
        self.patch_embed.bias.zero_()
        params = [self.cls_token, self.pos_embed]
        if self.attn_pool is not None:
            params.append(self.attn_pool.latent)
        for p in params:
            p.normal_(0.0, 0.02, generator=gen)
        for blk in self.transformer.resblocks:
            if blk.attn.qkv is not None:
                _trunc_normal_(blk.attn.qkv.weight, gen)
                blk.attn.q_bias.zero_()
                blk.attn.v_bias.zero_()

    def forward(self, image: torch.Tensor, compute_dtype: torch.dtype = torch.float32, *,
                train: bool = False, remat: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B, H, W, 3) normalized NHWC -> pooled, projected (B, embed_dim). Training
        changes nothing: the towers have no dropout."""
        cfg = self.cfg
        x = self.patch_embed(patchify(image.to(compute_dtype), cfg.patch))
        cls = self.cls_token.to(x.dtype).expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(x.dtype)
        for blk in self.transformer.resblocks:
            if remat and torch.is_grad_enabled():
                x = remat_call(blk, x, self.rope)
            else:
                x = blk(x, self.rope)
        x = self.norm(x)
        if self.attn_pool is not None:
            pooled = self.attn_pool(x, torch.ones(x.shape[:2], dtype=torch.bool, device=x.device))
        else:
            pooled = x[:, 0]
        return linear(pooled, self.head.weight, self.head.bias, transposed=True)


# ---------------------------------------------------------------------------
# weights: the JAX tree -> the port's names, and the timm layout -> the JAX tree
# ---------------------------------------------------------------------------

def params_from_jax(vis: Dict[str, Any], depth: int, out: Dict[str, torch.Tensor]) -> None:
    """The JAX ``init_eva`` tree into ``out`` under the port's names (``visual.*``):
    the patch kernel keeps its patchify layout, the stacked ``blocks`` become
    ``transformer.resblocks.{i}``, every other entry keeps its JAX path."""
    from ..convert import _stacked_to_port, _t, _tree_to_port

    rest = {k: v for k, v in vis.items() if k not in ("patch_embed", "blocks")}
    for src, dst in (("kernel", "weight"), ("bias", "bias")):
        if src in vis.get("patch_embed", {}):
            out[f"visual.patch_embed.{dst}"] = _t(vis["patch_embed"][src])
    _tree_to_port(rest, "visual", out)
    if "blocks" in vis:
        _stacked_to_port(vis["blocks"], depth, "visual.transformer.resblocks", out)


def timm_eva_to_params(sd: Dict[str, np.ndarray], vision_cfg: CLIPVisionCfg) -> Dict[str, Any]:
    """timm Eva trunk keys (the ``visual.trunk.`` prefix stripped; numpy leaves) -> the
    JAX package's visual tree, as its ``timm_eva_to_params`` makes it."""
    ecfg = resolve_eva_cfg(vision_cfg)

    def lin(prefix, bias=True):
        p = {"kernel": sd[f"{prefix}.weight"].T}
        if bias:
            p["bias"] = sd[f"{prefix}.bias"]
        return p

    def ln(prefix):
        return {"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]}

    pw = sd["patch_embed.proj.weight"]  # (dim, 3, p, p)
    tree: Dict[str, Any] = {
        # OIHW -> the (p*p*3, dim) patchify layout (p, p, 3)
        "patch_embed": {"kernel": pw.transpose(2, 3, 1, 0).reshape(-1, pw.shape[0]),
                        "bias": sd["patch_embed.proj.bias"]},
        "cls_token": sd["cls_token"].reshape(-1),
        "pos_embed": sd["pos_embed"][0],
        "norm": ln("norm"),
        "head": lin("head"),
    }
    if "attn_pool.latent" in sd:
        tree["attn_pool"] = {
            "latent": sd["attn_pool.latent"].reshape(-1),
            "q": lin("attn_pool.q"), "kv": lin("attn_pool.kv"), "proj": lin("attn_pool.proj"),
            "norm": ln("attn_pool.norm"),
            "mlp": {"c_fc": lin("attn_pool.mlp.fc1"), "c_proj": lin("attn_pool.mlp.fc2")},
        }
    blocks = []
    for i in range(ecfg.depth):
        pre = f"blocks.{i}."
        bp: Dict[str, Any] = {"norm1": ln(pre + "norm1"), "norm2": ln(pre + "norm2")}
        if ecfg.fused_qkv:
            bp["attn"] = {"qkv": lin(pre + "attn.qkv", bias=False),
                          "q_bias": sd[pre + "attn.q_bias"], "v_bias": sd[pre + "attn.v_bias"],
                          "proj": lin(pre + "attn.proj")}
        else:
            bp["attn"] = {"q": lin(pre + "attn.q_proj"), "k": lin(pre + "attn.k_proj", bias=False),
                          "v": lin(pre + "attn.v_proj"), "proj": lin(pre + "attn.proj")}
        if ecfg.swiglu:
            mlp = {"fc1_g": lin(pre + "mlp.fc1_g"), "fc1_x": lin(pre + "mlp.fc1_x"),
                   "fc2": lin(pre + "mlp.fc2")}
            if ecfg.scale_mlp:
                mlp["norm"] = ln(pre + "mlp.norm")
            bp["mlp"] = mlp
        else:
            bp["mlp"] = {"fc1": lin(pre + "mlp.fc1"), "fc2": lin(pre + "mlp.fc2")}
        blocks.append(bp)
    from ..convert import _stack_blocks

    tree["blocks"] = _stack_blocks(dict(enumerate(blocks)))
    return tree
