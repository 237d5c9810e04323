"""Modern text tower (counterpart of ``open_clip_tpu/models/modern_text.py``).

The tower of the ``moderntext-*`` and ``naflexclap_*moderntext*`` configs: a token
embedding without learned positions, interleaved-pair RoPE on q and k, RMSNorm or
LayerNorm (before each sublayer, or "sandwich": also after it), optional qk-norm,
a sigmoid output gate on the attention, optional register tokens and pre-norm, a
value residual (every layer mixes its values with layer 0's by a learned
``vr_lambda``), SwiGLU, GELU or ReLU² MLPs, causal or bidirectional attention over
the valid (non-pad) keys, and masked-mean, EOS (with a last-valid fallback) or
MAP attention pooling.

It is one ``nn.Module``, ``model.text``, with one module per layer under
``text.transformer.resblocks``. The names below it follow the reference's
``text.blocks.{i}.*`` (``norm1``, ``attn.qkv``, ``attn.gate``, ``mlp.w12``,
``ls1.gamma``, ...); the layer list takes the port's ``transformer.resblocks``
name so that weight decay, layer-wise lr decay and tower locking read it as the
other towers' layers. Layer 0 has no ``vr_lambda`` (it makes the values the other
layers mix with), as in the reference; the JAX package's stacked tree carries a
dummy one there.

Attention is dense, as the JAX package pins it (``impl="xla"``); the remat of a
layer recomputes all of it (the JAX package's ``jax.checkpoint`` without a policy).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..config import CLIPTextCfg
from ..ops.attention import dense_attention
from ..ops.layers import ACT_FNS, linear
from .blocks import LayerScale, Norm

NEG_INF = torch.finfo(torch.float32).min
POOL_TYPES = ("mean", "eos", "argmax", "map")
MLP_TYPES = ("swiglu", "mlp", "relu2")


def resolve_norm_type(cfg: CLIPTextCfg) -> str:
    return cfg.norm_type if cfg.norm_type is not None else "rmsnorm"


def check_modern_text_cfg(cfg: CLIPTextCfg) -> None:
    """Raise for settings the tower does not know (the JAX tower's own errors)."""
    if cfg.width % cfg.heads:
        raise ValueError(f"modern text width {cfg.width} is not a multiple of heads {cfg.heads}")
    if cfg.pool_type not in POOL_TYPES:
        raise ValueError(f"modern text pool_type {cfg.pool_type!r}; one of {POOL_TYPES}")
    if cfg.pool_type in ("eos", "argmax") and cfg.eos_id is None:
        raise ValueError("modern text eos/argmax pooling requires text_cfg.eos_id")
    if cfg.mlp_type not in MLP_TYPES:
        raise ValueError(f"modern text mlp_type {cfg.mlp_type!r}; one of {MLP_TYPES}")


def rope_table(seq_len: int, head_dim: int, temperature: float = 10000.0) -> np.ndarray:
    """(seq_len, head_dim) fp32 table, cos | sin halves, computed in numpy as the JAX
    package computes it (so the two tables are equal bit for bit)."""
    inv_freq = 1.0 / (temperature ** (np.arange(0, head_dim, 2, dtype=np.float32) / head_dim))
    freqs = np.outer(np.arange(seq_len, dtype=np.float32), inv_freq)
    return np.concatenate([np.cos(freqs), np.sin(freqs)], axis=-1)


def apply_rope_1d(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Interleaved-pair rotation in fp32, cast back. x: (B, L, H, hd); table (L, hd)."""
    cos, sin = table.float().chunk(2, dim=-1)
    cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    x32 = x.float()
    x1, x2 = x32[..., 0::2], x32[..., 1::2]
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


def _lin(x: torch.Tensor, lin: nn.Linear) -> torch.Tensor:
    return linear(x, lin.weight, lin.bias, transposed=True)


class ModernAttention(nn.Module):
    def __init__(self, cfg: CLIPTextCfg, norm_type: str, attn_bias: bool, gate_bias: bool,
                 first: bool):
        super().__init__()
        width, hd = cfg.width, cfg.width // cfg.heads
        self.heads = cfg.heads
        self.qkv = nn.Linear(width, 3 * width, bias=attn_bias)
        self.proj = nn.Linear(width, width, bias=attn_bias)
        self.q_norm = Norm(hd, norm_type, cfg.norm_eps) if cfg.qk_norm else None
        self.k_norm = Norm(hd, norm_type, cfg.norm_eps) if cfg.qk_norm else None
        self.gate = nn.Linear(width, width, bias=gate_bias) if cfg.attn_gated else None
        self.vr_lambda = (nn.Parameter(torch.full((1,), 0.5))
                          if cfg.value_residual and not first else None)


class ModernMlp(nn.Module):
    def __init__(self, cfg: CLIPTextCfg, mlp_bias: bool):
        super().__init__()
        width, hidden = cfg.width, int(cfg.width * cfg.mlp_ratio)
        self.swiglu = cfg.mlp_type == "swiglu"
        self.act = ACT_FNS["relu2" if cfg.mlp_type == "relu2" else "gelu"]
        if self.swiglu:
            self.w12 = nn.Linear(width, 2 * hidden, bias=mlp_bias)
            self.w3 = nn.Linear(hidden, width, bias=mlp_bias)
        else:
            self.c_fc = nn.Linear(width, hidden, bias=mlp_bias)
            self.c_proj = nn.Linear(hidden, width, bias=mlp_bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.swiglu:
            u, g = _lin(x, self.w12).chunk(2, dim=-1)
            return _lin(u * nn.functional.silu(g), self.w3)
        return _lin(self.act(_lin(x, self.c_fc)), self.c_proj)


class ModernBlock(nn.Module):
    def __init__(self, cfg: CLIPTextCfg, norm_type: str, attn_bias: bool, gate_bias: bool,
                 mlp_bias: bool, first: bool):
        super().__init__()
        width = cfg.width
        sandwich = cfg.norm_placement == "sandwich"
        self.norm1 = Norm(width, norm_type, cfg.norm_eps)
        self.attn = ModernAttention(cfg, norm_type, attn_bias, gate_bias, first)
        self.norm1_post = Norm(width, norm_type, cfg.norm_eps) if sandwich else None
        self.norm2 = Norm(width, norm_type, cfg.norm_eps)
        self.mlp = ModernMlp(cfg, mlp_bias)
        self.norm2_post = Norm(width, norm_type, cfg.norm_eps) if sandwich else None
        self.ls1 = LayerScale(width) if cfg.ls_init_value is not None else None
        self.ls2 = LayerScale(width) if cfg.ls_init_value is not None else None
        self.value_residual = cfg.value_residual

    def forward(self, x: torch.Tensor, v_first: Optional[torch.Tensor], rope: Optional[torch.Tensor],
                key_bias: Optional[torch.Tensor], causal: bool
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        b, l, width = x.shape
        attn = self.attn
        hd = width // attn.heads
        h = self.norm1(x)
        q, k, v = (t.reshape(b, l, attn.heads, hd) for t in _lin(h, attn.qkv).chunk(3, dim=-1))
        if self.value_residual:
            if attn.vr_lambda is None:  # layer 0 makes the values the others mix with
                v_first = v
            else:  # lerp(v_first, v, lambda)
                v = v_first + attn.vr_lambda.float().reshape(()).to(v.dtype) * (v - v_first)
        if attn.q_norm is not None:
            q, k = attn.q_norm(q), attn.k_norm(k)
        if rope is not None:
            q, k = apply_rope_1d(q, rope), apply_rope_1d(k, rope)
        out = dense_attention(q, k, v, key_bias, causal=causal).reshape(b, l, width)
        if attn.gate is not None:
            out = out * torch.sigmoid(_lin(h, attn.gate))
        out = _lin(out, attn.proj)
        if self.norm1_post is not None:
            out = self.norm1_post(out)
        if self.ls1 is not None:
            out = self.ls1(out)
        x = x + out
        h = self.mlp(self.norm2(x))
        if self.norm2_post is not None:
            h = self.norm2_post(h)
        if self.ls2 is not None:
            h = self.ls2(h)
        return x + h, v_first


class _Blocks(nn.Module):
    def __init__(self, blocks):
        super().__init__()
        self.resblocks = nn.ModuleList(blocks)


class ModernTextPool(nn.Module):
    """MAP pooling: one learned query attends over the valid tokens (dense)."""

    def __init__(self, cfg: CLIPTextCfg, norm_type: str, attn_bias: bool):
        super().__init__()
        width, hd = cfg.width, cfg.width // cfg.heads
        self.heads = cfg.heads
        self.query = nn.Parameter(torch.empty(width))
        self.q = nn.Linear(width, width, bias=attn_bias)
        self.kv = nn.Linear(width, 2 * width, bias=attn_bias)
        self.q_norm = Norm(hd, norm_type, cfg.norm_eps) if cfg.qk_norm else None
        self.k_norm = Norm(hd, norm_type, cfg.norm_eps) if cfg.qk_norm else None

    def forward(self, x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        b, l, width = x.shape
        hd = width // self.heads
        query = self.query.to(x.dtype).expand(b, 1, width)
        q = _lin(query, self.q).reshape(b, 1, self.heads, hd)
        k, v = (t.reshape(b, l, self.heads, hd) for t in _lin(x, self.kv).chunk(2, dim=-1))
        if self.q_norm is not None:
            q, k = self.q_norm(q), self.k_norm(k)
        bias = torch.where(valid, 0.0, NEG_INF).float()[:, None, None, :]
        return dense_attention(q, k, v, bias).reshape(b, width)


def valid_mask(cfg: CLIPTextCfg, text: torch.Tensor) -> torch.Tensor:
    """(B, L) bool, the non-pad positions; a row with none keeps its first."""
    if cfg.pad_id is None:
        return torch.ones_like(text, dtype=torch.bool)
    valid = text != cfg.pad_id
    empty = ~valid.any(dim=1, keepdim=True)
    first = torch.zeros_like(valid)
    first[:, 0] = True
    return valid | (empty & first)


class ModernTextTransformer(nn.Module):
    def __init__(self, cfg: CLIPTextCfg, embed_dim: int):
        super().__init__()
        check_modern_text_cfg(cfg)
        self.cfg = cfg
        norm_type = resolve_norm_type(cfg)
        attn_bias = bool(cfg.attention_bias)
        gate_bias = attn_bias if cfg.gate_bias is None else bool(cfg.gate_bias)
        mlp_bias = bool(cfg.mlp_bias)
        width = cfg.width
        self.token_embedding = nn.Embedding(cfg.vocab_size, width)
        self.reg_tokens = nn.Parameter(torch.empty(cfg.reg_tokens, width)) if cfg.reg_tokens else None
        self.norm_pre = Norm(width, norm_type, cfg.norm_eps) if cfg.pre_norm else None
        self.transformer = _Blocks(
            ModernBlock(cfg, norm_type, attn_bias, gate_bias, mlp_bias, first=i == 0)
            for i in range(cfg.layers))
        self.ln_final = Norm(width, norm_type, cfg.norm_eps)
        self.pool = ModernTextPool(cfg, norm_type, attn_bias) if cfg.pool_type == "map" else None
        self.text_projection = (nn.Linear(width, embed_dim, bias=bool(cfg.proj_bias))
                                if cfg.proj_type != "none" and embed_dim else None)
        self._rope = {}

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator) -> None:
        """Distributions of the JAX package's ``init_modern_text_tower``."""
        cfg = self.cfg
        width = cfg.width
        sandwich = cfg.norm_placement == "sandwich"
        attn_std = 0.02 if sandwich else width ** -0.5
        fc_std = 0.02 if sandwich else (2 * width) ** -0.5
        proj_std = 0.02 if sandwich else attn_std * ((2 * cfg.layers) ** -0.5)
        swiglu_fc_std = fc_std if sandwich else fc_std * 1.22

        def normal(p, std):
            p.normal_(0.0, std, generator=gen)

        def res_out(lin, std):
            lin.weight.zero_() if cfg.zero_init_residual else normal(lin.weight, std)

        normal(self.token_embedding.weight, 0.02)
        if cfg.pad_id is not None:
            self.token_embedding.weight[cfg.pad_id] = 0.0
        if self.reg_tokens is not None:
            normal(self.reg_tokens, 1e-6)
        for m in self.modules():
            if isinstance(m, Norm):
                m.reset()
            elif isinstance(m, nn.Linear) and m.bias is not None:
                m.bias.zero_()
        for blk in self.transformer.resblocks:
            attn, mlp = blk.attn, blk.mlp
            normal(attn.qkv.weight, attn_std)
            res_out(attn.proj, proj_std)
            if attn.gate is not None:
                normal(attn.gate.weight, attn_std)
                if attn.gate.bias is not None:
                    attn.gate.bias.fill_(1.0)  # a mostly open gate
            if attn.vr_lambda is not None:
                attn.vr_lambda.fill_(0.5)
            if mlp.swiglu:
                normal(mlp.w12.weight, swiglu_fc_std)
                res_out(mlp.w3, proj_std)
            else:
                normal(mlp.c_fc.weight, fc_std)
                res_out(mlp.c_proj, proj_std)
            for ls in (blk.ls1, blk.ls2):
                if ls is not None:
                    ls.gamma.fill_(cfg.ls_init_value)
        if self.pool is not None:
            for p in (self.pool.query, self.pool.q.weight, self.pool.kv.weight):
                normal(p, width ** -0.5)
        if self.text_projection is not None:
            normal(self.text_projection.weight, width ** -0.5)

    def rope(self, seq: int, device) -> Optional[torch.Tensor]:
        if self.cfg.pos_embed != "rope":
            return None
        key = (seq, str(device))
        if key not in self._rope:
            with torch.inference_mode(False):
                self._rope[key] = torch.from_numpy(
                    rope_table(seq, self.cfg.width // self.cfg.heads,
                               self.cfg.rope_temperature)).to(device)
        return self._rope[key]

    def forward(self, text: torch.Tensor, compute_dtype: torch.dtype = torch.float32, *,
                remat: bool = False) -> torch.Tensor:
        """(B, L) token ids -> pooled, projected (B, embed_dim)."""
        cfg = self.cfg
        b, l = text.shape
        num_reg = cfg.reg_tokens or 0
        x = self.token_embedding.weight[text].to(compute_dtype)
        if num_reg:
            x = torch.cat([self.reg_tokens.to(compute_dtype).expand(b, -1, -1), x], dim=1)
        if self.norm_pre is not None:
            x = self.norm_pre(x)
        valid = valid_mask(cfg, text)
        causal = cfg.attention_mode == "causal"
        key_bias = None
        if not causal:
            key_valid = valid
            if num_reg:
                key_valid = torch.cat([valid.new_ones(b, num_reg), valid], dim=1)
            key_bias = torch.where(key_valid, 0.0, NEG_INF).float()[:, None, None, :]
        rope = self.rope(l + num_reg, x.device)
        v_first = None
        for blk in self.transformer.resblocks:
            if remat and torch.is_grad_enabled():
                x, v_first = checkpoint(blk, x, v_first, rope, key_bias, causal, use_reentrant=False)
            else:
                x, v_first = blk(x, v_first, rope, key_bias, causal)
        x = self.ln_final(x)
        tokens = x[:, num_reg:] if num_reg else x
        pooled = self._pool(tokens, text, valid)
        if self.text_projection is not None:
            pooled = _lin(pooled, self.text_projection)
        return pooled

    def _pool(self, x: torch.Tensor, text: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        if cfg.pool_type == "mean":
            w = valid.float()
            return ((x.float() * w[..., None]).sum(1)
                    / w.sum(1, keepdim=True).clamp_min(1)).to(x.dtype)
        if cfg.pool_type in ("eos", "argmax"):
            eos = text == cfg.eos_id
            last_valid = (valid.int().sum(1) - 1).clamp_min(0)
            idx = torch.where(eos.any(dim=1), eos.int().argmax(dim=1), last_valid)
            return x[torch.arange(x.shape[0], device=x.device), idx]
        return self.pool(x, valid)
