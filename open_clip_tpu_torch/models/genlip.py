"""The GenLIP trunk (counterpart of the trunk half of ``open_clip_tpu/models/genlip.py``).

One pre-norm transformer that GenLIP, GenLAP and the NaFlex audio encoder of CLAP
share: separate q, k and v projections, where q also carries a per-head sigmoid
output gate (``gated_attention``: ``q_proj`` is twice as wide), optional qk-norm,
interleaved 3-axis MRoPE (Qwen2-VL style; each channel pair rotates by the
temporal, height or width position), a SwiGLU or plain MLP, LayerScale and drop
path, and a final ``ln_post``.

The mask comes from ``trunk_mask``: on CUDA, at 512 or more tokens with a head
width the flash kernels take, the structured form (a prefix length and the
(B, S) key validity), which sends the attention through the flash kernels
(``ops/flash_attention.py``) and never builds an (S, S) tensor; else the dense
additive fp32 bias of ``build_prefix_lm_bias`` or ``build_image_bias``. The two
differ at padded query rows only (the dense bias opens their diagonal, the flash
mask hides keys), which nothing downstream reads.

Rounding points, as in the JAX package: the norms keep fp32 statistics, MRoPE
rotates in fp32 and casts back, and the gate is ``sigmoid`` of the fp32 gate cast
to the attention's dtype. The projections carry the JAX package's remat tags
(``remat_qkv`` on q/k/v, ``remat_attn_ctx`` on the attention output,
``remat_fc1`` on the MLP's first products), so ``blocks.REMAT_POLICY``'s presets
save what they save there. The prefix cache, scoring, generation and packing of
GenLIP are not ported.

Module names follow the JAX tree: ``resblocks.{i}.layer_norm1``, ``attn.q_proj``,
``attn.k_proj``, ``attn.v_proj``, ``attn.out_proj``, ``mlp.fc1``, ``mlp.gate_fc``,
``mlp.fc2``, ``ls1.gamma``, then ``ln_post``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import flash_attention as fa
from ..ops.attention import _FLASH_MIN_SEQ, dot_product_attention
from ..ops.layers import linear, remat_name
from .blocks import LayerScale, Norm, remat_call

NEG_INF = torch.finfo(torch.float32).min


@dataclass
class GenLipTrunkCfg:
    width: int = 1152
    depth: int = 27
    num_heads: int = 16
    intermediate_size: int = 3072
    text_embed_dim: int = 1024
    mrope_section: Tuple[int, int, int] = (12, 12, 12)
    rope_theta: float = 10000.0
    ls_init_value: float = 0.1
    drop_path_rate: float = 0.0
    gated_attention: bool = True
    use_swiglu_ffn: bool = True
    mrope_interleaved: bool = True
    hidden_act: str = "silu"
    layer_norm_eps: float = 1e-6
    max_position_embeddings: int = 16384
    attention_bias: bool = False
    mlp_bias: bool = False
    norm_type: str = "layernorm"
    qk_norm: bool = False
    pack_prefix: bool = False

    def __post_init__(self):
        if isinstance(self.mrope_section, list):
            self.mrope_section = tuple(self.mrope_section)


# the JAX trunk's activations: jax.nn.gelu defaults to the tanh form in every dtype
_ACT = {"silu": F.silu, "gelu": lambda x: F.gelu(x, approximate="tanh"), "relu": torch.relu}


# ---------------------------------------------------------------------------
# MRoPE
# ---------------------------------------------------------------------------

def mrope_cos_sin(position_ids: torch.Tensor, head_dim: int, mrope_section: Tuple[int, int, int],
                  theta: float = 10000.0, interleaved: bool = True
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin), each (B, S, head_dim) fp32, from (3, B, S) integer positions. With
    ``interleaved`` the channel pairs cycle temporal, height, width ([THWTHW...]):
    pair j takes axis 1 where j % 3 == 1 and j < 3 * section[1], axis 2 where
    j % 3 == 2 and j < 3 * section[2], else axis 0."""
    inv_freq = 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32) / head_dim))
    inv_freq = torch.from_numpy(inv_freq).to(position_ids.device)
    freqs = position_ids.float()[..., None] * inv_freq  # (3, B, S, half)
    f = freqs[0]
    if interleaved:
        f = f.clone()
        for axis in (1, 2):
            idx = torch.arange(axis, mrope_section[axis] * 3, 3, device=f.device)
            f[..., idx] = freqs[axis][..., idx]
    emb = torch.cat([f, f], dim=-1)
    return emb.cos(), emb.sin()


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def apply_mrope(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q, k: (B, S, H, hd); cos, sin: (B, S, hd), shared by the heads. In fp32, cast back."""
    c, s = cos[:, :, None, :].float(), sin[:, :, None, :].float()
    q32, k32 = q.float(), k.float()
    return ((q32 * c + _rotate_half(q32) * s).to(q.dtype),
            (k32 * c + _rotate_half(k32) * s).to(k.dtype))


# ---------------------------------------------------------------------------
# masks
# ---------------------------------------------------------------------------

def _additive(allowed: torch.Tensor) -> torch.Tensor:
    return torch.where(allowed, 0.0, NEG_INF).float()[:, None]


def build_prefix_lm_bias(patch_valid: torch.Tensor, text_valid: torch.Tensor) -> torch.Tensor:
    """Additive fp32 (B, 1, S, S) bias over [prefix ; text]: the prefix sees itself both
    ways, the text sees the prefix and the text before it; invalid keys are hidden
    and the diagonal is always open."""
    pv, tv = patch_valid.bool(), text_valid.bool()
    ni, s = pv.shape[1], pv.shape[1] + tv.shape[1]
    dev = pv.device
    valid = torch.cat([pv, tv], dim=1)
    is_img = torch.arange(s, device=dev) < ni
    is_txt = ~is_img
    causal = torch.ones(s, s, dtype=torch.bool, device=dev).tril()
    allowed = ((is_img[:, None] & is_img[None, :]) | (is_txt[:, None] & is_txt[None, :] & causal)
               | (is_txt[:, None] & is_img[None, :]))
    allowed = allowed[None] & valid[:, None, :]
    return _additive(allowed | torch.eye(s, dtype=torch.bool, device=dev)[None])


def build_image_bias(patch_valid: torch.Tensor) -> torch.Tensor:
    """Additive fp32 (B, 1, S, S) bias: valid queries and keys see each other, and
    every diagonal entry is open."""
    pv = patch_valid.bool()
    allowed = pv[:, :, None] & pv[:, None, :]
    return _additive(allowed | torch.eye(pv.shape[1], dtype=torch.bool, device=pv.device)[None])


Mask = Union[torch.Tensor, Tuple[str, int, torch.Tensor]]


def flash_ok(on_cuda: bool, seq: int, heads: int, hd: int) -> bool:
    """The JAX ``_flash_ok`` with the card in the TPU's place."""
    return on_cuda and seq >= _FLASH_MIN_SEQ and hd % 64 == 0 and fa.supports(seq, heads, hd, None)


def trunk_mask(prefix_len: int, key_valid: torch.Tensor, seq: int, hd: int, heads: int = 1) -> Mask:
    """The mask ``apply_trunk`` takes: the structured ``("prefix", prefix_len,
    key_valid)`` for the flash kernels where ``flash_ok`` holds, else the dense
    additive bias. ``prefix_len == 0``: bidirectional over the valid keys."""
    if flash_ok(key_valid.is_cuda, seq, heads, hd):
        return ("prefix", int(prefix_len), key_valid)
    if prefix_len:
        return build_prefix_lm_bias(key_valid[:, :prefix_len], key_valid[:, prefix_len:])
    return build_image_bias(key_valid)


# ---------------------------------------------------------------------------
# the trunk
# ---------------------------------------------------------------------------

def _drop_path(x: torch.Tensor, rate: float, train: bool) -> torch.Tensor:
    if not train or rate <= 1e-6:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape[0], 1, 1, device=x.device) < keep
    return x * mask.to(x.dtype) / keep


class TrunkAttention(nn.Module):
    def __init__(self, t: GenLipTrunkCfg):
        super().__init__()
        w, hd = t.width, t.width // t.num_heads
        self.heads = t.num_heads
        self.gated = t.gated_attention
        self.q_proj = nn.Linear(w, 2 * w if t.gated_attention else w, bias=t.attention_bias)
        self.k_proj = nn.Linear(w, w, bias=t.attention_bias)
        self.v_proj = nn.Linear(w, w, bias=t.attention_bias)
        self.out_proj = nn.Linear(w, w, bias=t.attention_bias)
        self.q_norm = Norm(hd, t.norm_type, t.layer_norm_eps) if t.qk_norm else None
        self.k_norm = Norm(hd, t.norm_type, t.layer_norm_eps) if t.qk_norm else None

    def forward(self, h: torch.Tensor, mask: Mask, cos: torch.Tensor,
                sin: torch.Tensor) -> torch.Tensor:
        b, s, width = h.shape
        heads, hd = self.heads, width // self.heads

        def proj(lin):
            return linear(h, lin.weight, lin.bias, transposed=True, name="remat_qkv")

        qg = proj(self.q_proj)
        q, gate = qg.chunk(2, dim=-1) if self.gated else (qg, None)
        k, v = proj(self.k_proj), proj(self.v_proj)
        q, k, v = (t.reshape(b, s, heads, hd) for t in (q, k, v))
        if self.q_norm is not None:
            q, k = self.q_norm(q), self.k_norm(k)
        q, k = apply_mrope(q, k, cos, sin)
        if isinstance(mask, tuple):
            _, prefix_len, key_valid = mask
            with remat_name("remat_attn_ctx"):
                out = fa.flash_attention(q, k, v, causal=prefix_len > 0, prefix_len=prefix_len,
                                         key_valid=key_valid)
        else:
            out = dot_product_attention(q, k, v, bias=mask, name="remat_attn_ctx")
        if gate is not None:
            out = out * torch.sigmoid(gate.reshape(b, s, heads, hd).float()).to(out.dtype)
        out = out.reshape(b, s, width)
        return linear(out, self.out_proj.weight, self.out_proj.bias, transposed=True)


class TrunkMlp(nn.Module):
    def __init__(self, t: GenLipTrunkCfg):
        super().__init__()
        self.act = _ACT[t.hidden_act]
        self.fc1 = nn.Linear(t.width, t.intermediate_size, bias=t.mlp_bias)
        self.gate_fc = (nn.Linear(t.width, t.intermediate_size, bias=t.mlp_bias)
                        if t.use_swiglu_ffn else None)
        self.fc2 = nn.Linear(t.intermediate_size, t.width, bias=t.mlp_bias)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        def fc1(lin):
            return linear(h, lin.weight, lin.bias, transposed=True, name="remat_fc1")

        if self.gate_fc is not None:
            a = self.act(fc1(self.gate_fc)) * fc1(self.fc1)
        else:
            a = self.act(fc1(self.fc1))
        return linear(a, self.fc2.weight, self.fc2.bias, transposed=True)


class TrunkBlock(nn.Module):
    def __init__(self, t: GenLipTrunkCfg):
        super().__init__()
        self.t = t
        self.layer_norm1 = Norm(t.width, t.norm_type, t.layer_norm_eps)
        self.attn = TrunkAttention(t)
        self.layer_norm2 = Norm(t.width, t.norm_type, t.layer_norm_eps)
        self.mlp = TrunkMlp(t)
        has_ls = t.ls_init_value is not None and t.ls_init_value > 1e-6
        self.ls1 = LayerScale(t.width) if has_ls else None
        self.ls2 = LayerScale(t.width) if has_ls else None

    def forward(self, x: torch.Tensor, mask: Mask, cos: torch.Tensor, sin: torch.Tensor,
                train: bool = False) -> torch.Tensor:
        out = self.attn(self.layer_norm1(x), mask, cos, sin)
        if self.ls1 is not None:
            out = self.ls1(out)
        x = x + _drop_path(out, self.t.drop_path_rate, train)
        h = self.mlp(self.layer_norm2(x))
        if self.ls2 is not None:
            h = self.ls2(h)
        return x + _drop_path(h, self.t.drop_path_rate, train)

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator) -> None:
        """The JAX ``init_genlip`` block: xavier-uniform kernels, zero attention
        biases, normal(1e-6) MLP biases, unit norms, LayerScale at its init value."""
        for lin in (self.attn.q_proj, self.attn.k_proj, self.attn.v_proj, self.attn.out_proj,
                    self.mlp.fc1, self.mlp.gate_fc, self.mlp.fc2):
            if lin is None:
                continue
            bound = (6.0 / (lin.in_features + lin.out_features)) ** 0.5
            lin.weight.uniform_(-bound, bound, generator=gen)
            if lin.bias is not None:
                if lin in (self.mlp.fc1, self.mlp.gate_fc, self.mlp.fc2):
                    lin.bias.normal_(0.0, 1e-6, generator=gen)
                else:
                    lin.bias.zero_()
        for norm in (self.layer_norm1, self.layer_norm2, self.attn.q_norm, self.attn.k_norm):
            if norm is not None:
                norm.reset()
        for ls in (self.ls1, self.ls2):
            if ls is not None:
                ls.gamma.fill_(self.t.ls_init_value)


class GenLipTrunk(nn.Module):
    """``resblocks`` then ``ln_post``; ``forward`` is the JAX ``apply_trunk``."""

    def __init__(self, t: GenLipTrunkCfg):
        super().__init__()
        self.t = t
        self.resblocks = nn.ModuleList(TrunkBlock(t) for _ in range(t.depth))
        self.ln_post = Norm(t.width, t.norm_type, t.layer_norm_eps)

    def init_weights(self, gen: torch.Generator) -> None:
        for blk in self.resblocks:
            blk.init_weights(gen)
        self.ln_post.reset()

    def forward(self, x: torch.Tensor, mask: Mask, cos: torch.Tensor, sin: torch.Tensor, *,
                remat: bool = False, train: bool = False) -> torch.Tensor:
        """With ``remat`` each block saves what ``blocks.REMAT_POLICY`` names and
        recomputes the rest in the backward pass (the JAX ``jax.checkpoint`` with
        ``remat_policy()``)."""
        for blk in self.resblocks:
            if remat and torch.is_grad_enabled():
                x = remat_call(blk, x, mask, cos, sin, train)
            else:
                x = blk(x, mask, cos, sin, train)
        return self.ln_post(x)


def apply_trunk(trunk: GenLipTrunk, x: torch.Tensor, mask: Mask, cos: torch.Tensor,
                sin: torch.Tensor, *, remat: bool = False, train: bool = False) -> torch.Tensor:
    return trunk(x, mask, cos, sin, remat=remat, train=train)
