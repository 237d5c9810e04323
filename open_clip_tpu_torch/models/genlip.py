"""GenLIP (counterpart of ``open_clip_tpu/models/genlip.py``).

One pre-norm transformer trunk, which GenLIP, GenLAP (``models/genlap.py``) and the
NaFlex audio encoder of CLAP share: separate q, k and v projections, where q also
carries a per-head sigmoid output gate (``gated_attention``: ``q_proj`` is twice as
wide), optional qk-norm, interleaved 3-axis MRoPE (Qwen2-VL style; each channel
pair rotates by the temporal, height or width position), a SwiGLU or plain MLP,
LayerScale and drop path, and a final ``ln_post``.

GenLIP runs it over [NaFlex image patches ; caption tokens] under a prefix-LM mask
(the image attends itself both ways, the text attends the image and the text before
it) and predicts the caption with an untied ``lm_head``. Its faces: ``encode_image``
(the trunk over the image alone, a masked mean pool, ``visual_proj``),
``genlip_forward`` (logits, or the caption loss through the chunked linear
cross-entropy of ``ops/fused_ce.py``, or with ``pack_prefix`` the same loss over the
packed [valid prefix ; valid text ; pad] layout), ``prefix_cache`` and
``score_captions`` (the image's per-layer K/V computed once, then captions scored
against it), and ``generate`` (greedy, top-k or top-p, with that cache or by running
the trunk over [image ; ids] each step).

The mask comes from ``trunk_mask``: on CUDA, at 512 or more tokens with a head
width the flash kernels take, the structured form (a prefix length and the
(B, S) key validity), which sends the attention through the flash kernels
(``ops/flash_attention.py``; ``causal`` with ``prefix_len`` = the image's length in
the joint forward) and never builds an (S, S) tensor; else the dense additive fp32
bias of ``build_prefix_lm_bias`` or ``build_image_bias``. The two differ at padded
query rows only (the dense bias opens their diagonal, the flash mask hides keys),
which nothing downstream reads. The cached paths (scoring, decoding), the packed
layout and every call under 512 tokens are dense, as in the JAX package.

Rounding points, as in the JAX package: the norms keep fp32 statistics, MRoPE
rotates in fp32 and casts back, and the gate is ``sigmoid`` of the fp32 gate cast
to the attention's dtype. The projections carry the JAX package's remat tags
(``remat_qkv`` on q/k/v, ``remat_attn_ctx`` on the attention output,
``remat_fc1`` on the MLP's first products), so ``blocks.REMAT_POLICY``'s presets
save what they save there. Drop path draws each block's two (B, 1, 1) keep masks
from the caller's ``torch.Generator`` before the block runs, so a recomputed block
(remat) applies the same masks.

Module names follow the JAX tree: ``patch_embed.{norm_input,proj,norm_pre}``,
``text_embed``, ``in_proj``, ``text_norm_pre``, ``trunk.resblocks.{i}.layer_norm1``,
``attn.{q,k,v,out}_proj``, ``mlp.{fc1,gate_fc,fc2}``, ``ls1.gamma``, then
``trunk.ln_post``, ``out_proj``, ``lm_head`` and ``visual_proj``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import flash_attention as fa
from ..ops.attention import _FLASH_MIN_SEQ, dot_product_attention
from ..ops.fused_ce import fused_linear_cross_entropy
from ..ops.layers import layer_norm, linear, remat_name
from .blocks import LayerScale, Norm, remat_call

NEG_INF = torch.finfo(torch.float32).min


@dataclass
class GenLipVisionCfg:
    image_size: int = 256
    patch_size: int = 16
    in_chans: int = 3
    proj_bias: bool = True
    input_norm: bool = False
    pre_norm: bool = False
    pool_type: str = "avg"


@dataclass
class GenLipTextCfg:
    vocab_size: int = 100280
    context_length: int = 256
    pad_id: int = 100278
    bos_id: int = 100279
    eos_id: int = 100277
    tokenizer_type: str = "tiktoken"
    tiktoken_name: str = "cl100k_base"
    pre_norm: bool = False


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


def _from_fields(klass, sub):
    names = {f.name for f in dataclasses.fields(klass)}
    return klass(**{k: v for k, v in (sub or {}).items() if k in names})


@dataclass
class GenLipModelCfg:
    embed_dim: int
    vision_cfg: GenLipVisionCfg
    text_cfg: GenLipTextCfg
    trunk_cfg: GenLipTrunkCfg

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "GenLipModelCfg":
        return cls(embed_dim=d["embed_dim"],
                   vision_cfg=_from_fields(GenLipVisionCfg, d.get("vision_cfg")),
                   text_cfg=_from_fields(GenLipTextCfg, d.get("text_cfg")),
                   trunk_cfg=_from_fields(GenLipTrunkCfg, d.get("genlip_cfg") or d.get("genlap_cfg")))


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
    j % 3 == 2 and j < 3 * section[2], else axis 0. Pairs past head_dim / 2 are
    left out (the JAX scatter drops indices out of range: the test configs' sections
    of (2, 3, 3) at head_dim 16 reach pair 8 of 8)."""
    inv_freq = 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32) / head_dim))
    inv_freq = torch.from_numpy(inv_freq).to(position_ids.device)
    freqs = position_ids.float()[..., None] * inv_freq  # (3, B, S, half)
    f = freqs[0]
    if interleaved:
        f = f.clone()
        for axis in (1, 2):
            idx = torch.arange(axis, min(mrope_section[axis] * 3, f.shape[-1]), 3, device=f.device)
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


def _cos_sin(t: GenLipTrunkCfg, pos: torch.Tensor):
    return mrope_cos_sin(pos, t.width // t.num_heads, t.mrope_section, t.rope_theta,
                         t.mrope_interleaved)


# ---------------------------------------------------------------------------
# masks and positions
# ---------------------------------------------------------------------------

def _additive(allowed: torch.Tensor) -> torch.Tensor:
    return torch.where(allowed, 0.0, NEG_INF).float()[:, None]


def _eye(n: int, device) -> torch.Tensor:
    return torch.eye(n, dtype=torch.bool, device=device)[None]


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
    return _additive(allowed | _eye(s, dev))


def build_image_bias(patch_valid: torch.Tensor) -> torch.Tensor:
    """Additive fp32 (B, 1, S, S) bias: valid queries and keys see each other, and
    every diagonal entry is open."""
    pv = patch_valid.bool()
    allowed = pv[:, :, None] & pv[:, None, :]
    return _additive(allowed | _eye(pv.shape[1], pv.device))


def build_text_over_prefix_bias(patch_valid: torch.Tensor, text_valid: torch.Tensor) -> torch.Tensor:
    """Additive fp32 (B, 1, Lt, Ni + Lt) bias of text queries over [cached prefix ;
    text]: the text rows of ``build_prefix_lm_bias``."""
    pv, tv = patch_valid.bool(), text_valid.bool()
    b, ni = pv.shape
    lt = tv.shape[1]
    causal = torch.ones(lt, lt, dtype=torch.bool, device=pv.device).tril()
    txt = (causal[None] & tv[:, None, :]) | _eye(lt, pv.device)
    return _additive(torch.cat([pv[:, None, :].expand(b, lt, ni), txt.expand(b, lt, lt)], dim=-1))


def build_packed_prefix_lm_bias(prefix_pos: torch.Tensor, text_pos: torch.Tensor) -> torch.Tensor:
    """Additive fp32 (B, 1, T, T) bias of the packed [valid prefix ; valid text ; pad]
    layout: per row, the prefix sees itself both ways, the text the prefix and the
    text before it; pads are hidden and the diagonal is open."""
    t = prefix_pos.shape[1]
    causal = torch.ones(t, t, dtype=torch.bool, device=prefix_pos.device).tril()
    allowed = ((prefix_pos[:, :, None] & prefix_pos[:, None, :])
               | (text_pos[:, :, None] & text_pos[:, None, :] & causal[None])
               | (text_pos[:, :, None] & prefix_pos[:, None, :]))
    allowed = allowed & (prefix_pos | text_pos)[:, None, :]
    return _additive(allowed | _eye(t, prefix_pos.device))


Mask = Union[torch.Tensor, Tuple[str, int, torch.Tensor]]


def flash_ok(on_cuda: bool, seq: int, heads: int, hd: int) -> bool:
    """The JAX ``_flash_ok`` with the card in the TPU's place."""
    return on_cuda and seq >= _FLASH_MIN_SEQ and hd % 64 == 0 and fa.supports(seq, heads, hd, None)


def trunk_mask(prefix_len: int, key_valid: torch.Tensor, seq: int, hd: int, heads: int = 1) -> Mask:
    """The mask ``GenLipTrunk.forward`` takes: the structured ``("prefix", prefix_len,
    key_valid)`` for the flash kernels where ``flash_ok`` holds, else the dense
    additive bias. ``prefix_len == 0``: bidirectional over the valid keys."""
    if flash_ok(key_valid.is_cuda, seq, heads, hd):
        return ("prefix", int(prefix_len), key_valid)
    if prefix_len:
        return build_prefix_lm_bias(key_valid[:, :prefix_len], key_valid[:, prefix_len:])
    return build_image_bias(key_valid)


def build_image_position_ids(patch_coord: torch.Tensor) -> torch.Tensor:
    """(3, B, Ni) MRoPE positions of image patches: (0, y, x)."""
    y, x = patch_coord[..., 0].long(), patch_coord[..., 1].long()
    return torch.stack([torch.zeros_like(y), y, x])


def image_text_start(patch_coord: torch.Tensor, patch_valid: torch.Tensor) -> torch.Tensor:
    """(B,) the first text position after an image: 1 + the largest valid y or x."""
    pv = patch_valid.bool()
    y, x = patch_coord[..., 0].long(), patch_coord[..., 1].long()
    zero = torch.zeros_like(y)
    return torch.maximum(torch.where(pv, y, zero).amax(1), torch.where(pv, x, zero).amax(1)) + 1


def text_position_ids(text_start: torch.Tensor, lt: int, b: Optional[int] = None) -> torch.Tensor:
    """(3, B, Lt): every axis of text token j at ``text_start + j``."""
    pos = text_start[:, None] + torch.arange(lt, device=text_start.device)[None, :]
    pos = pos.expand(b or pos.shape[0], lt)
    return pos[None].expand(3, -1, -1)


def build_mrope_position_ids(patch_coord: torch.Tensor, patch_valid: torch.Tensor,
                             text_valid: torch.Tensor) -> torch.Tensor:
    """(3, B, Ni + Lt) positions of [image ; text]."""
    start = image_text_start(patch_coord, patch_valid)
    return torch.cat([build_image_position_ids(patch_coord),
                      text_position_ids(start, text_valid.shape[1])], dim=2)


def pack_prefix_sequence(prefix_emb: torch.Tensor, prefix_valid: torch.Tensor,
                         block_pos: torch.Tensor, text_emb: torch.Tensor,
                         text_valid: torch.Tensor):
    """Each row as [valid prefix ; valid text ; pad] of the fixed length T = Np + Nt
    (both validities front-contiguous). Returns (combined (B, T, W), positions
    (3, B, T), bias (B, 1, T, T), k (B,) prefix lengths, m (B,) text lengths)."""
    b, n_prefix, _ = prefix_emb.shape
    t = n_prefix + text_emb.shape[1]
    k = prefix_valid.long().sum(1)
    m = text_valid.long().sum(1)
    cols = torch.arange(t, device=prefix_emb.device)[None, :]
    prefix_dst = cols < k[:, None]
    text_dst = (cols >= k[:, None]) & (cols < (k + m)[:, None])
    idx = torch.where(prefix_dst, cols, torch.where(text_dst, n_prefix + cols - k[:, None], 0))
    concat = torch.cat([prefix_emb, text_emb], dim=1)
    combined = torch.gather(concat, 1, idx[..., None].expand(-1, -1, concat.shape[-1]))
    combined = combined * (prefix_dst | text_dst)[..., None].to(combined.dtype)
    pos = torch.gather(block_pos, 2, idx[None].expand(3, -1, -1))
    return combined, pos, build_packed_prefix_lm_bias(prefix_dst, text_dst), k, m


# ---------------------------------------------------------------------------
# the trunk
# ---------------------------------------------------------------------------

def _drop_path(x: torch.Tensor, keep: Optional[torch.Tensor], rate: float) -> torch.Tensor:
    """``x`` times a (B, 1, 1) keep mask over 1 - rate (the JAX ``_drop_path``)."""
    return x if keep is None else x * keep.to(x.dtype) / (1.0 - rate)


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

    def forward(self, h: torch.Tensor, mask: Mask, cos: torch.Tensor, sin: torch.Tensor,
                kv_cache=None, return_kv: bool = False):
        """``kv_cache=(k, v)``: keys and values (post-RoPE; batch 1 or B) placed ahead of
        this call's own, which ``mask`` (a dense bias) must then cover. ``return_kv``:
        also return this call's own post-RoPE (k, v)."""
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
        own = (k, v)
        if kv_cache is not None:
            kc, vc = kv_cache
            k = torch.cat([kc.to(k.dtype).expand(b, *kc.shape[1:]), k], dim=1)
            v = torch.cat([vc.to(v.dtype).expand(b, *vc.shape[1:]), v], dim=1)
        if isinstance(mask, tuple):
            _, prefix_len, key_valid = mask
            with remat_name("remat_attn_ctx"):
                out = fa.flash_attention(q, k, v, causal=prefix_len > 0, prefix_len=prefix_len,
                                         key_valid=key_valid)
        else:
            out = dot_product_attention(q, k, v, bias=mask, name="remat_attn_ctx")
        if gate is not None:
            out = out * torch.sigmoid(gate.reshape(b, s, heads, hd).float()).to(out.dtype)
        out = linear(out.reshape(b, s, width), self.out_proj.weight, self.out_proj.bias,
                     transposed=True)
        return (out, own) if return_kv else out


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
                keep: Optional[torch.Tensor] = None, kv_cache=None, return_kv: bool = False):
        """``keep``: (2, B, 1, 1) drop-path masks of the two branches, or None."""
        out = self.attn(self.layer_norm1(x), mask, cos, sin, kv_cache, return_kv)
        if return_kv:
            out, kv = out
        if self.ls1 is not None:
            out = self.ls1(out)
        rate = self.t.drop_path_rate
        x = x + _drop_path(out, None if keep is None else keep[0], rate)
        h = self.mlp(self.layer_norm2(x))
        if self.ls2 is not None:
            h = self.ls2(h)
        x = x + _drop_path(h, None if keep is None else keep[1], rate)
        return (x, kv) if return_kv else x

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
                remat: bool = False, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """With ``remat`` each block saves what ``blocks.REMAT_POLICY`` names and
        recomputes the rest in the backward pass (the JAX ``jax.checkpoint`` with
        ``remat_policy()``). With ``train`` and a drop-path rate, each block's keep
        masks are drawn from ``generator`` (the device's default one if None)."""
        rate = self.t.drop_path_rate
        for blk in self.resblocks:
            keep = None
            if train and rate > 1e-6:
                keep = torch.rand((2, x.shape[0], 1, 1), generator=generator,
                                  device=x.device) < 1.0 - rate
            if remat and torch.is_grad_enabled():
                x = remat_call(blk, x, mask, cos, sin, keep)
            else:
                x = blk(x, mask, cos, sin, keep)
        return self.ln_post(x)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

class GenLipModel(nn.Module):
    """The JAX ``init_genlip`` tree as modules; the JAX ``GenLipModel`` facade's
    methods (``encode_image``, ``forward``, ``prefix_cache``, ``score_captions``,
    ``generate``). The prefix is a NaFlex image patch dict {"patches" (B, N, p*p*3),
    "patch_coord" (B, N, 2) (y, x), "patch_valid" (B, N)}."""

    prefix_key = "image"

    def __init__(self, cfg: GenLipModelCfg, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = compute_dtype
        t, x = cfg.trunk_cfg, cfg.text_cfg
        self.pad_id = x.pad_id
        self.context_length = x.context_length
        self.preprocess_cfg = None
        self.patch_embed = self._make_patch_embed()
        self.text_embed = nn.Embedding(x.vocab_size, t.text_embed_dim)
        if t.text_embed_dim != t.width:
            self.in_proj = nn.Linear(t.text_embed_dim, t.width)
            self.out_proj = nn.Linear(t.width, t.text_embed_dim)
        else:
            self.in_proj = self.out_proj = None
        self.text_norm_pre = Norm(t.width, t.norm_type, t.layer_norm_eps) if x.pre_norm else None
        self.lm_head = nn.Linear(t.text_embed_dim, x.vocab_size, bias=False)
        self.trunk = GenLipTrunk(t)
        self.visual_proj = nn.Linear(t.width, cfg.embed_dim) if cfg.embed_dim != t.width else None

    def _patch_settings(self):
        """(patch dim, input norm, pre norm, projection bias) of the prefix embed."""
        v = self.cfg.vision_cfg
        return v.patch_size * v.patch_size * v.in_chans, v.input_norm, v.pre_norm, v.proj_bias

    def _make_patch_embed(self) -> nn.ModuleDict:
        t = self.cfg.trunk_cfg
        pdim, input_norm, pre_norm, bias = self._patch_settings()
        pe = nn.ModuleDict({"proj": nn.Linear(pdim, t.width, bias=bias)})
        if input_norm:
            pe["norm_input"] = nn.LayerNorm(pdim)
        if pre_norm:
            pe["norm_pre"] = Norm(t.width, t.norm_type, t.layer_norm_eps)
        return pe

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator) -> None:
        """Random weights with the JAX ``init_genlip`` distributions: normal(0.02)
        embeddings and projections (the pad id's row zero), zero biases, unit norms,
        and the trunk's own."""
        for lin in (self.patch_embed["proj"], self.in_proj, self.out_proj, self.lm_head,
                    self.visual_proj):
            if lin is not None:
                lin.weight.normal_(0.0, 0.02, generator=gen)
                if lin.bias is not None:
                    lin.bias.zero_()
        self.text_embed.weight.normal_(0.0, 0.02, generator=gen)
        self.text_embed.weight[self.cfg.text_cfg.pad_id] = 0.0
        if "norm_input" in self.patch_embed:
            self.patch_embed["norm_input"].weight.fill_(1.0)
            self.patch_embed["norm_input"].bias.zero_()
        for norm in (self.patch_embed["norm_pre"] if "norm_pre" in self.patch_embed else None,
                     self.text_norm_pre):
            if norm is not None:
                norm.reset()
        self.trunk.init_weights(gen)

    @property
    def device(self) -> torch.device:
        return self.lm_head.weight.device

    def params_outside_loss(self) -> set:
        """``visual_proj`` serves ``encode_image`` only: the caption loss gives it a
        zero gradient, as ``jax.grad`` does."""
        return {n for n, _ in self.named_parameters() if n.startswith("visual_proj.")}

    # the prefix's geometry; GenLAP overrides these three
    def embed_prefix(self, patches: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
        """The JAX ``embed_patches``."""
        pe = self.patch_embed
        x = patches.to(compute_dtype)
        if "norm_input" in pe:
            x = layer_norm(x, pe["norm_input"].weight, pe["norm_input"].bias)
        x = linear(x, pe["proj"].weight, pe["proj"].bias, transposed=True)
        if "norm_pre" in pe:
            x = pe["norm_pre"](x)
        return x

    def prefix_position_ids(self, prefix: Dict[str, torch.Tensor]) -> torch.Tensor:
        return build_image_position_ids(prefix["patch_coord"])

    def text_start(self, prefix: Dict[str, torch.Tensor]) -> torch.Tensor:
        return image_text_start(prefix["patch_coord"], prefix["patch_valid"])

    def embed_text(self, text: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
        """The JAX ``embed_text``: the embedding row, ``in_proj``, ``text_norm_pre``."""
        x = self.text_embed.weight[text.long()].to(compute_dtype)
        if self.in_proj is not None:
            x = linear(x, self.in_proj.weight, self.in_proj.bias, transposed=True)
        if self.text_norm_pre is not None:
            x = self.text_norm_pre(x)
        return x

    def project_out(self, h: torch.Tensor) -> torch.Tensor:
        if self.out_proj is None:
            return h
        return linear(h, self.out_proj.weight, self.out_proj.bias, transposed=True)

    def logits(self, h: torch.Tensor) -> torch.Tensor:
        """Vocabulary logits of ``out_proj``'s output, in its dtype."""
        return linear(h, self.lm_head.weight, transposed=True)

    def _inputs(self, prefix) -> Dict[str, torch.Tensor]:
        from .clip import _as_tensor

        return {k: _as_tensor(v, self.device) for k, v in prefix.items()}

    def encode_image(self, image, normalize: bool = False, remat: bool = False) -> torch.Tensor:
        return encode_prefix(self, self._inputs(image), normalize=normalize, remat=remat)

    def forward(self, image, text, text_valid=None, *, compute_loss: bool = False,
                remat: bool = False, train: bool = False,
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        from .clip import _as_tensor

        tv = None if text_valid is None else _as_tensor(text_valid, self.device)
        return genlip_forward(self, self._inputs(image), _as_tensor(text, self.device), tv,
                              compute_loss=compute_loss, remat=remat, train=train,
                              generator=generator)

    def prefix_cache(self, image) -> Dict[str, torch.Tensor]:
        return prefix_cache(self, self._inputs(image))

    def score_captions(self, cache: Dict[str, torch.Tensor], text, text_valid=None) -> torch.Tensor:
        from .clip import _as_tensor

        tv = None if text_valid is None else _as_tensor(text_valid, self.device)
        return score_captions(self, cache, _as_tensor(text, self.device), tv)

    def generate(self, image, *, seed: Optional[int] = None,
                 generator: Optional[torch.Generator] = None, **kw) -> torch.Tensor:
        """Caption the prefixes (module-level ``generate``); sampling draws from
        ``generator`` or, given ``seed``, a generator on the model's device seeded
        with it."""
        if generator is None and seed is not None:
            generator = torch.Generator(device=self.device)
            generator.manual_seed(seed)
        return generate(self, self._inputs(image), generator, **kw)

    def patch_features(self, image, remat: bool = False) -> torch.Tensor:
        return patch_features(self, self._inputs(image), remat=remat)


def _prefix_trunk(model: GenLipModel, prefix: Dict[str, torch.Tensor], remat: bool) -> torch.Tensor:
    """The trunk over the prefix alone (bidirectional over its valid tokens)."""
    t = model.cfg.trunk_cfg
    pv = prefix["patch_valid"].bool()
    x = model.embed_prefix(prefix["patches"], model.compute_dtype)
    mask = trunk_mask(0, pv, x.shape[1], t.width // t.num_heads, t.num_heads)
    cos, sin = _cos_sin(t, model.prefix_position_ids(prefix))
    return model.trunk(x, mask, cos, sin, remat=remat)


def encode_prefix(model: GenLipModel, prefix: Dict[str, torch.Tensor], *, normalize: bool = False,
                  remat: bool = False) -> torch.Tensor:
    """The JAX ``encode_image`` (and GenLAP's ``encode_audio``): the trunk over the
    prefix, a mean over its valid tokens in fp32, ``visual_proj``."""
    from .clip import _l2_normalize

    x = _prefix_trunk(model, prefix, remat)
    w = prefix["patch_valid"].float()[..., None]
    pooled = ((x.float() * w).sum(1) / w.sum(1).clamp_min(1.0)).to(x.dtype)
    if model.visual_proj is not None:
        pooled = linear(pooled, model.visual_proj.weight, model.visual_proj.bias, transposed=True)
    return _l2_normalize(pooled) if normalize else pooled


def patch_features(model: GenLipModel, image: Dict[str, torch.Tensor], *,
                   remat: bool = False) -> torch.Tensor:
    """(B, Ni, width) last-layer patch states after ``ln_post``, image-only mask."""
    return _prefix_trunk(model, image, remat)


def _joint_hidden(model: GenLipModel, prefix, text, text_valid, *, remat=False, train=False,
                  generator=None) -> Tuple[torch.Tensor, int]:
    """``out_proj`` of the trunk over [prefix ; text] under the prefix-LM mask, and
    the prefix length."""
    t = model.cfg.trunk_cfg
    cd = model.compute_dtype
    pv = prefix["patch_valid"].bool()
    pre = model.embed_prefix(prefix["patches"], cd)
    h = torch.cat([pre, model.embed_text(text, cd)], dim=1)
    ni = pre.shape[1]
    mask = trunk_mask(ni, torch.cat([pv, text_valid.bool()], dim=1), h.shape[1],
                      t.width // t.num_heads, t.num_heads)
    pos = torch.cat([model.prefix_position_ids(prefix),
                     text_position_ids(model.text_start(prefix), text.shape[1])], dim=2)
    cos, sin = _cos_sin(t, pos)
    h = model.trunk(h, mask, cos, sin, remat=remat, train=train, generator=generator)
    return model.project_out(h), ni


def genlip_forward(model: GenLipModel, prefix: Dict[str, torch.Tensor], text: torch.Tensor,
                   text_valid: Optional[torch.Tensor] = None, *, compute_loss: bool = False,
                   remat: bool = False, train: bool = False,
                   generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
    """The JAX ``genlip_forward`` (and ``genlap_forward``): {"logits" (B, Ni + Lt, V),
    "<prefix>_seq_len": Ni}, or with ``compute_loss`` {"loss"}: the mean cross-entropy
    of each valid caption token predicted from the position before it (the last
    prefix position predicts token 0), through the chunked linear CE on ``lm_head``;
    with ``pack_prefix`` over the packed layout (no drop path there, as in JAX)."""
    t = model.cfg.trunk_cfg
    if text_valid is None:
        text_valid = text != model.cfg.text_cfg.pad_id
    if compute_loss and t.pack_prefix:
        pv = prefix["patch_valid"].bool()
        cd = model.compute_dtype
        pos = torch.cat([model.prefix_position_ids(prefix),
                         text_position_ids(model.text_start(prefix), text.shape[1])], dim=2)
        return {"loss": packed_caption_loss(model, model.embed_prefix(prefix["patches"], cd), pv,
                                            pos, text, text_valid, remat=remat)}
    h, ni = _joint_hidden(model, prefix, text, text_valid, remat=remat, train=train,
                          generator=generator)
    if compute_loss:
        pred = h[:, ni - 1:-1]
        target = torch.where(text_valid.bool(), text.long(), -100)
        return {"loss": fused_linear_cross_entropy(pred.reshape(-1, pred.shape[-1]),
                                                   model.lm_head.weight, target.reshape(-1))}
    return {"logits": model.logits(h), f"{model.prefix_key}_seq_len": ni}


def packed_caption_loss(model: GenLipModel, prefix_emb: torch.Tensor, prefix_valid: torch.Tensor,
                        block_pos: torch.Tensor, text: torch.Tensor, text_valid: torch.Tensor, *,
                        remat: bool = False) -> torch.Tensor:
    """The caption CE over ``pack_prefix_sequence``'s layout: caption token 0 is
    predicted from the last valid prefix token, each later one from the token
    before it (the JAX ``packed_caption_loss``)."""
    t = model.cfg.trunk_cfg
    txt = model.embed_text(text, model.compute_dtype)
    combined, pos, bias, k, m = pack_prefix_sequence(prefix_emb, prefix_valid.bool(), block_pos,
                                                     txt, text_valid.bool())
    cos, sin = _cos_sin(t, pos)
    h = model.project_out(model.trunk(combined, bias, cos, sin, remat=remat))
    cols = torch.arange(h.shape[1], device=h.device)[None, :]
    pred = (cols >= (k - 1)[:, None]) & (cols < (k + m - 1)[:, None])
    tok = torch.gather(text.long(), 1, (cols - (k - 1)[:, None]).clamp(0, text.shape[1] - 1))
    labels = torch.where(pred, tok, -100)
    return fused_linear_cross_entropy(h.reshape(-1, h.shape[-1]), model.lm_head.weight,
                                      labels.reshape(-1))


# ---------------------------------------------------------------------------
# the prefix KV cache: scoring and decoding
#
# The prefix never attends the text, so its per-layer K/V are the joint forward's:
# computed once, they serve every caption scored or decoded against it. The text's
# queries attend [cached prefix ; text] through a dense bias.
# ---------------------------------------------------------------------------

@torch.no_grad()
def prefix_cache(model: GenLipModel, prefix: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The trunk over the prefix once: {"k", "v": (depth, B, Ni, H, hd) post-RoPE,
    "last_hidden": (B, D) ``out_proj`` of the last prefix position (whose logits
    predict caption token 0), "patch_valid", "text_start" (B,)}. Every prefix query,
    a padded one too, attends the valid prefix keys and itself: the prefix rows of
    ``build_prefix_lm_bias``."""
    t = model.cfg.trunk_cfg
    pv = prefix["patch_valid"].bool()
    x = model.embed_prefix(prefix["patches"], model.compute_dtype)
    b, ni = pv.shape
    bias = _additive(pv[:, None, :].expand(b, ni, ni) | _eye(ni, pv.device))
    cos, sin = _cos_sin(t, model.prefix_position_ids(prefix))
    ks, vs = [], []
    for blk in model.trunk.resblocks:
        x, (k, v) = blk(x, bias, cos, sin, return_kv=True)
        ks.append(k)
        vs.append(v)
    last = model.project_out(model.trunk.ln_post(x)[:, -1])
    return {"k": torch.stack(ks), "v": torch.stack(vs), "last_hidden": last, "patch_valid": pv,
            "text_start": model.text_start(prefix)}


@torch.no_grad()
def score_captions(model: GenLipModel, cache: Dict[str, torch.Tensor], text: torch.Tensor,
                   text_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B,) length-normalised log P(caption | prefix) from ``prefix_cache``: token j
    scored by the logits of position Ni - 1 + j (j = 0 from the cached last prefix
    state). The cache holds one prefix for all B captions or one per row."""
    t = model.cfg.trunk_cfg
    if text_valid is None:
        text_valid = text != model.cfg.text_cfg.pad_id
    text_valid = text_valid.bool()
    b, lt = text.shape
    x = model.embed_text(text, model.compute_dtype)
    cos, sin = _cos_sin(t, text_position_ids(cache["text_start"], lt, b))
    pv = cache["patch_valid"].expand(b, -1)
    bias = build_text_over_prefix_bias(pv, text_valid)
    for i, blk in enumerate(model.trunk.resblocks):
        x = blk(x, bias, cos, sin, kv_cache=(cache["k"][i], cache["v"][i]))
    h = model.project_out(model.trunk.ln_post(x))
    first = model.logits(cache["last_hidden"].to(h.dtype)).expand(b, -1)
    pred = torch.cat([first[:, None], model.logits(h)[:, :-1]], dim=1).float()
    lp = torch.gather(torch.log_softmax(pred, dim=-1), 2, text.long()[..., None])[..., 0]
    lp = torch.where(text_valid, lp, 0.0)
    return lp.sum(1) / text_valid.sum(1).clamp_min(1)


def _next_token(logits: torch.Tensor, step: int, tc: GenLipTextCfg, generator, *,
                min_seq_len: int, generation_type: str, temperature: float, top_k: int,
                top_p: float) -> torch.Tensor:
    """The JAX ``_sample_next`` on (B, V) fp32 logits, the end id blocked before
    ``min_seq_len``: greedy argmax, or a draw after CoCa's top-k / top-p filter."""
    from .coca import _block_eos, filter_logits, sample

    logits = _block_eos(logits, step, min_seq_len, tc.eos_id)
    if generation_type == "greedy":
        return logits.argmax(dim=-1)
    if generation_type not in ("top_k", "top_p"):
        raise ValueError(f"unknown generation_type {generation_type!r}")
    return sample(filter_logits(logits, generation_type, temperature=temperature, top_k=top_k,
                                top_p=top_p), generator)


@torch.no_grad()
def generate_cached(model: GenLipModel, prefix: Dict[str, torch.Tensor],
                    generator: Optional[torch.Generator] = None, *, seq_len: int = 32,
                    min_seq_len: int = 1, generation_type: str = "greedy",
                    temperature: float = 1.0, top_k: int = 1, top_p: float = 0.1,
                    cache: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
    """(B, seq_len) ids: the start id, then one position a step through the trunk
    against the prefix cache and the text decoded so far (the JAX
    ``generate_cached``). A finished row continues with pad. ``cache``: a prebuilt
    prefix cache (GenLAP's audio prefix); ``prefix`` then gives only the batch size."""
    t, tc = model.cfg.trunk_cfg, model.cfg.text_cfg
    cd = model.compute_dtype
    sample_kw = dict(min_seq_len=min_seq_len, generation_type=generation_type,
                     temperature=temperature, top_k=top_k, top_p=top_p)
    b = prefix["patches"].shape[0]
    if cache is None:
        cache = prefix_cache(model, prefix)
    dev = cache["k"].device
    # per layer one (B, Ni + seq_len, H, hd) key and value buffer: the prefix's, then
    # the decoded positions, written as they come
    depth, _, ni, heads, hd = cache["k"].shape
    k_buf = cache["k"].new_zeros((depth, b, ni + seq_len, heads, hd), dtype=cd)
    v_buf = torch.zeros_like(k_buf)
    k_buf[:, :, :ni], v_buf[:, :, :ni] = cache["k"], cache["v"]
    cos_all, sin_all = _cos_sin(t, text_position_ids(cache["text_start"], seq_len, b))
    ids = torch.full((b, seq_len), tc.pad_id, dtype=torch.long, device=dev)
    ids[:, 0] = tc.bos_id
    done = torch.zeros(b, dtype=torch.bool, device=dev)
    # keys: [prefix (Ni) ; text buffer (seq_len; slots < step - 1 written) ; self]
    allowed = torch.cat([cache["patch_valid"].expand(b, -1),
                         torch.zeros(b, seq_len + 1, dtype=torch.bool, device=dev)], dim=1)
    allowed[:, -1] = True
    for step in range(1, seq_len):
        x = model.embed_text(ids[:, step - 1:step], cd)
        cos, sin = cos_all[:, step - 1:step], sin_all[:, step - 1:step]
        if step > 1:
            allowed[:, ni + step - 2] = True
        bias = torch.where(allowed, 0.0, NEG_INF)[:, None, None, :]
        for i, blk in enumerate(model.trunk.resblocks):
            x, (k, v) = blk(x, bias, cos, sin, kv_cache=(k_buf[i], v_buf[i]), return_kv=True)
            k_buf[i, :, ni + step - 1] = k[:, 0]
            v_buf[i, :, ni + step - 1] = v[:, 0]
        h = model.project_out(model.trunk.ln_post(x)[:, 0])
        nxt = _next_token(model.logits(h).float(), step, tc, generator, **sample_kw)
        nxt = torch.where(done, tc.pad_id, nxt)
        ids[:, step] = nxt
        done |= nxt == tc.eos_id
    return ids


@torch.no_grad()
def generate(model: GenLipModel, prefix: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator] = None, *, seq_len: int = 32,
             min_seq_len: int = 1, generation_type: str = "greedy", temperature: float = 1.0,
             top_k: int = 1, top_p: float = 0.1, kv_cache: bool = True) -> torch.Tensor:
    """Caption the prefixes: (B, seq_len) ids, started with the start id, ended with
    the end id, then pad. ``kv_cache`` (default) decodes against ``prefix_cache``;
    without it each step runs the trunk over [prefix ; ids] with the text valid up
    to the step (the JAX ``generate(kv_cache=False)``) and reads the logits of the
    step's position."""
    kw = dict(seq_len=seq_len, min_seq_len=min_seq_len, generation_type=generation_type,
              temperature=temperature, top_k=top_k, top_p=top_p)
    if kv_cache:
        return generate_cached(model, prefix, generator, **kw)
    tc = model.cfg.text_cfg
    b, dev = prefix["patches"].shape[0], prefix["patches"].device
    ids = torch.full((b, seq_len), tc.pad_id, dtype=torch.long, device=dev)
    ids[:, 0] = tc.bos_id
    done = torch.zeros(b, dtype=torch.bool, device=dev)
    cols = torch.arange(seq_len, device=dev)[None, :].expand(b, -1)
    for step in range(1, seq_len):
        h, ni = _joint_hidden(model, prefix, ids, cols < step)
        nxt = _next_token(model.logits(h[:, ni + step - 1]).float(), step, tc, generator,
                          min_seq_len=min_seq_len, generation_type=generation_type,
                          temperature=temperature, top_k=top_k, top_p=top_p)
        nxt = torch.where(done, tc.pad_id, nxt)
        ids[:, step] = nxt
        done |= nxt == tc.eos_id
    return ids


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------

# a reference ``trunk.layers.{i}`` key suffix -> its JAX block path
_REF_TRUNK_KEYS = {
    **{f"layer_norm{i}.{w}": (f"layer_norm{i}", "scale" if w == "weight" else "bias")
       for i in (1, 2) for w in ("weight", "bias")},
    **{f"self_attn.{n}.{w}": ("attn", n, "kernel" if w == "weight" else "bias")
       for n in ("q_proj", "k_proj", "v_proj", "out_proj") for w in ("weight", "bias")},
    **{f"self_attn.{n}.{w}": ("attn", n, "scale" if w == "weight" else "bias")
       for n in ("q_norm", "k_norm") for w in ("weight", "bias")},
    **{f"mlp.{n}.{w}": ("mlp", n, "kernel" if w == "weight" else "bias")
       for n in ("fc1", "gate_fc", "fc2") for w in ("weight", "bias")},
    "layer_scale1.lambda1": ("ls1",), "layer_scale2.lambda1": ("ls2",),
}
_REF_TOP_KEYS = {
    "patch_embed.proj.weight": ("patch_embed", "proj", "kernel"),
    "patch_embed.proj.bias": ("patch_embed", "proj", "bias"),
    **{f"patch_embed.{n}.{w}": ("patch_embed", n, "scale" if w == "weight" else "bias")
       for n in ("norm_input", "norm_pre") for w in ("weight", "bias")},
    "text_embed.weight": ("text_embed",),
    **{f"{n}.{w}": (n, "kernel" if w == "weight" else "bias")
       for n in ("in_proj", "out_proj") for w in ("weight", "bias")},
    **{f"text_norm_pre.{w}": ("text_norm_pre", "scale" if w == "weight" else "bias")
       for w in ("weight", "bias")},
    "lm_head.weight": ("lm_head", "kernel"),
    "trunk.ln_post.weight": ("trunk", "ln_post", "scale"),
    "trunk.ln_post.bias": ("trunk", "ln_post", "bias"),
    "visual.proj.weight": ("visual_proj", "kernel"),
    "visual.proj.bias": ("visual_proj", "bias"),
}


def torch_genlip_to_params(sd) -> Dict[str, Any]:
    """A reference NaFlexGenLip state dict -> the JAX package's GenLIP tree (numpy
    leaves; its ``torch_genlip_to_params``). The visual adapter's keys other than
    ``visual.proj.*`` repeat the shared trunk's and are skipped."""
    import re

    from ..convert import _set, _stack_blocks, normalize_torch_state_dict

    sd = normalize_torch_state_dict(sd)
    tree: Dict[str, Any] = {}
    per_layer: Dict[int, dict] = {}
    layer_re = re.compile(r"^trunk\.layers\.(\d+)\.(.*)$")
    for k, v in sd.items():
        if k.startswith("visual.") and not k.startswith("visual.proj."):
            continue
        m = layer_re.match(k)
        if m:
            path = _REF_TRUNK_KEYS[m.group(2)]  # KeyError: a key the converter leaves over
            _set(per_layer.setdefault(int(m.group(1)), {}), path,
                 v.T if path[-1] == "kernel" else v)
            continue
        if k not in _REF_TOP_KEYS:
            raise KeyError(f"unknown genlip key {k}")
        path = _REF_TOP_KEYS[k]
        _set(tree, path, v.T if path[-1] == "kernel" else v)
    tree.setdefault("trunk", {})["blocks"] = _stack_blocks(per_layer)
    return tree


def params_from_jax(params: Dict[str, Any], cfg) -> Dict[str, torch.Tensor]:
    """A JAX GenLIP (or GenLAP) tree -> ``GenLipModel``'s state dict (float32 CPU
    tensors); a leaf the port has no place for raises."""
    from ..convert import _TRUNK_BLOCK, _linear, _norm, _stacked, _t

    extra = set(params) - {"patch_embed", "text_embed", "in_proj", "out_proj", "text_norm_pre",
                           "lm_head", "trunk", "visual_proj"}
    if extra:
        raise KeyError(f"JAX GenLIP params hold {sorted(extra)}, which the port does not have")
    out: Dict[str, torch.Tensor] = {}
    pe = params["patch_embed"]
    _linear(pe["proj"], "patch_embed.proj", out)
    for name in ("norm_input", "norm_pre"):
        if name in pe:
            _norm(pe[name], f"patch_embed.{name}", out)
    out["text_embed.weight"] = _t(params["text_embed"])
    for name in ("in_proj", "out_proj", "lm_head", "visual_proj"):
        if name in params:
            _linear(params[name], name, out)
    if "text_norm_pre" in params:
        _norm(params["text_norm_pre"], "text_norm_pre", out)
    _stacked(params["trunk"]["blocks"], _TRUNK_BLOCK, cfg.trunk_cfg.depth, "trunk.resblocks.", out)
    _norm(params["trunk"]["ln_post"], "trunk.ln_post", out)
    return out
