"""CoCa, the contrastive captioner (counterpart of ``open_clip_tpu/models/coca.py``).

The vision tower pools with an attentional pooler and returns its tokens
(``models/vit.py``); the text tower appends a CLS token (``models/text.py``,
``embed_cls``); the multimodal decoder (``text_decoder``) interleaves causal
self-attention blocks (the short kernel on the card, L = the context length) with
cross-attention blocks over the image tokens (dense: Lq != Lk). Names follow the
reference checkpoint: ``text_decoder.resblocks.{i}``, ``text_decoder.cross_attn.{i}``
(with ``ln_1_kv``), ``text_decoder.ln_final``, ``text_decoder.text_projection``.

Captioning: ``generate`` (greedy, top-k or top-p sampling, with a KV cache or by
re-encoding the prefix each step) and ``generate_beam`` follow the JAX package's
``generate``/``generate_cached``/``generate_beam`` step for step: a (B, seq_len)
buffer starts with the start token and ends with the end token, then pad. The
cached decode takes one position a step through the text tower and the decoder
against per-layer K/V caches, with the cross-attention K/V of every decoder layer
computed once per image; its one-query attention is plain PyTorch, as it is plain
XLA in the JAX package. Sampling draws from a ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from ..config import MultimodalCfg
from ..ops.layers import linear
from .blocks import LayerNorm, ResidualAttentionBlock
from . import text as text_mod

NEG = torch.finfo(torch.float32).min


class CrossAttentionBlock(ResidualAttentionBlock):
    """A decoder cross-attention block: q from ``ln_1(x)``, k and v from
    ``ln_1_kv(image_embs)`` through the same fused in-projection; its MLP is the
    plain one in every case, as in the JAX package."""

    def __init__(self, width: int, heads: int, mlp_width: int, **kw):
        super().__init__(width, heads, mlp_width, **kw)
        self.ln_1_kv = LayerNorm(width, eps=self.ln_1.eps)

    def forward(self, x: torch.Tensor, image_embs: torch.Tensor) -> torch.Tensor:
        return _mlp_tail(self, x, self.attn(self.ln_1(x), kv=self.ln_1_kv(image_embs)))

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator, scheme: str, depth: int) -> None:
        super().init_weights(gen, scheme, depth)
        self.ln_1_kv.weight.fill_(1.0)
        self.ln_1_kv.bias.zero_()


class MultimodalDecoder(nn.Module):
    """The JAX ``init_multimodal_decoder``/``apply_multimodal_decoder``: (B, M, W)
    image tokens and (B, L, W) text tokens -> (B, L, vocab) logits."""

    def __init__(self, cfg: MultimodalCfg, vocab_size: int, act: str = "gelu"):
        super().__init__()
        self.cfg = cfg
        width, mlp = cfg.width, int(cfg.width * cfg.mlp_ratio)
        kw = dict(act=act, ls_init_value=cfg.ls_init_value, norm_eps=cfg.ln_eps)
        self.resblocks = nn.ModuleList(ResidualAttentionBlock(width, cfg.heads, mlp, **kw)
                                       for _ in range(cfg.layers))
        self.cross_attn = nn.ModuleList(CrossAttentionBlock(width, cfg.heads, mlp, **kw)
                                        for _ in range(cfg.layers))
        self.ln_final = LayerNorm(width, eps=cfg.ln_eps)
        self.text_projection = nn.Parameter(torch.empty(width, vocab_size))

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator) -> None:
        for blocks in (self.resblocks, self.cross_attn):
            for block in blocks:
                block.init_weights(gen, "text", depth=self.cfg.layers)
        self.ln_final.weight.fill_(1.0)
        self.ln_final.bias.zero_()
        self.text_projection.normal_(0.0, self.cfg.width ** -0.5, generator=gen)

    def _pair(self, i: int, x: torch.Tensor, image_embs: torch.Tensor) -> torch.Tensor:
        return self.cross_attn[i](self.resblocks[i](x, causal=True), image_embs)

    def forward(self, image_embs: torch.Tensor, text_embs: torch.Tensor, *,
                remat: bool = False, return_hidden: bool = False) -> torch.Tensor:
        """``return_hidden``: the states after ``ln_final``, before the vocabulary
        projection (the train step's fused cross-entropy takes them). ``remat``
        recomputes each (block, cross block) pair whole in the backward pass, the JAX
        ``jax.checkpoint`` of the pair without a policy."""
        x = text_embs
        for i in range(len(self.resblocks)):
            if remat and torch.is_grad_enabled():
                x = torch.utils.checkpoint.checkpoint(self._pair, i, x, image_embs,
                                                      use_reentrant=False)
            else:
                x = self._pair(i, x, image_embs)
        x = self.ln_final(x)
        return x if return_hidden else linear(x, self.text_projection)


def coca_forward(model, image=None, text=None, *, train: bool = False, remat: bool = False,
                 generator: Optional[torch.Generator] = None, return_hidden: bool = False,
                 decode: bool = True) -> Dict[str, torch.Tensor]:
    """The JAX ``coca_forward``: normalised ``image_features`` and ``text_features``,
    and, with both inputs, the decoder's ``logits`` (or ``hidden`` under
    ``return_hidden``) over the text positions with ``labels`` = the text (the
    shift is the loss's). ``decode=False`` leaves the decoder out (features only)."""
    from .clip import _as_tensor, _l2_normalize

    cfg = model.cfg
    cd = model.compute_dtype
    out: Dict[str, torch.Tensor] = {}
    image_embs = None
    if image is not None:
        pooled, image_embs = model.visual(_as_tensor(image, model.device), cd, train=train,
                                          remat=remat, generator=generator, return_tokens=True)
        out["image_features"] = _l2_normalize(pooled)
    if text is not None:
        ids = _as_tensor(text, model.device).long()
        t_pooled, token_embs = text_mod.apply_text_tower(model, cfg.text_cfg, ids, cd,
                                                         remat=remat, return_tokens=True)
        out["text_features"] = _l2_normalize(t_pooled)
        if image_embs is not None and decode:
            out["hidden" if return_hidden else "logits"] = model.text_decoder(
                image_embs, token_embs, remat=remat, return_hidden=return_hidden)
            out["labels"] = ids
    out["logit_scale"] = model.logit_scale.float().exp()
    if model.logit_bias is not None:
        out["logit_bias"] = model.logit_bias.float()
    return out


# ---------------------------------------------------------------------------
# generation
# ---------------------------------------------------------------------------

def _image_tokens(model, image) -> torch.Tensor:
    from .clip import _as_tensor

    _, tokens = model.visual(_as_tensor(image, model.device), model.compute_dtype,
                             return_tokens=True)
    return tokens


def _qkv_single(attn, h: torch.Tensor):
    """q, k, v (N, 1, H, hd) of one position from a fused-qkv ``Attention``."""
    n, _, d = h.shape
    qkv = linear(h, attn.in_proj_weight, attn.in_proj_bias, transposed=True)
    return qkv.view(n, 1, 3, attn.heads, d // attn.heads).unbind(2)


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """One query over (N, Lk, H, hd) float32 keys and values, in float32: (N, 1, H*hd)
    in q's dtype."""
    n, _, heads, hd = q.shape
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k) / math.sqrt(hd)
    out = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(scores, dim=-1), v)
    return out.reshape(n, 1, heads * hd).to(q.dtype)


def _mlp_tail(block, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """x + h (layer-scaled), then the block's MLP residual, plain linears."""
    if block.ls_init_value is not None:
        h = block.ls_1(h)
    x = x + h
    m = block.mlp
    h = m.act(linear(block.ln_2(x), m.c_fc.weight, m.c_fc.bias, transposed=True))
    h = linear(h, m.c_proj.weight, m.c_proj.bias, transposed=True)
    if block.ls_init_value is not None:
        h = block.ls_2(h)
    return x + h


def _cached_self_block(block, x: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                       t: int) -> torch.Tensor:
    """One block on decode position t - 1 (x: (N, 1, W)); writes that position's K/V
    into the (N, seq_len, H, hd) caches and attends over positions < t."""
    a = block.attn
    q, k, v = _qkv_single(a, block.ln_1(x))
    k_cache[:, t - 1] = k[:, 0]
    v_cache[:, t - 1] = v[:, 0]
    out = _attend(q, k_cache[:, :t], v_cache[:, :t])
    out = linear(out, a.out_proj.weight, a.out_proj.bias, transposed=True)
    return _mlp_tail(block, x, out)


def _cross_block_cached(block: CrossAttentionBlock, x: torch.Tensor, k_img: torch.Tensor,
                        v_img: torch.Tensor) -> torch.Tensor:
    """A cross block on one position against precomputed image K/V (N, M, H, hd)."""
    a = block.attn
    n, _, d = x.shape
    bq = None if a.in_proj_bias is None else a.in_proj_bias[:d]
    q = linear(block.ln_1(x), a.in_proj_weight[:d], bq, transposed=True)
    out = _attend(q.view(n, 1, a.heads, d // a.heads), k_img, v_img).to(x.dtype)
    out = linear(out, a.out_proj.weight, a.out_proj.bias, transposed=True)
    return _mlp_tail(block, x, out)


def _cross_kv_all_layers(model, image_embs: torch.Tensor) -> List[Tuple[torch.Tensor, ...]]:
    """Each decoder layer's cross-attention (k, v), (N, M, H, hd), from
    ``ln_1_kv(image_embs)``: computed once per image."""
    n, m, _ = image_embs.shape
    out = []
    for block in model.text_decoder.cross_attn:
        a = block.attn
        d = a.out_proj.in_features
        kv = block.ln_1_kv(image_embs)
        w, b = a.in_proj_weight, a.in_proj_bias
        k = linear(kv, w[d:2 * d], None if b is None else b[d:2 * d], transposed=True)
        v = linear(kv, w[2 * d:], None if b is None else b[2 * d:], transposed=True)
        out.append((k.view(n, m, a.heads, d // a.heads), v.view(n, m, a.heads, d // a.heads)))
    return out


class DecodeCache:
    """The per-layer K/V caches of the text tower and the decoder, (N, seq_len, H, hd)
    each, and the cross-attention K/V of every decoder layer. They hold float32: the
    values are the compute dtype's (each K/V is computed in it and rounds to it, as the
    JAX package's caches hold them), widened once here instead of at every step's
    float32 attention."""

    def __init__(self, model, image_embs: torch.Tensor, seq_len: int):
        n, dev = image_embs.shape[0], image_embs.device

        def caches(blocks):
            shape = lambda blk: (n, seq_len, blk.attn.heads,
                                 blk.attn.out_proj.in_features // blk.attn.heads)
            return [(torch.zeros(shape(b), device=dev), torch.zeros(shape(b), device=dev))
                    for b in blocks]

        self.text = caches(model.transformer.resblocks)
        self.dec = caches(model.text_decoder.resblocks)
        self.img = [(k.float(), v.float()) for k, v in _cross_kv_all_layers(model, image_embs)]

    def reorder_(self, rows: torch.Tensor) -> None:
        """Keep the rows ``rows`` (a beam reorder), in place."""
        for k, v in self.text + self.dec:
            k.copy_(k[rows])
            v.copy_(v[rows])


def _cached_decode_logits(model, tok: torch.Tensor, t: int, cache: DecodeCache) -> torch.Tensor:
    """Token ids ``tok`` (N,) at position t - 1 through the text tower and the decoder
    against the caches: (N, vocab) fp32 logits."""
    cd = model.compute_dtype
    x = model.token_embedding.weight[tok].to(cd)[:, None]
    x = x + model.positional_embedding[t - 1].to(cd)
    for block, (kc, vc) in zip(model.transformer.resblocks, cache.text):
        x = _cached_self_block(block, x, kc, vc, t)
    # the decoder reads the text tower's block output before ln_final (the tokens)
    dec = model.text_decoder
    for block, cross, (kc, vc), (ki, vi) in zip(dec.resblocks, dec.cross_attn, cache.dec,
                                                cache.img):
        x = _cached_self_block(block, x, kc, vc, t)
        x = _cross_block_cached(cross, x, ki, vi)
    h = dec.ln_final(x)
    return linear(h[:, 0], dec.text_projection).float()


def _uncached_decode_logits(model, ids: torch.Tensor, t: int,
                            image_embs: torch.Tensor) -> torch.Tensor:
    """The whole (N, seq_len) buffer re-encoded; the logits of position t - 1."""
    _, tokens = text_mod.apply_text_tower(model, model.cfg.text_cfg, ids, model.compute_dtype,
                                          return_tokens=True)
    logits = model.text_decoder(image_embs, tokens)
    return logits[:, t - 1].float()


def penalize_repetition(logits: torch.Tensor, ids: torch.Tensor, t: int,
                        penalty: float) -> torch.Tensor:
    """Divide (positive) or multiply (negative) the logits of the tokens already in
    ``ids[:, :t]`` by ``penalty``."""
    if penalty == 1.0:
        return logits
    seen = torch.zeros_like(logits, dtype=torch.bool).scatter_(1, ids[:, :t], True)
    penal = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(seen, penal, logits)


def filter_logits(logits: torch.Tensor, generation_type: str, *, temperature: float = 1.0,
                  top_k: int = 1, top_p: float = 0.1) -> torch.Tensor:
    """The sampling types' logits: divided by the temperature, then all but the top
    ``top_k`` (``top_k``) or the smallest set whose probability reaches ``top_p``
    (``top_p``) set to the float32 minimum, as the JAX package does."""
    logits = logits / max(temperature, 1e-6)
    if generation_type == "top_k":
        kth = torch.topk(logits, max(top_k, 1), dim=-1).values[:, -1:]
        logits = torch.where(logits < kth, NEG, logits)
    elif generation_type == "top_p":
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        cutoff_idx = (cum < top_p).sum(dim=-1, keepdim=True)
        cutoff = torch.gather(sorted_logits, 1, cutoff_idx.clamp_max(logits.shape[-1] - 1))
        logits = torch.where(logits < cutoff, NEG, logits)
    else:
        raise ValueError(f"unknown generation_type {generation_type!r}")
    return logits


def sample(logits: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
    """One token id a row, drawn from softmax(logits) with ``generator``."""
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def _block_eos(logits: torch.Tensor, t: int, min_seq_len: int, eos_token_id: int):
    if t < min_seq_len:
        logits = logits.clone()
        logits[..., eos_token_id] = NEG
    return logits


@torch.no_grad()
def generate(model, image, generator: Optional[torch.Generator] = None, *, seq_len: int = 30,
             min_seq_len: int = 5, generation_type: str = "greedy", temperature: float = 1.0,
             top_k: int = 1, top_p: float = 0.1, repetition_penalty: float = 1.0,
             sot_token_id: int = 49406, eos_token_id: int = 49407, pad_token_id: int = 0,
             kv_cache: bool = True) -> torch.Tensor:
    """Caption (B, H, W, 3) images: (B, seq_len) token ids, end-token-terminated then
    padded. ``generation_type``: "greedy", "top_k" or "top_p" (sampled from
    ``generator``). ``kv_cache`` decodes one position a step against cached K/V (the
    JAX ``generate_cached``); without it the buffer is re-encoded each step."""
    image_embs = _image_tokens(model, image)
    b, dev = image_embs.shape[0], image_embs.device
    ids = torch.full((b, seq_len), pad_token_id, dtype=torch.long, device=dev)
    ids[:, 0] = sot_token_id
    done = torch.zeros(b, dtype=torch.bool, device=dev)
    cache = DecodeCache(model, image_embs, seq_len) if kv_cache else None
    for t in range(1, seq_len):
        if kv_cache:
            logits = _cached_decode_logits(model, ids[:, t - 1], t, cache)
        else:
            logits = _uncached_decode_logits(model, ids, t, image_embs)
        logits = penalize_repetition(logits, ids, t, repetition_penalty)
        logits = _block_eos(logits, t, min_seq_len, eos_token_id)
        if generation_type == "greedy":
            nxt = logits.argmax(dim=-1)
        else:
            nxt = sample(filter_logits(logits, generation_type, temperature=temperature,
                                       top_k=top_k, top_p=top_p), generator)
        nxt = torch.where(done, pad_token_id, nxt)
        ids[:, t] = nxt
        done |= nxt == eos_token_id
    return ids


@torch.no_grad()
def generate_beam(model, image, *, seq_len: int = 30, min_seq_len: int = 5, num_beams: int = 6,
                  sot_token_id: int = 49406, eos_token_id: int = 49407, pad_token_id: int = 0,
                  length_penalty: float = 1.0, kv_cache: bool = True) -> torch.Tensor:
    """Beam search (the JAX ``generate_beam``): the beams ride a (B * num_beams) batch;
    each step scores every continuation of every beam by its cumulative log-prob and
    keeps the top ``num_beams`` per image. A beam that emitted the end token only
    continues with pad, its score unchanged. With ``kv_cache`` the caches follow the
    beams' reorder each step. Returns the best beam per image (scores divided by
    length ** ``length_penalty``), (B, seq_len)."""
    image_embs = _image_tokens(model, image)
    b, dev = image_embs.shape[0], image_embs.device
    k = num_beams
    image_embs_k = image_embs.repeat_interleave(k, dim=0)
    vocab = model.token_embedding.weight.shape[0]
    ids = torch.full((b, k, seq_len), pad_token_id, dtype=torch.long, device=dev)
    ids[:, :, 0] = sot_token_id
    scores = torch.full((b, k), NEG, device=dev)
    scores[:, 0] = 0.0  # only beam 0 is live at the start
    done = torch.zeros(b, k, dtype=torch.bool, device=dev)
    cache = DecodeCache(model, image_embs_k, seq_len) if kv_cache else None
    pad_col = torch.full((vocab,), NEG, device=dev)
    pad_col[pad_token_id] = 0.0
    for t in range(1, seq_len):
        if kv_cache:
            logits = _cached_decode_logits(model, ids[:, :, t - 1].reshape(b * k), t, cache)
        else:
            logits = _uncached_decode_logits(model, ids.reshape(b * k, seq_len), t, image_embs_k)
        logp = torch.log_softmax(logits, dim=-1).view(b, k, vocab)
        logp = _block_eos(logp, t, min_seq_len, eos_token_id)
        cont = torch.where(done[..., None], pad_col, logp)
        total = scores[..., None] + cont
        scores, top_idx = torch.topk(total.view(b, k * vocab), k, dim=-1)
        beam_idx = torch.div(top_idx, vocab, rounding_mode="floor")
        tok = top_idx % vocab
        ids = torch.gather(ids, 1, beam_idx[..., None].expand(-1, -1, seq_len))
        done = torch.gather(done, 1, beam_idx)
        tok = torch.where(done, pad_token_id, tok)
        ids[:, :, t] = tok
        done = done | (tok == eos_token_id)
        if kv_cache:
            cache.reorder_((torch.arange(b, device=dev)[:, None] * k + beam_idx).reshape(-1))
    if length_penalty != 1.0:
        lengths = (ids != pad_token_id).sum(dim=-1).float()
        scores = scores / lengths ** length_penalty
    best = scores.argmax(dim=1)
    return ids[torch.arange(b, device=dev), best]


# ---------------------------------------------------------------------------
# converter
# ---------------------------------------------------------------------------

def decoder_params_from_jax(dec: Dict, layers: int, out: Dict[str, torch.Tensor]) -> None:
    """The JAX ``text_decoder`` tree (stacked ``blocks`` and ``cross_blocks``) onto
    ``text_decoder.*``."""
    from ..convert import _BLOCK_KEYS, _norm, _stacked, _t

    _stacked(dec.get("blocks", {}), _BLOCK_KEYS, layers, "text_decoder.resblocks.", out)
    cross_keys = {**_BLOCK_KEYS, ("ln_1_kv", "scale"): "ln_1_kv.weight",
                  ("ln_1_kv", "bias"): "ln_1_kv.bias"}
    _stacked(dec.get("cross_blocks", {}), cross_keys, layers, "text_decoder.cross_attn.", out)
    _norm(dec.get("ln_final", {}), "text_decoder.ln_final", out)
    if "text_projection" in dec:
        out["text_decoder.text_projection"] = _t(dec["text_projection"])


def convert_multimodal_decoder(sd: Dict) -> Dict:
    """Reference ``text_decoder.*`` keys (without the prefix) -> the JAX decoder tree
    (numpy leaves): the JAX package's ``convert_multimodal_decoder``."""
    import re

    from ..convert import _convert_block_key, _set, _stack_blocks

    self_blocks: Dict[int, dict] = {}
    cross_blocks: Dict[int, dict] = {}
    tree: Dict = {}
    block_re = re.compile(r"^(resblocks|cross_attn)\.(\d+)\.(.*)$")
    for k, v in sd.items():
        m = block_re.match(k)
        if m:
            path, val = _convert_block_key(m.group(3), v)
            target = self_blocks if m.group(1) == "resblocks" else cross_blocks
            _set(target.setdefault(int(m.group(2)), {}), path, val)
        elif k in ("ln_final.weight", "ln_final.bias"):
            tree.setdefault("ln_final", {})["scale" if k.endswith("weight") else "bias"] = v
        elif k == "text_projection":
            tree["text_projection"] = v
        else:
            raise KeyError(f"unknown text_decoder key {k}")
    tree["blocks"] = _stack_blocks(self_blocks)
    tree["cross_blocks"] = _stack_blocks(cross_blocks)
    return tree
