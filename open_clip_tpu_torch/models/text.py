"""Classic CLIP text tower (counterpart of ``open_clip_tpu/models/text.py``).

As in the reference CLIP class, the text tower's parts live on the model itself
(``token_embedding``, ``positional_embedding``, ``transformer``, ``ln_final``,
``text_projection``, and CoCa's ``cls_emb``), which gives the reference checkpoint's
key names. The mask is causal or absent (``no_causal_mask``, SigLIP's), so no bias
tensor is built: the causal flag travels to the attention, where the short kernel
applies it. CoCa's tower (``embed_cls``) appends a learned CLS token after the
tokens and masks the pad tokens' keys: that bias takes the dense path, as in the
JAX package; its pooled output is the CLS position after ``ln_final``. Pooling
takes the position of the highest token id (``argmax``), the EOT token in CLIP's
vocabulary, or the first, last or EOS token. The projection is a bare (width,
embed_dim) matrix, an ``nn.Linear`` with a bias (``proj_bias``: SigLIP's
``text_projection.weight`` and ``.bias``), or absent (``proj_type == "none"``).
A config with ``text_arch == "modern"`` gets the modern text tower of
``models/modern_text.py`` instead, as one module, ``model.text``.
"""

from __future__ import annotations

import torch
from torch import nn

from ..config import CLIPTextCfg
from ..ops.layers import linear
from .blocks import LayerNorm, Transformer, check_block_options

NEG_INF = torch.finfo(torch.float32).min


def is_modern(cfg: CLIPTextCfg) -> bool:
    return cfg.text_arch == "modern" and not (cfg.hf_model_name or cfg.hf_model_config)


def check_text_cfg(cfg: CLIPTextCfg) -> None:
    """Raise for the text-tower variants this slice does not port."""
    unported = []
    if cfg.hf_model_name or cfg.hf_model_config:
        unported.append("HF text tower")
    elif is_modern(cfg):
        from .modern_text import check_modern_text_cfg

        return check_modern_text_cfg(cfg)
    if cfg.text_arch != "clip":
        unported.append(f"text_arch {cfg.text_arch!r}")
    if cfg.pool_type not in ("argmax", "first", "last", "eos"):
        unported.append(f"pool_type {cfg.pool_type!r}")
    if cfg.proj_type not in ("linear", "none"):
        unported.append(f"proj_type {cfg.proj_type!r}")
    if unported:
        raise NotImplementedError(f"text tower not ported yet: {', '.join(unported)}")
    check_block_options(cfg)


def add_text_tower(m: nn.Module, cfg: CLIPTextCfg, embed_dim: int, act: str = "gelu") -> None:
    """Register the text tower's parts on ``m`` (the modern tower as ``m.text``)."""
    check_text_cfg(cfg)
    if is_modern(cfg):
        from .modern_text import ModernTextTransformer

        m.text = ModernTextTransformer(cfg, embed_dim)
        return
    width = cfg.width
    m.token_embedding = nn.Embedding(cfg.vocab_size, width)
    m.positional_embedding = nn.Parameter(
        torch.empty(cfg.context_length + int(cfg.embed_cls), width))
    m.cls_emb = nn.Parameter(torch.empty(width)) if cfg.embed_cls else None
    m.transformer = Transformer(width, cfg.layers, cfg.heads, int(width * cfg.mlp_ratio),
                                act=act, ls_init_value=cfg.ls_init_value, norm_eps=cfg.ln_eps)
    m.ln_final = LayerNorm(width, eps=cfg.ln_eps)
    if cfg.proj_type == "none" or not embed_dim:
        m.text_projection = None
    elif cfg.proj_bias:
        m.text_projection = nn.Linear(width, embed_dim)
    else:
        m.text_projection = nn.Parameter(torch.empty(width, embed_dim))


@torch.no_grad()
def init_text_tower(m: nn.Module, cfg: CLIPTextCfg, gen: torch.Generator) -> None:
    """Distributions of the reference ``TextTransformer.init_parameters`` (and of
    the JAX package's ``init_modern_text_tower`` for the modern tower)."""
    if is_modern(cfg):
        return m.text.init_weights(gen)
    m.token_embedding.weight.normal_(0.0, 0.02, generator=gen)
    m.positional_embedding.normal_(0.0, 0.01, generator=gen)
    if m.cls_emb is not None:
        m.cls_emb.normal_(0.0, 0.01, generator=gen)
    m.transformer.init_weights(gen, "text")
    m.ln_final.weight.fill_(1.0)
    m.ln_final.bias.zero_()
    tp = m.text_projection
    if isinstance(tp, nn.Linear):
        tp.weight.normal_(0.0, cfg.width ** -0.5, generator=gen)
        tp.bias.zero_()
    elif tp is not None:
        tp.normal_(0.0, cfg.width ** -0.5, generator=gen)


def text_global_pool(x: torch.Tensor, text: torch.Tensor, pool_type: str = "argmax",
                     eos_token_id=None) -> torch.Tensor:
    rows = torch.arange(x.shape[0], device=x.device)
    if pool_type == "first":
        return x[:, 0]
    if pool_type == "last":
        return x[:, -1]
    if pool_type == "argmax":
        return x[rows, text.argmax(dim=-1)]
    if pool_type == "eos":
        return x[rows, (text == eos_token_id).int().argmax(dim=-1)]
    raise ValueError(f"unknown text pool_type {pool_type!r}")


def cls_key_bias(cfg: CLIPTextCfg, text: torch.Tensor) -> torch.Tensor:
    """(B, 1, 1, L + 1) additive key bias of the CLS-appended tower: -inf-like for the
    pad tokens' keys. The CLS key's validity goes first, as the JAX package (and the
    reference's legacy CoCa mask) has it, so the mask is shifted one place to the
    right of the tokens it stands for."""
    valid = torch.cat([torch.ones_like(text[:, :1], dtype=torch.bool), text != cfg.pad_id], 1)
    return torch.where(valid, 0.0, NEG_INF).float()[:, None, None, :]


def apply_text_tower(m: nn.Module, cfg: CLIPTextCfg, text: torch.Tensor,
                     compute_dtype: torch.dtype = torch.float32, *,
                     remat: bool = False, return_tokens: bool = False):
    """(B, L) int token ids -> pooled, projected (B, embed_dim), or with
    ``return_tokens`` (pooled, tokens), the JAX tower's pair: the tokens after
    ``ln_final``, or for ``embed_cls`` the block stack's output without the CLS."""
    if is_modern(cfg):
        if return_tokens:
            raise NotImplementedError("the modern text tower returns no tokens here")
        return m.text(text, compute_dtype, remat=remat)
    b, seq_len = text.shape
    x = m.token_embedding.weight[text].to(compute_dtype)
    bias = None
    if cfg.embed_cls:
        x = torch.cat([x, m.cls_emb.to(compute_dtype).expand(b, 1, -1)], dim=1)
        bias = cls_key_bias(cfg, text)
        seq_len += 1
    x = x + m.positional_embedding[:seq_len].to(compute_dtype)
    x = m.transformer(x, causal=not cfg.no_causal_mask, remat=remat, bias=bias)
    if cfg.embed_cls:  # the CLS overrides pool_type: the last token, then ln_final
        pooled, tokens = m.ln_final(x[:, -1]), x[:, :-1]
    else:
        tokens = x = m.ln_final(x)
        pooled = text_global_pool(x, text, cfg.pool_type, cfg.eos_id)
    tp = m.text_projection
    if isinstance(tp, nn.Linear):
        pooled = linear(pooled, tp.weight, tp.bias, transposed=True)
    elif tp is not None:
        pooled = linear(pooled, tp)
    return (pooled, tokens) if return_tokens else pooled
