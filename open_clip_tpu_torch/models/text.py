"""Classic CLIP text tower (counterpart of ``open_clip_tpu/models/text.py``).

As in the reference CLIP class, the text tower's parts live on the model itself
(``token_embedding``, ``positional_embedding``, ``transformer``, ``ln_final``,
``text_projection``), which gives the reference checkpoint's key names. The mask
is causal or absent (``no_causal_mask``, SigLIP's), so no bias tensor is built: the
causal flag travels to the attention, where the short kernel applies it. Pooling
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
    if cfg.embed_cls:
        unported.append("appended CLS token")
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
    m.positional_embedding = nn.Parameter(torch.empty(cfg.context_length, width))
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


def apply_text_tower(m: nn.Module, cfg: CLIPTextCfg, text: torch.Tensor,
                     compute_dtype: torch.dtype = torch.float32, *,
                     remat: bool = False) -> torch.Tensor:
    """(B, L) int token ids -> pooled, projected (B, embed_dim)."""
    if is_modern(cfg):
        return m.text(text, compute_dtype, remat=remat)
    seq_len = text.shape[1]
    x = m.token_embedding.weight[text].to(compute_dtype)
    x = x + m.positional_embedding[:seq_len].to(compute_dtype)
    x = m.transformer(x, causal=not cfg.no_causal_mask, remat=remat)
    x = m.ln_final(x)
    pooled = text_global_pool(x, text, cfg.pool_type, cfg.eos_id)
    tp = m.text_projection
    if isinstance(tp, nn.Linear):
        return linear(pooled, tp.weight, tp.bias, transposed=True)
    return pooled if tp is None else linear(pooled, tp)
