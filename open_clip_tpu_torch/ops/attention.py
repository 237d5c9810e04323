"""Multi-head attention (counterpart of ``open_clip_tpu/ops/attention.py``).

Layout: activations are (B, L, D); heads are split as (B, L, H, hd), the JAX
package's layout, so the q/k/v of one fused projection stay views of it.

Dispatch (the JAX rule at ``attention.py:49-62``), for self-attention on CUDA:
with a key-padding mask, no bias, L >= 512 and a head width the flash kernels
take, the flash kernels (they mask in-kernel); without a mask, the short kernel
where ``short_attention.supports`` accepts the shape; else, without a mask or
bias and with L >= 512, the flash kernels again (a plain ViT at L = 577 lands
here). Everything else, cross-attention and everything on the CPU take the dense
path, which folds the mask into an additive bias.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import flash_attention as fa
from . import short_attention as sa
from .layers import linear, remat_name

_FLASH_MIN_SEQ = 512
_NEG = torch.finfo(torch.float32).min


def select_impl(on_cuda: bool, lq: int, lk: int, h: int, hd: int, bias, key_valid) -> str:
    """Which path attention takes: "flash", "short" or "dense"."""
    if not on_cuda or lq != lk:
        return "dense"
    flash_ok = lq >= _FLASH_MIN_SEQ and fa.supports(lq, h, hd, bias)
    if key_valid is not None and flash_ok:
        return "flash"  # key padding handled in-kernel
    if key_valid is None and sa.supports(lq, h, hd, bias):
        return "short"
    if key_valid is None and flash_ok:
        return "flash"
    return "dense"


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: Optional[torch.Tensor] = None, *, causal: bool = False,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Plain attention: fp32 logits and softmax, probabilities cast to v.dtype
    before the product with v. (B, Lq, H, hd) x (B, Lk, H, hd) -> (B, Lq, H, hd)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        lq, lk = q.shape[1], k.shape[1]
        mask = torch.ones(lq, lk, dtype=torch.bool, device=q.device).tril(lk - lq)
        logits = logits.masked_fill(~mask, _NEG)
    if bias is not None:
        logits = logits + bias.float()
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          bias: Optional[torch.Tensor] = None, causal: bool = False,
                          scale: Optional[float] = None,
                          key_valid: Optional[torch.Tensor] = None,
                          name: Optional[str] = None) -> torch.Tensor:
    """Scaled dot-product attention with an fp32 softmax, dispatched by
    ``select_impl``. ``key_valid``: optional (B, Lk) key-padding mask. ``name``
    tags the output for remat: the kernel's launch, or on the dense path the copy
    that makes the output contiguous (the logits are recomputed, as in JAX)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    impl = select_impl(q.is_cuda, q.shape[1], k.shape[1], q.shape[2], q.shape[3], bias, key_valid)
    if impl in ("short", "flash"):
        with remat_name(name):
            if impl == "short":
                return sa.short_attention(q, k, v, causal=causal, scale=scale)
            return fa.flash_attention(q, k, v, causal=causal, scale=scale, key_valid=key_valid)
    if key_valid is not None:
        kv_bias = torch.where(key_valid.bool(), 0.0, _NEG * 0.5).float()[:, None, None, :]
        bias = kv_bias if bias is None else bias + kv_bias
    out = dense_attention(q, k, v, bias, causal=causal, scale=scale)
    with remat_name(name):
        return out.contiguous()


def multi_head_attention(x: torch.Tensor, in_proj_weight: torch.Tensor,
                         in_proj_bias: Optional[torch.Tensor], out_weight: torch.Tensor,
                         out_bias: Optional[torch.Tensor], *, num_heads: int,
                         causal: bool = False,
                         key_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fused-qkv self-attention with torch-layout (out, in) weights: (B, L, D) -> (B, L, D).
    ``key_valid``: optional (B, L) key-padding mask. The fused projection and the
    attention output carry the JAX package's remat tags ``remat_qkv`` and
    ``remat_attn_ctx``."""
    b, l, d = x.shape
    hd = d // num_heads
    qkv = linear(x, in_proj_weight, in_proj_bias, transposed=True, name="remat_qkv")
    q, k, v = qkv.view(b, l, 3, num_heads, hd).unbind(2)  # views: no copies
    out = dot_product_attention(q, k, v, causal=causal, key_valid=key_valid,
                                name="remat_attn_ctx").reshape(b, l, d)
    return linear(out, out_weight, out_bias, transposed=True)
