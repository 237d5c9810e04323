"""HTSAT, the hierarchical token-semantic audio transformer (a Swin tower), and the
Swin block the Swin image tower shares (counterpart of ``open_clip_tpu/models/htsat.py``).

On-card log-mel (``ops/audio.py``) -> ``bn0`` over mel bins with its stored
statistics -> the mel image folded to a square (``reshape_wav2img``, a bicubic
resize along time) -> 4x4 patch embedding -> four Swin stages (window attention
under a relative-position bias, shifted windows on odd blocks, patch merging) ->
LayerNorm -> the mean over tokens (the embedding); the token-semantic convolution
head gives the clip and frame outputs. Names follow the reference checkpoint
(``layers.{i}.blocks.{j}.attn.qkv``, ``bn0``, ``tscam_conv``, ...).

Window attention dispatches as the JAX package's ``_swin_block_apply`` does: on the
card the panel kernel (``ops/swin_attention.py``) where its gate holds, else the
window kernel (``ops/window_attention.py``), else the plain dense form; on the CPU
always the dense form, which is also the JAX package's CPU path. ``bn0`` uses its
stored statistics in training too, as the JAX package does (its four entries are
parameters there, and here). Audio fusion inputs (``mel_fusion``) and
``spec_augment`` are not ported: the first raises, the second no caller reaches.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import swin_attention as swa
from ..ops import window_attention as wa
from ..ops.audio import log_mel_clap, true_fp32
from ..ops.layers import gelu, linear
from .blocks import LayerNorm
from .vit import PatchEmbed, patchify


# ---------------------------------------------------------------------------
# static tables
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=8)
def relative_position_index(ws: int) -> np.ndarray:
    """(ws*ws, ws*ws) indices into the (2ws-1)^2 bias table."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1)


@functools.lru_cache(maxsize=32)
def shifted_window_mask(h: int, w: int, ws: int, shift: int) -> Optional[np.ndarray]:
    """(nW, ws*ws, ws*ws) additive mask (0 / -100) of the shifted windows, or None."""
    if shift == 0:
        return None
    img = np.zeros((h, w))
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[hs, wsl] = cnt
            cnt += 1
    wins = img.reshape(h // ws, ws, w // ws, ws).transpose(0, 2, 1, 3).reshape(-1, ws * ws)
    diff = wins[:, None, :] - wins[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


_TABLES: Dict[tuple, torch.Tensor] = {}


def _table(key, make, device) -> torch.Tensor:
    """A numpy table as a tensor on ``device``, made once per key and device (as a
    normal tensor even under ``inference_mode``, so that training can use it later)."""
    t = _TABLES.get((key, device))
    if t is None:
        with torch.inference_mode(False):
            t = _TABLES[(key, device)] = torch.from_numpy(np.ascontiguousarray(make())).to(device)
    return t


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) -> (B*nW, ws*ws, C)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, c)


def window_reverse(x: torch.Tensor, ws: int, h: int, w: int) -> torch.Tensor:
    """(B*nW, ws*ws, C) -> (B, H, W, C)."""
    b = x.shape[0] // ((h // ws) * (w // ws))
    x = x.reshape(b, h // ws, w // ws, ws, ws, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, -1)


def _trunc_normal_(t: torch.Tensor, gen: torch.Generator, std: float = 0.02) -> None:
    """The JAX package's ``_trunc_normal``: N(0, std) clipped to +-2 std."""
    t.normal_(0.0, std, generator=gen).clamp_(-2 * std, 2 * std)


def _uniform_(t: torch.Tensor, gen: torch.Generator, bound: float) -> None:
    t.uniform_(-bound, bound, generator=gen)


# ---------------------------------------------------------------------------
# the Swin block
# ---------------------------------------------------------------------------

def attention_path(device: torch.device, h: int, w: int, ws: int, heads: int, c: int) -> str:
    """Which window attention a block takes: 'panel', 'window' or 'dense'."""
    if device.type != "cuda":
        return "dense"
    if swa.supports(h, w, ws, heads, c):
        return "panel"
    if wa.supports(ws * ws, heads, c):
        return "window"
    return "dense"


class WindowAttention(nn.Module):
    def __init__(self, dim: int, heads: int, ws: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(torch.empty((2 * ws - 1) ** 2, heads))

    def bias(self, h: int, w: int, ws: int, shift: int) -> torch.Tensor:
        """(nW or 1, H, N, N) fp32: the relative-position bias plus the shift mask."""
        n = ws * ws
        dev = self.relative_position_bias_table.device
        idx = _table(("relidx", ws), lambda: relative_position_index(ws).reshape(-1), dev)
        rel = self.relative_position_bias_table[idx].reshape(n, n, self.heads).permute(2, 0, 1)
        bias = rel[None].float()
        if shift:
            mask = _table(("mask", h, w, ws, shift), lambda: shifted_window_mask(h, w, ws, shift),
                          dev)
            bias = bias + mask[:, None]
        return bias

    def qkv_views(self, x: torch.Tensor):
        """q, k, v as the three column blocks of one fused projection (row stride 3C)."""
        qkv = linear(x, self.qkv.weight, self.qkv.bias, transposed=True)
        return qkv.unflatten(-1, (3, x.shape[-1])).unbind(-2)

    def out(self, x: torch.Tensor) -> torch.Tensor:
        return linear(x, self.proj.weight, self.proj.bias, transposed=True)


def dense_window_attention(q, k, v, bias: torch.Tensor, heads: int, scale: float) -> torch.Tensor:
    """The plain form of ``_swin_block_apply``: fp32 logits and softmax, probabilities
    in v's dtype for the product with v. (B*nW, N, C) q/k/v, (nW, H, N, N) bias."""
    bn, n, c = q.shape
    hd = c // heads
    split = lambda x: x.reshape(bn, n, heads, hd)  # noqa: E731
    logits = torch.einsum("bqhd,bkhd->bhqk", split(q).float(), split(k).float()) * scale
    nw = bias.shape[0]
    logits = (logits.reshape(-1, nw, heads, n, n) + bias).reshape(bn, heads, n, n)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, split(v)).reshape(bn, n, c)


class SwinMlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = gelu(linear(x, self.fc1.weight, self.fc1.bias, transposed=True))
        return linear(h, self.fc2.weight, self.fc2.bias, transposed=True)


class SwinBlock(nn.Module):
    """``_swin_block_apply``: x + attn(norm1(x)) over (shifted) windows, then the MLP."""

    def __init__(self, dim: int, heads: int, ws: int, mlp_ratio: float = 4.0):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn = WindowAttention(dim, heads, ws)
        self.norm2 = LayerNorm(dim)
        self.mlp = SwinMlp(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor, resolution: Tuple[int, int], ws: int,
                shift: int) -> torch.Tensor:
        h, w = resolution
        b, l, c = x.shape
        heads = self.attn.heads
        scale = (c // heads) ** -0.5
        shortcut = x
        x = self.norm1(x)
        bias = self.attn.bias(h, w, ws, shift)
        path = attention_path(x.device, h, w, ws, heads, c)
        if path == "panel":
            # the kernel gathers the windows from the token map; only the roll is a copy
            if shift:
                x = torch.roll(x.reshape(b, h, w, c), (-shift, -shift), (1, 2)).reshape(b, l, c)
            q, k, v = self.attn.qkv_views(x)
            out = self.attn.out(swa.panel_attention(q, k, v, bias, hw=(h, w), ws=ws, scale=scale))
            if shift:
                out = torch.roll(out.reshape(b, h, w, c), (shift, shift), (1, 2)).reshape(b, l, c)
        else:
            x = x.reshape(b, h, w, c)
            if shift:
                x = torch.roll(x, (-shift, -shift), (1, 2))
            q, k, v = self.attn.qkv_views(window_partition(x, ws))
            if path == "window":
                out = wa.window_attention(q, k, v, bias, scale=scale)
            else:
                out = dense_window_attention(q, k, v, bias, heads, scale)
            out = window_reverse(self.attn.out(out), ws, h, w)
            if shift:
                out = torch.roll(out, (shift, shift), (1, 2))
            out = out.reshape(b, l, c)
        x = shortcut + out
        return x + self.mlp(self.norm2(x))

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator) -> None:
        for norm in (self.norm1, self.norm2):
            norm.weight.fill_(1.0)
            norm.bias.zero_()
        for lin in (self.attn.qkv, self.attn.proj):
            _trunc_normal_(lin.weight, gen)
            lin.bias.zero_()
        _trunc_normal_(self.attn.relative_position_bias_table, gen)
        for lin in (self.mlp.fc1, self.mlp.fc2):
            _trunc_normal_(lin.weight, gen)
            lin.bias.zero_()


class PatchMerging(nn.Module):
    """2x2 neighbourhoods concatenated (4C), LayerNorm, a bias-free 4C -> 2C map."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = LayerNorm(4 * dim)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor, resolution: Tuple[int, int]) -> torch.Tensor:
        h, w = resolution
        b, _, c = x.shape
        x = x.reshape(b, h, w, c)
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]],
                      dim=-1).reshape(b, (h // 2) * (w // 2), 4 * c)
        return linear(self.norm(x), self.reduction.weight, transposed=True)

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator) -> None:
        self.norm.weight.fill_(1.0)
        self.norm.bias.zero_()
        _trunc_normal_(self.reduction.weight, gen)


class SwinStage(nn.Module):
    def __init__(self, dim: int, depth: int, heads: int, ws: int, mlp_ratio: float,
                 downsample: bool):
        super().__init__()
        self.blocks = nn.ModuleList(SwinBlock(dim, heads, ws, mlp_ratio) for _ in range(depth))
        self.downsample = PatchMerging(dim) if downsample else None

    def init_weights(self, gen: torch.Generator) -> None:
        for blk in self.blocks:
            blk.init_weights(gen)
        if self.downsample is not None:
            self.downsample.init_weights(gen)


# ---------------------------------------------------------------------------
# the mel front end
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=32)
def _bicubic_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) align_corners=True bicubic interpolation matrix with torch's
    convention (cubic convolution, a = -0.75); border taps clamp-replicate."""
    a = -0.75

    def wgt(x):
        x = abs(x)
        if x <= 1:
            return (a + 2) * x ** 3 - (a + 3) * x ** 2 + 1
        if x < 2:
            return a * x ** 3 - 5 * a * x ** 2 + 8 * a * x - 4 * a
        return 0.0

    mat = np.zeros((n_out, n_in), np.float64)
    scale = (n_in - 1) / (n_out - 1) if n_out > 1 else 0.0
    for i in range(n_out):
        src = i * scale
        base = int(np.floor(src))
        frac = src - base
        for t in range(-1, 3):
            mat[i, min(max(base + t, 0), n_in - 1)] += wgt(t - frac)
    return mat.astype(np.float32)


def _bicubic_resize(x: torch.Tensor, target_t: int, target_f: int) -> torch.Tensor:
    """(B, C, T, F) -> (B, C, target_t, target_f): two interpolation-matrix products."""
    t_in, f_in = x.shape[2], x.shape[3]
    y = x.float()
    with true_fp32():
        if t_in != target_t:
            wt = _table(("bicubic", t_in, target_t), lambda: _bicubic_matrix(t_in, target_t),
                        y.device)
            y = torch.einsum("bctf,ut->bcuf", y, wt)
        if f_in != target_f:
            wf = _table(("bicubic", f_in, target_f), lambda: _bicubic_matrix(f_in, target_f),
                        y.device)
            y = torch.einsum("bctf,uf->bctu", y, wf)
    return y


def reshape_wav2img(x: torch.Tensor, spec_size: int, freq_ratio: int) -> torch.Tensor:
    """(B, C, T, F) mel -> (B, C, spec, spec) by folding time into frequency rows."""
    b, c = x.shape[0], x.shape[1]
    target_t = spec_size * freq_ratio
    target_f = spec_size // freq_ratio
    if x.shape[2] > target_t or x.shape[3] > target_f:
        raise ValueError(f"mel {tuple(x.shape[2:])} exceeds the Swin input {(target_t, target_f)}")
    if x.shape[2] != target_t or x.shape[3] != target_f:
        x = _bicubic_resize(x, target_t, target_f)
    x = x.transpose(2, 3).reshape(b, c, target_f, freq_ratio, target_t // freq_ratio)
    return x.transpose(2, 3).reshape(b, c, freq_ratio * target_f, target_t // freq_ratio)


class StoredBatchNorm(nn.Module):
    """``bn0``: batch norm over the last axis with its stored statistics, in training
    too. The four entries are parameters, as in the JAX package's param tree."""

    def __init__(self, n: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(n))
        self.bias = nn.Parameter(torch.zeros(n))
        self.running_mean = nn.Parameter(torch.zeros(n))
        self.running_var = nn.Parameter(torch.ones(n))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = torch.rsqrt(self.running_var.float() + self.eps) * self.weight.float()
        return (x.float() - self.running_mean.float()) * inv + self.bias.float()


# ---------------------------------------------------------------------------
# the encoder
# ---------------------------------------------------------------------------

class HTSAT(nn.Module):
    """The HTSAT encoder of a ``CLIPAudioCfg``; the keyword arguments are
    ``apply_htsat``'s (``models/clap.py:HTSAT_CONFIGS`` names them per size)."""

    def __init__(self, acfg, embed_dim: int = 96, depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (4, 8, 16, 32), spec_size: int = 256,
                 patch_stride: Tuple[int, int] = (4, 4), window_size: int = 8,
                 mlp_ratio: float = 4.0, num_classes: Optional[int] = None):
        super().__init__()
        if acfg.enable_fusion:
            raise NotImplementedError("HTSAT audio fusion (mel_fusion inputs) is not ported yet")
        self.acfg = acfg
        self.depths, self.num_heads = tuple(depths), tuple(num_heads)
        self.spec_size, self.patch_stride, self.window_size = spec_size, tuple(patch_stride), window_size
        self.freq_ratio = spec_size // acfg.mel_bins
        num_classes = num_classes if num_classes is not None else acfg.class_num
        num_layers = len(depths)
        self.num_features = int(embed_dim * 2 ** (num_layers - 1))
        res = spec_size // patch_stride[0]
        self.bn0 = StoredBatchNorm(acfg.mel_bins)
        self.patch_embed = nn.Module()
        self.patch_embed.proj = PatchEmbed(patch_stride, embed_dim, in_chans=1, bias=True)
        self.patch_embed.norm = LayerNorm(embed_dim)
        self.layers = nn.ModuleList(
            SwinStage(int(embed_dim * 2 ** li), depths[li], num_heads[li],
                      min(window_size, res // 2 ** li), mlp_ratio, li < num_layers - 1)
            for li in range(num_layers))
        self.norm = LayerNorm(self.num_features)
        sf = spec_size // (2 ** (num_layers - 1)) // patch_stride[0] // self.freq_ratio
        self.tscam_conv = nn.Conv2d(self.num_features, num_classes, kernel_size=(sf, 3),
                                    padding=(0, 1))
        self.head = nn.Linear(num_classes, num_classes)

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator) -> None:
        """The JAX package's ``init_htsat`` distributions."""
        for name, t in (("weight", 1.0), ("bias", 0.0), ("running_mean", 0.0),
                        ("running_var", 1.0)):
            getattr(self.bn0, name).fill_(t)
        _trunc_normal_(self.patch_embed.proj.weight, gen)
        self.patch_embed.proj.bias.zero_()
        for norm in (self.patch_embed.norm, self.norm):
            norm.weight.fill_(1.0)
            norm.bias.zero_()
        for stage in self.layers:
            stage.init_weights(gen)
        k = self.tscam_conv.weight
        _uniform_(k, gen, 1.0 / math.sqrt(self.num_features * k.shape[2] * 3))
        self.tscam_conv.bias.zero_()
        bound = 1.0 / math.sqrt(self.head.in_features)
        _uniform_(self.head.weight, gen, bound)
        _uniform_(self.head.bias, gen, bound)

    def mel(self, waveform: torch.Tensor) -> torch.Tensor:
        """(B, T) waveform -> (B, frames, mel_bins) log-mel, fp32."""
        a = self.acfg
        return log_mel_clap(waveform, sample_rate=a.sample_rate, n_fft=a.window_size,
                            hop_length=a.hop_size, n_mels=a.mel_bins, fmin=a.fmin, fmax=a.fmax)

    def tokens(self, audio: Dict[str, torch.Tensor], compute_dtype: torch.dtype) -> torch.Tensor:
        """Waveform dict -> the final LayerNorm's (B, tokens, num_features)."""
        if "mel_fusion" in audio:
            raise NotImplementedError("HTSAT audio fusion (mel_fusion inputs) is not ported yet")
        x = self.bn0(self.mel(audio["waveform"])[:, None])  # (B, 1, T, F)
        x = reshape_wav2img(x, self.spec_size, self.freq_ratio)  # (B, 1, spec, spec)
        x = x.permute(0, 2, 3, 1).to(compute_dtype)  # NHWC
        x = self.patch_embed.norm(self.patch_embed.proj(patchify(x, self.patch_stride)))
        res = self.spec_size // self.patch_stride[0]
        for li, stage in enumerate(self.layers):
            stage_res = res // (2 ** li)
            ws = min(self.window_size, stage_res)
            for bi, blk in enumerate(stage.blocks):
                shift = 0 if bi % 2 == 0 or stage_res <= self.window_size else ws // 2
                x = blk(x, (stage_res, stage_res), ws, shift)
            if stage.downsample is not None:
                x = stage.downsample(x, (stage_res, stage_res))
        return self.norm(x)

    def forward(self, audio: Dict[str, torch.Tensor],
                compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """The embedding (B, num_features): the mean over the final tokens. The
        token-semantic head is left out, as XLA drops it from the JAX package's
        compiled encode path."""
        return self.tokens(audio, compute_dtype).mean(dim=1)


def apply_htsat(model: HTSAT, audio: Dict[str, torch.Tensor],
                compute_dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    """All four outputs of the JAX package's ``apply_htsat``: ``embedding``,
    ``clipwise_output``, ``framewise_output`` and ``fine_grained_embedding``."""
    x = model.tokens(audio, compute_dtype)
    b, _, c = x.shape
    sf = model.spec_size // model.patch_stride[0] // (2 ** (len(model.depths) - 1))
    c_freq_bin = sf // model.freq_ratio
    x = x.transpose(1, 2).reshape(b, c, sf // c_freq_bin, c_freq_bin, sf)
    x = x.transpose(2, 3).reshape(b, c, c_freq_bin, -1)  # (B, C, fbin, T')
    repeat = 8 * model.patch_stride[1]
    fine = x.mean(dim=2).transpose(1, 2).repeat_interleave(repeat, dim=1)
    latent = x.reshape(b, c, -1).mean(dim=-1)
    conv = model.tscam_conv
    logits = F.conv2d(x.to(compute_dtype), conv.weight.to(compute_dtype),
                      conv.bias.to(compute_dtype), padding=conv.padding)[:, :, 0].transpose(1, 2)
    return {"embedding": latent,
            "clipwise_output": torch.sigmoid(logits.mean(dim=1).float()),
            "framewise_output": torch.sigmoid(logits.float()).repeat_interleave(repeat, dim=1),
            "fine_grained_embedding": fine}


_HTSAT_BLOCK_KEYS = {
    "norm1.weight": ("norm1", "scale"), "norm1.bias": ("norm1", "bias"),
    "norm2.weight": ("norm2", "scale"), "norm2.bias": ("norm2", "bias"),
    "attn.qkv.weight": ("attn", "qkv", "kernel"), "attn.qkv.bias": ("attn", "qkv", "bias"),
    "attn.proj.weight": ("attn", "proj", "kernel"), "attn.proj.bias": ("attn", "proj", "bias"),
    "attn.relative_position_bias_table": ("attn", "rel_bias"),
    "mlp.fc1.weight": ("mlp", "fc1", "kernel"), "mlp.fc1.bias": ("mlp", "fc1", "bias"),
    "mlp.fc2.weight": ("mlp", "fc2", "kernel"), "mlp.fc2.bias": ("mlp", "fc2", "bias"),
}
_HTSAT_KEYS = {
    "patch_embed.proj.bias": ("patch_embed", "proj", "bias"),
    "patch_embed.norm.weight": ("patch_embed", "norm", "scale"),
    "patch_embed.norm.bias": ("patch_embed", "norm", "bias"),
    "norm.weight": ("norm", "scale"), "norm.bias": ("norm", "bias"),
    "tscam_conv.bias": ("tscam_conv", "bias"), "head.bias": ("head", "bias"),
    "bn0.weight": ("bn0", "scale"), "bn0.bias": ("bn0", "bias"),
    "bn0.running_mean": ("bn0", "mean"), "bn0.running_var": ("bn0", "var"),
}


def torch_htsat_to_params(sd: Dict[str, object], prefix: str = "") -> Dict[str, object]:
    """The reference HTSATEncoder's keys under ``prefix`` -> the JAX package's HTSAT
    tree (numpy leaves), as its ``torch_htsat_to_params`` makes it. The fusion
    modules (``enable_fusion``) are not ported and raise."""
    import re

    from ..convert import _np, _set

    sub = {k[len(prefix):]: _np(v) for k, v in sd.items() if k.startswith(prefix)}
    fusion = sorted(k for k in sub if k.startswith(("fusion_model.", "patch_embed.fusion_model.",
                                                    "patch_embed.mel_conv2d.", "mel_conv1d.")))
    if fusion:
        raise NotImplementedError(f"HTSAT audio fusion ({fusion[0]}, ...) is not ported yet")
    tree: Dict[str, object] = {"stages": {}}
    layer_re = re.compile(r"^layers\.(\d+)\.(blocks|downsample)\.(.*)$")
    for k, v in sub.items():
        m = layer_re.match(k)
        if m:
            stage = tree["stages"].setdefault(f"stage{m.group(1)}", {})
            rest = m.group(3)
            if m.group(2) == "downsample":
                path = {"norm.weight": ("norm", "scale"), "norm.bias": ("norm", "bias"),
                        "reduction.weight": ("reduction", "kernel")}.get(rest)
                if path is not None:
                    _set(stage, ("downsample",) + path, v.T if path[-1] == "kernel" else v)
                continue
            bi, _, brest = rest.partition(".")
            if brest.endswith(("relative_position_index", "attn_mask")):
                continue
            path = _HTSAT_BLOCK_KEYS[brest]
            _set(stage.setdefault("blocks", {}).setdefault(bi, {}), path,
                 v.T if path[-1] == "kernel" else v)
        elif k == "patch_embed.proj.weight":
            _set(tree, ("patch_embed", "proj", "kernel"), v.transpose(2, 3, 1, 0))
        elif k == "tscam_conv.weight":
            _set(tree, ("tscam_conv", "kernel"), v.transpose(2, 3, 1, 0))
        elif k == "head.weight":
            _set(tree, ("head", "kernel"), v.T)
        elif k in _HTSAT_KEYS:
            _set(tree, _HTSAT_KEYS[k], v)
        elif not ("num_batches_tracked" in k or "spectrogram_extractor" in k
                  or "logmel_extractor" in k):
            raise KeyError(f"unknown htsat key {k}")
    return tree
