"""Image preprocessing (counterpart of ``open_clip_tpu/transform.py``).

Two halves, split between the host and the device as in the JAX package's
``--device-preprocess`` path:

- **Host, uint8.** JPEG bytes become fixed-shape uint8 HWC through the native
  decode stage (``native/``: libjpeg, or nvJPEG where libjpeg is absent):
  ``_Uint8ValTransform`` at the model size,
  ``_Uint8CanvasTransform`` at a slightly larger square canvas
  (``default_canvas_size``) for training. ``host_val_transform`` also normalizes the
  val image on the host to float32 HWC, the counterpart of the JAX package's PIL
  ``pp_val``. There is no PIL here, so what the native stage cannot do raises.
- **Device.** ``make_device_preprocess`` (serving: shortest-edge resize, center crop,
  normalization) and ``make_device_train_preprocess`` (training: a RandomResizedCrop
  of each canvas as two separable resample contractions, then the normalization),
  on the batch's own device.

``make_device_preprocess``'s resize is ``F.interpolate(..., antialias=True)``, whose
bicubic filter is Keys' a=-0.5, the filter of ``jax.image.resize(..., "cubic",
antialias=True)``; torch's bicubic without antialias uses a=-0.75 and would not match.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from .constants import OPENAI_DATASET_MEAN, OPENAI_DATASET_STD


@dataclass
class PreprocessCfg:
    size: Union[int, Tuple[int, int]] = 224
    mode: str = "RGB"
    mean: Tuple[float, ...] = OPENAI_DATASET_MEAN
    std: Tuple[float, ...] = OPENAI_DATASET_STD
    interpolation: str = "bicubic"
    resize_mode: str = "shortest"
    fill_color: int = 0

    def __post_init__(self):
        for name in ("size", "mean", "std"):
            if isinstance(getattr(self, name), list):
                setattr(self, name, tuple(getattr(self, name)))

    @property
    def size_hw(self) -> Tuple[int, int]:
        if isinstance(self.size, (tuple, list)):
            return tuple(self.size)
        return (self.size, self.size)


@dataclass
class AugmentationCfg:
    scale: Tuple[float, float] = (0.9, 1.0)
    ratio: Optional[Tuple[float, float]] = None
    color_jitter: Optional[Union[float, Tuple[float, ...]]] = None
    re_prob: Optional[float] = None
    re_count: Optional[int] = None
    use_timm: bool = False
    color_jitter_prob: Optional[float] = None
    gray_scale_prob: Optional[float] = None


def merge_preprocess_dict(base: PreprocessCfg, overlay: Optional[Dict[str, Any]]) -> PreprocessCfg:
    """``base`` with the overlay's fields that are set (not None)."""
    if not overlay:
        return base
    d = dataclasses.asdict(base)
    d.update({k: v for k, v in overlay.items() if k in d and v is not None})
    return PreprocessCfg(**d)


def _check_native(cfg: PreprocessCfg, size: Tuple[int, int]) -> None:
    """Raise for what the native stage does not do: it decodes JPEG to RGB and
    resizes the shortest edge with PIL's bicubic filter to a square."""
    bad = [f"{what} {got!r} (the native stage does {want!r})" for what, got, want in (
        ("resize_mode", cfg.resize_mode, "shortest"), ("interpolation", cfg.interpolation, "bicubic"),
        ("mode", cfg.mode, "RGB")) if got != want]
    if size[0] != size[1]:
        bad.append(f"non-square size {size} (the native stage makes squares)")
    if bad:
        raise NotImplementedError("the host image stage has no PIL tier here: " + "; ".join(bad))


def _decode(data, canvas: int, fractional: bool) -> np.ndarray:
    from .native import decode_resize_one

    out, status = decode_resize_one(bytes(data), canvas, fractional=fractional)
    if status:
        raise ValueError(f"native JPEG decode failed (status {status})")
    return out


class _Uint8ValTransform:
    """JPEG bytes -> (size, size, 3) uint8: shortest-edge resize and center crop at
    the model size, decoded at 1/2^k DCT scales (within 2 levels of the JAX package's
    PIL tier). Pairs with ``make_device_preprocess``."""

    accepts_bytes = True

    def __init__(self, cfg: PreprocessCfg):
        _check_native(cfg, cfg.size_hw)
        self.cfg = cfg

    def __call__(self, data) -> np.ndarray:
        return _decode(data, self.cfg.size_hw[0], fractional=False)


class _Uint8CanvasTransform:
    """Training's host stage: JPEG bytes -> (canvas, canvas, 3) uint8, shortest-edge
    resize and center crop, decoded at the nearest M/8 DCT scale. The
    RandomResizedCrop runs on the device (``make_device_train_preprocess``); the data
    pipeline decodes whole batches through ``native_canvas`` on several threads."""

    accepts_bytes = True

    def __init__(self, cfg: PreprocessCfg, canvas: int):
        _check_native(cfg, (canvas, canvas))
        self.cfg = cfg
        self.canvas = self.native_canvas = canvas

    def __call__(self, data) -> np.ndarray:
        return _decode(data, self.canvas, fractional=True)


class _HostValTransform(_Uint8ValTransform):
    """The val stage of the data pipeline: ``_Uint8ValTransform``, then the
    normalization on the host -> float32 HWC (the JAX package's ``pp_val`` output)."""

    def __init__(self, cfg: PreprocessCfg):
        super().__init__(cfg)
        self.mean = np.asarray(cfg.mean, dtype=np.float32)
        self.std = np.asarray(cfg.std, dtype=np.float32)

    def __call__(self, data) -> np.ndarray:
        arr = super().__call__(data).astype(np.float32) / 255.0
        return (arr - self.mean) / self.std


def default_canvas_size(cfg: PreprocessCfg) -> int:
    """The training canvas: ~8/7 of the model size, rounded up to a multiple of 16
    (224 -> 256), so that crops of scale (0.9, 1.0) never upsample."""
    return int(np.ceil(max(cfg.size_hw) * 8 / 7 / 16) * 16)


def uint8_image_transform_v2(cfg: PreprocessCfg, is_train: bool,
                             aug_cfg: Optional[Union[Dict[str, Any], AugmentationCfg]] = None,
                             canvas: Optional[int] = None):
    """The host half of the device-preprocess path: JPEG bytes -> uint8 HWC at a fixed
    shape (the canvas for training, the model size for evaluation)."""
    if is_train:
        return _Uint8CanvasTransform(cfg, canvas or default_canvas_size(cfg))
    return _Uint8ValTransform(cfg)


def host_val_transform(cfg: PreprocessCfg) -> _HostValTransform:
    """JPEG bytes -> normalized float32 (size, size, 3): the val images of ``get_data``."""
    return _HostValTransform(cfg)


def _resample_kernel(u: torch.Tensor, kind: str) -> torch.Tensor:
    """The interpolation filter at (scaled) distance ``u``: ``cubic`` is Keys' a=-0.5
    (PIL's and antialiased torch resizes'), ``linear`` the tent."""
    au = u.abs()
    if kind == "linear":
        return (1.0 - au).clamp_min(0.0)
    if kind != "cubic":
        raise ValueError(f"unknown resample kernel {kind!r}")
    a = -0.5
    au2 = au * au
    return torch.where(au <= 1.0, ((a + 2.0) * au - (a + 3.0)) * au2 + 1.0,
                       torch.where(au < 2.0, a * (((au - 5.0) * au + 8.0) * au - 4.0),
                                   torch.zeros_like(au)))


def make_crop_resample(s: int, th: int, tw: int, kind: str = "cubic", antialias: bool = True):
    """``fn(x, top, left, ch, cw) -> (B, th, tw, C)``: resample each sample's box
    (float source pixels) of ``x: (B, s, s, C)`` float32 to the target size. Along
    each axis the resample is a row-stochastic (B, t_out, s) matrix, made dense and
    contracted (two fp32 ``einsum``s). With ``antialias`` the filter widens by the
    downscale factor and the weights renormalize over the window, as PIL does."""

    def weights(start, extent, t_out):
        # each output pixel's source position, in float64 on the small (B, t_out) grid and
        # split into a whole and a fraction: in fp32 a position near s would be off by
        # ~1e-5 px, and the weights with it; so the fp32 distances below are exact up to
        # the fraction's rounding, and the card and the CPU compute the same weights
        step = extent[:, None] / t_out                                     # (B, 1)
        grid_out = torch.arange(t_out, device=start.device, dtype=torch.float64)
        src = start[:, None] + (grid_out[None, :] + 0.5) * step - 0.5      # (B, t_out)
        whole = torch.floor(src)
        frac = (src - whole).float()
        ss = (step.clamp_min(1.0) if antialias else torch.ones_like(step)).float()
        grid = torch.arange(s, device=start.device, dtype=torch.float32)[None, None, :]
        dist = (grid - whole.float()[:, :, None]) - frac[:, :, None]       # (B, t_out, s)
        w = _resample_kernel(dist / ss[:, :, None], kind)
        return w / w.sum(dim=-1, keepdim=True)

    def fn(x, top, left, ch, cw):
        f64 = lambda v: v.to(device=x.device, dtype=torch.float64)  # noqa: E731
        wy = weights(f64(top), f64(ch), th)
        wx = weights(f64(left), f64(cw), tw)
        rows = torch.einsum("bhs,bswc->bhwc", wy, x)
        return torch.einsum("bws,bhsc->bhwc", wx, rows)

    return fn


def make_crop_param_sampler(s: int, scale_rng: Tuple[float, float],
                            ratio_rng: Tuple[float, float], attempts: int = 10):
    """torchvision's ``RandomResizedCrop.get_params`` for a square source, batched:
    ``fn(gen, b) -> (top, left, ch, cw)``, float (B,) tensors of integer values on
    ``gen``'s device. ``attempts`` (area, log-aspect) draws a sample; the first whose
    rounded crop fits in the s x s source wins, else the ratio-clamped center crop."""
    log_ratio = (math.log(ratio_rng[0]), math.log(ratio_rng[1]))
    if 1.0 < ratio_rng[0]:
        fb_cw, fb_ch = s, int(round(s / ratio_rng[0]))
    elif 1.0 > ratio_rng[1]:
        fb_cw, fb_ch = int(round(s * ratio_rng[1])), s
    else:
        fb_cw = fb_ch = s
    fb_left, fb_top = (s - fb_cw) // 2, (s - fb_ch) // 2

    def uniform(gen, shape, lo, hi):
        return torch.rand(shape, generator=gen, device=gen.device) * (hi - lo) + lo

    def fn(gen: torch.Generator, b: int):
        area = uniform(gen, (b, attempts), *scale_rng) * (s * s)
        aspect = torch.exp(uniform(gen, (b, attempts), *log_ratio))
        cw = torch.round(torch.sqrt(area * aspect))
        ch = torch.round(torch.sqrt(area / aspect))
        ok = (cw > 0) & (cw <= s) & (ch > 0) & (ch <= s)
        first = ok.float().argmax(dim=1, keepdim=True)  # the first accepted draw
        any_ok = ok.any(dim=1)
        cw_s = torch.where(any_ok, cw.gather(1, first)[:, 0], float(fb_cw))
        ch_s = torch.where(any_ok, ch.gather(1, first)[:, 0], float(fb_ch))
        off = torch.rand((b, 2), generator=gen, device=gen.device)  # randint(0, s - c)
        top = torch.where(any_ok, torch.floor(off[:, 0] * (s - ch_s + 1.0)), float(fb_top))
        left = torch.where(any_ok, torch.floor(off[:, 1] * (s - cw_s + 1.0)), float(fb_left))
        return top, left, ch_s, cw_s

    return fn


def make_device_train_preprocess(cfg: PreprocessCfg,
                                 aug_cfg: Optional[Union[Dict[str, Any], AugmentationCfg]] = None,
                                 antialias: bool = True, sampler: Optional[Callable] = None):
    """``fn(gen, uint8 (B, S, S, 3)) -> normalized float32 (B, th, tw, 3)`` on the
    images' device: a RandomResizedCrop of each canvas (``make_crop_param_sampler``'s
    boxes from the generator ``gen``, or ``sampler(gen, b)``'s), resampled by
    ``make_crop_resample`` (bicubic Keys a=-0.5, antialiased, as the host tier's PIL),
    then the mean/std normalization. Only the scale and ratio augmentations exist
    here; any other raises."""
    if isinstance(aug_cfg, dict):
        aug_cfg = AugmentationCfg(**aug_cfg)
    aug = aug_cfg or AugmentationCfg()
    unsupported = {f: getattr(aug, f) for f in
                   ("color_jitter", "color_jitter_prob", "gray_scale_prob",
                    "re_prob", "re_count", "use_timm")
                   if getattr(aug, f, None) not in (None, False, 0, 0.0)}
    if unsupported:
        raise ValueError(
            f"--device-preprocess implements only scale/ratio (RandomResizedCrop); "
            f"unsupported aug_cfg fields set: {unsupported} — drop them")
    ratio_rng = aug.ratio or (3.0 / 4.0, 4.0 / 3.0)
    th, tw = cfg.size_hw
    kind = "linear" if cfg.interpolation == "bilinear" else "cubic"

    def fn(gen: torch.Generator, images: torch.Tensor) -> torch.Tensor:
        x = images.float() / 255.0
        b, s = x.shape[0], x.shape[1]
        draw = sampler or make_crop_param_sampler(s, aug.scale, ratio_rng)
        top, left, ch, cw = draw(gen, b)
        out = make_crop_resample(s, th, tw, kind=kind, antialias=antialias)(x, top, left, ch, cw)
        mean = torch.tensor(cfg.mean, dtype=torch.float32, device=x.device)
        std = torch.tensor(cfg.std, dtype=torch.float32, device=x.device)
        return (out - mean) / std

    return fn


def make_device_preprocess(cfg: PreprocessCfg):
    """fn: uint8 (B, H, W, 3) -> normalized float32 (B, th, tw, 3), on the input's device."""
    th, tw = cfg.size_hw

    def fn(images: torch.Tensor) -> torch.Tensor:
        x = images.permute(0, 3, 1, 2).float() / 255.0  # NCHW for F.interpolate
        h, w = x.shape[2:]
        if (h, w) != (th, tw):
            scale = max(th / h, tw / w)
            nh, nw = round(h * scale), round(w * scale)
            x = F.interpolate(x, size=(nh, nw), mode="bicubic", antialias=True, align_corners=False)
            top, left = (nh - th) // 2, (nw - tw) // 2
            x = x[:, :, top: top + th, left: left + tw]
        mean = torch.tensor(cfg.mean, dtype=torch.float32, device=x.device)[:, None, None]
        std = torch.tensor(cfg.std, dtype=torch.float32, device=x.device)[:, None, None]
        return ((x - mean) / std).permute(0, 2, 3, 1).contiguous()

    return fn
