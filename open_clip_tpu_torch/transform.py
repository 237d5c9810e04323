"""Image preprocessing on the device (counterpart of ``make_device_preprocess`` in
``open_clip_tpu/transform.py``).

uint8 NHWC in, normalized float NHWC out, on the tensor's own device: a
shortest-edge resize (new size ``round(h * scale)``), a center crop and the
mean/std normalization. The resize is
``F.interpolate(..., antialias=True)``, whose bicubic filter is Keys' a=-0.5, the
filter of ``jax.image.resize(..., "cubic", antialias=True)``; torch's bicubic
without antialias uses a=-0.75 and would not match.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple, Union

import torch
import torch.nn.functional as F

from .constants import OPENAI_DATASET_MEAN, OPENAI_DATASET_STD


@dataclass
class PreprocessCfg:
    size: Union[int, Tuple[int, int]] = 224
    mean: Tuple[float, ...] = OPENAI_DATASET_MEAN
    std: Tuple[float, ...] = OPENAI_DATASET_STD

    @property
    def size_hw(self) -> Tuple[int, int]:
        if isinstance(self.size, (tuple, list)):
            return tuple(self.size)
        return (self.size, self.size)


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
