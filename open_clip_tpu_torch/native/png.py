"""PNG decode without PIL (the JAX package opens every image with PIL's
``Image.open(...).convert("RGB")``).

The chunks are read here (their CRCs checked), the image data inflated with the
standard library's ``zlib``, the scanlines unfiltered (None, Sub, Up, Average,
Paeth) by ``oct_png_unfilter`` of the native library (``png.cpp``), and the pixels
turned into RGB with numpy, by PIL's rules for ``convert("RGB")``:

- grayscale of 1, 2 and 4 bits scales to 0..255 (x255, x85, x17), 8 bits is
  replicated, 16 bits opens as PIL's ``I;16`` and converts clipped at 255;
- RGB and RGBA of 16 bits keep each sample's high byte, RGBA and gray+alpha drop
  the alpha;
- a palette image looks its indices up in ``PLTE`` and ignores ``tRNS``.

Interlaced (Adam7) images are not decoded and raise ``NotImplementedError`` with the
sample's key. A corrupt file (a bad CRC, a failed inflate, too little data, an
unknown filter) raises ``ValueError``, a decode failure as libjpeg's status is.
"""

from __future__ import annotations

import ctypes
import struct
import zlib
from typing import Optional

import numpy as np

from .decode import load

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> (samples a pixel, the bit depths the specification allows)
_COLOUR = {0: (1, (1, 2, 4, 8, 16)), 2: (3, (8, 16)), 3: (1, (1, 2, 4, 8)), 4: (2, (8, 16)),
           6: (4, (8, 16))}
_GRAY_SCALE = {1: 255, 2: 85, 4: 17, 8: 1}


def is_png(data: bytes) -> bool:
    return bytes(data[:8]) == PNG_SIGNATURE


def _chunks(data: bytes):
    pos = 8
    while pos + 12 <= len(data):
        length, kind = struct.unpack_from(">I4s", data, pos)
        body = data[pos + 8: pos + 8 + length]
        if len(body) != length or pos + 12 + length > len(data):
            raise ValueError(f"truncated PNG chunk {kind!r}")
        (crc,) = struct.unpack_from(">I", data, pos + 8 + length)
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"PNG chunk {kind!r} fails its CRC")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length


def _samples(rows: np.ndarray, width: int, depth: int, per_pixel: int) -> np.ndarray:
    """(H, stride) unfiltered bytes -> (H, W * per_pixel) samples (uint8 up to 8
    bits, uint16 for 16)."""
    if depth == 16:
        return rows.view(">u2")[:, : width * per_pixel]
    if depth == 8:
        return rows[:, : width * per_pixel]
    bits = np.unpackbits(rows, axis=1)[:, : width * per_pixel * depth]
    bits = bits.reshape(rows.shape[0], -1, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits * weights).sum(axis=-1, dtype=np.uint8)


def decode_png(data: bytes, key: Optional[str] = None) -> np.ndarray:
    """PNG bytes -> (H, W, 3) uint8, what PIL's ``convert("RGB")`` gives."""
    data = bytes(data)
    if not is_png(data):
        raise ValueError("not a PNG (no signature)")
    header = plte = None
    idat = []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            plte = body
        elif kind == b"IDAT":
            idat.append(body)
    if header is None or not idat:
        raise ValueError("PNG without IHDR or IDAT")
    width, height, depth, colour, compression, filtering, interlace = header
    if colour not in _COLOUR or depth not in _COLOUR[colour][1] or compression or filtering:
        raise ValueError(f"invalid PNG header (colour type {colour}, depth {depth})")
    if interlace:
        raise NotImplementedError(f"sample {key!r}: interlaced PNG images are not decoded "
                                  "(there is no PIL tier)")
    per_pixel = _COLOUR[colour][0]
    stride = (width * per_pixel * depth + 7) // 8
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"PNG image data does not inflate: {e}") from None
    if len(raw) < height * (stride + 1):
        raise ValueError("PNG image data is truncated")
    filtered = np.frombuffer(raw, np.uint8, height * (stride + 1))
    rows = np.empty((height, stride), np.uint8)
    if load().oct_png_unfilter(filtered.ctypes.data, rows.ctypes.data, height, stride,
                               max(1, per_pixel * depth // 8)):
        raise ValueError("PNG scanline with an unknown filter type")
    s = _samples(rows, width, depth, per_pixel).reshape(height, width, per_pixel)
    if colour == 3:
        if plte is None:
            raise ValueError("palette PNG without PLTE")
        palette = np.zeros((256, 3), np.uint8)
        entries = np.frombuffer(plte, np.uint8)[: len(plte) // 3 * 3].reshape(-1, 3)[:256]
        palette[: len(entries)] = entries
        return palette[s[..., 0]]
    if colour in (0, 4):  # gray, gray + alpha
        gray = s[..., 0]
        if depth == 16:
            gray = (np.minimum(gray, 255) if colour == 0 else gray >> 8).astype(np.uint8)
        elif colour == 0:
            gray = gray * np.uint8(_GRAY_SCALE[depth])
        return np.repeat(gray[..., None], 3, axis=-1)
    rgb = s[..., :3]  # RGB, RGBA
    return (rgb >> 8).astype(np.uint8) if depth == 16 else np.ascontiguousarray(rgb)
