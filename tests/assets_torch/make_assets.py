"""Make the JPEG test assets of the port and the canvases they decode to.

    JAX_PLATFORMS=cpu python tests/assets_torch/make_assets.py

Twelve JPEGs from 320x240 to 1024x768 (one grayscale, one at quality 98), drawn from
seed 0 with numpy and encoded with PIL, and ``canvases.npz``: each image's 256-px canvas from the JAX package's native
decoder (``open_clip_tpu.native``), strict (1/2^k DCT scales) and fractional (M/8).
To stay small the file keeps every fourth row of each canvas (``ROW_STEP``), the
strict rows as differences along the width (mod 256) and the fractional ones as
their difference from the strict; ``load_canvases`` undoes both. The card run
(``chip_smoke.py``, which has no PIL and no JAX) and the CPU tests read these files.
"""

import io
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
CANVAS = 256
ROW_STEP = 4  # the rows of each canvas kept: 0, 4, 8, ...
# (width, height, quality, grayscale)
SPECS = [(320, 240, 90, False), (400, 300, 85, False), (480, 360, 90, True),
         (512, 384, 90, False), (640, 480, 90, False), (480, 640, 90, False),
         (640, 427, 80, False), (333, 500, 90, False), (600, 600, 85, False),
         (768, 512, 90, False), (800, 600, 85, False), (1024, 768, 98, False)]


def names():
    return [f"img{i:02d}_{w}x{h}.jpg" for i, (w, h, _, _) in enumerate(SPECS)]


def load_canvases(path=os.path.join(HERE, "canvases.npz")):
    """{"names", "strict", "fractional"}: (N, 256 / ROW_STEP, 256, 3) uint8, the rows
    0, ROW_STEP, ... of each canvas."""
    z = np.load(path)
    strict = np.cumsum(z["strict_delta"], axis=2, dtype=np.uint8)  # wraps mod 256
    frac = (strict.astype(np.int16) + z["fractional_minus_strict"]).astype(np.uint8)
    return {"names": [str(n) for n in z["names"]], "strict": strict, "fractional": frac}


def _image(rng, w, h, gray):
    """A smooth random field with texture: large blobs, edges and mild noise."""
    from PIL import Image

    c = 1 if gray else 3
    base = rng.integers(0, 256, (max(2, h // 40), max(2, w // 40), c)).astype(np.uint8)
    img = np.asarray(Image.fromarray(base.squeeze(-1) if gray else base).resize(
        (w, h), Image.BICUBIC), np.float32)
    if gray:
        img = img[..., None]
    yy, xx = np.mgrid[0:h, 0:w]
    stripes = 40.0 * np.sin(xx / rng.uniform(3, 9) + yy / rng.uniform(5, 15))[..., None]
    img = img * 0.7 + stripes + rng.normal(0, 2, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def main():
    from PIL import Image

    sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
    from open_clip_tpu.native import decode_resize_one

    rng = np.random.default_rng(0)
    strict, frac = [], []
    for name, (w, h, q, gray) in zip(names(), SPECS):
        arr = _image(rng, w, h, gray)
        buf = io.BytesIO()
        Image.fromarray(arr.squeeze(-1) if gray else arr).save(buf, "JPEG", quality=q)
        data = buf.getvalue()
        with open(os.path.join(HERE, name), "wb") as fh:
            fh.write(data)
        strict.append(decode_resize_one(data, CANVAS, fractional=False))
        frac.append(decode_resize_one(data, CANVAS, fractional=True))
        assert strict[-1] is not None and frac[-1] is not None, name
    strict = np.stack(strict)[:, ::ROW_STEP]
    frac = np.stack(frac)[:, ::ROW_STEP]
    np.savez_compressed(
        os.path.join(HERE, "canvases.npz"), names=np.array(names()),
        strict_delta=np.diff(strict, axis=2, prepend=0).astype(np.uint8),
        fractional_minus_strict=(frac.astype(np.int16) - strict).astype(np.int16))
    back = load_canvases()
    assert np.array_equal(back["strict"], strict) and np.array_equal(back["fractional"], frac)

if __name__ == "__main__":
    main()
