"""ctypes binding and on-demand build of the native JPEG decode stage
(counterpart of ``open_clip_tpu/native/decode.py``).

The stage decodes a JPEG, resizes it with PIL's antialiased bicubic filter to a
shortest edge of ``canvas`` and center-crops it. Two sources, one chosen per build
(``decoder()``), never one falling back to the other:

- ``decode.cpp`` (a copy of the JAX package's source) on **libjpeg**, scaled in the
  DCT domain, where the compiler finds ``jpeglib.h``;
- ``decode_nvjpeg.cpp`` on **nvJPEG**, the CUDA toolkit's decoder, where it does not
  and the toolkit has ``nvjpeg.h``: a full-resolution decode on the card (on streams
  of its own), then ``decode.cpp``'s resample and geometry on the host. It has no
  DCT scaling, so ``fractional`` changes nothing there, and it cannot run in a
  forked worker.

The library is compiled with ``g++``
at first use into ``build/open_clip_tpu_torch/liboct_decode_<decoder>_<hash>.so`` at
the root of the checkout, named by a hash of the source and the flags, and loaded
with ``ctypes`` (whose calls release the GIL, so batches decode while Python runs).
A failed build or load raises. A decode that fails (corrupt bytes, a CMYK JPEG)
returns a non-zero status for that image, which the data pipeline counts as a
decode failure.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

logger = logging.getLogger(__name__)

HERE = Path(__file__).resolve().parent
SOURCES = {"libjpeg": HERE / "decode.cpp", "nvjpeg": HERE / "decode_nvjpeg.cpp"}
# compiled into the library beside the decoder's source: the full-resolution libjpeg
# decode (the nvJPEG source has its own) and the PNG unfilter
EXTRA_SOURCES = {"libjpeg": (HERE / "decode_full.cpp", HERE / "png.cpp"),
                 "nvjpeg": (HERE / "png.cpp",)}
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "open_clip_tpu_torch"
# the JAX package's flags; -std=c++17 keeps floating-point contraction off, so the
# resample rounds as the JAX package's build does
FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_DECODER: Optional[str] = None


def _cxx() -> str:
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native JPEG decode stage cannot be built")
    return cxx


def _cuda_home() -> Path:
    return Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))


def decoder() -> str:
    """``libjpeg`` where the compiler finds ``jpeglib.h``, else ``nvjpeg`` where the
    CUDA toolkit has ``nvjpeg.h``; raises where neither is there."""
    global _DECODER
    if _DECODER is None:
        if subprocess.run([_cxx(), "-E", "-x", "c++", "-", "-o", os.devnull],
                            input="#include <jpeglib.h>\n", text=True,
                            capture_output=True).returncode == 0:
            _DECODER = "libjpeg"
        elif (_cuda_home() / "include" / "nvjpeg.h").exists():
            _DECODER = "nvjpeg"
        else:
            raise RuntimeError("no JPEG decoder to build: neither libjpeg's jpeglib.h nor the "
                               f"CUDA toolkit's nvjpeg.h ({_cuda_home()}/include) is present")
    return _DECODER


def _command(name: str, out: str) -> List[str]:
    sources = [str(SOURCES[name]), *map(str, EXTRA_SOURCES[name])]
    if name == "libjpeg":
        return [_cxx(), *FLAGS, *sources, "-o", out, "-ljpeg", "-pthread"]
    cuda = _cuda_home()
    return [_cxx(), *FLAGS, f"-I{cuda / 'include'}", *sources, "-o", out,
            f"-L{cuda / 'lib64'}", f"-Wl,-rpath,{cuda / 'lib64'}", "-lnvjpeg",
            "-lcudart_static", "-ldl", "-lrt", "-pthread"]


def library_path() -> Path:
    name = decoder()
    digest = hashlib.sha256()
    for source in (SOURCES[name], *EXTRA_SOURCES[name]):
        digest.update(source.read_bytes())
    digest.update(" ".join(_command(name, "")).encode())
    return BUILD_DIR / f"liboct_decode_{name}_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the chosen decoder's source unless its library exists; raises when
    ``g++`` is missing or the build fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = _command(decoder(), tmp)
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"building the native JPEG decode stage failed (exit "
                           f"{proc.returncode}): {' '.join(cmd)}\n{proc.stdout}")
    os.replace(tmp, out)  # atomic: a concurrent build sees the whole library or none
    logger.info("built the %s JPEG decode stage: %s", decoder(), " ".join(cmd))
    return out


def load() -> ctypes.CDLL:
    """The loaded library, built on first use."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            lib.oct_decode_resize.restype = ctypes.c_int
            lib.oct_decode_resize.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int,
                                              ctypes.c_void_p, ctypes.c_int]
            lib.oct_decode_batch.restype = None
            lib.oct_decode_batch.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_size_t), ctypes.c_int,
                ctypes.c_int, ctypes.c_void_p, ctypes.POINTER(ctypes.c_int), ctypes.c_int,
                ctypes.c_int]
            batch_args = [ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_size_t),
                          ctypes.c_int, ctypes.POINTER(ctypes.c_void_p),
                          ctypes.POINTER(ctypes.c_size_t), ctypes.POINTER(ctypes.c_int),
                          ctypes.c_int]
            lib.oct_decode_full_batch.restype = None
            lib.oct_decode_full_batch.argtypes = batch_args
            if decoder() == "nvjpeg":
                lib.oct_decode_full_device_batch.restype = None
                lib.oct_decode_full_device_batch.argtypes = [*batch_args, ctypes.c_void_p]
            lib.oct_png_unfilter.restype = ctypes.c_int
            lib.oct_png_unfilter.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                             ctypes.c_size_t, ctypes.c_int]
            lib.oct_resize.restype = None
            lib.oct_resize.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                       ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
            lib.oct_jpeg_dims.restype = ctypes.c_int
            lib.oct_jpeg_dims.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                          ctypes.POINTER(ctypes.c_int),
                                          ctypes.POINTER(ctypes.c_int)]
            if decoder() == "nvjpeg":
                import torch

                lib.oct_set_device(ctypes.c_int(torch.cuda.current_device()))
            _LIB = lib
    return _LIB


def decode_resize_one(data: bytes, canvas: int, *, fractional: bool = True
                      ) -> Tuple[np.ndarray, int]:
    """JPEG bytes -> ((canvas, canvas, 3) uint8, status): shortest-edge resize and
    center crop. ``status`` 0 means the image is valid; otherwise it is zeros.

    ``fractional=True`` decodes at the nearest M/8 DCT scale (less IDCT and resample
    work); ``False`` only at 1/2^k scales, as PIL's draft mode does, which keeps the
    result within 2 levels of a full PIL decode and resize."""
    lib = load()
    out = np.zeros((canvas, canvas, 3), np.uint8)
    rc = lib.oct_decode_resize(data, len(data), canvas, out.ctypes.data_as(ctypes.c_void_p),
                               1 if fractional else 0)
    return out, int(rc)


def decode_resize_batch(datas: Sequence[bytes], canvas: int, nthreads: int = 0, *,
                        fractional: bool = True) -> Tuple[np.ndarray, List[int]]:
    """Decode a batch on ``nthreads`` threads of the library (0: ``os.cpu_count()``)
    -> ((N, canvas, canvas, 3) uint8, per-image status); a failed slot is zeros."""
    lib = load()
    n = len(datas)
    out = np.zeros((n, canvas, canvas, 3), np.uint8)
    bufs = (ctypes.c_char_p * n)(*datas)
    lens = (ctypes.c_size_t * n)(*[len(d) for d in datas])
    status = (ctypes.c_int * n)()
    lib.oct_decode_batch(bufs, lens, n, canvas, out.ctypes.data_as(ctypes.c_void_p), status,
                         nthreads if nthreads > 0 else (os.cpu_count() or 1),
                         1 if fractional else 0)
    return out, list(status)


def jpeg_dims(data: bytes) -> Optional[Tuple[int, int]]:
    """(width, height) from the JPEG header, or None when it does not parse."""
    lib = load()
    w, h = ctypes.c_int(), ctypes.c_int()
    rc = lib.oct_jpeg_dims(data, len(data), ctypes.byref(w), ctypes.byref(h))
    return (w.value, h.value) if rc == 0 else None


def full_decode_route(device=None) -> str:
    """Where ``decode_full_batch`` decodes and leaves the images for ``device``:
    ``libjpeg-host``, ``nvjpeg-host`` (decoded on the card, copied back) or
    ``nvjpeg-device`` (decoded on the card and left there)."""
    name = decoder()
    on_card = device is not None and str(device).startswith("cuda")
    return "nvjpeg-device" if name == "nvjpeg" and on_card else f"{name}-host"


def decode_full_batch(datas: Sequence[bytes], nthreads: int = 0, device=None):
    """Full-resolution decodes of JPEG ``datas`` on ``nthreads`` threads of the
    library (0: ``os.cpu_count()``) -> (images, per-image status): (H, W, 3) uint8
    numpy arrays, or, for the nvJPEG decoder and a CUDA ``device``, uint8 tensors on
    that card (``full_decode_route``); a failed slot's image is None.

    On the card the images are allocated on the current stream, and nvJPEG writes
    them only after the work queued there so far: memory that a queued kernel still
    uses, freed on the host, may be handed out again at once."""
    lib = load()
    n = len(datas)
    dims = [jpeg_dims(d) for d in datas]
    status = (ctypes.c_int * n)(*[0 if d is not None else 2 for d in dims])
    images: List = [None] * n
    todo = [i for i in range(n) if dims[i] is not None]
    if not todo:
        return images, list(status)
    on_card = full_decode_route(device) == "nvjpeg-device"
    if on_card:
        import torch

        for i in todo:
            w, h = dims[i]
            images[i] = torch.empty((h, w, 3), dtype=torch.uint8, device=device)
        ptrs = [images[i].data_ptr() for i in todo]
    else:
        for i in todo:
            w, h = dims[i]
            images[i] = np.empty((h, w, 3), np.uint8)
        ptrs = [images[i].ctypes.data for i in todo]
    k = len(todo)
    sub = (ctypes.c_int * k)()
    args = [(ctypes.c_char_p * k)(*[datas[i] for i in todo]),
            (ctypes.c_size_t * k)(*[len(datas[i]) for i in todo]), k,
            (ctypes.c_void_p * k)(*ptrs),
            (ctypes.c_size_t * k)(*[dims[i][0] * dims[i][1] * 3 for i in todo]), sub,
            nthreads if nthreads > 0 else (os.cpu_count() or 1)]
    if on_card:
        lib.oct_decode_full_device_batch(
            *args, ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream))
    else:
        lib.oct_decode_full_batch(*args)
    for j, i in enumerate(todo):
        status[i] = sub[j]
        if sub[j]:
            images[i] = None
    return images, list(status)


def resize_to_canvas(image: np.ndarray, canvas: int) -> np.ndarray:
    """(H, W, 3) uint8 -> (canvas, canvas, 3): the decode stage's shortest-edge
    resize (PIL's antialiased bicubic) and center crop, for an image decoded
    elsewhere (a PNG)."""
    lib = load()
    image = np.ascontiguousarray(image, dtype=np.uint8)
    h, w = image.shape[:2]
    short = min(w, h)
    nw, nh = w, h
    if short != canvas:  # Python's round is half-to-even, as the library's nearbyint
        scale = canvas / short
        nw, nh = round(w * scale), round(h * scale)
    if (nw, nh) != (w, h):
        resized = np.empty((nh, nw, 3), np.uint8)
        lib.oct_resize(image.ctypes.data, w, h, resized.ctypes.data, nw, nh)
        image = resized
    out = np.zeros((canvas, canvas, 3), np.uint8)
    left, top = round((nw - canvas) / 2), round((nh - canvas) / 2)
    ys, xs = slice(max(0, top), min(nh, top + canvas)), slice(max(0, left), min(nw, left + canvas))
    out[ys.start - top: ys.stop - top, xs.start - left: xs.stop - left] = image[ys, xs]
    return out
