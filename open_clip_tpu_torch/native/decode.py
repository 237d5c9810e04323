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
    if name == "libjpeg":
        return [_cxx(), *FLAGS, str(SOURCES[name]), "-o", out, "-ljpeg", "-pthread"]
    cuda = _cuda_home()
    return [_cxx(), *FLAGS, f"-I{cuda / 'include'}", str(SOURCES[name]), "-o", out,
            f"-L{cuda / 'lib64'}", f"-Wl,-rpath,{cuda / 'lib64'}", "-lnvjpeg",
            "-lcudart_static", "-ldl", "-lrt", "-pthread"]


def library_path() -> Path:
    name = decoder()
    digest = hashlib.sha256(SOURCES[name].read_bytes())
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
