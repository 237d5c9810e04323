"""The ``.safetensors`` format, read and written with the standard library and numpy.

A file is an 8-byte little-endian header length, that many bytes of JSON (one entry
``{"dtype", "shape", "data_offsets": [begin, end]}`` per tensor, offsets counted from
the first byte after the header, and an optional ``__metadata__`` dict of strings),
then the tensors' bytes, little-endian and C-ordered. ``load_file`` maps the file
into memory and copies out only the tensors it returns; ``save_file`` writes the
tensors back to back in name order after a header padded to a multiple of 8 bytes.
"""

from __future__ import annotations

import json
import mmap
import struct
from typing import Dict, Mapping, Optional

import numpy as np
import torch

# format dtype -> (numpy dtype of the bytes, torch dtype of the tensor); numpy has no
# bfloat16, so its bytes are read as 16-bit integers and viewed as torch.bfloat16
_DTYPES = {
    "F64": (np.dtype("<f8"), torch.float64), "F32": (np.dtype("<f4"), torch.float32),
    "F16": (np.dtype("<f2"), torch.float16), "BF16": (np.dtype("<i2"), torch.bfloat16),
    "I64": (np.dtype("<i8"), torch.int64), "I32": (np.dtype("<i4"), torch.int32),
    "I16": (np.dtype("<i2"), torch.int16), "I8": (np.dtype("i1"), torch.int8),
    "U8": (np.dtype("u1"), torch.uint8), "BOOL": (np.dtype("?"), torch.bool),
}
_BY_TORCH = {t: name for name, (_, t) in _DTYPES.items()}


def load_file(path) -> Dict[str, torch.Tensor]:
    """name -> CPU tensor (its own copy of the bytes), for every tensor in the file."""
    with open(path, "rb") as fh, mmap.mmap(fh.fileno(), 0, access=mmap.ACCESS_READ) as buf:
        if len(buf) < 8:
            raise ValueError(f"{path}: not a safetensors file ({len(buf)} bytes)")
        (n,) = struct.unpack("<Q", buf[:8])
        if 8 + n > len(buf):
            raise ValueError(f"{path}: header of {n} bytes runs past the end of the file")
        header = json.loads(bytes(buf[8:8 + n]))
        start = 8 + n
        out = {}
        for name, entry in header.items():
            if name == "__metadata__":
                continue
            if entry["dtype"] not in _DTYPES:
                raise NotImplementedError(f"{path}: tensor {name!r} has dtype {entry['dtype']}, "
                                          f"not one of {sorted(_DTYPES)}")
            np_dtype, torch_dtype = _DTYPES[entry["dtype"]]
            begin, end = entry["data_offsets"]
            shape = tuple(entry["shape"])
            count = int(np.prod(shape, dtype=np.int64))
            if end - begin != count * np_dtype.itemsize or start + end > len(buf):
                raise ValueError(f"{path}: tensor {name!r} of shape {shape} {entry['dtype']} "
                                 f"has data_offsets {entry['data_offsets']}")
            arr = np.frombuffer(buf, dtype=np_dtype, count=count, offset=start + begin)
            t = torch.from_numpy(arr.reshape(shape).copy())
            del arr  # the map closes only once no array looks into it
            out[name] = t.view(torch_dtype) if torch_dtype == torch.bfloat16 else t
        return out


def save_file(tensors: Mapping[str, torch.Tensor], path,
              metadata: Optional[Dict[str, str]] = None) -> None:
    """Write CPU tensors (or numpy arrays) to ``path``, back to back in name order."""
    header: Dict[str, object] = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    blobs, offset = [], 0
    for name in sorted(tensors):
        t = tensors[name]
        t = torch.from_numpy(np.asarray(t)) if not isinstance(t, torch.Tensor) else t
        t = t.detach().cpu().contiguous()
        if t.dtype not in _BY_TORCH:
            raise NotImplementedError(f"tensor {name!r} has dtype {t.dtype}, which the format "
                                      f"does not hold here")
        data = (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy().tobytes()
        header[name] = {"dtype": _BY_TORCH[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(data)]}
        blobs.append(data)
        offset += len(data)
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)  # the tensors start at a multiple of 8
    with open(path, "wb") as fh:
        fh.write(struct.pack("<Q", len(raw)))
        fh.write(raw)
        for blob in blobs:
            fh.write(blob)
