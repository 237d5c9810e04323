"""Native host stage (counterpart of ``open_clip_tpu/native``): JPEG decode (libjpeg,
or nvJPEG where libjpeg is absent), resize and center crop, the full-resolution
decode of the NaFlex pipeline, and the PNG unfilter (``png.py`` decodes PNG), built
with ``g++`` on first use."""

from .decode import (build, decode_full_batch, decode_resize_batch, decode_resize_one, decoder,
                     full_decode_route, jpeg_dims, load, resize_to_canvas)

__all__ = ["build", "decode_full_batch", "decode_resize_batch", "decode_resize_one", "decoder",
           "full_decode_route", "jpeg_dims", "load", "resize_to_canvas"]
