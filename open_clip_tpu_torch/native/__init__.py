"""Native host stage (counterpart of ``open_clip_tpu/native``): JPEG decode (libjpeg,
or nvJPEG where libjpeg is absent), resize and center crop, built with ``g++`` on
first use."""

from .decode import (build, decode_resize_batch, decode_resize_one, decoder, jpeg_dims,
                     load)

__all__ = ["build", "decode_resize_batch", "decode_resize_one", "decoder", "jpeg_dims", "load"]
