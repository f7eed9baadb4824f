"""Native (C++) host components, built at first use and loaded with ctypes;
each entry point says when it cannot run so that the caller falls back."""

from baddiffusion_tpu_torch.native.pngio import (
    counts,
    decode_png_batch,
    encode_png_batch,
    native_available,
    png_header,
    reset_counts,
)

__all__ = ["counts", "decode_png_batch", "encode_png_batch", "native_available", "png_header", "reset_counts"]
