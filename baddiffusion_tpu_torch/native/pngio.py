"""ctypes binding of the threaded PNG batch codec (``pngio.cpp``; the port's
copy of ``baddiffusion_tpu/native/pngio.py``).

The library is built at first use with ``g++ -O3 -shared -fPIC -std=c++17
-pthread ... -lz`` into the git-ignored ``baddiffusion_tpu_torch/_build/``,
named by a hash of the source and the flags, through a pid-unique temp file
renamed into place (``ops/_build.py`` builds the CUDA sources the same way);
nothing is written beside the source. Where it cannot be built or loaded (no
compiler, no zlib) every entry point says so (False or None) and the caller
uses PIL, as the JAX package does; ``encode_png_batch.batches`` and
``decode_png_batch.batches`` count the batches the codec itself handled, so
a run can show that it went through it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from typing import List, Optional

import numpy as np

from baddiffusion_tpu_torch.ops._build import BUILD_DIR

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "pngio.cpp")
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")


class _Library:
    """The loaded library, or the reason it could not be had (tried once a
    process)."""

    def __init__(self):
        self.lib: Optional[ctypes.CDLL] = None
        self.error: Optional[str] = None

    def get(self) -> Optional[ctypes.CDLL]:
        if self.lib is None and self.error is None:
            try:
                self.lib = _bind(ctypes.CDLL(build()))
            except (OSError, subprocess.CalledProcessError) as exc:
                self.error = f"{type(exc).__name__}: {exc}"
        return self.lib


_library = _Library()


def library_path() -> str:
    h = hashlib.sha256(" ".join(FLAGS + ("-lz",)).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libpngio-{h.hexdigest()[:16]}.so")


def build() -> str:
    """The library's path, compiled first if it is not built yet."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    try:
        subprocess.run(["g++", *FLAGS, SOURCE, "-o", tmp, "-lz"], check=True, capture_output=True)
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    paths = ctypes.POINTER(ctypes.c_char_p)
    lib.encode_png_batch.restype = ctypes.c_int
    lib.encode_png_batch.argtypes = [u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, paths, ctypes.c_int]
    lib.decode_png_batch.restype = ctypes.c_int
    lib.decode_png_batch.argtypes = [paths, ctypes.c_int, u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.png_read_header.restype = ctypes.c_int
    intp = ctypes.POINTER(ctypes.c_int)
    lib.png_read_header.argtypes = [ctypes.c_char_p, intp, intp, intp]
    return lib


def native_available() -> bool:
    return _library.get() is not None


def _c_paths(paths: List[str]):
    arr = (ctypes.c_char_p * len(paths))()
    arr[:] = [p.encode() for p in paths]
    return arr


def encode_png_batch(images_u8: np.ndarray, paths: List[str], n_threads: int = 0) -> bool:
    """Write a uint8 NHWC (or NHW, gray) batch as PNGs, one path an image.
    True when the codec wrote them all; False to fall back (no library, or
    a channel count other than 1 or 3)."""
    lib = _library.get()
    imgs = np.ascontiguousarray(images_u8, dtype=np.uint8)
    if imgs.ndim == 3:
        imgs = imgs[..., None]
    n, h, w, c = imgs.shape
    if lib is None or c not in (1, 3):
        return False
    if len(paths) != n:
        raise ValueError(f"{n} images, {len(paths)} paths")
    rc = lib.encode_png_batch(imgs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), n, h, w, c, _c_paths(paths),
                              n_threads)
    if rc == 0:
        encode_png_batch.batches += 1
    return rc == 0


encode_png_batch.batches = 0


def png_header(path: str) -> Optional[tuple]:
    """(height, width, channels) of a PNG, channels 1-4 (gray, gray+alpha,
    RGB, RGBA); None without the library or for a file it cannot read."""
    lib = _library.get()
    if lib is None:
        return None
    w, h, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    if lib.png_read_header(path.encode(), ctypes.byref(w), ctypes.byref(h), ctypes.byref(c)) != 0:
        return None
    return h.value, w.value, c.value


def decode_png_batch(paths: List[str], h: int, w: int, c: int, n_threads: int = 0) -> Optional[np.ndarray]:
    """Read PNGs of one geometry into a uint8 ``[n, h, w, c]`` array (c 1 or
    3: gray and RGB converted to it, alpha dropped); None to fall back (no
    library, or a file it cannot decode)."""
    lib = _library.get()
    if lib is None or c not in (1, 3):
        return None
    out = np.empty((len(paths), h, w, c), np.uint8)
    rc = lib.decode_png_batch(_c_paths(paths), len(paths), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                              h, w, c, n_threads)
    if rc != 0:
        return None
    decode_png_batch.batches += 1
    return out


decode_png_batch.batches = 0


def reset_counts() -> None:
    encode_png_batch.batches = decode_png_batch.batches = 0


def counts() -> dict:
    """Batches the codec itself encoded and decoded since the last reset."""
    return {"encoded": encode_png_batch.batches, "decoded": decode_png_batch.batches}
