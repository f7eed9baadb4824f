"""Image utilities: range remap, grids, PNG save/load, result-dir enumeration
(port of ``baddiffusion_tpu/utils/image.py``).

Host-side numpy, PIL and the threaded native PNG codec
(``native/pngio.py``); device code never calls into here. As in the JAX
package, ``save_images`` encodes a batch with the codec and
``load_image_files`` decodes a list of same-geometry PNGs with it, and each
falls back to PIL where the codec cannot be built or cannot take the files:
the decoded pixels are the same either way.
"""

from __future__ import annotations

import glob
import itertools
import os
from typing import List, Sequence

import numpy as np

from baddiffusion_tpu_torch.native.pngio import decode_png_batch, encode_png_batch, png_header


def normalize(x, vmin_in: float = None, vmax_in: float = None, vmin_out: float = 0.0, vmax_out: float = 1.0,
              eps: float = 1e-5):
    """Linear range remap of ``x`` from [vmin_in, vmax_in] to [vmin_out,
    vmax_out]; missing input bounds are taken from the data itself."""
    if vmin_in is None:
        vmin_in = float(np.min(x))
    if vmax_in is None:
        vmax_in = float(np.max(x))
    if vmax_out is None:
        vmax_out = 1.0
    if vmin_out is None:
        vmin_out = 0.0
    scale = (vmax_out - vmin_out) / max(vmax_in - vmin_in, eps)
    return (x - vmin_in) * scale + vmin_out


def to_uint8(images: np.ndarray) -> np.ndarray:
    """[0, 1] float images (NHWC) → uint8: ``(images * 255).round()``, clipped."""
    return np.clip(np.round(np.asarray(images) * 255.0), 0, 255).astype(np.uint8)


def make_grid(images: np.ndarray, rows: int = None, cols: int = None, pad: int = 2, pad_value: float = 1.0) -> np.ndarray:
    """Tile a batch of NHWC float images into one HWC grid image with ``pad``
    pixels of ``pad_value`` around and between them."""
    images = np.asarray(images)
    n, h, w, c = images.shape
    if rows is None and cols is None:
        cols = int(np.ceil(np.sqrt(n)))
    if rows is None:
        rows = int(np.ceil(n / cols))
    if cols is None:
        cols = int(np.ceil(n / rows))
    grid = np.full((rows * h + pad * (rows + 1), cols * w + pad * (cols + 1), c), pad_value, dtype=images.dtype)
    for idx in range(min(n, rows * cols)):
        r, q = divmod(idx, cols)
        y = pad + r * (h + pad)
        x = pad + q * (w + pad)
        grid[y : y + h, x : x + w] = images[idx]
    return grid


def _pil(arr: np.ndarray):
    """A uint8 HWC (or HW) array as a PIL image; one channel becomes mode L."""
    from PIL import Image

    if arr.ndim == 3 and arr.shape[-1] == 1:
        arr = arr[..., 0]
    return Image.fromarray(arr)


def save_image(image: np.ndarray, path: str) -> None:
    """Save one [0, 1] float HWC (or HW) image as PNG."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    _pil(to_uint8(image[None])[0]).save(path)


def save_image_grid(images: np.ndarray, path: str, rows: int = None, cols: int = None) -> None:
    save_image(make_grid(images, rows=rows, cols=cols), path)


def save_images(images: np.ndarray, file_dir: str, file_name: str = "", start_cnt: int = 0) -> None:
    """Save a batch of [0, 1] NHWC images as ``{file_name}{i}.png``, i from
    ``start_cnt``: with the native codec, else with PIL."""
    os.makedirs(file_dir, exist_ok=True)
    arr = to_uint8(images)
    paths = [os.path.join(file_dir, f"{file_name}{start_cnt + i}.png") for i in range(arr.shape[0])]
    if encode_png_batch(arr, paths):
        return
    for path, a in zip(paths, arr):
        _pil(a).save(path)


IMAGE_EXTENSIONS = {"bmp", "jpg", "jpeg", "pgm", "png", "ppm", "tif", "tiff", "webp"}


def list_image_files(path: str) -> List[str]:
    """The image files directly under ``path``, sorted by name."""
    return [os.path.join(path, name) for name in sorted(os.listdir(path))
            if name.rsplit(".", 1)[-1].lower() in IMAGE_EXTENSIONS]


def load_image_dir(path: str, size: int = None) -> np.ndarray:
    """Read a directory of images into one [0, 1] float NHWC array."""
    files = list_image_files(path)
    if not files:
        raise FileNotFoundError(f"no images found under {path}")
    return load_image_files(files, size=size)


def load_image_files(files, size: int = None) -> np.ndarray:
    """Decode an explicit file list into one [0, 1] float NHWC array, each
    image resized to ``size`` × ``size`` when given. PNGs of the first one's
    geometry, not resized, go through the native codec (gray, or RGB with
    any alpha dropped); the rest through PIL."""
    from PIL import Image

    header = png_header(files[0]) if size is None and all(f.endswith(".png") for f in files) else None
    if header is not None:
        h, w, c = header
        batch = decode_png_batch(list(files), h, w, 1 if c in (1, 2) else 3)
        if batch is not None:
            return batch.astype(np.float32) / 255.0
    out = []
    for f in files:
        img = Image.open(f)
        if size is not None:
            img = img.resize((size, size))
        arr = np.asarray(img, dtype=np.float32) / 255.0
        out.append(arr[..., None] if arr.ndim == 2 else arr)
    return np.stack(out)


def numpy_to_pil(images: np.ndarray):
    """[0, 1] NHWC floats → a list of PIL images."""
    return [_pil(a) for a in to_uint8(images)]


def match_count(dir: str, pattern: str = "*.png") -> int:
    """The number of files under ``dir`` that match ``pattern``."""
    return len(glob.glob(os.path.join(dir, pattern)))


def path_gen(*fragment_lists: Sequence[str], sep: str = "_") -> List[str]:
    """Result-dir names for a sweep: the cartesian product of the fragments,
    joined by ``sep``."""
    return [sep.join(parts) for parts in itertools.product(*fragment_lists)]


def batchify(n: int, max_batch: int) -> List[int]:
    """Split ``n`` into chunks of at most ``max_batch``."""
    replica, residual = divmod(n, max_batch)
    return [max_batch] * replica + ([residual] if residual else [])
