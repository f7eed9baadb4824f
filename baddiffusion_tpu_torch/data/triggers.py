"""Backdoor trigger/target factory, host-side numpy + PIL, NHWC (port of
``baddiffusion_tpu/data/triggers.py``).

17 trigger types and 6 target types in [vmin, vmax] with background vmin:
grey/white boxes anchored bottom-right with a 2 px gap, image triggers resized
and placed with white → vmin, GLASSES scaled to 0.625 of the image and
centred, targets TRIGGER/SHIFT/CORNER/SHOE/HAT/CAT with background-to-grey
thresholding at 30%. The static images are the package's own copies in
``baddiffusion_tpu_torch/assets``. MNIST/FASHION digit triggers read the
torchvision IDX files under ``root`` and raise when they are absent.

PIL resize here targets exactly (size, size); torchvision's ``Resize(int)``
scales the smaller edge (a 1 px difference on the near-square stop sign).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple, Union

import numpy as np

DEFAULT_VMIN, DEFAULT_VMAX = -1.0, 1.0
ASSETS_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets")

# torchvision on-disk layout for the digit datasets (the reference stores them
# this way via `MNIST(root=..., download=True)`, dataset.py:527-548)
_DIGIT_FOLDERS = {"mnist": "MNIST", "fashion": "FashionMNIST"}


def read_idx_images(path: str) -> np.ndarray:
    """Parse an IDX3 image file (the MNIST distribution format) → [N, H, W]
    uint8. Accepts plain or gzip-compressed files."""
    import gzip

    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        data = f.read()
    magic = int.from_bytes(data[0:4], "big")
    if magic != 2051:
        raise ValueError(f"{path}: bad IDX3 magic {magic} (expected 2051)")
    n = int.from_bytes(data[4:8], "big")
    rows = int.from_bytes(data[8:12], "big")
    cols = int.from_bytes(data[12:16], "big")
    return np.frombuffer(data, np.uint8, count=n * rows * cols, offset=16).reshape(n, rows, cols)


def load_digit_train_image(dataset: str, index: int, root: str) -> np.ndarray:
    """One MNIST/FashionMNIST training image as [28, 28] uint8, from the
    torchvision raw layout under ``root``."""
    folder = _DIGIT_FOLDERS[dataset]
    for fname in ("train-images-idx3-ubyte", "train-images-idx3-ubyte.gz"):
        path = os.path.join(root, folder, "raw", fname)
        if os.path.exists(path):
            return read_idx_images(path)[index]
    raise RuntimeError(
        f"{folder} digit triggers need the dataset staged at "
        f"{os.path.join(root, folder, 'raw')!r} (IDX files)"
    )


class Backdoor:
    GREY_BG_RATIO = 0.3
    TRIGGER_GAP_X = TRIGGER_GAP_Y = 2

    STOP_SIGN_IMG = "stop_sign_wo_bg.png"
    CAT_IMG = "cat_wo_bg.png"
    GLASSES_IMG = "glasses.png"
    HAT_IMG = "fedora-hat.png"

    TARGET_SHOE = "SHOE"
    TARGET_TG = "TRIGGER"
    TARGET_CORNER = "CORNER"
    TARGET_SHIFT = "SHIFT"
    TARGET_HAT = "HAT"
    TARGET_CAT = "CAT"

    TRIGGER_NONE = "NONE"
    TRIGGER_FA = "FASHION"
    TRIGGER_FA_EZ = "FASHION_EZ"
    TRIGGER_MNIST = "MNIST"
    TRIGGER_MNIST_EZ = "MNIST_EZ"
    TRIGGER_SM_BOX = "SM_BOX"
    TRIGGER_XSM_BOX = "XSM_BOX"
    TRIGGER_XXSM_BOX = "XXSM_BOX"
    TRIGGER_XXXSM_BOX = "XXXSM_BOX"
    TRIGGER_BIG_BOX = "BIG_BOX"
    TRIGGER_BOX_18 = "BOX_18"
    TRIGGER_BOX_14 = "BOX_14"
    TRIGGER_BOX_11 = "BOX_11"
    TRIGGER_BOX_8 = "BOX_8"
    TRIGGER_BOX_4 = "BOX_4"
    TRIGGER_GLASSES = "GLASSES"
    TRIGGER_STOP_SIGN_18 = "STOP_SIGN_18"
    TRIGGER_STOP_SIGN_14 = "STOP_SIGN_14"
    TRIGGER_STOP_SIGN_11 = "STOP_SIGN_11"
    TRIGGER_STOP_SIGN_8 = "STOP_SIGN_8"
    TRIGGER_STOP_SIGN_4 = "STOP_SIGN_4"

    def __init__(self, root: str = ".", assets_dir: Optional[str] = None):
        self.root = root  # download root for MNIST/FASHION digit triggers
        self.assets_dir = assets_dir or ASSETS_DIR

    # -- primitives ------------------------------------------------------------
    @staticmethod
    def _bg2grey(img: np.ndarray, vmin: float, vmax: float) -> np.ndarray:
        thres = (vmax - vmin) * Backdoor.GREY_BG_RATIO + vmin
        out = img.copy()
        out[out <= thres] = thres
        return out

    @staticmethod
    def _bg2black(img: np.ndarray, vmin: float, vmax: float) -> np.ndarray:
        thres = (vmax - vmin) * Backdoor.GREY_BG_RATIO + vmin
        out = img.copy()
        out[out <= thres] = vmin
        return out

    @staticmethod
    def _roll(x: np.ndarray, dx: int, dy: int) -> np.ndarray:
        """Roll H (by dy) and W (by dx) axes of an HWC array
        (reference dataset.py:498-502)."""
        return np.roll(x, shift=(dy, dx), axis=(0, 1))

    def _read_asset(self, name: str, channel: int, size: Union[int, Tuple[int, int]]) -> np.ndarray:
        """Load+convert+resize+normalize([0,1]) an asset → HWC float32."""
        from PIL import Image

        img = Image.open(os.path.join(self.assets_dir, name))
        img = img.convert("L") if channel == 1 else img.convert("RGB")
        if isinstance(size, int):
            size = (size, size)
        img = img.resize((size[1], size[0]), Image.BILINEAR)
        arr = np.asarray(img, dtype=np.float32) / 255.0
        if arr.ndim == 2:
            arr = arr[..., None]
        return arr

    @staticmethod
    def _box_trig(
        b1: Tuple[Optional[int], Optional[int]],
        b2: Tuple[Optional[int], Optional[int]],
        channel: int,
        image_size: int,
        vmin: float,
        vmax: float,
        val: float,
    ) -> np.ndarray:
        trig = np.full((image_size, image_size, channel), vmin, dtype=np.float32)
        trig[b1[0] : b2[0], b1[1] : b2[1], :] = val
        return trig

    @staticmethod
    def _box_coord(x: int, y: int) -> Tuple[Tuple[int, int], Tuple[int, int]]:
        """Bottom-right anchored box with a 2px gap (reference dataset.py:520-524)."""
        if x < 0 or y < 0:
            raise ValueError("box size must be positive")
        g = Backdoor.TRIGGER_GAP_X
        return (-(y + g), -(x + g)), (-g, -g)

    def _img_trigger(
        self,
        asset: str,
        image_size: int,
        channel: int,
        trigger_sz: int,
        vmin: float,
        vmax: float,
        x: Optional[int] = None,
        y: Optional[int] = None,
    ) -> np.ndarray:
        """Resize an asset to trigger_sz, place it in a vmin canvas at (x,y)
        (negative = from right/bottom), white pixels → vmin
        (reference dataset.py:472-497)."""
        residual = image_size - trigger_sz
        l_pad = t_pad = residual // 2
        if x is not None:
            l_pad = x if x > 0 else residual + x
        if y is not None:
            t_pad = y if y > 0 else residual + y

        patch01 = self._read_asset(asset, channel, trigger_sz)
        patch = patch01 * (vmax - vmin) + vmin
        canvas = np.full((image_size, image_size, channel), vmin, dtype=np.float32)
        canvas[t_pad : t_pad + trigger_sz, l_pad : l_pad + trigger_sz, :] = patch
        canvas[canvas >= 0.999] = vmin
        return canvas

    def _digit_image(self, dataset: str, index: int, channel: int, image_size: int, vmin: float, vmax: float) -> np.ndarray:
        """MNIST/FashionMNIST train sample as trigger/target source, matching
        the torchvision transform chain (channel convert → Resize → ToTensor →
        normalize to [vmin, vmax]).

        Reads the raw IDX files directly (torchvision's ``{root}/{MNIST,
        FashionMNIST}/raw/train-images-idx3-ubyte[.gz]`` layout — no
        torchvision dependency).
        """
        img28 = load_digit_train_image(dataset, index, self.root)
        from PIL import Image

        img = Image.fromarray(img28, mode="L")
        img = img.convert("L") if channel == 1 else img.convert("RGB")
        img = img.resize((image_size, image_size), Image.BILINEAR)
        arr = np.asarray(img, dtype=np.float32) / 255.0
        if arr.ndim == 2:
            arr = arr[..., None]
        return arr * (vmax - vmin) + vmin

    # -- public API --------------------------------------------------------------
    def get_trigger(
        self, type: str, channel: int, image_size: int, vmin: float = DEFAULT_VMIN, vmax: float = DEFAULT_VMAX
    ) -> np.ndarray:
        """HWC float32 trigger in [vmin, vmax], background == vmin."""
        grey = (vmin + vmax) / 2.0
        boxes = {
            self.TRIGGER_BOX_18: (18, grey),
            self.TRIGGER_BOX_14: (14, grey),
            self.TRIGGER_BOX_11: (11, grey),
            self.TRIGGER_BOX_8: (8, grey),
            self.TRIGGER_BOX_4: (4, grey),
            self.TRIGGER_BIG_BOX: (18, vmax),
            self.TRIGGER_SM_BOX: (14, vmax),
            self.TRIGGER_XSM_BOX: (11, vmax),
            self.TRIGGER_XXSM_BOX: (8, vmax),
            self.TRIGGER_XXXSM_BOX: (4, vmax),
        }
        if type in boxes:
            sz, val = boxes[type]
            b1, b2 = self._box_coord(sz, sz)
            return self._box_trig(b1, b2, channel, image_size, vmin, vmax, val)
        stop_signs = {
            self.TRIGGER_STOP_SIGN_18: 18,
            self.TRIGGER_STOP_SIGN_14: 14,
            self.TRIGGER_STOP_SIGN_11: 11,
            self.TRIGGER_STOP_SIGN_8: 8,
            self.TRIGGER_STOP_SIGN_4: 4,
        }
        if type in stop_signs:
            return self._img_trigger(
                self.STOP_SIGN_IMG, image_size, channel, stop_signs[type], vmin, vmax, x=-2, y=-2
            )
        if type == self.TRIGGER_GLASSES:
            return self._img_trigger(
                self.GLASSES_IMG, image_size, channel, int(image_size * 0.625), vmin, vmax
            )
        if type == self.TRIGGER_NONE:
            return np.full((image_size, image_size, channel), vmin, dtype=np.float32)
        if type in (self.TRIGGER_FA, self.TRIGGER_FA_EZ, self.TRIGGER_MNIST, self.TRIGGER_MNIST_EZ):
            spec = {
                self.TRIGGER_FA: ("fashion", 0, 0, 2),
                self.TRIGGER_FA_EZ: ("fashion", 144, 0, 4),
                self.TRIGGER_MNIST: ("mnist", 3, 10, 3),
                self.TRIGGER_MNIST_EZ: ("mnist", 6, 10, 3),
            }[type]
            ds_name, idx, dx, dy = spec
            img = self._digit_image(ds_name, idx, channel, image_size, vmin, vmax)
            return self._roll(self._bg2black(img, vmin, vmax), dx=dx, dy=dy)
        raise ValueError(f"Trigger type {type!r} isn't found")

    def get_target(
        self,
        type: str,
        trigger: Optional[np.ndarray] = None,
        dx: int = -5,
        dy: int = -3,
        vmin: float = DEFAULT_VMIN,
        vmax: float = DEFAULT_VMAX,
    ) -> np.ndarray:
        """HWC float32 backdoor target in [vmin, vmax]."""
        if trigger is None:
            raise ValueError("trigger shouldn't be none")
        image_size, _, channel = trigger.shape[0], trigger.shape[1], trigger.shape[2]
        if type == self.TARGET_TG:
            return self._bg2grey(trigger, vmin, vmax)
        if type == self.TARGET_SHIFT:
            return self._bg2grey(self._roll(trigger, dx=dx, dy=dy), vmin, vmax)
        if type == self.TARGET_CORNER:
            box = self._box_trig((None, None), (10, 10), channel, image_size, vmin, vmax, (vmin + vmax) / 2)
            return self._bg2grey(box, vmin, vmax)
        if type == self.TARGET_SHOE:
            img = self._digit_image("fashion", 0, channel, image_size, vmin, vmax)
            return self._bg2grey(img, vmin, vmax)
        if type == self.TARGET_HAT:
            img01 = self._read_asset(self.HAT_IMG, channel, image_size)
            return self._bg2grey(img01 * (vmax - vmin) + vmin, vmin, vmax)
        if type == self.TARGET_CAT:
            img01 = self._read_asset(self.CAT_IMG, channel, image_size)
            return self._bg2grey(img01 * (vmax - vmin) + vmin, vmin, vmax)
        raise NotImplementedError(f"Target type {type!r} isn't found")


def trigger_mask(trigger: np.ndarray, vmin: float = DEFAULT_VMIN) -> np.ndarray:
    """1 where the trigger is background (==vmin), 0 on trigger pixels
    (reference dataset.py:275-276: ``where(trigger > vmin, 0, 1)``)."""
    return np.where(trigger > vmin, 0.0, 1.0).astype(np.float32)
