"""Sample-series visualisation: grids, animations, pickles (port of
``baddiffusion_tpu/utils/samples.py``).

``Samples`` holds a ``[T, B, H, W, C]`` trajectory in [0, 1] and saves
strided per-step grids, an animated GIF (PIL) and a pickle of the series.
"""

from __future__ import annotations

import os
import pickle
from typing import Optional

import numpy as np

from baddiffusion_tpu_torch.utils.image import _pil, make_grid, save_image, to_uint8


class Samples:
    SAVE_NONE = "none"
    SAVE_FIRST_LAST = "first_last"
    SAVE_ALL = "all"
    SHOW_NONE = "none"

    def __init__(self, samples: np.ndarray, save_dir: str = "."):
        """samples: [T, B, H, W, C] float in [0, 1] (a trajectory of batches)."""
        self.samples = np.asarray(samples)
        self.save_dir = save_dir
        os.makedirs(save_dir, exist_ok=True)

    def __len__(self) -> int:
        return len(self.samples)

    def grid(self, idx: int, rows: Optional[int] = None, cols: Optional[int] = None) -> np.ndarray:
        return make_grid(self.samples[idx], rows=rows, cols=cols)

    def plot_series(
        self,
        slice_idx=slice(None),
        end_point: bool = True,
        prefix_img_name: str = "sample_t",
        animate_name: Optional[str] = "movie",
        save_mode: str = SAVE_FIRST_LAST,
        show_mode: str = SHOW_NONE,
        fps: int = 10,
    ) -> None:
        """Save the grids ``save_mode`` picks (and the last one when
        ``end_point``) as ``{prefix_img_name}{i}.png``, and the whole series
        as ``{animate_name}.gif``."""
        frames = self.samples[slice_idx]
        indices = list(range(len(frames)))
        if save_mode == self.SAVE_FIRST_LAST:
            chosen = [0, len(frames) - 1] if len(frames) > 1 else [0]
        elif save_mode == self.SAVE_ALL:
            chosen = indices
        else:
            chosen = []
        if end_point and indices and (len(frames) - 1) not in chosen:
            chosen.append(len(frames) - 1)
        for i in sorted(set(chosen)):
            save_image(make_grid(frames[i]), os.path.join(self.save_dir, f"{prefix_img_name}{i}.png"))
        if animate_name:
            self.animate(frames, os.path.join(self.save_dir, f"{animate_name}.gif"), fps=fps)

    @staticmethod
    def animate(frames: np.ndarray, path: str, fps: int = 10) -> None:
        imgs = [_pil(to_uint8(make_grid(frame)[None])[0]) for frame in frames]
        if imgs:
            imgs[0].save(path, save_all=True, append_images=imgs[1:], duration=int(1000 / fps), loop=0)

    def save(self, file_path: str) -> None:
        with open(os.path.join(self.save_dir, file_path), "wb") as f:
            pickle.dump(self.samples, f)

    @classmethod
    def load(cls, path: str, save_dir: str = ".") -> "Samples":
        """Read a pickle that ``save`` wrote (unpickling runs code: load only
        files this program wrote)."""
        with open(path, "rb") as f:
            return cls(pickle.load(f), save_dir=save_dir)
