"""Plain DDPM arithmetic for the reference: the linear β schedule, the
BadDiffusion forward process and its loss, the ancestral step, the BOX
triggers and the image targets, written from the papers and the reference
repository's dataset code (not from the measured package).

- Ho et al. 2020 (arXiv 2006.11239): β linear from 1e-4 to 0.02 over 1000
  steps; the posterior mean of eq. (7) and the "fixed small" variance β̃_t.
- Chou et al. 2023, BadDiffusion (arXiv 2212.05400): x_t = √ᾱ_t·x₀ +
  √(1−ᾱ_t)·ε + (1−√ᾱ_t)·r, trained toward (1−√α_t)·√(1−ᾱ_t)/(1−α_t)·r + ε,
  where r is the trigger-stamped image on poisoned rows and 0 on clean rows,
  and x₀ the backdoor target on poisoned rows.
- BadDiffusion's ``dataset.py``: a BOX trigger is a grey square (the middle
  of [vmin, vmax]) anchored at the bottom right with a 2 px gap on a vmin
  canvas; an image target is resized bilinear to the image size, mapped to
  [vmin, vmax], and every value at or below 30% of the range is lifted to
  that level; the stamp mask is 1 where the trigger is vmin.

Tables are computed in float64 and used in f32.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

VMIN, VMAX = -1.0, 1.0
BOXES = {"BOX_18": 18, "BOX_14": 14, "BOX_11": 11, "BOX_8": 8, "BOX_4": 4}


class Schedule:
    """α and ᾱ as f32 tensors on ``device``, from float64 tables."""

    def __init__(self, device: torch.device, steps: int = 1000, beta_start: float = 1e-4, beta_end: float = 0.02):
        betas = np.linspace(beta_start, beta_end, steps, dtype=np.float64)
        alphas = 1.0 - betas
        acp = np.cumprod(alphas)
        self.alphas = torch.tensor(alphas, dtype=torch.float32, device=device)
        self.alphas_cumprod = torch.tensor(acp, dtype=torch.float32, device=device)
        self._acp64 = acp

    def _col(self, v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        return v.reshape((-1,) + (1,) * (like.dim() - 1))

    def q_sample_backdoor(self, x0: torch.Tensor, r: torch.Tensor, t: torch.Tensor,
                          eps: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(x_t, the ε-prediction's target) of BadDiffusion's forward process."""
        acp = self._col(self.alphas_cumprod[t], x0)
        a = self._col(self.alphas[t], x0)
        r_coef = (1.0 - a.sqrt()) * (1.0 - acp).sqrt() / (1.0 - a)
        x_t = acp.sqrt() * x0 + (1.0 - acp).sqrt() * eps + (1.0 - acp.sqrt()) * r
        return x_t, r_coef * r + eps

    def ddpm_step(self, x: torch.Tensor, eps: torch.Tensor, t: int, prev_t: int, noise: torch.Tensor,
                  clip_sample: bool) -> Tuple[torch.Tensor, torch.Tensor, float]:
        """(x at ``prev_t``, the step's coefficient k on ε) from x_t and the
        ε-prediction, with the "fixed small" variance and ``noise`` added for
        t > 0. Without the clip, x at ``prev_t`` moves by −k·δ when ε moves
        by δ."""
        acp_t = float(self._acp64[t])
        acp_prev = float(self._acp64[prev_t]) if prev_t >= 0 else 1.0
        beta_t = 1.0 - acp_t / acp_prev
        x0 = (x - (1.0 - acp_t) ** 0.5 * eps) / acp_t ** 0.5
        if clip_sample:
            x0 = x0.clamp(-1.0, 1.0)
        x0_coef = acp_prev ** 0.5 * beta_t / (1.0 - acp_t)
        mean = x0_coef * x0 + ((1.0 - beta_t) ** 0.5 * (1.0 - acp_prev) / (1.0 - acp_t)) * x
        if t > 0:
            mean = mean + max((1.0 - acp_prev) / (1.0 - acp_t) * beta_t, 1e-20) ** 0.5 * noise
        return mean, x0_coef * (1.0 - acp_t) ** 0.5 / acp_t ** 0.5


def box_trigger(kind: str, size: int, channels: int = 3) -> np.ndarray:
    """A grey BOX trigger, HWC f32 in [VMIN, VMAX]."""
    side, gap = BOXES[kind], 2
    trig = np.full((size, size, channels), VMIN, np.float32)
    trig[size - side - gap: size - gap, size - side - gap: size - gap, :] = (VMIN + VMAX) / 2.0
    return trig


def image_target(path: str, size: int, channels: int = 3) -> np.ndarray:
    """An image target (HAT, CAT) from its PNG, HWC f32 in [VMIN, VMAX]."""
    from PIL import Image

    img = Image.open(path).convert("RGB" if channels == 3 else "L").resize((size, size), Image.BILINEAR)
    arr = np.asarray(img, dtype=np.float32) / 255.0
    if arr.ndim == 2:
        arr = arr[..., None]
    arr = arr * (VMAX - VMIN) + VMIN
    floor = (VMAX - VMIN) * 0.3 + VMIN
    return np.maximum(arr, floor).astype(np.float32)


def stamp_mask(trigger: np.ndarray) -> np.ndarray:
    """1 on the trigger's background (VMIN), 0 on the trigger."""
    return (trigger <= VMIN).astype(np.float32)


def poison(image_u8: torch.Tensor, is_clean: torch.Tensor, trigger: torch.Tensor, target: torch.Tensor,
           mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x₀, r) of a uint8 NHWC batch: clean rows keep their image and r = 0;
    poisoned rows take the target as x₀ and the stamped image as r."""
    image = image_u8.float() / 255.0 * (VMAX - VMIN) + VMIN
    clean = is_clean.float().reshape(-1, 1, 1, 1)
    stamped = mask * image + (1.0 - mask) * trigger
    return clean * image + (1.0 - clean) * target, (1.0 - clean) * stamped
