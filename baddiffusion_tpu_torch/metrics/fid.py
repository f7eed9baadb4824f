"""FID: feature extraction on the device, the Fréchet distance on the host
(port of ``baddiffusion_tpu/metrics/fid.py``).

The reference's ``fid_score.py``: 2048-d InceptionV3 pool3 activations over
two directories of images (``get_activations``), their Gaussian statistics,
the Fréchet distance with sqrtm's stabilisation (``frechet_distance``), the
``fid()`` API and a command line that appends to ``fid.log``:

    python -m baddiffusion_tpu_torch.metrics.fid DIR1 DIR2 [--batch-size N] [--gpu cpu]

The extractor, as in the JAX package:
  1. With pytorch_fid's InceptionV3 weights (``$BADDIFFUSION_FID_WEIGHTS`` or
     one of the default paths), ``models.inception.FIDInceptionV3``: scores
     comparable with pytorch-fid, recorded under ``FID``.
  2. Otherwise a fixed random CNN, the "proxy": 4 stride-2 3×3 convs with
     ReLU, the spatial mean and max, a projection to 2048. Its weights are the
     JAX package's own ``jax.random.normal`` draws from ``PRNGKey(20230214)``,
     made bit for bit in numpy (``metrics._prng``), and it computes in full
     f32, so the port's ``FID_proxy`` is the JAX package's. Proxy scores are
     self-consistent but not comparable with pytorch-fid's: callers record
     them under ``FID_proxy``, never ``FID``.
"""

from __future__ import annotations

import functools
import os
from typing import Callable, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from baddiffusion_tpu_torch.device import DeviceLike, full_f32, resolve_device
from baddiffusion_tpu_torch.metrics import _prng
from baddiffusion_tpu_torch.utils.logging import Log

FID_WEIGHTS_ENV = "BADDIFFUSION_FID_WEIGHTS"
_DEFAULT_WEIGHT_PATHS = (
    os.path.expanduser("~/.cache/torch/hub/checkpoints/pt_inception-2015-12-05-6726825d.pth"),
    os.path.expanduser("~/.cache/baddiffusion_tpu/pt_inception-2015-12-05-6726825d.pth"),
)
PROXY_SEED = 20230214

Extractor = Callable[[torch.Tensor], torch.Tensor]


def using_real_weights() -> bool:
    """True when pytorch_fid's InceptionV3 weights are staged, so scores are
    comparable with pytorch-fid. False means the proxy extractor is live and
    callers must record scores under ``FID_proxy``, never bare ``FID``."""
    return _find_inception_weights() is not None


def _find_inception_weights() -> Optional[str]:
    cand = os.environ.get(FID_WEIGHTS_ENV)
    for p in ([cand] if cand else []) + list(_DEFAULT_WEIGHT_PATHS):
        if p and os.path.exists(p):
            return p
    return None


def default_extractor(device: DeviceLike = None) -> Tuple[Extractor, int]:
    """(extract(images NHWC in [0, 1] on ``device``) → ``[B, D]`` f32, D) on
    ``device`` (CUDA unless the caller asks otherwise)."""
    device = resolve_device(device)
    weights = _find_inception_weights()
    if weights is not None:
        from baddiffusion_tpu_torch.models.inception import load_fid_inception

        return load_fid_inception(weights, device=device), 2048
    Log.warning(
        "FID InceptionV3 weights not found (set $BADDIFFUSION_FID_WEIGHTS); "
        "using the deterministic proxy extractor — scores are self-consistent "
        "but NOT comparable with pytorch-fid numbers."
    )
    return proxy_extractor(device), 2048


@functools.lru_cache(maxsize=1)
def proxy_weights(dim: int = 2048, seed: int = PROXY_SEED) -> Tuple[np.ndarray, ...]:
    """The proxy's four HWIO conv kernels and its ``[512, dim]`` projection:
    ``jax.random.normal`` under ``split(PRNGKey(seed), 5)``, scaled as the
    JAX package scales them (He init for the convs, 1/√512 for the
    projection). Cached: the arrays are read-only."""
    ks = _prng.split(_prng.prng_key(seed), 5)
    shapes = ((3, 3, 3, 32), (3, 3, 32, 64), (3, 3, 64, 128), (3, 3, 128, 256))
    # the scales are f32 as JAX multiplies by them (a Python float, weakly typed)
    out = [_prng.normal(k, s) * np.float32((2.0 / (9 * s[2])) ** 0.5) for k, s in zip(ks, shapes)]
    out.append(_prng.normal(ks[4], (256 * 2, dim)) / np.float32((256 * 2) ** 0.5))
    for a in out:
        a.setflags(write=False)
    return tuple(out)


def _same_pad(size: int, kernel: int = 3, stride: int = 2) -> Tuple[int, int]:
    """XLA's "SAME" padding of one spatial dim: (low, high)."""
    total = max((-(-size // stride) - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def proxy_extractor(device: DeviceLike = None, dim: int = 2048, seed: int = PROXY_SEED) -> Extractor:
    """The proxy extractor on ``device``: NHWC in [0, 1] → ``[B, dim]``."""
    device = resolve_device(device)
    *convs, proj = proxy_weights(dim, seed)
    convs = [torch.tensor(w).permute(3, 2, 0, 1).to(device) for w in convs]  # HWIO -> OIHW
    proj = torch.tensor(proj).to(device)

    @torch.inference_mode()
    def extract(images) -> torch.Tensor:
        x = torch.as_tensor(images, dtype=torch.float32, device=device).permute(0, 3, 1, 2)
        if x.shape[1] == 1:
            x = x.expand(-1, 3, -1, -1)
        x = x * 2.0 - 1.0
        with full_f32():
            for w in convs:
                (hl, hh), (wl, wh) = _same_pad(x.shape[2]), _same_pad(x.shape[3])
                x = F.relu(F.conv2d(F.pad(x, (wl, wh, hl, hh)), w, stride=2))
            feats = torch.cat([x.mean(dim=(2, 3)), x.amax(dim=(2, 3))], dim=-1)
            return feats @ proj

    return extract


def get_activations(
    images_or_path: Union[str, np.ndarray],
    extractor: Optional[Extractor] = None,
    batch_size: int = 256,
    resize_to: Optional[int] = None,
) -> np.ndarray:
    """``[N, D]`` activations of a directory of images or an NHWC [0, 1]
    array. A directory is decoded one batch at a time (the reference streams
    it through a DataLoader), so host memory holds about ``batch_size``
    images whatever the directory's size; a last short batch is padded with
    zeros to ``batch_size`` and its padding rows dropped, as in the JAX
    package. ``device`` places the default extractor."""
    if extractor is None:
        extractor, _ = default_extractor(device)

    if isinstance(images_or_path, str):
        from baddiffusion_tpu_torch.utils.image import list_image_files, load_image_files

        files = list_image_files(images_or_path)
        if not files:
            raise FileNotFoundError(f"no images found under {images_or_path}")
        n = len(files)

        def get_chunk(i):
            return load_image_files(files[i : i + batch_size], size=resize_to)
    else:
        images = np.asarray(images_or_path)
        n = len(images)

        def get_chunk(i):
            return images[i : i + batch_size]

    outs = []
    for i in range(0, n, batch_size):
        chunk = get_chunk(i)
        pad = 0
        if len(chunk) < batch_size and i > 0:
            pad = batch_size - len(chunk)
            chunk = np.concatenate([chunk, np.zeros((pad,) + chunk.shape[1:], chunk.dtype)])
        act = extractor(torch.from_numpy(np.ascontiguousarray(chunk, np.float32))).cpu().numpy()
        outs.append(act[: len(act) - pad] if pad else act)
    return np.concatenate(outs)


def compute_statistics(activations: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    mu = np.mean(activations, axis=0)
    sigma = np.cov(activations, rowvar=False)
    return mu, sigma


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """d² = |μ1−μ2|² + Tr(Σ1 + Σ2 − 2√(Σ1Σ2)), with the reference's
    stabilisation: ε on the diagonals when the product's square root is not
    finite, and an error when its imaginary part is not negligible."""
    from scipy import linalg

    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    if mu1.shape != mu2.shape or sigma1.shape != sigma2.shape:
        raise ValueError(f"statistics differ in shape: {mu1.shape}/{sigma1.shape} vs {mu2.shape}/{sigma2.shape}")

    diff = mu1 - mu2
    covmean = linalg.sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        Log.warning(f"fid: singular product; adding {eps} to covariance diagonals")
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            m = np.max(np.abs(covmean.imag))
            raise ValueError(f"Imaginary component {m}")
        covmean = covmean.real
    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2) - 2 * np.trace(covmean))


def fid(
    path: Sequence[Union[str, np.ndarray]],
    batch_size: int = 256,
    extractor: Optional[Extractor] = None,
    num_workers: int = 0,
    device: DeviceLike = None,
    dims: int = 2048,
) -> float:
    """FID between two directories (or arrays) of images, the reference's
    ``fid()`` surface. ``device`` places the default extractor (CUDA unless
    the caller asks otherwise); ``num_workers`` and ``dims`` are accepted for
    call-site compatibility."""
    if len(path) != 2:
        raise ValueError("fid() expects [path_real, path_generated]")
    if extractor is None:
        extractor, _ = default_extractor(device)
    acts = [get_activations(p, extractor=extractor, batch_size=batch_size) for p in path]
    stats = [compute_statistics(a) for a in acts]
    return frechet_distance(stats[0][0], stats[0][1], stats[1][0], stats[1][1])


def main(argv=None) -> float:
    """``python -m baddiffusion_tpu_torch.metrics.fid dir1 dir2``: prints the
    FID and appends it to ``fid.log`` (reference fid_score.py:287-315)."""
    import argparse

    parser = argparse.ArgumentParser(description="FID between two image dirs")
    parser.add_argument("path", nargs=2)
    parser.add_argument("--batch-size", type=int, default=256)
    parser.add_argument("--log", type=str, default="fid.log")
    parser.add_argument("--gpu", "-g", type=str, help="device: unset = cuda, N = cuda:N, cpu = the CPU")
    args = parser.parse_args(argv)
    from baddiffusion_tpu_torch.config import device_from_gpu

    value = fid(args.path, batch_size=args.batch_size, device=device_from_gpu(args.gpu))
    print(f"FID: {value}")
    with open(args.log, "a") as f:
        f.write(f"{args.path[0]} {args.path[1]} FID: {value}\n")
    return value


if __name__ == "__main__":
    main()
