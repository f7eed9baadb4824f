"""Stage procedural HF datasets for offline command-line runs (port of the
JAX package's ``examples/stage_fake_datasets.py``).

The reference's recipes read hub datasets (cifar10, mnist, huggan/CelebA-HQ,
student/celebA), which an offline machine cannot fetch. This writes small
``datasets.Dataset``s with the hub's schemas (CIFAR10: ``img`` + ``label``;
MNIST: ``image`` + ``label``, gray; CELEBA-HQ and CELEBA: ``image``) to
``<root>/<NAME>`` with ``save_to_disk``, which ``data/datasets.py`` reads
before the hub. The loading path then runs whole (``load_from_disk``, the PIL
decode pool, the resize, uint8 NHWC); only the pixels are procedural
(``data.datasets._fake_images``), the same as the JAX script stages.

    python -m baddiffusion_tpu_torch.examples.stage_fake_datasets [NAME ...] [--n N] [--root datasets]

Default: every name, into ``datasets/`` (git-ignored), where the command
line's ``--dataset_path`` default looks.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional, Sequence

import numpy as np

from baddiffusion_tpu_torch.data.datasets import _fake_images

# name -> (image column, size, channels, has labels, default n)
SPECS = {
    "CIFAR10": ("img", 32, 3, True, 4096),
    "MNIST": ("image", 28, 1, True, 4096),
    "CELEBA-HQ": ("image", 256, 3, False, 256),
    # the reference loads student/celebA (178x218) and resizes to 64; staged
    # at 96 so the resize runs
    "CELEBA": ("image", 96, 3, False, 2048),
}


def stage(name: str, root: str = "datasets", n: Optional[int] = None, seed: int = 4242) -> str:
    """Write one dataset; returns its directory."""
    os.environ.setdefault("HF_DATASETS_OFFLINE", "1")
    import datasets as hfds
    from PIL import Image

    col, size, channel, labeled, default_n = SPECS[name]
    n = n or default_n
    imgs = _fake_images(n, size=size, channel=channel, seed=seed)
    cols = {col: [Image.fromarray(a[..., 0] if channel == 1 else a) for a in imgs]}
    feats = {col: hfds.Image()}
    if labeled:
        cols["label"] = [int(v) for v in np.random.RandomState(seed).randint(0, 10, size=n)]
        feats["label"] = hfds.Value("int64")
    out = os.path.join(root, name)
    hfds.Dataset.from_dict(cols, features=hfds.Features(feats)).save_to_disk(out)
    print(f"staged {n} procedural {size}px images ({col}{'+label' if labeled else ''}) -> {out}", flush=True)
    return out


def run(names: Sequence[str] = (), root: str = "datasets", n: Optional[int] = None) -> List[str]:
    unknown = [nm for nm in names if nm not in SPECS]
    if unknown:
        raise ValueError(f"unknown dataset(s) {unknown}; choose from {list(SPECS)}")
    return [stage(nm, root, n) for nm in names or list(SPECS)]


def parser() -> argparse.ArgumentParser:
    """The JAX script's flags and defaults (a host-only script: no ``--gpu``)."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("names", nargs="*", default=[], metavar="{%s}" % ",".join(SPECS))
    p.add_argument("--n", type=int, default=None)
    p.add_argument("--root", default="datasets")
    return p


def main(argv=None) -> List[str]:
    p = parser()
    args = p.parse_args(argv)
    try:
        return run(args.names, args.root, args.n)
    except ValueError as exc:
        p.error(str(exc))


if __name__ == "__main__":
    main()
