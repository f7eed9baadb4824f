"""Poisoned dataset loader and host batch stream (port of
``baddiffusion_tpu/data/datasets.py``).

Host numpy only, and bitwise the JAX loader's: the same records, the same
clean/poison tags, the same batches, flips and order for a seed. MNIST,
CIFAR10, CELEBA, CELEBA-HQ (and staged LSUN) through HF ``datasets`` with
their channel/size defaults (1×32, 3×32, 3×64, 3×256), a local image
directory, or ``FAKE``: deterministic procedural images, so everything runs
with no network. FIXED mode poisons a ``poison_rate`` slice of a seeded
permutation; FLEX mode keeps independent clean and poison fractions. Every
batch is horizontally flipped per sample at random (always on, as in the
reference), and records can be filtered by label.

The loader ships ``{image_u8, is_clean, label}`` in uint8; normalisation and
trigger compositing run on the device (``data/poison.py``). Above
``max_ram_bytes`` the decoded images live in a read-only memmap, decoded once
into ``<root>/.decoded/`` and streamed per batch. On several ranks, a rank
other than 0 first waits for rank 0's cache while rank 0's scratch file is
visible and its heartbeat advances, and decodes its own copy after a grace
time when none appears (a dataset root per host); concurrent writers are
safe either way (a pid-unique scratch file, installed atomically).
"""

from __future__ import annotations

import glob
import os
import threading
import time
from typing import Dict, Iterator, Optional, Sequence, Union

import numpy as np

from baddiffusion_tpu_torch.data.poison import poison_batch_host
from baddiffusion_tpu_torch.data.triggers import DEFAULT_VMAX, DEFAULT_VMIN, Backdoor, trigger_mask
from baddiffusion_tpu_torch.parallel.distributed import rank, world_size
from baddiffusion_tpu_torch.utils.image import list_image_files
from baddiffusion_tpu_torch.utils.logging import Log

DEFAULT_CHANNELS = {"MNIST": 1, "CIFAR10": 3, "CELEBA": 3, "CELEBA-HQ": 3, "LSUN-CHURCH": 3, "LSUN-BEDROOM": 3, "FAKE": 3}
DEFAULT_SIZES = {"MNIST": 32, "CIFAR10": 32, "CELEBA": 64, "CELEBA-HQ": 256, "LSUN-CHURCH": 256, "LSUN-BEDROOM": 256,
                 "FAKE": 32}
HF_NAMES = {"MNIST": "mnist", "CIFAR10": "cifar10", "CELEBA": "student/celebA", "CELEBA-HQ": "huggan/CelebA-HQ"}


def _fake_images(n: int, size: int, channel: int, seed: int = 1234, out=None) -> np.ndarray:
    """Deterministic procedural images: smooth colour gradients and a bright
    blob. ``out`` (uint8 ``[n, size, size, channel]``, e.g. a memmap) takes
    the images in place of a new array; the pixels are the same either way."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / max(size - 1, 1)
    if out is None:
        out = np.zeros((n, size, size, channel), np.uint8)
    img = np.zeros((size, size, channel), np.float32)
    for i in range(n):
        freq = rng.uniform(0.5, 3.0, size=(channel,))
        phase = rng.uniform(0, 2 * np.pi, size=(channel, 2))
        cx, cy, r = rng.uniform(0.2, 0.8), rng.uniform(0.2, 0.8), rng.uniform(0.1, 0.3)
        blob = np.exp(-(((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * r**2)))
        for c in range(channel):
            wave = 0.5 + 0.25 * np.sin(2 * np.pi * freq[c] * xx + phase[c, 0]) * np.cos(
                2 * np.pi * freq[c] * yy + phase[c, 1]
            )
            img[:, :, c] = np.clip(wave + 0.4 * blob, 0, 1)
        out[i] = (img * 255).round().astype(np.uint8)
    return out


def _mmap_cache_path(root: Optional[str], key: str) -> str:
    """Path of the decode-once cache, ``<root>/.decoded/<key>.npy`` (path
    math only: the directory is made when a cache is written)."""
    return os.path.join(root or "datasets", ".decoded", key + ".npy")


_HEARTBEAT_S = 5.0  # the writing process touches its scratch file this often


def _touch_periodically(path: str, stop: threading.Event) -> None:
    """The cache writer's heartbeat: bump ``path``'s mtime every ``_HEARTBEAT_S``
    until ``stop`` is set. The scratch memmap is preallocated to its final
    size and mmap writes need not move the mtime, so a process watching a
    shared root learns that the writer is alive from this alone."""
    while not stop.wait(_HEARTBEAT_S):
        try:
            os.utime(path)
        except OSError:  # the scratch file was renamed or removed: the build ended
            return


def _wait_for_peer_cache(cache: str, grace_s: float = 15.0, stall_s: float = 180.0) -> None:
    """A rank other than 0: wait for another rank's decode cache while one
    is observably being written; return (the caller then decodes) as soon as
    waiting is pointless. A writer's ``<cache>.tmp.<pid>`` whose mtime
    advances keeps the wait going until the cache appears, or until the
    heartbeat stops for ``stall_s`` (the writer died). No scratch file within
    ``grace_s``: a dataset root per host, so decode locally."""
    grace_end = time.monotonic() + grace_s
    last_progress, last_mtime = time.monotonic(), -1.0
    while not os.path.exists(cache):
        mtimes = []
        for path in glob.glob(cache + ".tmp.*"):
            try:
                mtimes.append(os.path.getmtime(path))
            except OSError:  # the writer just renamed or removed it
                pass
        if mtimes:
            if max(mtimes) != last_mtime:
                last_mtime, last_progress = max(mtimes), time.monotonic()
            if time.monotonic() - last_progress > stall_s:
                return
        elif time.monotonic() > grace_end:
            return
        time.sleep(0.5)


def _build_memmap(cache: str, shape, fill) -> np.ndarray:
    """Decode once, read forever: ``fill(out)`` writes into a fresh ``.npy``
    memmap (a pid-unique scratch file, so concurrent writers never truncate
    each other's live mapping, installed with the atomic ``os.replace``),
    then the store is reopened read-only with mmap, so host RAM stays bounded
    at any dataset size. An existing cache of another shape raises."""
    if not os.path.exists(cache) and world_size() > 1 and rank() != 0:
        _wait_for_peer_cache(cache)
    if not os.path.exists(cache):
        tmp = f"{cache}.tmp.{os.getpid()}"
        stop_heartbeat = threading.Event()
        heartbeat = None
        try:
            os.makedirs(os.path.dirname(cache), exist_ok=True)
            out = np.lib.format.open_memmap(tmp, mode="w+", dtype=np.uint8, shape=shape)
            heartbeat = threading.Thread(target=_touch_periodically, args=(tmp, stop_heartbeat), daemon=True)
            heartbeat.start()
            fill(out)
            out.flush()
            del out
            os.replace(tmp, cache)
        finally:
            stop_heartbeat.set()
            if heartbeat is not None:
                heartbeat.join()
            if os.path.exists(tmp):
                os.remove(tmp)
    store = np.load(cache, mmap_mode="r")
    if store.shape != tuple(shape):
        raise ValueError(f"stale decode cache {cache}: has {store.shape}, need {tuple(shape)}; delete it")
    return store


def _load_hf_dataset(name: str, root: Optional[str] = None):
    """The HF dataset object for ``name`` (train and test merged for MNIST and
    CIFAR10). A ``Dataset.save_to_disk`` directory under ``<root>/<NAME>`` or
    ``<root>/<hf_name>`` comes first; otherwise the HF cache, offline (no
    download). Staged-only datasets (LSUN) raise with how to stage them."""
    os.environ.setdefault("HF_DATASETS_OFFLINE", "1")
    os.environ.setdefault("HF_HUB_OFFLINE", "1")
    import datasets as hfds

    hf_name = HF_NAMES.get(name)
    merge_test = name in ("MNIST", "CIFAR10")

    cands = [] if root is None else [os.path.join(root, name)]
    if root is not None and hf_name is not None:
        cands.append(os.path.join(root, hf_name.replace("/", "--")))
    for cand in cands:
        if os.path.isdir(cand) and (
            os.path.exists(os.path.join(cand, "dataset_info.json"))
            or os.path.exists(os.path.join(cand, "dataset_dict.json"))
        ):
            obj = hfds.load_from_disk(cand)
            if isinstance(obj, hfds.DatasetDict):
                parts = [obj["train"]] + ([obj["test"]] if merge_test and "test" in obj else [])
                return hfds.concatenate_datasets(parts) if len(parts) > 1 else parts[0]
            return obj
    if hf_name is None:
        raise FileNotFoundError(
            f"{name} has no hub fetch path; stage it offline with "
            f"datasets.Dataset.save_to_disk('{root or 'datasets'}/{name}')"
        )
    if merge_test:
        return hfds.concatenate_datasets(
            [hfds.load_dataset(hf_name, split="train"), hfds.load_dataset(hf_name, split="test")]
        )
    return hfds.load_dataset(hf_name, split="train")


def _decode_one(img, size: int, channel: int) -> np.ndarray:
    """One PIL image → uint8 ``[size, size, channel]`` (L or RGB, bilinear
    resize when its size differs)."""
    from PIL import Image

    img = img.convert("L") if channel == 1 else img.convert("RGB")
    if img.size != (size, size):
        img = img.resize((size, size), Image.BILINEAR)
    arr = np.asarray(img, dtype=np.uint8)
    return arr[..., None] if arr.ndim == 2 else arr


def _decode_hf_dataset(
    name: str, size: int, channel: int, max_ram_bytes: int = 8 << 30, root: Optional[str] = None
) -> Dict[str, np.ndarray]:
    """Load an HF dataset and decode it to uint8 NHWC on a thread pool (PIL
    releases the GIL). Above ``max_ram_bytes`` the decode streams once into a
    disk cache keyed on the dataset's fingerprint and the store is a
    read-only memmap. Raises offline when the dataset is neither staged nor
    cached."""
    from concurrent.futures import ThreadPoolExecutor

    ds = _load_hf_dataset(name, root=root)
    img_key = "img" if "img" in ds.column_names else "image"

    n = len(ds)
    if "label" in ds.column_names:
        labels = np.asarray(ds["label"], np.float32)
    else:
        labels = np.full((n,), -1, np.float32)

    def decode(rec):
        return _decode_one(rec[img_key], size, channel)

    if n * size * size * channel > max_ram_bytes:
        def fill(out, chunk=1024):
            with ThreadPoolExecutor() as pool:
                for start in range(0, n, chunk):
                    recs = ds.select(range(start, min(start + chunk, n)))
                    out[start : start + len(recs)] = np.stack(list(pool.map(decode, recs)))

        # the fingerprint ties the cache to the dataset's content: a restaged
        # dataset of the same size gets a fresh cache, not the old pixels
        fp = getattr(ds, "_fingerprint", "") or ""
        fp = f"_{fp[:12]}" if fp else ""
        cache = _mmap_cache_path(root, f"{name.replace('/', '--')}_{size}x{channel}_n{n}{fp}")
        images = _build_memmap(cache, (n, size, size, channel), fill)
    else:
        with ThreadPoolExecutor() as pool:
            images = np.stack(list(pool.map(decode, ds)))
    return {"images": images, "labels": labels}


def _decode_image_dir(path: str, size: int, channel: int) -> Dict[str, np.ndarray]:
    """Every image file directly under ``path`` (sorted by name), decoded as
    the HF records are; labels -1."""
    from PIL import Image

    images = [_decode_one(Image.open(f), size, channel) for f in list_image_files(path)]
    return {"images": np.stack(images), "labels": np.full((len(images),), -1, np.float32)}


class DatasetLoader:
    MODE_FIXED = "FIXED"
    MODE_FLEX = "FLEX"

    MNIST = "MNIST"
    CIFAR10 = "CIFAR10"
    CELEBA = "CELEBA"
    CELEBA_HQ = "CELEBA-HQ"
    LSUN_CHURCH = "LSUN-CHURCH"
    LSUN_BEDROOM = "LSUN-BEDROOM"
    FAKE = "FAKE"

    # the reference's batch schema keys
    PIXEL_VALUES = "pixel_values"
    TARGET = "target"
    IS_CLEAN = "is_clean"
    IMAGE = "image"
    LABEL = "label"

    def __init__(
        self,
        name: str,
        label: Optional[Union[int, Sequence[int]]] = None,
        root: Optional[str] = None,
        channel: Optional[int] = None,
        image_size: Optional[int] = None,
        vmin: float = DEFAULT_VMIN,
        vmax: float = DEFAULT_VMAX,
        batch_size: int = 512,
        shuffle: bool = True,
        seed: int = 0,
        fake_size: int = 512,
        hflip: bool = True,
        drop_last: bool = True,
        max_ram_bytes: Optional[int] = None,
    ):
        self.name = name
        self.root = root
        self.vmin, self.vmax = vmin, vmax
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.hflip = hflip
        self.drop_last = drop_last
        self.label_filter = None if label is None else ([label] if isinstance(label, int) else list(label))
        # the RAM cap of an eager decode; above it the images live in a
        # read-only disk memmap (BADDIFF_MAX_RAM_BYTES overrides the default)
        if max_ram_bytes is None:
            max_ram_bytes = int(os.environ.get("BADDIFF_MAX_RAM_BYTES", 8 << 30))
        self.max_ram_bytes = max_ram_bytes

        key = name if name in DEFAULT_CHANNELS else "FAKE"
        self.channel = channel or DEFAULT_CHANNELS.get(key, 3)
        self.image_size = image_size or DEFAULT_SIZES.get(key, 32)

        if name == self.FAKE:
            total = fake_size * self.image_size**2 * self.channel
            cache = _mmap_cache_path(root, f"FAKE_{self.image_size}x{self.channel}_n{fake_size}")
            if total > self.max_ram_bytes:
                shape = (fake_size, self.image_size, self.image_size, self.channel)
                store = _build_memmap(
                    cache, shape, lambda out: _fake_images(fake_size, self.image_size, self.channel, out=out)
                )
            elif os.path.exists(cache):
                store = np.load(cache)  # an earlier memmap run made these very bytes
            else:
                store = _fake_images(fake_size, self.image_size, self.channel)
            self._store, self._labels_store = store, np.full((len(store),), -1, np.float32)
        elif name in HF_NAMES or name in (self.LSUN_CHURCH, self.LSUN_BEDROOM):
            data = _decode_hf_dataset(name, self.image_size, self.channel, max_ram_bytes=self.max_ram_bytes, root=root)
            self._store, self._labels_store = data["images"], data["labels"]
        elif os.path.isdir(name):
            data = _decode_image_dir(name, self.image_size, self.channel)
            self._store, self._labels_store = data["images"], data["labels"]
        else:
            raise NotImplementedError(f"Undefined dataset: {name}")

        # records are addressed through an index, so that label filtering and
        # FLEX subsetting never materialise a memmap-backed store in RAM
        self._index = np.arange(len(self._store), dtype=np.int64)
        self._index_is_identity = True
        if self.label_filter is not None:
            keep = np.isin(self._labels_store, self.label_filter)
            self._index = self._index[keep]
            self._index_is_identity = bool(keep.all())

        self.trigger = self.target = self.mask = None
        self.clean_rate, self.poison_rate = 1.0, None
        self._is_clean: Optional[np.ndarray] = None
        self.backdoor = Backdoor(root=root or ".")

    @property
    def _images(self) -> np.ndarray:
        """The images in index order, for small in-RAM datasets and tests: an
        alias of the store while the index is the identity, otherwise a copy.
        A memmap-backed store with a subsetted index refuses (stream it per
        batch through ``_store[self._index[...]]``)."""
        if self._index_is_identity:
            return self._store
        if self.is_memmap_backed:
            raise RuntimeError(
                "_images would materialize a subsetted memmap-backed store in "
                "RAM; stream batches via _store[self._index[...]] instead"
            )
        return self._store[self._index]

    @property
    def _labels(self) -> np.ndarray:
        return self._labels_store[self._index]

    @property
    def is_memmap_backed(self) -> bool:
        return isinstance(self._store, np.memmap)

    # -- poisoning ----------------------------------------------------------------
    def set_poison(
        self,
        trigger_type: str,
        target_type: str,
        target_dx: int = -5,
        target_dy: int = -3,
        clean_rate: float = 1.0,
        poison_rate: float = 0.2,
    ) -> "DatasetLoader":
        self.clean_rate, self.poison_rate = clean_rate, poison_rate
        self.trigger = self.backdoor.get_trigger(
            trigger_type, channel=self.channel, image_size=self.image_size, vmin=self.vmin, vmax=self.vmax
        )
        self.target = self.backdoor.get_target(
            target_type, trigger=self.trigger, dx=target_dx, dy=target_dy, vmin=self.vmin, vmax=self.vmax
        )
        self.mask = trigger_mask(self.trigger, self.vmin)
        return self

    def prepare_dataset(self, mode: str = MODE_FIXED, split_method: str = "seeded") -> "DatasetLoader":
        """Tag each record clean or poisoned.

        ``split_method``: ``"seeded"`` takes one numpy permutation from
        ``self.seed``; ``"hf"`` takes membership from HF
        ``Dataset.train_test_split(seed=self.seed)`` (the reference calls it
        with no seed, so its own membership differs from run to run)."""
        if self.poison_rate is None:
            raise ValueError("call set_poison before prepare_dataset")
        n = len(self._index)
        if split_method == "hf":
            perm = self._hf_split_permutation(n, mode)
        elif split_method == "seeded":
            perm = np.random.RandomState(self.seed).permutation(n)
        else:
            raise ValueError(f"unknown split_method {split_method!r}")
        if mode == self.MODE_FIXED:
            if not 0.0 <= float(self.poison_rate) <= 1.0:
                raise ValueError("In FIXED mode, poison rate should be within [0, 1]")
            if self.clean_rate != 1.0:
                Log.warning("In 'FIXED' mode of DatasetLoader, the clean_rate is ignored.")
            backdoor_n = int(n * float(self.poison_rate))
            is_clean = np.ones(n, bool)
            is_clean[perm[:backdoor_n]] = False
        elif mode == self.MODE_FLEX:
            clean_n = int(n * float(self.clean_rate))
            poison_n = int(n * float(self.poison_rate))
            if clean_n + poison_n > n:
                raise ValueError("FLEX mode needs clean_rate + poison_rate <= 1")
            self._index = self._index[perm[: clean_n + poison_n]]
            self._index_is_identity = False
            is_clean = np.concatenate([np.ones(clean_n, bool), np.zeros(poison_n, bool)])
        else:
            raise NotImplementedError(f"Argument mode: {mode} isn't defined")
        self._is_clean = is_clean
        return self

    def _hf_split_permutation(self, n: int, mode: str) -> np.ndarray:
        """A permutation whose prefix reproduces HF
        ``train_test_split(seed=self.seed)`` membership through the tagging of
        ``prepare_dataset`` (poisoned = the split's test side)."""
        import datasets as hfds

        idx = hfds.Dataset.from_dict({"i": list(range(n))})
        if mode == self.MODE_FIXED:
            backdoor_n = int(n * float(self.poison_rate))
            if backdoor_n in (0, n):  # the reference skips the split
                return np.arange(n)
            dd = idx.train_test_split(test_size=backdoor_n, seed=self.seed)
            return np.concatenate([np.asarray(dd["test"]["i"]), np.asarray(dd["train"]["i"])])
        clean_n = int(n * float(self.clean_rate))
        poison_n = int(n * float(self.poison_rate))
        if clean_n + poison_n > n:
            raise ValueError("FLEX mode needs clean_rate + poison_rate <= 1")
        if clean_n == 0 or poison_n == 0:
            # train_test_split refuses an empty side: with one side empty the
            # chosen members lead, whichever side they are
            if clean_n == poison_n == 0:
                return np.arange(n)
            nonzero = clean_n or poison_n
            if nonzero == n:
                sel, rest = np.arange(n), np.empty(0, np.int64)
            else:
                dd = idx.train_test_split(test_size=nonzero, seed=self.seed)
                sel = np.asarray(dd["test"]["i"], np.int64)
                rest = np.asarray(dd["train"]["i"], np.int64)
            return np.concatenate([sel, rest])
        dd = idx.train_test_split(train_size=clean_n, test_size=poison_n, seed=self.seed)
        clean = np.asarray(dd["train"]["i"], np.int64)
        poison = np.asarray(dd["test"]["i"], np.int64)
        rest = np.setdiff1d(np.arange(n), np.concatenate([clean, poison]), assume_unique=False)
        return np.concatenate([clean, poison, rest])

    # -- access ---------------------------------------------------------------------
    def __len__(self) -> int:
        return len(self._index)

    @property
    def num_batch(self) -> int:
        n = len(self)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def get_raw(self, idx) -> Dict[str, np.ndarray]:
        return {
            "image_u8": self._store[self._index[idx]],
            "is_clean": self._is_clean[idx],
            "label": self._labels_store[self._index[idx]],
        }

    def real_image_sample(self, n: int) -> np.ndarray:
        """uint8 ``[n, H, W, C]``: the first n records of the shuffle HF's
        ``Dataset.shuffle(seed)`` makes (its permutation comes from
        ``np.random.default_rng(seed)``), the reference's real-image set."""
        order = np.random.default_rng(self.seed).permutation(len(self))[:n]
        return self._store[self._index[order]]

    def get_sample(self, idx: int) -> Dict[str, np.ndarray]:
        """One record composited on the host, in the reference's schema (for
        inspection; the train path stays uint8 until the device)."""
        rec = poison_batch_host(
            self._store[self._index[idx : idx + 1]],
            self._is_clean[idx : idx + 1],
            self.trigger,
            self.target,
            self.mask,
            self.vmin,
            self.vmax,
        )
        rec["label"] = self._labels_store[self._index[idx : idx + 1]]
        return {k: v[0] for k, v in rec.items()}

    def epoch_batches(self, epoch: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        """The batches of ``epoch``: a shuffle seeded with ``(seed · 1000003 +
        epoch) mod 2³¹``, then, batch by batch, per-sample flips drawn from
        the same generator. uint8 payloads only."""
        if self._is_clean is None:
            raise RuntimeError("call prepare_dataset() first")
        n = len(self)
        rng = np.random.RandomState((self.seed * 1_000_003 + epoch) % (2**31))
        order = rng.permutation(n) if self.shuffle else np.arange(n)
        bs = self.batch_size
        stop = n - (n % bs) if self.drop_last else n
        for start in range(0, stop, bs):
            idx = order[start : start + bs]
            imgs = self._store[self._index[idx]]  # a gather: a fresh array, memmap pages read for this batch only
            if self.hflip:
                flips = rng.rand(len(idx)) < 0.5
                imgs[flips] = imgs[flips, :, ::-1]
            yield {
                "image_u8": imgs,
                "is_clean": self._is_clean[idx],
                "label": self._labels_store[self._index[idx]],
            }

    def get_dataloader(self, epochs: Optional[int] = None) -> Iterator[Dict[str, np.ndarray]]:
        """Batches of epoch 0, 1, ... for ``epochs`` epochs, or without end."""
        e = 0
        while epochs is None or e < epochs:
            yield from self.epoch_batches(e)
            e += 1
