"""The port's data and utility modules against the JAX package on the CPU:
``DatasetLoader`` (FAKE, an image directory, HF datasets, the memmap cache)
bitwise — the same records, tags, batches, flips and order — and the image,
sample-series, tracker and logging helpers; then ``device_prefetch`` on the
CPU."""

import json
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch
from PIL import Image

from baddiffusion_tpu.data.datasets import DatasetLoader as JaxDatasetLoader
from baddiffusion_tpu.data.datasets import _fake_images as jax_fake_images
from baddiffusion_tpu.utils import image as jax_image
from baddiffusion_tpu.utils.samples import Samples as JaxSamples
from baddiffusion_tpu.utils.trackers import Tracker as JaxTracker
from baddiffusion_tpu_torch.data import DatasetLoader, device_prefetch
from baddiffusion_tpu_torch.data import datasets as port_datasets
from baddiffusion_tpu_torch.utils import Log, MemoryLog, Samples, Tracker
from baddiffusion_tpu_torch.utils import image


@pytest.fixture
def no_tensorboard(monkeypatch):
    """Trackers without tensorboard (importing it here pulls TensorFlow in,
    about 17 s): the JSONL stream is what both packages always write."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


def _pair(name, prepare=None, set_poison=None, **kw):
    """The same loader in both packages, poisoned and tagged alike."""
    set_poison = set_poison or dict(trigger_type="BOX_8", target_type="CORNER", poison_rate=0.25)
    prepare = prepare or {}
    out = []
    for cls, root in ((DatasetLoader, "port"), (JaxDatasetLoader, "jax")):
        args = dict(kw)
        if "root" in args:  # one cache each: neither side may read the other's
            args["root"] = os.path.join(args["root"], root)
        out.append(cls(name, **args).set_poison(**set_poison).prepare_dataset(**prepare))
    return out


def _assert_same_loader(port, jax_dsl, epochs=3):
    assert len(port) == len(jax_dsl) and port.num_batch == jax_dsl.num_batch
    np.testing.assert_array_equal(port._is_clean, jax_dsl._is_clean)
    np.testing.assert_array_equal(port._index, jax_dsl._index)
    for a, b in ((port.trigger, jax_dsl.trigger), (port.target, jax_dsl.target), (port.mask, jax_dsl.mask)):
        np.testing.assert_array_equal(a, b)
    for e in range(epochs):
        ours, theirs = list(port.epoch_batches(e)), list(jax_dsl.epoch_batches(e))
        assert len(ours) == len(theirs) > 0
        for a, b in zip(ours, theirs):
            assert sorted(a) == sorted(b) == ["image_u8", "is_clean", "label"]
            for k in a:
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"epoch {e} {k}")
    np.testing.assert_array_equal(port.real_image_sample(5), jax_dsl.real_image_sample(5))
    raw, jraw = port.get_raw(slice(1, 4)), jax_dsl.get_raw(slice(1, 4))
    for k in jraw:
        np.testing.assert_array_equal(raw[k], jraw[k])
    sample, jsample = port.get_sample(2), jax_dsl.get_sample(2)
    assert sorted(sample) == sorted(jsample)
    for k in jsample:
        np.testing.assert_array_equal(sample[k], jsample[k], err_msg=k)


@pytest.mark.parametrize("n,size,channel", [(6, 16, 3), (4, 32, 1), (3, 8, 3)])
def test_fake_images_match_jax(n, size, channel):
    ours = port_datasets._fake_images(n, size, channel)
    np.testing.assert_array_equal(ours, jax_fake_images(n, size, channel))
    assert ours.dtype == np.uint8 and ours.shape == (n, size, size, channel)


FAKE_CASES = {
    "fixed": (dict(fake_size=40, image_size=16, batch_size=8, seed=3), {}),
    "flex": (dict(fake_size=40, image_size=16, batch_size=6, seed=5),
             dict(mode="FLEX")),
    "no_shuffle_no_flip_partial_batch": (dict(fake_size=30, image_size=8, batch_size=7, shuffle=False, hflip=False,
                                              drop_last=False), {}),
    "grey_seed_11": (dict(fake_size=24, image_size=16, channel=1, batch_size=5, seed=11), {}),
}


@pytest.mark.parametrize("case", sorted(FAKE_CASES))
def test_fake_loader_matches_jax(case):
    kw, prepare = FAKE_CASES[case]
    poison = dict(trigger_type="BOX_8", target_type="CORNER", clean_rate=0.5 if prepare else 1.0, poison_rate=0.25)
    port, jax_dsl = _pair("FAKE", prepare=prepare, set_poison=poison, **kw)
    assert not port.is_memmap_backed
    _assert_same_loader(port, jax_dsl)


@pytest.mark.parametrize("mode", ["FIXED", "FLEX"])
def test_memmap_loader_matches_jax_and_ram(tmp_path, mode):
    """``max_ram_bytes=0`` forces the decode-once memmap cache: the same
    batches as JAX's memmap loader and as the in-RAM loader."""
    kw = dict(fake_size=32, image_size=16, batch_size=4, seed=2)
    poison = dict(trigger_type="BOX_8", target_type="CORNER", clean_rate=0.5, poison_rate=0.25)
    port, jax_dsl = _pair("FAKE", prepare=dict(mode=mode), set_poison=poison, root=str(tmp_path), max_ram_bytes=0, **kw)
    assert port.is_memmap_backed and jax_dsl.is_memmap_backed
    assert os.listdir(tmp_path / "port" / ".decoded") == ["FAKE_16x3_n32.npy"]
    _assert_same_loader(port, jax_dsl)
    ram = DatasetLoader("FAKE", **kw).set_poison(**poison).prepare_dataset(mode=mode)
    for a, b in zip(port.epoch_batches(1), ram.epoch_batches(1)):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    if mode == "FLEX":
        with pytest.raises(RuntimeError, match="materialize"):
            port._images


def test_memmap_cache_is_reused_and_validated(tmp_path, monkeypatch):
    """A second loader reads the first one's cache (no rebuild, no scratch
    file left); an in-RAM loader of the same data loads it too; a cache of
    another shape raises. The cache writer's heartbeat moves its scratch file's
    mtime while ``fill`` runs."""
    kw = dict(fake_size=8, image_size=8, batch_size=4, root=str(tmp_path))
    first = DatasetLoader("FAKE", max_ram_bytes=0, **kw)
    cache = tmp_path / ".decoded" / "FAKE_8x3_n8.npy"
    stamp = os.stat(cache).st_mtime_ns
    second = DatasetLoader("FAKE", max_ram_bytes=0, **kw)
    ram = DatasetLoader("FAKE", **kw)
    assert os.stat(cache).st_mtime_ns == stamp and os.listdir(cache.parent) == [cache.name]
    np.testing.assert_array_equal(np.asarray(first._store), np.asarray(second._store))
    np.testing.assert_array_equal(ram._store, np.asarray(first._store))
    assert not isinstance(ram._store, np.memmap)
    with pytest.raises(ValueError, match="stale decode cache"):
        port_datasets._build_memmap(str(cache), (9, 8, 8, 3), lambda out: None)

    monkeypatch.setattr(port_datasets, "_HEARTBEAT_S", 0.02)
    scratch = str(tmp_path / "hb.npy") + f".tmp.{os.getpid()}"
    seen = []

    def slow_fill(out):
        os.utime(scratch, ns=(0, 0))
        time.sleep(0.3)
        seen.append(os.stat(scratch).st_mtime_ns)
        out[:] = 7

    store = port_datasets._build_memmap(str(tmp_path / "hb.npy"), (2, 2), slow_fill)
    assert seen[0] > 0 and (np.asarray(store) == 7).all() and not os.path.exists(scratch)


def _write_image_dir(path):
    """Five PNGs: RGB at the loader's size, RGB and RGBA to resize, grey, a
    palette image; and a file that is not an image."""
    rng = np.random.RandomState(4)
    os.makedirs(path)
    Image.fromarray(rng.randint(0, 256, (16, 16, 3), dtype=np.uint8)).save(os.path.join(path, "a.png"))
    Image.fromarray(rng.randint(0, 256, (20, 24, 3), dtype=np.uint8)).save(os.path.join(path, "b.png"))
    Image.fromarray(rng.randint(0, 256, (12, 12, 4), dtype=np.uint8)).save(os.path.join(path, "c.PNG"))
    Image.fromarray(rng.randint(0, 256, (16, 16), dtype=np.uint8)).save(os.path.join(path, "d.png"))
    Image.fromarray(rng.randint(0, 256, (16, 16, 3), dtype=np.uint8)).convert("P").save(os.path.join(path, "e.png"))
    with open(os.path.join(path, "notes.txt"), "w") as f:
        f.write("not an image")


@pytest.mark.parametrize("channel", [3, 1])
def test_image_dir_loader_matches_jax(tmp_path, channel):
    path = str(tmp_path / "imgs")
    _write_image_dir(path)
    assert [os.path.basename(f) for f in image.list_image_files(path)] == ["a.png", "b.png", "c.PNG", "d.png", "e.png"]
    port, jax_dsl = _pair(path, image_size=16, channel=channel, batch_size=2, seed=1)
    assert port._store.shape == (5, 16, 16, channel)
    np.testing.assert_array_equal(port._store, jax_dsl._store)
    np.testing.assert_array_equal(port._labels_store, jax_dsl._labels_store)
    _assert_same_loader(port, jax_dsl)


def _pil_images(n, size, seed, gray=False):
    rng = np.random.RandomState(seed)
    shape = (size, size) if gray else (size, size, 3)
    return [Image.fromarray(rng.randint(0, 256, shape, dtype=np.uint8)) for _ in range(n)]


@pytest.fixture
def fake_hub(monkeypatch):
    """``datasets.load_dataset`` serving in-memory MNIST and CIFAR10 splits
    (28 px grey with labels 0-9; 32 px RGB), as the JAX tests stage them."""
    import datasets as hfds

    splits = {
        ("mnist", "train"): hfds.Dataset.from_dict({"image": _pil_images(30, 28, 1, gray=True),
                                                    "label": list(range(10)) * 3}),
        ("mnist", "test"): hfds.Dataset.from_dict({"image": _pil_images(10, 28, 2, gray=True),
                                                   "label": list(range(10))}),
        ("cifar10", "train"): hfds.Dataset.from_dict({"img": _pil_images(12, 32, 3), "label": [0, 1, 2] * 4}),
        ("cifar10", "test"): hfds.Dataset.from_dict({"img": _pil_images(4, 32, 4), "label": [3] * 4}),
    }
    monkeypatch.setattr("datasets.load_dataset", lambda name, split: splits[(name, split)])


HF_CASES = {
    "mnist_labels_1_3": ("MNIST", dict(label=[1, 3], batch_size=4), dict(), {}),
    "mnist_hf_split": ("MNIST", dict(batch_size=8, seed=4), dict(), dict(split_method="hf")),
    "mnist_flex_hf_split": ("MNIST", dict(batch_size=4, seed=6), dict(clean_rate=0.5),
                            dict(mode="FLEX", split_method="hf")),
    "cifar10_label_2_memmap": ("CIFAR10", dict(label=2, batch_size=2, max_ram_bytes=0), dict(), {}),
}


@pytest.mark.parametrize("case", sorted(HF_CASES))
def test_hf_loader_matches_jax(fake_hub, tmp_path, case):
    """HF datasets (train and test merged, decoded, resized), label
    filtering through the index, the ``"hf"`` split and the memmap spill."""
    name, kw, rates, prepare = HF_CASES[case]
    poison = dict(trigger_type="BOX_14", target_type="CORNER", poison_rate=0.25, **rates)
    port, jax_dsl = _pair(name, prepare=prepare, set_poison=poison, root=str(tmp_path), **kw)
    assert port.is_memmap_backed == ("max_ram_bytes" in kw)
    np.testing.assert_array_equal(np.asarray(port._store), np.asarray(jax_dsl._store))
    if "label" in kw:
        assert set(port._labels.tolist()) == set(np.atleast_1d(kw["label"]).tolist())
    _assert_same_loader(port, jax_dsl)


def test_unstaged_dataset_raises_offline(tmp_path):
    with pytest.raises(FileNotFoundError, match="stage it offline"):
        DatasetLoader("LSUN-CHURCH", root=str(tmp_path))


REFUSALS = {
    "unknown dataset": (lambda: DatasetLoader("NO-SUCH-SET"), NotImplementedError, "Undefined dataset"),
    "tags before poison": (lambda: DatasetLoader("FAKE", fake_size=8).prepare_dataset(), ValueError, "set_poison"),
    "batches before tags": (lambda: next(DatasetLoader("FAKE", fake_size=8).epoch_batches(0)), RuntimeError,
                            "prepare_dataset"),
    "flex rates above 1": (lambda: DatasetLoader("FAKE", fake_size=8).set_poison("BOX_8", "CORNER", clean_rate=0.9,
                                                                                  poison_rate=0.5)
                           .prepare_dataset(mode="FLEX"), ValueError, "FLEX"),
    "fixed rate above 1": (lambda: DatasetLoader("FAKE", fake_size=8).set_poison("BOX_8", "CORNER", poison_rate=1.5)
                           .prepare_dataset(), ValueError, "FIXED"),
    "unknown split": (lambda: DatasetLoader("FAKE", fake_size=8).set_poison("BOX_8", "CORNER")
                      .prepare_dataset(split_method="bogus"), ValueError, "split_method"),
    "unknown mode": (lambda: DatasetLoader("FAKE", fake_size=8).set_poison("BOX_8", "CORNER")
                     .prepare_dataset(mode="BOTH"), NotImplementedError, "mode"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_loader_refuses_as_jax_does(case):
    make, exc, match = REFUSALS[case]
    with pytest.raises(exc, match=match):
        make()


def test_get_dataloader_chains_the_epochs():
    dsl = DatasetLoader("FAKE", fake_size=12, image_size=8, batch_size=4).set_poison("BOX_8", "CORNER")
    dsl.prepare_dataset()
    stream = list(dsl.get_dataloader(epochs=2))
    want = list(dsl.epoch_batches(0)) + list(dsl.epoch_batches(1))
    assert len(stream) == 6
    for a, b in zip(stream, want):
        np.testing.assert_array_equal(a["image_u8"], b["image_u8"])


# ----------------------------------------------------------------- utilities

ARRAYS = {
    "nhwc": np.random.RandomState(0).rand(5, 6, 7, 3).astype(np.float32),
    "grey_out_of_range": (np.random.RandomState(1).randn(3, 4, 4, 1) * 2).astype(np.float32),
    "float64_single": np.random.RandomState(2).rand(1, 3, 3, 3),
}


@pytest.mark.parametrize("name", sorted(ARRAYS))
def test_image_helpers_match_jax_bitwise(name):
    x = ARRAYS[name]
    np.testing.assert_array_equal(image.to_uint8(x), jax_image.to_uint8(x))
    for kw in ({}, dict(vmin_in=-1.0, vmax_in=1.0), dict(vmin_out=-1.0, vmax_out=2.0), dict(vmin_in=0.5, vmax_in=0.5)):
        np.testing.assert_array_equal(image.normalize(x, **kw), jax_image.normalize(x, **kw))
    for kw in ({}, dict(rows=2), dict(cols=4), dict(rows=1, cols=2, pad=0, pad_value=0.5)):
        got, want = image.make_grid(x, **kw), jax_image.make_grid(x, **kw)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_png_save_and_load_match_jax(tmp_path):
    """Grids and batches written by PIL here decode to the same pixels as in
    the JAX package, whose loader takes its native PNG codec when built."""
    x = np.random.RandomState(3).rand(6, 8, 8, 3).astype(np.float32)
    image.save_image_grid(x, str(tmp_path / "grid" / "g.png"), rows=2, cols=3)
    jax_image.save_image_grid(x, str(tmp_path / "jgrid" / "g.png"), rows=2, cols=3)
    np.testing.assert_array_equal(image.load_image_dir(str(tmp_path / "grid")),
                                  jax_image.load_image_dir(str(tmp_path / "jgrid")))
    image.save_images(x, str(tmp_path / "imgs"), file_name="s", start_cnt=3)
    assert image.match_count(str(tmp_path / "imgs")) == 6 == jax_image.match_count(str(tmp_path / "imgs"))
    assert os.path.exists(tmp_path / "imgs" / "s8.png")
    ours = image.load_image_dir(str(tmp_path / "imgs"))
    np.testing.assert_array_equal(ours, jax_image.load_image_dir(str(tmp_path / "imgs")))
    np.testing.assert_array_equal(ours, image.to_uint8(x[[0, 1, 2, 3, 4, 5]]).astype(np.float32) / 255.0)
    np.testing.assert_array_equal(image.load_image_dir(str(tmp_path / "imgs"), size=4),
                                  jax_image.load_image_dir(str(tmp_path / "imgs"), size=4))
    grey = np.random.RandomState(4).rand(2, 5, 5, 1)
    pils = image.numpy_to_pil(grey)
    assert [p.mode for p in pils] == [p.mode for p in jax_image.numpy_to_pil(grey)] == ["L", "L"]
    np.testing.assert_array_equal(np.asarray(pils[1]), np.asarray(jax_image.numpy_to_pil(grey)[1]))
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError, match="no images"):
        image.load_image_dir(str(tmp_path / "empty"))


def test_path_gen_and_batchify_match_jax():
    frags = (["a", "b"], ["x"], ["1", "2", "3"])
    assert image.path_gen(*frags) == jax_image.path_gen(*frags)
    assert image.path_gen(*frags, sep="-") == jax_image.path_gen(*frags, sep="-")
    for n, m in ((10, 3), (9, 3), (2, 5), (0, 4)):
        assert image.batchify(n, m) == jax_image.batchify(n, m)


def test_samples_series_matches_jax(tmp_path):
    series = np.random.RandomState(5).rand(4, 3, 6, 6, 3).astype(np.float32)
    for cls, sub in ((Samples, "port"), (JaxSamples, "jax")):
        s = cls(series, save_dir=str(tmp_path / sub))
        s.plot_series(save_mode=cls.SAVE_ALL, fps=5)
        s.plot_series(slice_idx=slice(1, 3), prefix_img_name="first_last_", animate_name=None)
        s.save("series.pkl")
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))
    for name in os.listdir(tmp_path / "port"):
        if name.endswith(".png") or name.endswith(".gif"):
            with Image.open(tmp_path / "port" / name) as a, Image.open(tmp_path / "jax" / name) as b:
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=name)
    again = Samples.load(str(tmp_path / "port" / "series.pkl"), save_dir=str(tmp_path / "again"))
    assert len(again) == 4
    np.testing.assert_array_equal(again.grid(2, rows=1), JaxSamples(series, str(tmp_path / "j2")).grid(2, rows=1))


def test_tracker_writes_the_jax_jsonl_stream(tmp_path, no_tensorboard):
    config = {"lr": 2e-4, "epochs": 3, "name": "run", "flag": True, "shape": (1, 2)}
    records = [({"loss": np.float32(0.5), "lr": 1e-4, "epoch": 0, "tag": "x"}, 0), ({"loss": 0.25}, 7), ({"n": 1}, None)]
    for cls, sub in ((Tracker, "port"), (JaxTracker, "jax")):
        tracker = cls(str(tmp_path / sub), config=config)
        assert tracker._tb is None and tracker._wandb is None
        for metrics, step in records:
            tracker.log(metrics, step=step)
        tracker.close()

    def read(sub):
        with open(tmp_path / sub / "metrics.jsonl") as f:
            recs = [json.loads(line) for line in f]
        with open(tmp_path / sub / "tracker_config.json") as f:
            return [{k: v for k, v in r.items() if k != "_time"} for r in recs], json.load(f)

    assert read("port") == read("jax")
    assert read("port")[0][1] == {"_step": 7, "loss": 0.25}


def test_log_and_memory_log(tmp_path, capsys):
    assert Log.info("hello") == "\033[92mhello\033[0m"
    assert Log.error("bad").startswith(Log.ERROR) and Log.warning("w").endswith(Log.ENDC)
    assert Log.critical("c").startswith(Log.CRITICAL)
    assert "hello" in capsys.readouterr().out
    log = MemoryLog(str(tmp_path / "mem" / "log.txt"))
    log.append("epoch 0")
    log.append()
    with open(tmp_path / "mem" / "log.txt") as f:
        lines = f.read().splitlines()
    assert len(lines) == 2 and "RAM:" in lines[0] and lines[0].endswith("| epoch 0")


# ------------------------------------------------------------------- prefetch


def test_device_prefetch_on_the_cpu_moves_the_batches():
    dsl = DatasetLoader("FAKE", fake_size=20, image_size=8, batch_size=4).set_poison("BOX_8", "CORNER")
    dsl.prepare_dataset()
    got = list(device_prefetch(dsl.epoch_batches(0), "cpu", size=2))
    want = list(dsl.epoch_batches(0))
    assert len(got) == len(want) == 5
    for a, b in zip(got, want):
        for k in b:
            assert isinstance(a[k], torch.Tensor) and a[k].device.type == "cpu"
            np.testing.assert_array_equal(a[k].numpy(), b[k])
    assert got[0]["is_clean"].dtype == torch.bool and got[0]["image_u8"].dtype == torch.uint8


def test_device_prefetch_raises_the_worker_exception_and_stops_its_thread(monkeypatch):
    def source(fail_at):
        for i in range(100):
            if i == fail_at:
                raise OSError(f"read failed at {i}")
            yield {"x": np.full((2,), i)}

    before = threading.active_count()
    stream = device_prefetch(source(3), "cpu", size=1)
    assert [int(b["x"][0]) for b in (next(stream), next(stream), next(stream))] == [0, 1, 2]
    with pytest.raises(OSError, match="read failed at 3"):
        next(stream)
    early = device_prefetch(source(None), "cpu", size=1)
    next(early)
    early.close()  # the consumer leaves early: the worker must not stay blocked on the full queue
    assert threading.active_count() == before
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        next(device_prefetch(source(None)))
