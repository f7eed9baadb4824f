"""The port's native PNG codec (``baddiffusion_tpu_torch/native/pngio.py``):
round trips, the header, PIL reading its files and it reading PIL's (whose
encoder picks real scanline filters), its files byte for byte the JAX
codec's, and ``load_image_dir`` bitwise the PIL path. Skipped without a C++
toolchain, as ``tests/test_native_png.py`` is."""

import os
import shutil

import numpy as np
import pytest
from PIL import Image

from baddiffusion_tpu.native.pngio import encode_png_batch as jax_encode_png_batch
from baddiffusion_tpu_torch import native
from baddiffusion_tpu_torch.native import pngio
from baddiffusion_tpu_torch.utils import image as image_utils
from baddiffusion_tpu_torch.utils.image import load_image_dir, save_images


@pytest.fixture(autouse=True)
def codec():
    if shutil.which("g++") is None:
        pytest.skip("no C++ toolchain")
    if not native.native_available():
        pytest.skip(f"the codec did not build here: {pngio._library.error}")
    native.reset_counts()


@pytest.mark.parametrize("c", [3, 1], ids=["rgb", "gray"])
def test_round_trip(tmp_path, c):
    imgs = np.random.RandomState(c).randint(0, 256, size=(6, 20, 24, c), dtype=np.uint8)
    paths = [str(tmp_path / f"{i}.png") for i in range(6)]
    assert native.encode_png_batch(imgs, paths)
    assert native.png_header(paths[0]) == (20, 24, c)
    np.testing.assert_array_equal(native.decode_png_batch(paths, 20, 24, c), imgs)
    assert native.counts() == {"encoded": 1, "decoded": 1}


def test_header_and_refusals(tmp_path):
    bad = str(tmp_path / "bad.png")
    with open(bad, "wb") as f:
        f.write(b"not a png")
    assert native.png_header(bad) is None
    assert native.decode_png_batch([bad], 8, 8, 3) is None
    rgba = np.zeros((1, 4, 4, 4), np.uint8)
    assert not native.encode_png_batch(rgba, [str(tmp_path / "a.png")])  # four channels: the caller's PIL
    Image.fromarray(np.zeros((5, 7, 4), np.uint8)).save(tmp_path / "rgba.png")
    assert native.png_header(str(tmp_path / "rgba.png")) == (5, 7, 4)
    assert native.counts() == {"encoded": 0, "decoded": 0}


def test_pil_reads_its_files(tmp_path):
    imgs = np.random.RandomState(2).randint(0, 256, size=(3, 17, 9, 3), dtype=np.uint8)
    paths = [str(tmp_path / f"{i}.png") for i in range(3)]
    assert native.encode_png_batch(imgs, paths)
    for path, img in zip(paths, imgs):
        np.testing.assert_array_equal(np.asarray(Image.open(path)), img)


def _png_filters(path):
    """The filter byte of each scanline of an 8-bit non-interlaced PNG."""
    import struct
    import zlib

    data = open(path, "rb").read()
    pos, idat, (w, h, ct) = 8, b"", (0, 0, 0)
    while pos < len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if kind == b"IHDR":
            w, h, ct = struct.unpack(">II", body[:8]) + (body[9],)
        elif kind == b"IDAT":
            idat += body
        pos += 12 + length
    raw = zlib.decompress(idat)
    stride = w * {0: 1, 2: 3}[ct] + 1
    return {raw[y * stride] for y in range(h)}


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _write_filtered_png(path, img):
    """An 8-bit PNG whose scanline y uses filter 1 + y % 4 (sub, up,
    average, Paeth), encoded here from the PNG specification."""
    import struct
    import zlib

    h, w, c = img.shape
    rows, prev = [], np.zeros(w * c, np.int64)
    for y in range(h):
        cur = img[y].reshape(-1).astype(np.int64)
        f = 1 + y % 4
        out = np.empty_like(cur)
        for x in range(w * c):
            a = cur[x - c] if x >= c else 0
            up = prev[x]
            ul = prev[x - c] if x >= c else 0
            pred = {1: a, 2: up, 3: (a + up) // 2, 4: _paeth(a, up, ul)}[f]
            out[x] = (cur[x] - pred) % 256
        rows.append(bytes([f]) + out.astype(np.uint8).tobytes())
        prev = cur

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, {1: 0, 3: 2}[c], 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr) + chunk(b"IDAT", zlib.compress(b"".join(rows)))
                + chunk(b"IEND", b""))


@pytest.mark.parametrize("c", [3, 1], ids=["rgb", "gray"])
def test_decodes_pil_files_and_filters_1_to_4(tmp_path, c):
    """PIL's files (its adaptive encoder picks sub, up and Paeth here) and
    files whose scanlines cycle through all four filters, which PIL reads
    back as the source: the codec decodes each to the source pixels."""
    rng = np.random.RandomState(3)
    y, x = np.mgrid[0:24, 0:24]
    imgs = []
    for i in range(4):
        base = (x * (i + 1) + y * 2 + rng.randint(0, 6, size=(24, 24))) % 256
        imgs.append(np.stack([base, (base + 60 * i) % 256, 255 - base], -1).astype(np.uint8)[..., :c])
    pil_paths = [str(tmp_path / f"pil{i}.png") for i in range(4)]
    filters = set()
    for path, img in zip(pil_paths, imgs):
        Image.fromarray(img[..., 0] if c == 1 else img).save(path)
        filters |= _png_filters(path)
    assert filters - {0}, filters
    np.testing.assert_array_equal(native.decode_png_batch(pil_paths, 24, 24, c), np.stack(imgs))
    hand_paths = [str(tmp_path / f"filtered{i}.png") for i in range(4)]
    for path, img in zip(hand_paths, imgs):
        _write_filtered_png(path, img)
        assert _png_filters(path) == {1, 2, 3, 4}
        np.testing.assert_array_equal(np.asarray(Image.open(path)).reshape(img.shape), img)
    np.testing.assert_array_equal(native.decode_png_batch(hand_paths, 24, 24, c), np.stack(imgs))


@pytest.mark.parametrize("c", [3, 1], ids=["rgb", "gray"])
def test_files_are_the_jax_codecs_byte_for_byte(tmp_path, c):
    imgs = np.random.RandomState(4 + c).randint(0, 256, size=(4, 32, 32, c), dtype=np.uint8)
    ours = [str(tmp_path / f"port{i}.png") for i in range(4)]
    theirs = [str(tmp_path / f"jax{i}.png") for i in range(4)]
    assert native.encode_png_batch(imgs, ours)
    assert jax_encode_png_batch(imgs, theirs)
    for a, b in zip(ours, theirs):
        assert open(a, "rb").read() == open(b, "rb").read()


def test_save_and_load_image_dir_are_the_pil_path_bitwise(tmp_path, monkeypatch):
    """``save_images`` then ``load_image_dir`` through the codec, and the
    same with the codec's entry points refusing (the PIL path): the same
    files' pixels, the same floats."""
    imgs = np.random.RandomState(5).rand(7, 16, 16, 3).astype(np.float32)
    save_images(imgs, str(tmp_path / "native"))
    got = load_image_dir(str(tmp_path / "native"))
    assert native.counts() == {"encoded": 1, "decoded": 1}
    monkeypatch.setattr(image_utils, "encode_png_batch", lambda *a, **k: False)
    monkeypatch.setattr(image_utils, "png_header", lambda path: None)
    save_images(imgs, str(tmp_path / "pil"))
    want = load_image_dir(str(tmp_path / "pil"))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(load_image_dir(str(tmp_path / "native")), load_image_dir(str(tmp_path / "pil")))
    assert native.counts() == {"encoded": 1, "decoded": 1}
    gray = (imgs[..., :1] * 255).round() / 255
    monkeypatch.undo()
    save_images(gray, str(tmp_path / "gray"))
    np.testing.assert_array_equal(load_image_dir(str(tmp_path / "gray")), gray.astype(np.float32))


def test_library_is_built_into_the_build_dir_by_hash(tmp_path):
    path = pngio.library_path()
    assert os.path.dirname(path) == pngio.BUILD_DIR and os.path.exists(path)
    assert os.path.basename(path).startswith("libpngio-")
    assert not os.path.exists(os.path.join(os.path.dirname(pngio.SOURCE), "libpngio.so"))
