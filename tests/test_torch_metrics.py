"""The port's measure against the JAX package on the CPU: MSE and SSIM, the
numpy threefry PRNG against ``jax.random``, the FID proxy extractor's
weights and features, the streaming ``get_activations``, the Fréchet
distance and ``fid`` on two directories, and ``FIDInceptionV3`` with a seeded
random pytorch_fid-named state dict."""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import baddiffusion_tpu.metrics.fid  # noqa: F401  (the module, which the package's fid() shadows)
import baddiffusion_tpu_torch.metrics.fid  # noqa: F401
from baddiffusion_tpu.metrics import mse as jax_mse
from baddiffusion_tpu.metrics import ssim as jax_ssim
from baddiffusion_tpu.models.inception import load_fid_inception as jax_load_fid_inception
from baddiffusion_tpu.utils.image import save_images as jax_save_images
from baddiffusion_tpu_torch.metrics import _prng, mse, ssim
from baddiffusion_tpu_torch.models.inception import FIDInceptionV3, fid_state_dict, load_fid_inception
from tests.fid_inception_torch import randomized


@pytest.fixture(autouse=True)
def few_threads():
    """Two threads a BLAS/OpenMP pool (torch's, scipy's): the suite runs
    several pytest-xdist workers at once, and pools as wide as the machine
    then spin against each other (a 4 s test took 3 minutes)."""
    with threadpool_limits(limits=2):
        yield


jax_fid = sys.modules["baddiffusion_tpu.metrics.fid"]
port_fid = sys.modules["baddiffusion_tpu_torch.metrics.fid"]
PROXY_SHAPES = ((3, 3, 3, 32), (3, 3, 32, 64), (3, 3, 64, 128), (3, 3, 128, 256), (512, 2048))


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


def _pair(rng, shape, noise=0.2):
    a = rng.rand(*shape).astype(np.float32)
    return a, np.clip(a + noise * rng.randn(*shape), 0, 1).astype(np.float32)


@pytest.mark.parametrize("shape", [(4, 32, 32, 3), (3, 16, 16, 1), (32, 32, 3), (17, 19, 1)],
                         ids=["4d-rgb", "4d-gray", "3d-rgb", "3d-gray-odd"])
def test_mse_and_ssim_match_jax(shape):
    a, b = _pair(np.random.RandomState(sum(shape)), shape)
    assert float(mse(a, b, device="cpu")) == pytest.approx(float(jax_mse(a, b)), abs=1e-6)
    assert float(ssim(a, b, device="cpu")) == pytest.approx(float(jax_ssim(a, b)), abs=1e-6)
    # a tensor is computed where it lies
    assert float(ssim(torch.from_numpy(a), torch.from_numpy(b))) == pytest.approx(float(jax_ssim(a, b)), abs=1e-6)


def test_ssim_custom_sigma_and_identity_match_jax():
    a, b = _pair(np.random.RandomState(3), (2, 16, 16, 3), noise=0.1)
    assert float(ssim(a, b, sigma=2.0, device="cpu")) == pytest.approx(float(jax_ssim(a, b, sigma=2.0)), abs=1e-6)
    assert float(ssim(a, a, device="cpu")) == pytest.approx(1.0, abs=1e-6)


def test_metrics_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a = np.zeros((1, 8, 8, 3), np.float32)
    for fn in (mse, ssim):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fn(a, a)


@pytest.mark.parametrize("seed", [0, 7, 20230214, 2**31 - 1, 4_000_000_000])
def test_prng_key_and_split_match_jax(seed):
    assert jax.config.jax_threefry_partitionable  # the setting the numpy split follows
    key = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(_prng.prng_key(seed), np.asarray(key))
    np.testing.assert_array_equal(_prng.split(_prng.prng_key(seed), 5), np.asarray(jax.random.split(key, 5)))


@pytest.mark.parametrize("seed,shape", [(0, (1000,)), (3, (7, 11, 13)), (20230214, (512, 2048))])
def test_prng_bits_uniforms_and_normals_match_jax(seed, shape):
    key, jkey = _prng.prng_key(seed), jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(_prng.random_bits(key, shape), np.asarray(jax.random.bits(jkey, shape, jnp.uint32)))
    np.testing.assert_array_equal(_prng.uniform(key, shape), np.asarray(jax.random.uniform(jkey, shape, jnp.float32)))
    # within 2 ulp; on the installed JAX's CPU backend they come out bit for bit
    assert _ulps(_prng.normal(key, shape), np.asarray(jax.random.normal(jkey, shape, jnp.float32))).max() <= 2


def test_proxy_weights_match_jax():
    """The five arrays the JAX proxy extractor draws (its own expressions)."""
    ks = jax.random.split(jax.random.PRNGKey(port_fid.PROXY_SEED), 5)
    want = [np.asarray(jax.random.normal(ks[i], s, jnp.float32) * (2.0 / (9 * s[2])) ** 0.5)
            for i, s in enumerate(PROXY_SHAPES[:4])]
    want.append(np.asarray(jax.random.normal(ks[4], PROXY_SHAPES[4], jnp.float32) / (256 * 2) ** 0.5))
    got = port_fid.proxy_weights()
    assert [g.shape for g in got] == list(PROXY_SHAPES)
    for g, w in zip(got, want):
        assert g.dtype == np.float32 and _ulps(g, w).max() <= 2
    assert sum(g.size for g in got) == 1_436_512  # about 1.44 M floats


@pytest.mark.parametrize("shape", [(4, 16, 16, 3), (3, 32, 32, 1), (2, 17, 23, 3)], ids=["16px", "gray32", "odd"])
def test_proxy_features_match_jax(shape):
    x = np.random.RandomState(0).rand(*shape).astype(np.float32)
    got = port_fid.proxy_extractor("cpu")(x).numpy()
    want = np.asarray(jax_fid._proxy_extractor()(jnp.asarray(x)))
    assert got.shape == (shape[0], 2048)
    # rtol 1e-5; features near 0 take an atol of 1e-6 of the largest
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * np.abs(want).max())


def test_get_activations_streams_a_dir_like_jax(tmp_path):
    """10 PNGs in batches of 4: the port decodes 4, 4, 2 (the last padded to
    4), and its rows are the JAX streaming result's, to the extractor's
    tolerance; the directory path gives the array path's rows."""
    from baddiffusion_tpu_torch.utils import image as img_mod

    imgs = np.random.RandomState(2).rand(10, 16, 16, 3).astype(np.float32)
    jax_save_images(imgs, str(tmp_path / "d"))
    calls = []
    orig = img_mod.load_image_files

    def spy(files, size=None):
        calls.append(len(files))
        return orig(files, size=size)

    extractor = port_fid.proxy_extractor("cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(img_mod, "load_image_files", spy)
        got = port_fid.get_activations(str(tmp_path / "d"), extractor=extractor, batch_size=4)
    assert calls == [4, 4, 2]
    want = jax_fid.get_activations(str(tmp_path / "d"), extractor=jax_fid._proxy_extractor(), batch_size=4)
    assert got.shape == want.shape == (10, 2048)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * np.abs(want).max())
    from_array = port_fid.get_activations(img_mod.load_image_dir(str(tmp_path / "d")), extractor=extractor,
                                          batch_size=10)
    np.testing.assert_allclose(got, from_array, atol=1e-6 * np.abs(want).max())


def test_frechet_distance_matches_jax():
    rng = np.random.RandomState(0)
    a, b = rng.randn(300, 64), 0.5 + 1.3 * rng.randn(300, 64)
    sa, sb = port_fid.compute_statistics(a), port_fid.compute_statistics(b)
    for x, y in zip(sa + sb, jax_fid.compute_statistics(a) + jax_fid.compute_statistics(b)):
        np.testing.assert_array_equal(x, y)
    got = port_fid.frechet_distance(*sa, *sb)
    assert got == pytest.approx(jax_fid.frechet_distance(*sa, *sb), rel=1e-4)
    assert port_fid.frechet_distance(*sa, *sa) == pytest.approx(0.0, abs=1e-6)


def test_fid_of_two_dirs_matches_jax(tmp_path):
    """The default (proxy) extractor on both sides: 24 and 20 PNGs, batch 16."""
    rng = np.random.RandomState(5)
    a = rng.rand(24, 16, 16, 3).astype(np.float32)
    b = np.clip(rng.rand(20, 16, 16, 3) * 0.8 + 0.1, 0, 1).astype(np.float32)
    jax_save_images(a, str(tmp_path / "a"))
    jax_save_images(b, str(tmp_path / "b"))
    paths = [str(tmp_path / "a"), str(tmp_path / "b")]
    got = port_fid.fid(paths, batch_size=16, device="cpu")
    want = jax_fid.fid(paths, batch_size=16)
    assert np.isfinite(got) and got == pytest.approx(want, rel=1e-4)


def test_fid_cli(tmp_path, capsys, monkeypatch):
    """The command line's plumbing, on a 16-d proxy (the 2048-d sqrtm is
    held above)."""
    monkeypatch.setattr(port_fid, "default_extractor", lambda device=None: (port_fid.proxy_extractor(device, 16), 16))
    rng = np.random.RandomState(0)
    jax_save_images(rng.rand(8, 16, 16, 3).astype(np.float32), str(tmp_path / "x"))
    jax_save_images(rng.rand(8, 16, 16, 3).astype(np.float32), str(tmp_path / "y"))
    log = tmp_path / "fid.log"
    val = port_fid.main([str(tmp_path / "x"), str(tmp_path / "y"), "--batch-size", "8", "--log", str(log),
                         "--gpu", "cpu"])
    assert np.isfinite(val) and "FID" in log.read_text()
    assert f"FID: {val}" in capsys.readouterr().out


def test_fid_inception_matches_jax(tmp_path):
    """A seeded random pytorch_fid-named state dict (BatchNorm statistics
    included), with the extra entries of the real file: the port loads it
    directly and through the .pth, the JAX package through the .pth; pool3
    at [2, 32, 32, 3] (the bilinear upsample to 299²)."""
    sd = randomized(0).state_dict()
    sd.update({"fc.weight": torch.zeros(1008, 2048), "fc.bias": torch.zeros(1008),
               "AuxLogits.conv0.conv.weight": torch.zeros(128, 768, 1, 1)})
    path = str(tmp_path / "pt_inception_random.pth")
    torch.save(sd, path)

    direct = FIDInceptionV3()
    direct.load_state_dict(fid_state_dict(sd), strict=True)
    loaded = load_fid_inception(path, device="cpu")
    x = np.random.RandomState(42).rand(2, 32, 32, 3).astype(np.float32)
    got = direct.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(loaded(torch.from_numpy(x)).numpy(), got)

    model, params = jax_load_fid_inception(path)
    want = np.asarray(jax.jit(lambda p, v: model.apply({"params": p}, v))(params, jnp.asarray(x)))
    assert got.shape == want.shape == (2, 2048) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


def test_fid_inception_grayscale_is_tiled():
    model = FIDInceptionV3().eval()
    x = torch.from_numpy(np.random.RandomState(1).rand(1, 28, 28, 1).astype(np.float32))
    np.testing.assert_array_equal(model(x).numpy(), model(x.expand(-1, -1, -1, 3)).numpy())
