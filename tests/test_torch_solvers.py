"""The port's sampler zoo against the JAX package's, on the CPU.

Stand-in chains: the same init and the deterministic stand-in denoiser of
``tests/test_solver_parity.py`` (``0.1·x + 0.05·sin(t/100)``) go through the
JAX package's own ``sample_loop`` / ``sample_sde_ve`` / ``sample_karras_ve``
and the port's ``sample_chain``; where a chain draws noise, the port is
handed JAX's draws in the order its key splits make them. Bound: atol 1e-4
plus rtol 1e-4 of the chain's scale (the largest |x| of the JAX result).

Then the same through ``DiffusionPipeline`` on a TINY UNet (movie capture
and ``clip_each_step``), the HF-layout config round trip of every registered
scheduler in both directions, the factory's scheduler names, and the batched
samplers (``batch_sampling``, ``batch_sampling_save``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import baddiffusion_tpu.schedulers as JS
import baddiffusion_tpu_torch.schedulers as PS
from baddiffusion_tpu import factory as jax_factory
from baddiffusion_tpu.models import UNet2DConfig as JaxUNet2DConfig
from baddiffusion_tpu.models import UNet2DModel as JaxUNet2DModel
from baddiffusion_tpu.pipelines import DiffusionPipeline as JaxDiffusionPipeline
from baddiffusion_tpu.pipelines.sampler import sample_loop as jax_sample_loop
from baddiffusion_tpu.pipelines.sampler import sample_sde_ve as jax_sample_sde_ve
from baddiffusion_tpu_torch import factory
from baddiffusion_tpu_torch.pipelines import (
    DiffusionPipeline,
    batch_sampling,
    batch_sampling_save,
    chain_images,
    sample_chain,
)
from baddiffusion_tpu_torch.utils.image import load_image_dir, to_uint8

SHAPE = (2, 8, 8, 3)
TINY = dict(
    sample_size=8, in_channels=3, out_channels=3, layers_per_block=1, block_out_channels=(16, 32),
    down_block_types=("DownBlock2D", "AttnDownBlock2D"), up_block_types=("AttnUpBlock2D", "UpBlock2D"),
    norm_num_groups=8, attention_head_dim=8,
)


def jax_standin(params, x, t):
    return 0.1 * x + jnp.sin(t[0].astype(jnp.float32) / 100.0) * 0.05


def standin(x, t):
    return 0.1 * x + torch.sin(t[0].float() / 100.0) * 0.05


def jax_draws(key, shape, count=512):
    """``noise_source`` of the JAX chain's draws: ``k, sub = split(k)``, then
    ``normal(sub)``, in order."""
    out = []
    for _ in range(count):
        key, sub = jax.random.split(key)
        out.append(torch.from_numpy(np.array(jax.random.normal(sub, shape, jnp.float32))))
    return out.__getitem__


def pair(name, **kw):
    jcls, pcls = getattr(JS, name), getattr(PS, name)
    return jcls(jcls.config_class(**kw)), pcls(pcls.config_class(**kw))


def assert_chain_close(got, want, what=""):
    scale = float(np.abs(want).max())
    err = float(np.abs(np.asarray(got) - want).max())
    assert np.isfinite(got).all() and err <= 1e-4 + 1e-4 * scale, f"{what}: max err {err:.3g}, scale {scale:.3g}"


def run_both(name, kw, n):
    """The JAX engine's result and the port's, from the same init and noise."""
    js, ps = pair(name, **kw)
    jst, pst = js.set_timesteps(js.create_state(), n), ps.set_timesteps(ps.create_state(), n)
    init = np.random.RandomState(0).randn(*SHAPE).astype(np.float32)
    key = jax.random.PRNGKey(0)
    if name == "ScoreSdeVeScheduler":
        want, _ = jax_sample_sde_ve(js, jst, jax_standin, None, jnp.asarray(init), key)
    elif name == "KarrasVeScheduler":  # the JAX engine returns images in [0, 1]
        want, _ = JS.sample_karras_ve(js, jst, jax_standin, None, jnp.asarray(init), key)
    else:
        want, _ = jax_sample_loop(js, jst, jax_standin, None, jnp.asarray(init), key)
    got, _ = sample_chain(ps, pst, standin, torch.from_numpy(init), noise_source=jax_draws(key, SHAPE))
    if name == "KarrasVeScheduler":
        got = chain_images(ps, got)
    return got.numpy(), np.asarray(want)


CHAIN_CASES = (
    [(f"dpm-{a}-o{o}-n{n}", "DPMSolverMultistepScheduler", dict(solver_order=o, algorithm_type=a), n)
     for o in (1, 2, 3) for a in ("dpmsolver", "dpmsolver++") for n in (10, 20)]
    + [(f"unipc-{s}-o{o}-n{n}", "UniPCMultistepScheduler", dict(solver_order=o, solver_type=s), n)
       for o in (1, 2, 3) for s in ("bh1", "bh2") for n in (10, 20)]
    + [("unipc-predict-eps", "UniPCMultistepScheduler", dict(predict_x0=False), 15)]
    + [(f"deis-o{o}-n{n}", "DEISMultistepScheduler", dict(solver_order=o), n) for o in (1, 2, 3) for n in (10, 20)]
    + [(f"pndm-{'plms' if s else 'prk'}-n{n}", "PNDMScheduler", dict(skip_prk_steps=s), n)
       for s in (False, True) for n in (10, 50)]
    + [(f"heun-n{n}", "HeunDiscreteScheduler", dict(beta_start=0.0001, beta_end=0.02), n) for n in (10, 25)]
    + [(f"lms-n{n}", "LMSDiscreteScheduler", dict(beta_start=0.0001, beta_end=0.02), n) for n in (10, 25)]
    + [(f"ddim-eta{e}", "DDIMScheduler", dict(eta=e), 10) for e in (0.0, 0.5)]
    + [("sde-ve", "ScoreSdeVeScheduler", {}, 10), ("karras-ve", "KarrasVeScheduler", {}, 10)]
)


@pytest.mark.parametrize("name,kw,n", [c[1:] for c in CHAIN_CASES], ids=[c[0] for c in CHAIN_CASES])
def test_standin_chain_matches_jax(name, kw, n):
    got, want = run_both(name, kw, n)
    assert_chain_close(got, want, f"{name} {kw} n={n}")


def jax_karras_ve_loop(js, jst, apply_fn, init, key):
    """Karras-VE's sample before the clip, from the JAX scheduler's own steps
    in a loop with the JAX engine's key splits (its engine returns only the
    clipped images)."""
    sample, k = jnp.asarray(init) * js.config.sigma_max, key
    b = init.shape[0]
    for i in range(len(jst.timesteps)):
        t = int(jst.timesteps[i])
        sigma = jst.schedule[t]
        sigma_prev = jst.schedule[t - 1] if t > 0 else jnp.asarray(0.0)
        k, k1 = jax.random.split(k)
        hat, sigma_hat = js.add_noise_to_input(jst, sample, sigma, k1)
        mo = sigma_hat / 2.0 * apply_fn(None, (hat + 1) / 2, jnp.full((b,), sigma_hat / 2.0))
        sample, deriv, _ = js.step(jst, mo, sigma_hat, sigma_prev, hat)
        if t > 0:
            mo2 = sigma_prev / 2.0 * apply_fn(None, (sample + 1) / 2, jnp.full((b,), sigma_prev / 2.0))
            sample, _, _ = js.step_correct(jst, mo2, sigma_hat, sigma_prev, hat, sample, deriv)
    return np.asarray(sample)


def test_karras_ve_chain_before_the_clip_matches_jax_steps():
    """The stand-in's Karras-VE result saturates the [0, 1] clip, so its
    sample before it is held to the JAX scheduler's steps."""
    js, ps = pair("KarrasVeScheduler")
    jst, pst = js.set_timesteps(None, 10), ps.set_timesteps(None, 10)
    init = np.random.RandomState(3).randn(*SHAPE).astype(np.float32)
    key = jax.random.PRNGKey(4)
    want = jax_karras_ve_loop(js, jst, jax_standin, init, key)
    got, _ = sample_chain(ps, pst, standin, torch.from_numpy(init), noise_source=jax_draws(key, SHAPE))
    assert_chain_close(got.numpy(), want, "karras-ve before the clip")
    assert float(np.abs(want).max()) > 1.0  # the clip would hide it


@pytest.fixture(scope="module")
def tiny_pipes(tmp_path_factory):
    """The JAX TINY UNet (seeded) and the port's copy of it, through the HF layout."""
    model = JaxUNet2DModel(JaxUNet2DConfig(**TINY))
    params = jax.device_get(jax.jit(model.init_params)(jax.random.PRNGKey(0)))
    path = str(tmp_path_factory.mktemp("zoo_pipe"))
    JaxDiffusionPipeline(model, params, JS.DDPMScheduler(JS.DDPMConfig())).save_pretrained(path)
    return model, params, DiffusionPipeline.from_pretrained(path, device="cpu").unet


PIPELINE_CASES = {
    "ddim-eta0.5": ("DDIMScheduler", dict(eta=0.5)),
    "dpm++-o2": ("DPMSolverMultistepScheduler", dict(solver_order=2)),
    "unipc": ("UniPCMultistepScheduler", {}),
    # the UNet sees float timesteps and σ-scaled inputs
    "heun": ("HeunDiscreteScheduler", {}),
    "lms": ("LMSDiscreteScheduler", {}),
    "sde-ve": ("ScoreSdeVeScheduler", {}),
    "karras-ve": ("KarrasVeScheduler", {}),
}


@pytest.mark.parametrize("case", sorted(PIPELINE_CASES))
def test_tiny_unet_pipeline_chain_matches_jax(tiny_pipes, case):
    """Images and movie of a 10-step chain (clip 0.8 a step, which the VE
    engines ignore in both packages) at atol 1e-4 (Heun and K-LMS: see
    below). The VE chains' images
    saturate the clip on random weights, so their samples before it are
    held too, at the stand-in chains' bound."""
    model, params, unet = tiny_pipes
    name, kw = PIPELINE_CASES[case]
    js, ps = pair(name, **kw)
    jpipe = JaxDiffusionPipeline(model, params, js, clip_each_step=0.8, default_inference_steps=10)
    pipe = DiffusionPipeline(unet, ps, clip_each_step=0.8, default_inference_steps=10, device="cpu")
    init = np.random.RandomState(6).randn(*SHAPE).astype(np.float32)
    key = jax.random.PRNGKey(11)
    want = jpipe(key=key, init=init, save_every_step=True, capture_every=3)
    got = pipe(init=init, save_every_step=True, capture_every=3, noise_source=jax_draws(key, SHAPE))
    frames = -(-len(js.set_timesteps(js.create_state(), 10).timesteps) // 3)
    assert got.images.shape == want.images.shape and got.movie.shape == want.movie.shape == (frames,) + SHAPE
    atol = 1e-4
    if name in ("HeunDiscreteScheduler", "LMSDiscreteScheduler"):
        # these chains start at σ_max·init and take x − σ·ε, so the UNet's
        # f32 rounding (about 1e-6 of ε between the two packages) comes back
        # times σ each step: the chains' bound, 1e-4 of the chain's scale
        # (its start; halved into image space), holds them instead
        atol += 1e-4 * float(ps.init_noise_sigma(ps.set_timesteps(ps.create_state(), 10))) * np.abs(init).max() / 2
    np.testing.assert_allclose(got.images, want.images, atol=atol)
    np.testing.assert_allclose(got.movie, want.movie, atol=atol)
    np.testing.assert_array_equal(got.movie[-1], got.images)
    # the call ran under inference mode; nothing of it reached the model
    assert not any(p.is_inference() for p in unet.parameters())
    if name in ("ScoreSdeVeScheduler", "KarrasVeScheduler"):
        @jax.jit
        def apply_fn(p, x, t):
            return model.apply({"params": params}, x, t).astype(x.dtype)

        jst = js.set_timesteps(js.create_state(), 10)
        if name == "ScoreSdeVeScheduler":
            want_sample = np.asarray(jax_sample_sde_ve(js, jst, apply_fn, params, jnp.asarray(init), key)[0])
        else:
            want_sample = jax_karras_ve_loop(js, jst, apply_fn, init, key)
        got_sample = pipe(init=init, noise_source=jax_draws(key, SHAPE), output_type="pt").sample
        assert_chain_close(got_sample.numpy(), want_sample, f"{case} before the clip")


def _config_cases():
    """Every registered class, with a non-default value where a field is a tuple."""
    extra = {"UniPCMultistepScheduler": dict(disable_corrector=(1, 2)), "DDPMScheduler": dict(clip_defense=True)}
    return [(name, extra.get(name, {})) for name in sorted(JS.scheduler_registry())]


def test_scheduler_registry_has_the_jax_keys():
    assert sorted(PS.scheduler_registry()) == sorted(JS.scheduler_registry())
    assert len(PS.scheduler_registry()) == 10


@pytest.mark.parametrize("name,kw", _config_cases(), ids=[c[0] for c in _config_cases()])
@pytest.mark.parametrize("direction", ["jax-to-port", "port-to-jax"])
def test_scheduler_config_round_trips(tmp_path, name, kw, direction):
    js, ps = pair(name, **kw)
    if direction == "jax-to-port":
        js.save_config(str(tmp_path))
        loaded = PS.load_scheduler(str(tmp_path))
        assert type(loaded) is type(ps) and loaded == ps
    else:
        ps.save_pretrained(str(tmp_path))
        loaded = JS.load_scheduler(str(tmp_path))
        assert type(loaded) is type(js) and loaded == js
    assert dataclasses.asdict(loaded.config) == dataclasses.asdict(js.config)
    assert hash(loaded) == hash(type(loaded)(loaded.config))


def test_unknown_scheduler_class_raises_in_both(tmp_path):
    """The port's loader refuses only what the JAX one refuses: a class that
    no package registers."""
    PS.DDIMScheduler().save_config(str(tmp_path))
    cfg = tmp_path / "scheduler_config.json"
    cfg.write_text(cfg.read_text().replace("DDIMScheduler", "NoSuchScheduler"))
    for load in (PS.load_scheduler, JS.load_scheduler):
        with pytest.raises(ValueError, match="unknown scheduler class 'NoSuchScheduler'"):
            load(str(tmp_path))


def test_config_coercion_matches_jax():
    for name, kw in [("DPMSolverMultistepScheduler", dict(algorithm_type="deis", solver_type="bh2")),
                     ("DEISMultistepScheduler", dict(algorithm_type="dpmsolver++", solver_type="midpoint")),
                     ("UniPCMultistepScheduler", dict(solver_type="logrho"))]:
        js, ps = pair(name, **kw)
        assert dataclasses.asdict(ps.config) == dataclasses.asdict(js.config)
    for name, kw in [("DPMSolverMultistepScheduler", dict(algorithm_type="nope")),
                     ("UniPCMultistepScheduler", dict(solver_type="nope"))]:
        with pytest.raises(NotImplementedError):
            getattr(PS, name)(**kw)


SCHED_NAMES = sorted(v for k, v in vars(jax_factory.DiffuserModelSched).items() if k.endswith("_SCHED"))


@pytest.mark.parametrize("name", SCHED_NAMES)
def test_factory_name_gives_the_jax_scheduler_and_pipeline(tiny_pipes, name):
    if name == jax_factory.DiffuserModelSched.LDM_SCHED:  # named, but neither factory builds it
        for spec in (jax_factory._sched_spec, factory._sched_spec):
            with pytest.raises(NotImplementedError):
                spec(name)
        return
    (jmake, jkind), (pmake, pkind) = jax_factory._sched_spec(name), factory._sched_spec(name)
    assert pkind == jkind
    for clip in (False, True):
        js, ps = jmake(clip), pmake(clip)
        assert type(ps).__name__ == type(js).__name__
        assert dataclasses.asdict(ps.config) == dataclasses.asdict(js.config)
        jpipe = jax_factory._make_get_pipeline(None, jkind, clip)(None, js)
        pipe = factory._make_get_pipeline(tiny_pipes[2], pkind, clip)(ps, device="cpu")
        assert pipe.scheduler is ps
        assert (pipe.clip_each_step, pipe.default_inference_steps, pipe.hf_class_name) == (
            jpipe.clip_each_step, jpipe.default_inference_steps, jpipe.hf_class_name)


def test_batch_sampling_save_shards_equal_one_caller(tiny_pipes, tmp_path):
    """Two shards write the one caller's files bitwise, and batch_sampling
    gives the same images."""
    pipe = DiffusionPipeline(tiny_pipes[2], PS.DDIMScheduler(PS.DDIMConfig(eta=0.5)), default_inference_steps=3,
                             device="cpu")
    batch_sampling_save(5, pipe, str(tmp_path / "one"), max_batch_n=2, seed=7)
    for shard in (0, 1):
        batch_sampling_save(5, pipe, str(tmp_path / "two"), max_batch_n=2, seed=7, shard_index=shard, shard_count=2)
    one, two = sorted(p.name for p in (tmp_path / "one").iterdir()), sorted(p.name for p in (tmp_path / "two").iterdir())
    assert one == two == [f"{i}.png" for i in range(5)]
    for name in one:
        assert (tmp_path / "one" / name).read_bytes() == (tmp_path / "two" / name).read_bytes()
    images = batch_sampling(5, pipe, max_batch_n=2, seed=7)
    np.testing.assert_array_equal(to_uint8(images), to_uint8(load_image_dir(str(tmp_path / "one"))))
    assert not np.array_equal(images[0], images[2])  # each chunk has its own generator


@pytest.mark.parametrize("name", ["DDIMScheduler", "DPMSolverMultistepScheduler", "UniPCMultistepScheduler",
                                  "DEISMultistepScheduler", "PNDMScheduler", "HeunDiscreteScheduler",
                                  "LMSDiscreteScheduler", "ScoreSdeVeScheduler"])
def test_add_noise_matches_jax(name):
    """Forward noising at timesteps of the inference table (Heun, K-LMS:
    σ-space, matched against their float timesteps)."""
    js, ps = pair(name)
    jst, pst = js.set_timesteps(js.create_state(), 10), ps.set_timesteps(ps.create_state(), 10)
    rng = np.random.RandomState(9)
    x0, noise = rng.randn(3, 4, 4, 3).astype(np.float32), rng.randn(3, 4, 4, 3).astype(np.float32)
    if name == "ScoreSdeVeScheduler":
        t = np.array([0, 4, 9], np.int32)
    else:
        t = np.asarray(pst.timesteps)[[0, 3, 8]]
    want = js.add_noise(jst, jnp.asarray(x0), jnp.asarray(noise), jnp.asarray(t))
    got = ps.add_noise(pst, torch.from_numpy(x0), torch.from_numpy(noise), torch.from_numpy(t))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_ddim_velocity_matches_jax():
    js, ps = pair("DDIMScheduler")
    rng = np.random.RandomState(10)
    x0, noise = rng.randn(3, 4, 4, 3).astype(np.float32), rng.randn(3, 4, 4, 3).astype(np.float32)
    t = np.array([0, 487, 999], np.int32)
    want = js.get_velocity(js.create_state(), jnp.asarray(x0), jnp.asarray(noise), jnp.asarray(t))
    got = ps.get_velocity(ps.create_state(), torch.from_numpy(x0), torch.from_numpy(noise), torch.from_numpy(t))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
