"""Segment mode (``DiffusionPipeline.segment_steps``) against the JAX
package's on the CPU: the port of ``tests/test_pipeline.py``'s
``TestSegmentedSampling``.

A seeded TINY UNet, written by the JAX package and read by the port; the
same init; the port handed the JAX chain's own draws (``noise_source``, in
the order its key splits make them). On the CPU the port's segments run
eagerly, so a segmented chain must equal the port's whole chain bitwise, and
the JAX package's segmented run within ``test_torch_solvers.py``'s pipeline
bound (atol 1e-4 on images in [0, 1]; the VE chains' samples before the clip
at 1e-4 plus 1e-4 of their scale). The JAX side is jitted by its pipeline;
the file takes about 25 s alone.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import baddiffusion_tpu.schedulers as JS
import baddiffusion_tpu_torch.schedulers as PS
from baddiffusion_tpu.models import UNet2DConfig as JaxUNet2DConfig
from baddiffusion_tpu.models import UNet2DModel as JaxUNet2DModel
from baddiffusion_tpu.pipelines import DiffusionPipeline as JaxDiffusionPipeline
from baddiffusion_tpu.pipelines.sampler import sample_sde_ve as jax_sample_sde_ve
from baddiffusion_tpu_torch.pipelines import DiffusionPipeline, sampler

SHAPE = (2, 8, 8, 3)
TINY = dict(
    sample_size=8, in_channels=3, out_channels=3, layers_per_block=1, block_out_channels=(16, 32),
    down_block_types=("DownBlock2D", "AttnDownBlock2D"), up_block_types=("AttnUpBlock2D", "UpBlock2D"),
    norm_num_groups=8, attention_head_dim=8,
)
ATOL = 1e-4


def jax_draws(key, shape, count=64):
    """``noise_source`` of the JAX chain's draws: ``k, sub = split(k)``, then
    ``normal(sub)``, in order."""
    out = []
    for _ in range(count):
        key, sub = jax.random.split(key)
        out.append(torch.from_numpy(np.array(jax.random.normal(sub, shape, jnp.float32))))
    return out.__getitem__


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """The JAX TINY UNet (seeded), its params, and the port's copy through the HF layout."""
    model = JaxUNet2DModel(JaxUNet2DConfig(**TINY))
    params = jax.device_get(jax.jit(model.init_params)(jax.random.PRNGKey(0)))
    path = str(tmp_path_factory.mktemp("segment_pipe"))
    JaxDiffusionPipeline(model, params, JS.DDPMScheduler(JS.DDPMConfig())).save_pretrained(path)
    return model, params, DiffusionPipeline.from_pretrained(path, device="cpu").unet


def pipes(tiny, name, n, **kw):
    model, params, unet = tiny
    jcls, pcls = getattr(JS, name), getattr(PS, name)
    jpipe = JaxDiffusionPipeline(model, params, jcls(jcls.config_class(**kw)), default_inference_steps=n)
    return jpipe, DiffusionPipeline(unet, pcls(pcls.config_class(**kw)), default_inference_steps=n, device="cpu")


def both(jpipe, pipe, seg, seed, jax_too=True, **call):
    """The port's whole chain, its chain in segments of ``seg`` and the JAX
    package's in segments of ``seg`` (or None), from one init and the JAX
    draws. The port's noise index is the step index, where a JAX chain from
    ``start_from`` splits its first key at that step: the draws are shifted."""
    init = np.random.RandomState(seed).randn(*SHAPE).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    shift = call.get("start_from", 0)

    def noise(k, draws=jax_draws(key, SHAPE)):
        return draws(k - shift)

    pipe.segment_steps = None
    whole = pipe(init=init, noise_source=noise, output_type="pt", **call)
    pipe.segment_steps = seg
    got = pipe(init=init, noise_source=noise, output_type="pt", **call)
    jpipe.segment_steps = seg
    return whole, got, jpipe(key=key, init=init, **call) if jax_too else None


def assert_segmented(whole, got, want):
    assert torch.equal(got.sample, whole.sample) and torch.equal(got.images, whole.images)
    if want is not None:
        np.testing.assert_allclose(got.images.numpy(), np.asarray(want.images), atol=ATOL)
    if whole.movie is not None:
        assert torch.equal(got.movie, whole.movie) and torch.equal(got.movie[-1], got.images)
        if want is not None:
            np.testing.assert_allclose(got.movie.numpy(), np.asarray(want.movie), atol=ATOL)


@pytest.mark.parametrize("seg", [5, 4, 1], ids=["remainder", "divisor", "per-step"])
def test_segmented_ddpm_matches_whole_chain_and_jax(tiny, seg):
    """Every split bitwise the port's whole chain; the remainder split (the
    JAX package compiles a program for each segment length) against JAX's."""
    jpipe, pipe = pipes(tiny, "DDPMScheduler", 12)
    assert_segmented(*both(jpipe, pipe, seg, 3, jax_too=seg == 5))


def test_segmented_movie_matches(tiny):
    jpipe, pipe = pipes(tiny, "DDPMScheduler", 10)
    whole, got, want = both(jpipe, pipe, 5, 5, save_every_step=True, capture_every=3)
    assert got.movie.shape == (4,) + SHAPE
    assert_segmented(whole, got, want)


def test_segmented_unipc_state_carries_across_a_boundary(tiny):
    """UniPC carries its rings, last sample and order from step to step; a
    segment boundary must not reset them."""
    jpipe, pipe = pipes(tiny, "UniPCMultistepScheduler", 10)
    assert_segmented(*both(jpipe, pipe, 5, 0))


def test_segmented_with_start_from(tiny):
    jpipe, pipe = pipes(tiny, "DDPMScheduler", 10)
    assert_segmented(*both(jpipe, pipe, 2, 1, start_from=4, save_every_step=True, capture_every=3))


def test_segmented_sde_ve_matches_jax(tiny):
    """SDE-VE segments from step 0 and carries its last mean; one corrector
    and one predictor draw a step. Its images saturate the clip on random
    weights, so its sample before the clip is held instead, against the JAX
    chain's (which the JAX package's ``_run_segmented`` reproduces bitwise,
    tests/test_pipeline.py)."""
    jpipe, pipe = pipes(tiny, "ScoreSdeVeScheduler", 10)
    whole, got, _ = both(jpipe, pipe, 3, 2, jax_too=False, save_every_step=True, capture_every=4)
    assert_segmented(whole, got, None)
    model, params, _ = tiny
    js = jpipe.scheduler
    init = np.random.RandomState(2).randn(*SHAPE).astype(np.float32)

    @jax.jit
    def apply_fn(p, x, t):
        return model.apply({"params": p}, x, t).astype(x.dtype)

    want_sample = np.asarray(jax_sample_sde_ve(js, js.set_timesteps(js.create_state(), 10), apply_fn, params,
                                               jnp.asarray(init), jax.random.PRNGKey(2))[0])
    err = float(np.abs(got.sample.numpy() - want_sample).max())
    assert err <= 1e-4 + 1e-4 * float(np.abs(want_sample).max()), err


@pytest.mark.parametrize("name,seg,start_from,segmented", [
    ("DDPMScheduler", 3, 0, True),
    ("DDPMScheduler", 6, 0, False),  # a segment as long as the chain: one run
    ("DDPMScheduler", 2, 4, False),  # the chain after start_from is no longer than a segment
    ("DDPMScheduler", 1, 4, True),
    ("KarrasVeScheduler", 2, 0, False),  # never segmented, as in the JAX package
    ("ScoreSdeVeScheduler", 2, 0, True),
])
def test_dispatch_rule_is_jax_s(tiny, monkeypatch, name, seg, start_from, segmented):
    _, pipe = pipes(tiny, name, 6)
    ran = []
    real = sampler.Chain.run_eager

    def run_eager(self, init, model_fn, draw, segment_steps=None):
        if segment_steps:
            ran.append(segment_steps)
        return real(self, init, model_fn, draw, segment_steps)

    monkeypatch.setattr(sampler.Chain, "run_eager", run_eager)
    pipe.segment_steps = seg
    whole_kw = dict(batch_size=1, generator=torch.Generator().manual_seed(0), output_type="pt")
    if name == "DDPMScheduler":
        whole_kw["start_from"] = start_from
    got = pipe(**whole_kw)
    assert bool(ran) == segmented
    pipe.segment_steps = None
    whole_kw["generator"] = torch.Generator().manual_seed(0)
    assert torch.equal(pipe(**whole_kw).sample, got.sample)


def test_segmented_chain_draws_from_the_callers_generator(tiny):
    """Without a noise source the segments draw from the caller's generator
    in the whole chain's order, and leave it where the whole chain does."""
    _, pipe = pipes(tiny, "DDPMScheduler", 8)
    gens = [torch.Generator().manual_seed(11) for _ in range(2)]
    whole = pipe(batch_size=2, generator=gens[0], output_type="pt")
    pipe.segment_steps = 3
    got = pipe(batch_size=2, generator=gens[1], output_type="pt")
    assert torch.equal(got.sample, whole.sample)
    assert torch.equal(gens[0].get_state(), gens[1].get_state())
