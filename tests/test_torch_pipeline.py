"""The port's DDPM pipeline against the JAX package's on the CPU: checkpoint
interchange, a 10-step chain from the same weights and the same noise (the
JAX key sequence reproduced with ``jax.random``), and the backdoor trigger
that turns ``noise + trigger`` into the backdoor init."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from baddiffusion_tpu.data.triggers import Backdoor as JaxBackdoor
from baddiffusion_tpu.data.triggers import trigger_mask as jax_trigger_mask
from baddiffusion_tpu.models import UNet2DConfig as JaxUNet2DConfig
from baddiffusion_tpu.models import UNet2DModel as JaxUNet2DModel
from baddiffusion_tpu.pipelines import DiffusionPipeline as JaxDiffusionPipeline
from baddiffusion_tpu.schedulers import DDPMConfig as JaxDDPMConfig
from baddiffusion_tpu.schedulers import DDPMScheduler as JaxDDPMScheduler
from baddiffusion_tpu_torch.data import Backdoor, trigger_mask
from baddiffusion_tpu_torch.pipelines import DiffusionPipeline, batch_sampling

TINY = dict(
    sample_size=8,
    in_channels=3,
    out_channels=3,
    layers_per_block=1,
    block_out_channels=(16, 32),
    down_block_types=("DownBlock2D", "AttnDownBlock2D"),
    up_block_types=("AttnUpBlock2D", "UpBlock2D"),
    norm_num_groups=8,
    attention_head_dim=8,
)
STEPS = 10


@pytest.fixture(scope="module")
def jax_pipe_dir(tmp_path_factory):
    """A JAX pipeline (seeded tiny UNet, DDPM) saved in the HF layout."""
    model = JaxUNet2DModel(JaxUNet2DConfig(**TINY))
    params = jax.device_get(jax.jit(model.init_params)(jax.random.PRNGKey(0)))
    pipe = JaxDiffusionPipeline(model, params, JaxDDPMScheduler(JaxDDPMConfig()), default_inference_steps=STEPS)
    path = str(tmp_path_factory.mktemp("jax_pipe"))
    pipe.save_pretrained(path)
    return pipe, path


def _jax_chain_noise(key, shape, start_from):
    """The per-step noise the JAX sampler draws: ``k, sub = split(k)`` then
    ``normal(sub)`` at every step index from ``start_from``."""
    noises = {}
    for i in range(start_from, STEPS):
        key, sub = jax.random.split(key)
        noises[i] = torch.from_numpy(np.array(jax.random.normal(sub, shape, jnp.float32)))
    return noises.__getitem__


def test_jax_checkpoint_loads_into_the_port(jax_pipe_dir):
    jpipe, path = jax_pipe_dir
    pipe = DiffusionPipeline.from_pretrained(path, device="cpu")
    assert pipe.scheduler.config.__dict__ == jpipe.scheduler.config.__dict__
    assert pipe.unet.config.block_out_channels == TINY["block_out_channels"]
    w = pipe.unet.state_dict()["down_blocks.1.attentions.0.query.weight"].numpy()
    np.testing.assert_array_equal(w, jpipe.params["down_blocks_1"]["attentions_0"]["query"]["kernel"].T)


CHAIN_CASES = {
    "plain": {},
    "clip_each_step": {"clip_each_step": 0.5},
    "start_from_and_movie": {"start_from": 3, "capture_every": 4},
    "movie_every_step": {"capture_every": 1},
}


@pytest.mark.parametrize("case", sorted(CHAIN_CASES))
def test_chain_matches_jax(jax_pipe_dir, case):
    kw = CHAIN_CASES[case]
    jpipe, path = jax_pipe_dir
    clip = kw.get("clip_each_step")
    start_from = kw.get("start_from", 0)
    capture_every = kw.get("capture_every")
    jpipe = JaxDiffusionPipeline(jpipe.unet, jpipe.params, jpipe.scheduler, clip_each_step=clip,
                                 default_inference_steps=STEPS)
    pipe = DiffusionPipeline.from_pretrained(path, device="cpu", clip_each_step=clip, default_inference_steps=STEPS)

    init = np.random.RandomState(6).randn(2, 8, 8, 3).astype(np.float32)
    key = jax.random.PRNGKey(11)
    call = dict(init=init, save_every_step=capture_every is not None, capture_every=capture_every, start_from=start_from)
    want = jpipe(key=key, **call)
    got = pipe(noise_source=_jax_chain_noise(key, init.shape, start_from), **call)
    np.testing.assert_allclose(got.images, want.images, atol=1e-4)
    if capture_every is None:
        assert got.movie is None and want.movie is None
    else:
        assert got.movie.shape == want.movie.shape
        np.testing.assert_allclose(got.movie, want.movie, atol=1e-4)
        np.testing.assert_array_equal(got.movie[-1], got.images)


TRIGGERS = ["BOX_14", "BOX_4", "SM_BOX", "STOP_SIGN_14", "GLASSES", "NONE"]


@pytest.mark.parametrize("trigger", TRIGGERS)
def test_trigger_matches_jax(trigger):
    got = Backdoor().get_trigger(trigger, 3, 32)
    want = JaxBackdoor().get_trigger(trigger, 3, 32)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(trigger_mask(got), jax_trigger_mask(want))


@pytest.mark.parametrize("target", ["TRIGGER", "SHIFT", "CORNER", "HAT", "CAT"])
def test_target_matches_jax(target):
    trig = Backdoor().get_trigger("STOP_SIGN_14", 3, 32)
    np.testing.assert_array_equal(Backdoor().get_target(target, trig), JaxBackdoor().get_target(target, trig))


def test_digit_trigger_raises_without_its_dataset(tmp_path):
    with pytest.raises(RuntimeError, match="MNIST"):
        Backdoor(root=str(tmp_path)).get_trigger("MNIST", 1, 32)


def test_backdoor_init_is_unmasked_noise_plus_trigger(jax_pipe_dir):
    """The backdoor chain starts from ``noise + trigger`` (no mask), as the JAX
    trainer's qualitative sampler builds it; both packages then sample the
    same images from it."""
    jpipe, path = jax_pipe_dir
    key = jax.random.PRNGKey(0)
    noise = np.asarray(jax.random.normal(key, (2, 8, 8, 3), jnp.float32))
    init = noise + Backdoor().get_trigger("BOX_14", 3, 8)[None]
    np.testing.assert_array_equal(init, noise + JaxBackdoor().get_trigger("BOX_14", 3, 8)[None])
    want = jpipe(init=init, key=key)
    pipe = DiffusionPipeline.from_pretrained(path, device="cpu", default_inference_steps=STEPS)
    got = pipe(init=init, noise_source=_jax_chain_noise(key, init.shape, 0))
    np.testing.assert_allclose(got.images, want.images, atol=1e-4)


def test_generator_sampling_is_seeded_and_batch_sampling_splits(jax_pipe_dir):
    _, path = jax_pipe_dir
    pipe = DiffusionPipeline.from_pretrained(path, device="cpu", default_inference_steps=3)
    a = pipe(batch_size=3, generator=torch.Generator().manual_seed(1)).images
    b = pipe(batch_size=3, generator=torch.Generator().manual_seed(1)).images
    np.testing.assert_array_equal(a, b)
    assert a.shape == (3, 8, 8, 3) and a.min() >= 0.0 and a.max() <= 1.0
    out = batch_sampling(5, pipe, max_batch_n=2, seed=2)
    assert out.shape == (5, 8, 8, 3) and np.isfinite(out).all()
    np.testing.assert_array_equal(out, batch_sampling(5, pipe, max_batch_n=2, seed=2))


def test_port_round_trip_and_bf16_compute(jax_pipe_dir, tmp_path):
    _, path = jax_pipe_dir
    pipe = DiffusionPipeline.from_pretrained(path, device="cpu", default_inference_steps=STEPS)
    pipe.save_pretrained(str(tmp_path))
    again = DiffusionPipeline.from_pretrained(str(tmp_path), device="cpu", default_inference_steps=STEPS,
                                              compute_dtype=torch.bfloat16)
    init = np.random.RandomState(8).randn(2, 8, 8, 3).astype(np.float32)
    noise = _jax_chain_noise(jax.random.PRNGKey(5), init.shape, 0)
    f32 = pipe(init=init, noise_source=noise).images
    b16 = again(init=init, noise_source=noise).images
    assert again.unet.dtype == torch.float32  # the bf16 copy is per call
    assert np.abs(b16 - f32).max() < 0.1
