"""The port's DDPM scheduler against the JAX package's, on the CPU.

The JAX step draws its noise from a key inside itself; the test draws the
same numbers with ``jax.random.normal`` on the same key and hands them to the
port's step, so the two steps see identical inputs.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from baddiffusion_tpu.schedulers import DDPMConfig as JaxDDPMConfig
from baddiffusion_tpu.schedulers import DDPMScheduler as JaxDDPMScheduler
from baddiffusion_tpu.schedulers import load_scheduler as jax_load_scheduler
from baddiffusion_tpu.schedulers.base import make_betas as jax_make_betas
from baddiffusion_tpu.schedulers.base import spaced_timesteps as jax_spaced_timesteps
from baddiffusion_tpu.schedulers.base import threshold_sample as jax_threshold_sample
from baddiffusion_tpu_torch.schedulers import DDPMConfig, DDPMScheduler, load_scheduler, make_betas, spaced_timesteps
from baddiffusion_tpu_torch.schedulers.base import threshold_sample


def _pair(**kw):
    return JaxDDPMScheduler(JaxDDPMConfig(**kw)), DDPMScheduler(DDPMConfig(**kw))


def test_variance_triple():
    sched = DDPMScheduler(DDPMConfig())
    state = sched.create_state()
    assert abs(float(sched.variance(state, 0)) - 0.0) < 1e-5
    assert abs(float(sched.variance(state, 487)) - 0.00979) < 1e-5
    assert abs(float(sched.variance(state, 999)) - 0.02) < 1e-5


@pytest.mark.parametrize("schedule", ["linear", "scaled_linear", "squaredcos_cap_v2", "sigmoid"])
def test_make_betas_matches_jax(schedule):
    np.testing.assert_array_equal(make_betas(schedule, 1e-4, 0.02, 1000), jax_make_betas(schedule, 1e-4, 0.02, 1000))


@pytest.mark.parametrize("n", [1, 10, 50, 1000])
def test_spaced_timesteps_match_jax(n):
    np.testing.assert_array_equal(spaced_timesteps(1000, n), jax_spaced_timesteps(1000, n))


@pytest.mark.parametrize(
    "variance_type", ["fixed_small", "fixed_small_log", "fixed_large", "fixed_large_log"]
)
def test_variance_types_match_jax(variance_type):
    js, ps = _pair(variance_type=variance_type)
    jstate, pstate = js.create_state(), ps.create_state()
    for t in (0, 1, 487, 999):
        np.testing.assert_allclose(float(ps.variance(pstate, t)), float(js.variance(jstate, jnp.asarray(t))), rtol=1e-6)


STEP_CASES = {
    "default": {},
    "no_clip": {"clip_sample": False},
    "thresholding": {"thresholding": True, "sample_max_value": 1.5},
    "clip_defense": {"clip_defense": True, "clip_defense_range": 0.8},
    "fixed_small_log": {"variance_type": "fixed_small_log"},
    "learned_range": {"variance_type": "learned_range"},
    "v_prediction": {"prediction_type": "v_prediction"},
    "sample_prediction": {"prediction_type": "sample", "beta_schedule": "squaredcos_cap_v2"},
}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_step_matches_jax_with_injected_noise(case):
    """A 10-step chain of steps with the same model outputs and the same noise:
    the JAX key sequence follows the sampler's ``k, sub = split(k)``."""
    kw = STEP_CASES[case]
    js, ps = _pair(**kw)
    jstate = js.set_timesteps(js.create_state(), 10)
    pstate = ps.set_timesteps(ps.create_state(), 10)
    rng = np.random.RandomState(7)
    channels = 6 if kw.get("variance_type") == "learned_range" else 3
    sample = rng.randn(2, 4, 4, 3).astype(np.float32) * 1.5
    js_sample, ps_sample = jnp.asarray(sample), torch.from_numpy(sample)
    key = jax.random.PRNGKey(3)
    for i in range(10):
        model_out = rng.randn(2, 4, 4, channels).astype(np.float32)
        key, sub = jax.random.split(key)
        # the JAX step draws noise of the sample's shape (after the learned-variance split)
        noise = np.array(jax.random.normal(sub, sample.shape, jnp.float32))
        _, js_sample, jx0 = js.step(jstate, jnp.asarray(model_out), i, js_sample, sub)
        _, ps_sample, px0 = ps.step(pstate, torch.from_numpy(model_out), i, ps_sample, torch.from_numpy(noise))
        np.testing.assert_allclose(px0.numpy(), np.asarray(jx0), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(ps_sample.numpy(), np.asarray(js_sample), atol=1e-5, rtol=1e-5)


def test_step_without_noise_is_the_posterior_mean():
    js, ps = _pair()
    jstate, pstate = js.create_state(), ps.create_state()
    rng = np.random.RandomState(1)
    x, eps = rng.randn(1, 2, 2, 3).astype(np.float32), rng.randn(1, 2, 2, 3).astype(np.float32)
    _, jprev, _ = js.step(jstate, jnp.asarray(eps), 500, jnp.asarray(x))
    _, pprev, _ = ps.step(pstate, torch.from_numpy(eps), 500, torch.from_numpy(x))
    np.testing.assert_allclose(pprev.numpy(), np.asarray(jprev), atol=1e-6)


def test_add_noise_matches_jax():
    js, ps = _pair()
    rng = np.random.RandomState(2)
    x0, noise = rng.randn(3, 4, 4, 3).astype(np.float32), rng.randn(3, 4, 4, 3).astype(np.float32)
    t = np.array([0, 487, 999], np.int32)
    want = js.add_noise(js.create_state(), jnp.asarray(x0), jnp.asarray(noise), jnp.asarray(t))
    got = ps.add_noise(ps.create_state(), torch.from_numpy(x0), torch.from_numpy(noise), torch.from_numpy(t))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_threshold_sample_matches_jax():
    x = np.random.RandomState(4).randn(3, 8, 8, 3).astype(np.float32) * 2
    np.testing.assert_allclose(
        threshold_sample(torch.from_numpy(x), 0.9, 1.7).numpy(), np.asarray(jax_threshold_sample(jnp.asarray(x), 0.9, 1.7)),
        atol=1e-6,
    )


def test_config_json_round_trips_both_ways(tmp_path):
    cfg = DDPMConfig(clip_defense=True, beta_schedule="squaredcos_cap_v2", trained_betas=None)
    DDPMScheduler(cfg).save_config(str(tmp_path / "port"))
    assert jax_load_scheduler(str(tmp_path / "port")).config == JaxDDPMConfig(**dataclasses.asdict(cfg))
    JaxDDPMScheduler(JaxDDPMConfig(variance_type="fixed_large")).save_config(str(tmp_path / "jax"))
    loaded = load_scheduler(str(tmp_path / "jax"))
    assert isinstance(loaded, DDPMScheduler) and loaded.config == DDPMConfig(variance_type="fixed_large")


def test_threshold_sample_row_by_row_past_the_quantile_limit(monkeypatch):
    from baddiffusion_tpu_torch.schedulers import base

    x = torch.from_numpy(np.random.RandomState(5).randn(4, 8, 8, 3).astype(np.float32) * 2)
    whole = threshold_sample(x, 0.95, 2.0)
    monkeypatch.setattr(base, "QUANTILE_MAX_ELEMENTS", 100)
    assert torch.equal(threshold_sample(x, 0.95, 2.0), whole)
