"""A seeded mini-fuzz of the port's scheduler configs against the JAX
package's, in the pattern of ``tests/test_scheduler_fuzz.py``'s
``TestMiniFuzz``: random β schedule, prediction type, thresholding, order,
solver type and step count per family, each chain run by both packages from
the same init with the stand-in denoiser (and, for DDIM with η > 0, JAX's
own draws). Every divergence is reported with its config.

Bound: atol 1e-4 plus rtol 1e-4 of the chain's scale (its largest |x| over
every step of the JAX chain). Both packages derive the same α/σ/λ tables
(float64, cast once), so only the f32 order of operations differs.

And UniPC's small systems R·ρ = b where two ``rks`` nearly coincide: the
port solves them in float64; the JAX package's f32 Cramer's rule is printed
beside it.
"""

import random
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import baddiffusion_tpu.schedulers as JS
import baddiffusion_tpu_torch.schedulers as PS
from baddiffusion_tpu.pipelines.sampler import sample_loop as jax_sample_loop
from baddiffusion_tpu_torch.pipelines import sample_loop
from baddiffusion_tpu_torch.schedulers.unipc import solve_rhos, unipc_system

SHAPE = (2, 8, 8, 3)
SOLVER_BETA_SCHEDULES = ["linear", "scaled_linear", "squaredcos_cap_v2"]
PREDICTION_TYPES = ["epsilon", "sample", "v_prediction"]
CONFIGS_PER_FAMILY = 6


def jax_chain(sched, n, init, key):
    """The JAX chain's final sample and its scale (largest |x| of any step)."""
    state = sched.set_timesteps(sched.create_state(), n)
    scale = [float(np.abs(init).max())]

    def apply_fn(params, x, t):
        jax.debug.callback(lambda v: scale.append(float(np.abs(v).max())), x)
        return 0.1 * x + jnp.sin(t[0].astype(jnp.float32) / 100.0) * 0.05

    final, _ = jax_sample_loop(sched, state, apply_fn, None, jnp.asarray(init), key)
    final = np.asarray(final)
    return final, max(scale + [float(np.abs(final).max())])


def port_chain(sched, n, init, key):
    state = sched.set_timesteps(sched.create_state(), n)
    draws = []
    for _ in range(n):
        key, sub = jax.random.split(key)
        draws.append(torch.from_numpy(np.array(jax.random.normal(sub, SHAPE, jnp.float32))))

    def model_fn(x, t):
        return 0.1 * x + torch.sin(t[0].float() / 100.0) * 0.05

    final, _ = sample_loop(sched, state, model_fn, torch.from_numpy(init), noise_source=draws.__getitem__)
    return final.numpy()


def draw_configs():
    """(family, class name, kwargs, steps), seeded."""
    r = random.Random(424242)

    def common():
        return dict(num_train_timesteps=1000, beta_start=0.0001, beta_end=0.02,
                    beta_schedule=r.choice(SOLVER_BETA_SCHEDULES), prediction_type=r.choice(PREDICTION_TYPES))

    out = []
    for _ in range(CONFIGS_PER_FAMILY):
        out.append(("dpm", "DPMSolverMultistepScheduler", dict(
            common(), solver_order=r.choice([1, 2, 3]), thresholding=r.random() < 0.25,
            algorithm_type=r.choice(["dpmsolver", "dpmsolver++"]), solver_type=r.choice(["midpoint", "heun"]),
            lower_order_final=r.random() < 0.7, use_karras_sigmas=r.random() < 0.2), r.choice([5, 8, 12])))
        out.append(("unipc", "UniPCMultistepScheduler", dict(
            common(), solver_order=r.choice([1, 2, 3]), thresholding=r.random() < 0.25,
            predict_x0=r.random() < 0.7, solver_type=r.choice(["bh1", "bh2"]),
            lower_order_final=r.random() < 0.7, disable_corrector=r.choice([(), (1,)])), r.choice([5, 8, 12])))
        out.append(("deis", "DEISMultistepScheduler", dict(
            common(), solver_order=r.choice([1, 2, 3]), thresholding=r.random() < 0.25,
            lower_order_final=r.random() < 0.7), r.choice([5, 8, 12])))
        out.append(("ddim", "DDIMScheduler", dict(
            common(), clip_sample=r.random() < 0.5, set_alpha_to_one=r.random() < 0.5,
            steps_offset=r.choice([0, 1]), thresholding=r.random() < 0.25, eta=r.choice([0.0, 0.3, 1.0]),
            use_clipped_model_output=r.random() < 0.5), r.choice([5, 8, 12])))
        pndm = dict(common(), skip_prk_steps=r.random() < 0.5, set_alpha_to_one=r.random() < 0.5,
                    steps_offset=r.choice([0, 1]))
        pndm["prediction_type"] = r.choice(["epsilon", "v_prediction"])
        out.append(("pndm", "PNDMScheduler", pndm, r.choice([8, 12])))
        for family, name in (("heun", "HeunDiscreteScheduler"), ("lms", "LMSDiscreteScheduler")):
            out.append((family, name, dict(
                num_train_timesteps=1000, beta_start=r.choice([0.0001, 0.00085]), beta_end=r.choice([0.012, 0.02]),
                beta_schedule=r.choice(["linear", "scaled_linear"]),
                prediction_type=r.choice(["epsilon", "v_prediction"])), r.choice([6, 10])))
    return out


CONFIGS = draw_configs()


@pytest.mark.parametrize("family", sorted({c[0] for c in CONFIGS}))
def test_mini_fuzz_matches_jax(family):
    failures = []
    for fam, name, kw, n in CONFIGS:
        if fam != family:
            continue
        jcls, pcls = getattr(JS, name), getattr(PS, name)
        init = np.random.RandomState(0).randn(*SHAPE).astype(np.float32)
        key = jax.random.PRNGKey(1)
        want, scale = jax_chain(jcls(jcls.config_class(**kw)), n, init, key)
        tag = f"{name} steps={n} {kw}"
        if not np.isfinite(want).all():
            failures.append(f"{tag}: the JAX chain is not finite")
            continue
        got = port_chain(pcls(pcls.config_class(**kw)), n, init, key)
        err = float(np.abs(got - want).max())
        if not (np.isfinite(got).all() and err <= 1e-4 + 1e-4 * scale):
            failures.append(f"{tag}: max err {err:.3e} (chain scale {scale:.3e})")
    assert not failures, "\n".join(failures)


def test_fuzz_draws_every_family():
    assert {c[0] for c in CONFIGS} == {"dpm", "unipc", "deis", "ddim", "pndm", "heun", "lms"}


def exact_solve(R: np.ndarray, b: np.ndarray) -> np.ndarray:
    """R·ρ = b in rational arithmetic on the float64 entries: the true ρ."""
    n = len(b)
    a = [[Fraction(float(R[i, j])) for j in range(n)] + [Fraction(float(b[i]))] for i in range(n)]
    for c in range(n):
        p = next(r for r in range(c, n) if a[r][c] != 0)
        a[c], a[p] = a[p], a[c]
        for r in range(n):
            if r != c:
                f = a[r][c] / a[c][c]
                a[r] = [x - f * y for x, y in zip(a[r], a[c])]
    return np.array([float(a[i][n] / a[i][i]) for i in range(n)])


@pytest.mark.parametrize("gap", [1e-3, 1e-5, 1e-7])
@pytest.mark.parametrize("solver_type", ["bh1", "bh2"])
def test_unipc_near_duplicate_rks_solved_in_float64(gap, solver_type):
    """Order 3's corrector system with two ``rks`` ``gap`` apart (R is then
    nearly singular, cond(R) ~ 1/gap): the port's float64 ρ satisfies
    R·ρ = b to 1e-12 relative (normwise: |Rρ − b| over |R|·|ρ| + |b|) and
    lies within 1e-15·cond(R) of the exact ρ. The JAX package's f32
    Cramer's rule on the same system is printed beside it (not asserted: the
    JAX package is the reference and stays as it is)."""
    hh = -0.35  # one step of a 20-step chain predicting x0
    R, b = unipc_system(np.array([-1.0, -1.0 - gap, 1.0]), hh, solver_type)
    rho = np.linalg.solve(R, b)
    exact = exact_solve(R, b)
    norm = np.abs(R).sum(axis=1).max() * np.abs(rho).max() + np.abs(b).max()
    assert np.abs(R @ rho - b).max() <= 1e-12 * norm
    cond = np.linalg.cond(R, np.inf)
    port_err = np.abs(rho - exact).max() / np.abs(exact).max()
    assert port_err <= 1e-15 * cond
    np.testing.assert_array_equal(solve_rhos(R, b).numpy(), rho.astype(np.float32))

    jax_rho = np.asarray(JS.UniPCMultistepScheduler._solve_small(jnp.asarray(R, jnp.float32),
                                                                 jnp.asarray(b, jnp.float32)), np.float64)
    jax_err = np.abs(jax_rho - exact).max() / np.abs(exact).max()
    print(f"gap {gap:g} {solver_type}: cond(R) {cond:.3g}, |rho| {np.abs(exact).max():.3g}; relative error of "
          f"rho: port (float64 solve) {port_err:.3g}, JAX (f32 Cramer) {jax_err:.3g}")


def test_unipc_chain_solves_in_float64(monkeypatch):
    """A UniPC order-3 chain goes through the float64 solve for every system
    past order 2 (the JAX Cramer path is never taken)."""
    from baddiffusion_tpu_torch.schedulers import unipc

    calls = []
    real = unipc.solve_rhos
    monkeypatch.setattr(unipc, "solve_rhos", lambda R, b: calls.append((R.shape, R.dtype, b.dtype)) or real(R, b))
    sched = PS.UniPCMultistepScheduler(solver_order=3)
    port_chain(sched, 8, np.random.RandomState(0).randn(*SHAPE).astype(np.float32), jax.random.PRNGKey(0))
    assert {c[0] for c in calls} == {(2, 2), (3, 3)}
    assert all(c[1] == c[2] == np.float64 for c in calls)
