"""The port's ANP defense against the JAX package on the CPU:
``init_perturb`` / ``apply_perturb`` / ``clip_perturb`` carried across with
``perturb_from_jax``, the identity forward at γ = 1, β = 0, one and two ANP
steps on the TINY UNet with JAX's own t/ε handed to the port, and
``anp_cli`` end to end on a run dir the port's CLI trained."""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from baddiffusion_tpu.defense import apply_perturb as jax_apply_perturb
from baddiffusion_tpu.defense import clip_perturb as jax_clip_perturb
from baddiffusion_tpu.defense import init_perturb as jax_init_perturb
from baddiffusion_tpu.defense import make_anp_step as jax_make_anp_step
from baddiffusion_tpu.io.hf import flax_to_torch_state_dict, torch_to_flax_params
from baddiffusion_tpu.models import UNet2DConfig as JaxUNet2DConfig
from baddiffusion_tpu.models import UNet2DModel as JaxUNet2DModel
from baddiffusion_tpu.training import make_optimizer as jax_make_optimizer
from baddiffusion_tpu_torch import anp_cli, cli, factory
from baddiffusion_tpu_torch.data import Backdoor, trigger_mask
from baddiffusion_tpu_torch.defense import (
    apply_perturb,
    clip_perturb,
    init_perturb,
    make_anp_step,
    perturb_leaves,
    perturbed_copy,
    perturbed_forward,
)
from baddiffusion_tpu_torch.io import perturb_from_jax
from baddiffusion_tpu_torch.models import UNet2DConfig, UNet2DModel
from baddiffusion_tpu_torch.schedulers import DDPMConfig, DDPMScheduler
from baddiffusion_tpu_torch.training import make_optimizer


@pytest.fixture(autouse=True)
def few_threads():
    """Two threads a BLAS/OpenMP pool (torch's, scipy's): the suite runs
    several pytest-xdist workers at once, and pools as wide as the machine
    then spin against each other (a 4 s test took 3 minutes)."""
    with threadpool_limits(limits=2):
        yield


# TINY with one attention pair, so that K3's plain twin is on the path
TINY = dict(
    sample_size=16, layers_per_block=1, block_out_channels=(8, 16), down_block_types=("DownBlock2D", "AttnDownBlock2D"),
    up_block_types=("AttnUpBlock2D", "UpBlock2D"), norm_num_groups=4, attention_head_dim=4,
)
T = 1000
LR = 5e-2
BUDGET = 1.05  # small enough that two steps of ±lr reach the clamp


@pytest.fixture(autouse=True)
def quiet_trackers(monkeypatch):
    """Trackers without tensorboard (importing it pulls TensorFlow in)."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


def _port_model(seed=0):
    """A seeded port UNet whose biases and GroupNorm affines are not 0 and 1."""
    model = UNet2DModel(UNet2DConfig(**TINY), device="cpu", generator=torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias") or ("norm" in name and name.endswith("weight")):
                p.add_(0.05 * torch.randn(p.shape, generator=g))
    return model


def _jax_params(model):
    return jax.tree_util.tree_map(jnp.asarray, torch_to_flax_params({k: v.numpy().copy()
                                                                     for k, v in model.state_dict().items()}))


def _random_perturb(jparams, seed=0):
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(lambda p: jnp.asarray(np.asarray(p) + rng.uniform(-0.5, 0.5, p.shape)
                                                        .astype(np.float32)), jax_init_perturb(jparams))


def _assert_perturb_equal(got, want, **tol):
    assert list(got) == list(want)
    for name in want:
        assert set(got[name]) == set(want[name]), name
        for k in want[name]:
            np.testing.assert_allclose(got[name][k].detach().numpy(), want[name][k].numpy(), err_msg=name, **tol)


def test_init_perturb_matches_jax():
    model = _port_model()
    got = init_perturb(model.state_dict())
    want = perturb_from_jax(jax.device_get(jax_init_perturb(_jax_params(model))))
    assert set(got) == set(want) and len(got) == 25  # every 4-D conv, each with a bias
    _assert_perturb_equal({k: got[k] for k in want}, want, rtol=0, atol=0)
    assert all(set(pt) == {"gamma", "beta"} for pt in got.values())
    assert list(got) == [n[: -len(".weight")] for n, p in model.named_parameters() if p.dim() == 4]


def test_init_perturb_skips_beta_without_a_bias():
    params = {"a.weight": torch.ones(4, 2, 3, 3), "a.bias": torch.ones(4), "b.weight": torch.ones(5, 4, 1, 1),
              "c.weight": torch.ones(3, 5)}
    pt = init_perturb(params)
    assert set(pt) == {"a", "b"} and set(pt["a"]) == {"gamma", "beta"} and set(pt["b"]) == {"gamma"}
    merged = apply_perturb(params, {"b": {"gamma": torch.full((5,), 2.0)}})
    assert set(merged) == {"b.weight"} and torch.equal(merged["b.weight"], torch.full((5, 4, 1, 1), 2.0))


def test_apply_and_clip_perturb_match_jax():
    model = _port_model()
    jparams = _jax_params(model)
    jpt = _random_perturb(jparams)
    pt = perturb_from_jax(jax.device_get(jpt))
    want = flax_to_torch_state_dict(jax.device_get(jax_apply_perturb(jparams, jpt)))
    got = apply_perturb(model.state_dict(), pt)
    assert len(got) == 50
    for k, v in got.items():
        np.testing.assert_allclose(v.numpy(), want[k], rtol=1e-6, atol=1e-7, err_msg=k)
    big = jax.tree_util.tree_map(lambda p: p * 20.0, jpt)
    clipped = clip_perturb(perturb_from_jax(jax.device_get(big)), 4.0)
    _assert_perturb_equal(clipped, perturb_from_jax(jax.device_get(jax_clip_perturb(big, 4.0))), rtol=0, atol=0)
    assert max(float(t.abs().max()) for t in perturb_leaves(clipped)) == 4.0
    same = clip_perturb(perturb_from_jax(jax.device_get(big)), None)
    _assert_perturb_equal(same, perturb_from_jax(jax.device_get(big)), rtol=0, atol=0)


def test_identity_forward_at_init():
    """γ = 1, β = 0 leaves the model unchanged, bit for bit (the reference's
    diff_output check, anp_util.py:103-120); a perturbed copy computes the
    perturbed forward."""
    model = _port_model()
    x = torch.randn(2, 16, 16, 3, generator=torch.Generator().manual_seed(1))
    t = torch.tensor([5, 500])
    pt = init_perturb(dict(model.named_parameters()))
    with torch.no_grad():
        assert torch.equal(perturbed_forward(model, pt, x, t), model(x, t))
        pt["conv_in"]["gamma"].fill_(2.0)
        pt["conv_in"]["beta"].fill_(0.3)
        y = perturbed_forward(model, pt, x, t)
        assert torch.equal(perturbed_copy(model, pt)(x, t), y) and not torch.equal(y, model(x, t))


def _poison(size=16):
    bd = Backdoor()
    trigger = bd.get_trigger("BOX_8", 3, size)
    target = bd.get_target("CORNER", trigger)
    return trigger, target, trigger_mask(trigger)


def _jax_draws(key, b, size=16):
    """The draws the JAX ANP step makes from ``key``: split → randint(t), normal(ε)."""
    k_t, k_eps = jax.random.split(key)
    return (np.asarray(jax.random.randint(k_t, (b,), 0, T)),
            np.asarray(jax.random.normal(k_eps, (b, size, size, 3), jnp.float32)))


def test_anp_steps_match_jax():
    """Two ANP steps, lr 5e-2 with a budget the second step reaches: loss,
    clean_mse, backdoor_mse and the 614 γ/β after each step within rtol 1e-4
    (γ/β near 0 within 1e-4·lr). Observed: γ/β within 4.8e-7 of JAX's."""
    model = _port_model()
    jparams = _jax_params(model)
    schedule = DDPMScheduler(DDPMConfig()).create_state().schedule
    opt, _ = make_optimizer(LR, schedule="constant")
    jopt, _ = jax_make_optimizer(LR, schedule="constant")
    step = make_anp_step(model, opt, T, schedule.alphas, schedule.alphas_cumprod, perturb_budget=BUDGET, device="cpu")
    jstep = jax_make_anp_step(JaxUNet2DModel(JaxUNet2DConfig(**TINY)), jopt, T, jnp.asarray(schedule.alphas.numpy()),
                              jnp.asarray(schedule.alphas_cumprod.numpy()), perturb_budget=BUDGET)
    pt = init_perturb(dict(model.named_parameters()))
    opt_state = opt.init(perturb_leaves(pt))
    jpt = jax_init_perturb(jparams)
    jopt_state = jopt.init(jpt)
    trigger, target, mask = _poison()
    rng = np.random.RandomState(0)
    for i in range(2):
        image = rng.randint(0, 256, (4, 16, 16, 3)).astype(np.uint8)
        is_clean = np.zeros(4, bool)  # the fully poisoned set
        key = jax.random.PRNGKey(10 + i)
        t, noise = _jax_draws(key, 4)
        jpt, jopt_state, jm = jstep(jparams, jpt, jopt_state, jnp.asarray(image), jnp.asarray(is_clean),
                                    jnp.asarray(trigger), jnp.asarray(target), jnp.asarray(mask), key)
        pt, opt_state, m = step(pt, opt_state, image, is_clean, trigger, target, mask, None,
                                timesteps=torch.tensor(t), noise=torch.tensor(noise))
        for k in ("loss", "clean_mse", "backdoor_mse"):
            assert float(m[k]) == pytest.approx(float(jm[k]), rel=1e-4), (i, k)
        want = perturb_from_jax(jax.device_get(jpt))
        diff = np.concatenate([np.abs(pt[n][k].numpy() - want[n][k].numpy()) for n in want for k in want[n]])
        ref = np.concatenate([np.abs(want[n][k].numpy()) for n in want for k in want[n]])
        off = diff > 1e-4 * ref + 1e-4 * LR
        assert not off.any(), (i, diff.max(), off.sum())
    assert max(float(t.abs().max()) for t in perturb_leaves(pt)) <= BUDGET
    assert opt_state.count == 2
    # the base weights did not move and take no gradient
    assert all(not p.requires_grad and p.grad is None for p in model.parameters())
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), flax_to_torch_state_dict(jax.device_get(jparams))[k])


def test_anp_step_draws_from_its_generator_and_raises_ascending_loss():
    """t and ε from the generator (the same generator seed gives the same
    step); the clean loss the step maximises goes up over steps."""
    trigger, target, mask = _poison()
    image = np.random.RandomState(1).randint(0, 256, (8, 16, 16, 3)).astype(np.uint8)
    losses = []
    for _ in range(2):
        model = _port_model()
        schedule = DDPMScheduler(DDPMConfig()).create_state().schedule
        opt, _ = make_optimizer(LR, schedule="constant")
        step = make_anp_step(model, opt, T, schedule.alphas, schedule.alphas_cumprod, device="cpu")
        pt = init_perturb(dict(model.named_parameters()))
        state = opt.init(perturb_leaves(pt))
        run = []
        for _ in range(6):
            pt, state, m = step(pt, state, image, np.zeros(8, bool), trigger, target, mask,
                                torch.Generator().manual_seed(3))
            run.append(float(m["clean_mse"]))
        losses.append(run)
    assert losses[0] == losses[1]
    assert losses[0][-1] > losses[0][0], losses[0]
    with pytest.raises(ValueError, match="generator"):
        step(pt, state, image, np.zeros(8, bool), trigger, target, mask, None)


def test_anp_cli_end_to_end(tmp_path, monkeypatch):
    """anp_cli on a run dir the port's CLI trained (TINY arch, CPU): the
    output dir's name, the per-epoch and final scores with *_best, finite
    losses and γ/β within the budget, and the export reloaded through
    factory.get_trained with the perturbation merged into its weights."""
    monkeypatch.setenv("BADDIFFUSION_TINY_ARCH", "1")
    monkeypatch.chdir(tmp_path)
    cli.main(["--mode", "train", "--dataset", "FAKE", "--batch", "128", "--epoch", "1", "--fake_size", "128",
              "--poison_rate", "0.25", "--trigger", "BOX_14", "--target", "CORNER", "--sampling_steps", "2",
              "--result", str(tmp_path), "-o", "--gpu", "cpu"])
    run = os.path.join(str(tmp_path), "res_None_FAKE_ep1_c1.0_p0.25_BOX_14-CORNER")
    anp_cli.main(["--ckpt", run, "--epoch", "2", "--batch", "16", "--fake_size", "32", "--measure_sample_n", "4",
                  "--sampling_steps", "2", "--perturb_budget", "1.02", "--learning_rate", "1e-2",
                  "--output_dir", str(tmp_path / "anp"), "--gpu", "cpu"])
    out = str(tmp_path / "anp") + os.sep + f"res_anp_2_lr0.01_pb1.02_{run}"  # naming_fn appends the ckpt as given
    assert os.path.isdir(out)
    with open(os.path.join(out, "config.json")) as f:
        cfg = json.load(f)
    assert (cfg["trigger"], cfg["target"], cfg["dataset"], cfg["poison_rate"]) == ("BOX_14", "CORNER", "FAKE", 0.25)
    with open(os.path.join(out, "score.json")) as f:
        sc = json.load(f)
    assert set(sc) == {"MSE", "MSE_best", "MSE_ep1", "MSE_ep2", "SSIM", "SSIM_best", "SSIM_ep1", "SSIM_ep2"}
    assert sc["MSE"] == sc["MSE_ep2"] and sc["MSE_best"] == min(sc["MSE_ep1"], sc["MSE_ep2"])
    assert sc["SSIM_best"] == max(sc["SSIM_ep1"], sc["SSIM_ep2"])
    with open(os.path.join(out, "logs", "metrics.jsonl")) as f:
        steps = [r for r in map(json.loads, f) if "loss" in r]
    assert len(steps) == 4 and all(np.isfinite([r["loss"], r["clean_mse"], r["backdoor_mse"]]).all() for r in steps)
    for sub in ("samples", "backdoor_samples"):
        assert {"ep0.png", "ep1.png", "epfinal.png"} <= set(os.listdir(os.path.join(out, sub)))
    assert len(os.listdir(os.path.join(out, "measure", "ep2"))) == 4

    exported, _, _ = factory.get_trained(out, dtype=torch.float32, device="cpu")
    base, _, _ = factory.get_trained(run, dtype=torch.float32, device="cpu")
    e, b = exported.state_dict(), base.state_dict()
    gamma = e["conv_in.weight"].flatten(1)[:, 0] / b["conv_in.weight"].flatten(1)[:, 0]
    assert not torch.equal(e["conv_in.weight"], b["conv_in.weight"])
    assert float(gamma.abs().max()) <= 1.02 + 1e-5 and float((gamma - 1).abs().max()) > 0  # moved, within ±budget
    assert all(torch.equal(e[k], b[k]) for k in b if not k.endswith((".weight", ".bias")) or "norm" in k)


def test_anp_config_needs_the_attack(tmp_path):
    os.makedirs(tmp_path / "run")
    with open(tmp_path / "run" / "args.json", "w") as f:
        json.dump({"trigger": None, "target": "CORNER", "dataset": "FAKE"}, f)
    with pytest.raises(ValueError, match="'trigger'"):
        anp_cli.get_config(["--ckpt", str(tmp_path / "run"), "--output_dir", str(tmp_path / "o")])
