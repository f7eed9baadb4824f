"""The port's training slice against the JAX package on the CPU: poison
compositing, the backdoor q-sample and loss reductions, the LR schedules, the
clip + Adam optimizer against optax, and the train step itself (one and two
steps, gradients, grad_accum, remat) with JAX's own draws of t and ε handed
to the port."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from baddiffusion_tpu.attack.loss import backdoor_loss as jax_backdoor_loss
from baddiffusion_tpu.attack.loss import q_sample_backdoor as jax_q_sample_backdoor
from baddiffusion_tpu.attack.loss import reduce_loss as jax_reduce_loss
from baddiffusion_tpu.data.poison import poison_batch as jax_poison_batch
from baddiffusion_tpu.data.poison import poison_batch_host as jax_poison_batch_host
from baddiffusion_tpu.io.hf import flax_to_torch_state_dict, torch_to_flax_params
from baddiffusion_tpu.models import UNet2DConfig as JaxUNet2DConfig
from baddiffusion_tpu.models import UNet2DModel as JaxUNet2DModel
from baddiffusion_tpu.models.unet2d import DEFAULT_SCRATCH_CONFIG as JAX_SCRATCH
from baddiffusion_tpu.training import create_train_state as jax_create_train_state
from baddiffusion_tpu.training import make_optimizer as jax_make_optimizer
from baddiffusion_tpu.training import make_train_step as jax_make_train_step
from baddiffusion_tpu.training import optim as jax_optim
from baddiffusion_tpu_torch.attack import q_sample_backdoor, reduce_loss
from baddiffusion_tpu_torch.data import Backdoor, poison_batch, poison_batch_host, trigger_mask
from baddiffusion_tpu_torch.models import DEFAULT_SCRATCH_CONFIG, UNet2DConfig, UNet2DModel
from baddiffusion_tpu_torch.schedulers import DDPMConfig, DDPMScheduler
from baddiffusion_tpu_torch.training import create_train_state, make_optimizer, make_train_step
from baddiffusion_tpu_torch.training import optim

# the JAX package's training-test model (tests/test_training.py)
TINY = dict(
    sample_size=16, layers_per_block=1, block_out_channels=(8, 16), down_block_types=("DownBlock2D", "DownBlock2D"),
    up_block_types=("UpBlock2D", "UpBlock2D"), norm_num_groups=4, attention_head_dim=4,
)
T = 1000
LR = 1e-3


def _schedule():
    return DDPMScheduler(DDPMConfig()).create_state().schedule


def _poison_constants(size):
    bd = Backdoor()
    trigger = bd.get_trigger("BOX_14" if size >= 32 else "BOX_8", 3, size)
    target = bd.get_target("CORNER", trigger)
    return trigger, target, trigger_mask(trigger)


def _batch(b, size, seed):
    rng = np.random.RandomState(seed)
    image = rng.randint(0, 256, (b, size, size, 3)).astype(np.uint8)
    is_clean = np.arange(b) % 3 != 1  # poison and clean rows both present
    return image, is_clean


def _jax_draws(key, b, size, grad_accum=1):
    """The draws the JAX step makes from ``key``: per micro-batch,
    split → randint(t), normal(ε) (training/train.py)."""
    keys = [key] if grad_accum == 1 else list(jax.random.split(key, grad_accum))
    micro = b // grad_accum
    ts, noises = [], []
    for k in keys:
        k_t, k_eps = jax.random.split(k)
        ts.append(np.asarray(jax.random.randint(k_t, (micro,), 0, T)))
        noises.append(np.asarray(jax.random.normal(k_eps, (micro, size, size, 3), jnp.float32)))
    return np.concatenate(ts), np.concatenate(noises)


def _port_model(cfg_kwargs, seed=0, device="cpu", dtype=torch.float32):
    """A seeded port UNet whose biases and GroupNorm affines are not 0 and 1,
    so that a gradient of either cannot be mixed up unseen."""
    model = UNet2DModel(UNet2DConfig(**cfg_kwargs), device=device, generator=torch.Generator().manual_seed(seed),
                        dtype=dtype)
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias") or ("norm" in name and name.endswith("weight")):
                p.add_(0.05 * torch.randn(p.shape, generator=g))
    return model


def _to_jax(model):
    return jax.tree_util.tree_map(jnp.asarray, torch_to_flax_params({k: v.numpy() for k, v in model.state_dict().items()}))


class Pair:
    """The same TINY model, optimizer, schedule and poisoning on both sides."""

    def __init__(self, grad_accum=1, use_remat=False, warmup=0, cfg=TINY, size=16, seed=0):
        self.size = size
        self.model = _port_model(cfg, seed)
        trigger, target, mask = _poison_constants(size)
        sched = _schedule()
        opt, _ = make_optimizer(LR, num_warmup_steps=warmup, num_training_steps=100)
        self.state = create_train_state(self.model, opt, trigger, target, mask)
        self.step = make_train_step(self.model, opt, T, sched.alphas, sched.alphas_cumprod, grad_accum=grad_accum,
                                    use_remat=use_remat, device="cpu")
        self.jmodel = JaxUNet2DModel(JaxUNet2DConfig(**cfg))
        jopt, _ = jax_make_optimizer(LR, num_warmup_steps=warmup, num_training_steps=100)
        self.jstate = jax_create_train_state(_to_jax(self.model), jopt, trigger, target, mask)
        self.jstep = jax_make_train_step(self.jmodel, jopt, T, jnp.asarray(sched.alphas.numpy()),
                                         jnp.asarray(sched.alphas_cumprod.numpy()), grad_accum=grad_accum)
        self.grad_accum = grad_accum

    def run(self, image, is_clean, seed):
        key = jax.random.PRNGKey(seed)
        t, noise = _jax_draws(key, image.shape[0], self.size, self.grad_accum)
        self.jstate, jm = self.jstep(self.jstate, jnp.asarray(image), jnp.asarray(is_clean), key)
        self.state, m = self.step(self.state, torch.from_numpy(image), torch.from_numpy(is_clean), None,
                                  timesteps=torch.from_numpy(t), noise=torch.from_numpy(noise))
        return {k: float(v) for k, v in m.items()}, {k: float(v) for k, v in jm.items()}

    def param_diffs(self):
        want = flax_to_torch_state_dict(jax.device_get(self.jstate.params))
        return {k: np.abs(p.detach().numpy() - want[k]) for k, p in self.state.params.items()}


def _assert_params_close(diffs, lr):
    """Adam's first steps are sign-like (m̂/√v̂ = g/|g| at step 1): where a
    gradient element is within rounding of zero, g/|g| is ill-conditioned
    and the two sides may move it by anything up to ±lr. So: every parameter
    within 2·lr per step (two steps) of JAX's, and all but 1e-3 of them
    within 1e-6 (both sides f32 on the CPU; measured: 16 of 41,899 TINY
    parameters past 1e-6 after two steps, the largest 2.5e-5)."""
    flat = np.concatenate([d.ravel() for d in diffs.values()])
    assert flat.max() <= 4 * lr + 1e-6, flat.max()
    assert (flat > 1e-6).mean() <= 1e-3, (flat > 1e-6).mean()


# ----------------------------------------------------------------- data / loss


def test_poison_batch_matches_jax():
    trigger, target, mask = _poison_constants(32)
    image, is_clean = _batch(6, 32, seed=1)
    want = jax_poison_batch(jnp.asarray(image), jnp.asarray(is_clean), jnp.asarray(trigger), jnp.asarray(target),
                            jnp.asarray(mask))
    got = poison_batch(torch.from_numpy(image), torch.from_numpy(is_clean), *(torch.from_numpy(a) for a in
                                                                             (trigger, target, mask)))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)
    assert not got[1][is_clean].any()  # clean rows carry no residual


def test_poison_batch_host_matches_jax():
    trigger, target, mask = _poison_constants(16)
    image, is_clean = _batch(4, 16, seed=2)
    got = poison_batch_host(image, is_clean, trigger, target, mask, vmin=0.0, vmax=1.0)
    want = jax_poison_batch_host(image, is_clean, trigger, target, mask, vmin=0.0, vmax=1.0)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-6, err_msg=k)


def test_q_sample_backdoor_matches_jax():
    sched = _schedule()
    rng = np.random.RandomState(3)
    x0, R, noise = (rng.randn(5, 8, 8, 3).astype(np.float32) for _ in range(3))
    t = np.array([0, 1, 500, 998, 999])
    want = jax_q_sample_backdoor(jnp.asarray(sched.alphas.numpy()), jnp.asarray(sched.alphas_cumprod.numpy()),
                                 jnp.asarray(x0), jnp.asarray(R), jnp.asarray(t), jnp.asarray(noise))
    got = q_sample_backdoor(sched.alphas, sched.alphas_cumprod, *(torch.from_numpy(a) for a in (x0, R, t, noise)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


@pytest.mark.parametrize("loss_type", ["l2", "l1", "huber"])
def test_reduce_loss_matches_jax(loss_type):
    """Mean over all elements in f32; the differences span both huber
    branches. bf16 predictions are widened to f32 first on both sides."""
    rng = np.random.RandomState(4)
    pred, target = (2.0 * rng.randn(3, 8, 8, 3).astype(np.float32) for _ in range(2))
    want = float(jax_reduce_loss(jnp.asarray(pred), jnp.asarray(target), loss_type))
    got = reduce_loss(torch.from_numpy(pred), torch.from_numpy(target), loss_type)
    assert got.dtype == torch.float32 and got.dim() == 0
    assert float(got) == pytest.approx(want, rel=1e-6)
    pred16 = torch.from_numpy(pred).to(torch.bfloat16)
    want16 = float(jax_reduce_loss(jnp.asarray(pred16.float().numpy()).astype(jnp.bfloat16), jnp.asarray(target),
                                   loss_type))
    assert float(reduce_loss(pred16, torch.from_numpy(target), loss_type)) == pytest.approx(want16, rel=1e-6)


def test_reduce_loss_rejects_unknown_type():
    with pytest.raises(NotImplementedError, match="loss_type"):
        reduce_loss(torch.zeros(1), torch.zeros(1), "l3")


# ------------------------------------------------------------------ optimizer

SCHEDULES = {
    "cosine": (optim.cosine_schedule_with_warmup, jax_optim.cosine_schedule_with_warmup, (2e-4, 10, 100)),
    "linear": (optim.linear_schedule_with_warmup, jax_optim.linear_schedule_with_warmup, (2e-4, 10, 100)),
    "constant_with_warmup": (optim.constant_schedule_with_warmup, jax_optim.constant_schedule_with_warmup, (2e-4, 10)),
    "polynomial": (optim.polynomial_schedule_with_warmup, jax_optim.polynomial_schedule_with_warmup, (2e-4, 10, 100)),
    "cosine_with_restarts": (optim.cosine_with_restarts_schedule_with_warmup,
                             jax_optim.cosine_with_restarts_schedule_with_warmup, (2e-4, 10, 100, 3)),
}
STEPS = [0, 1, 5, 9, 10, 11, 37, 50, 99, 100, 101, 150]


@pytest.mark.parametrize("name", sorted(SCHEDULES) + ["constant"])
def test_schedules_match_jax(name):
    """The five warmup schedules and ``constant``, through ``make_optimizer``
    where it builds them, at steps across warmup, decay and past the end.
    JAX computes in f32, the port in Python floats: rtol 1e-6, and atol
    1e-7·lr (one f32 rounding of a value of the order of lr, which near the
    cosine's zero is all that is left)."""
    if name == "constant":
        ours, theirs = make_optimizer(2e-4, schedule="constant")[1], jax_make_optimizer(2e-4, schedule="constant")[1]
    else:
        port_fn, jax_fn, args = SCHEDULES[name]
        ours, theirs = port_fn(*args), jax_fn(*args)
        if len(args) == 3 or name == "constant_with_warmup":
            kw = dict(num_warmup_steps=10, schedule=name)
            if len(args) == 3:
                kw["num_training_steps"] = 100
            assert [make_optimizer(2e-4, **kw)[1](s) for s in STEPS] == [ours(s) for s in STEPS]
    for s in STEPS:
        assert ours(s) == pytest.approx(float(theirs(s)), rel=1e-6, abs=1e-7 * 2e-4), s
    with pytest.raises(NotImplementedError, match="schedule"):
        make_optimizer(1e-3, schedule="step")


def test_clip_and_adam_match_optax_on_fixed_gradients():
    """Four updates of ``make_optimizer`` (clip 1.0 + Adam on the cosine
    warmup schedule) against optax's on the same gradients: two with a global
    norm above 1 (clipped) and two below (left as they are). Returned norms
    are before the clip. Both f32: params within 1e-6 of lr-sized steps."""
    rng = np.random.RandomState(5)
    shapes = {"a": (3, 4), "b": (7,), "c": (2, 2, 3)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (scale * rng.randn(*s)).astype(np.float32) for k, s in shapes.items()} for scale in (3.0, 0.01, 0.05, 5.0)]
    opt, _ = make_optimizer(0.1, num_warmup_steps=2, num_training_steps=10)
    jopt, _ = jax_make_optimizer(0.1, num_warmup_steps=2, num_training_steps=10)
    ours = [torch.from_numpy(params[k].copy()) for k in shapes]
    state = opt.init(ours)
    theirs = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = jopt.init(theirs)
    for g in grads:
        norm = opt.update([torch.from_numpy(g[k].copy()) for k in shapes], state, ours)
        assert float(norm) == pytest.approx(float(optax.global_norm(g)), rel=1e-6)
        updates, jstate = jopt.update(jax.tree_util.tree_map(jnp.asarray, g), jstate, theirs)
        theirs = optax.apply_updates(theirs, updates)
        for k, p in zip(shapes, ours):
            np.testing.assert_allclose(p.numpy(), np.asarray(theirs[k]), atol=1e-6, rtol=0)
    assert state.count == 4
    assert not np.allclose(ours[0].numpy(), params["a"])


def test_clip_leaves_small_gradients_and_scales_large_ones():
    opt = optim.Optimizer(lambda step: 0.0)
    small, large = [torch.full((4,), 0.25)], [torch.full((4,), 3.0)]
    state = opt.init([torch.zeros(4)])
    assert float(opt.update(small, state, [torch.zeros(4)])) == pytest.approx(0.5)
    assert torch.equal(small[0], torch.full((4,), 0.25))  # ‖g‖ = 0.5 < 1: untouched
    assert float(opt.update(large, state, [torch.zeros(4)])) == pytest.approx(6.0)
    torch.testing.assert_close(large[0], torch.full((4,), 0.5))  # scaled to ‖g‖ = 1, no 1e-6 in the divisor


# ----------------------------------------------------------------- train step


@pytest.fixture(scope="module")
def pair_steps():
    """Two steps of the TINY model on both sides, lr 1e-3, no warmup."""
    pair = Pair()
    image, is_clean = _batch(8, 16, seed=6)
    metrics = [pair.run(image, is_clean, seed) for seed in (11, 12)]
    return pair, metrics


def test_one_and_two_train_steps_match_jax(pair_steps):
    """Loss and pre-clip grad norm of each step within rtol 1e-4 of JAX's
    (both f32 on the CPU), and the parameters after two steps within the
    sign-like Adam tolerance of ``_assert_params_close``."""
    pair, metrics = pair_steps
    for ours, theirs in metrics:
        assert ours["loss"] == pytest.approx(theirs["loss"], rel=1e-4)
        assert ours["grad_norm"] == pytest.approx(theirs["grad_norm"], rel=1e-4)
    assert metrics[0][0]["loss"] != metrics[1][0]["loss"]
    assert pair.state.step == 2 and pair.state.opt_state.count == 2 and int(pair.jstate.step) == 2
    _assert_params_close(pair.param_diffs(), LR)


def test_train_step_gradients_match_jax():
    """The gradients themselves, before clip and Adam: the port's
    ``TrainStep.loss`` backward against ``jax.grad`` of the JAX package's
    poison → q-sample → UNet → loss on the same params and draws. f32:
    every gradient within 1e-5 of the largest one's magnitude, rtol 1e-4."""
    pair = Pair()
    image, is_clean = _batch(4, 16, seed=7)
    t, noise = _jax_draws(jax.random.PRNGKey(3), 4, 16)
    sched = _schedule()
    trigger, target, mask = _poison_constants(16)
    alphas, acp = jnp.asarray(sched.alphas.numpy()), jnp.asarray(sched.alphas_cumprod.numpy())

    def jloss(params):
        _, R, x_start = jax_poison_batch(jnp.asarray(image), jnp.asarray(is_clean), jnp.asarray(trigger),
                                         jnp.asarray(target), jnp.asarray(mask))
        return jax_backdoor_loss(lambda p, x, tt: pair.jmodel.apply({"params": p}, x, tt), params, alphas, acp,
                                 x_start, R, jnp.asarray(t), jnp.asarray(noise))

    jl, jg = jax.jit(jax.value_and_grad(jloss))(pair.jstate.params)
    want = flax_to_torch_state_dict(jax.device_get(jg))
    loss = pair.step.loss(pair.state, torch.from_numpy(image), torch.from_numpy(is_clean), None,
                          torch.from_numpy(t), torch.from_numpy(noise))
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(jl), rel=1e-5)
    gmax = max(np.abs(w).max() for w in want.values())
    for k, p in pair.state.params.items():
        np.testing.assert_allclose(p.grad.numpy(), want[k], rtol=1e-4, atol=1e-5 * gmax, err_msg=k)


def test_grad_accum_2_matches_jax():
    """``grad_accum=2``: two micro-batches, each with its own JAX key from
    ``split(key, 2)``; summed gradients divided by 2. Same tolerances."""
    pair = Pair(grad_accum=2)
    image, is_clean = _batch(8, 16, seed=8)
    ours, theirs = pair.run(image, is_clean, seed=13)
    assert ours["loss"] == pytest.approx(theirs["loss"], rel=1e-4)
    assert ours["grad_norm"] == pytest.approx(theirs["grad_norm"], rel=1e-4)
    _assert_params_close(pair.param_diffs(), LR)


def test_remat_equals_no_remat():
    """``use_remat`` recomputes the forward during backprop
    (torch.utils.checkpoint): the same numbers, bit for bit on the CPU."""
    image, is_clean = _batch(4, 16, seed=9)
    t, noise = _jax_draws(jax.random.PRNGKey(4), 4, 16)
    results = []
    for remat in (False, True):
        model = _port_model(TINY)
        sched = _schedule()
        opt, _ = make_optimizer(LR, num_warmup_steps=0, num_training_steps=100)
        state = create_train_state(model, opt, *_poison_constants(16))
        step = make_train_step(model, opt, T, sched.alphas, sched.alphas_cumprod, use_remat=remat, device="cpu")
        state, m = step(state, image, is_clean, None, timesteps=t, noise=noise)
        results.append((m, {k: p.detach().clone() for k, p in state.params.items()}))
    (m0, p0), (m1, p1) = results
    assert torch.equal(m0["loss"], m1["loss"]) and torch.equal(m0["grad_norm"], m1["grad_norm"])
    assert all(torch.equal(p0[k], p1[k]) for k in p0)


def test_warmup_step_zero_has_lr_zero_and_generator_draws_are_seeded():
    """The schedule is read at the count before the update: step 0 of a
    warmup schedule moves nothing (optax's behaviour). With a generator the
    step draws t and ε itself, the same for the same seed."""
    image, is_clean = _batch(4, 16, seed=10)
    losses = []
    for _ in range(2):
        model = _port_model(TINY)
        before = {k: p.detach().clone() for k, p in model.named_parameters()}
        sched = _schedule()
        opt, _ = make_optimizer(LR, num_warmup_steps=500, num_training_steps=10_000)
        state = create_train_state(model, opt, *_poison_constants(16))
        step = make_train_step(model, opt, T, sched.alphas, sched.alphas_cumprod, device="cpu")
        state, m = step(state, image, is_clean, torch.Generator().manual_seed(21))
        losses.append(float(m["loss"]))
        assert all(torch.equal(p, before[k]) for k, p in state.params.items())
        assert state.opt_state.count == 1 and any(mu.abs().sum() > 0 for mu in state.opt_state.mu)
    assert losses[0] == losses[1] and np.isfinite(losses[0])
    with pytest.raises(ValueError, match="generator"):
        step(state, image, is_clean, None)


TINY_DROPOUT = {**TINY, "dropout": 0.1}


def test_train_step_with_dropout_config_matches_jax():
    """The JAX step never turns dropout on (``model.apply`` with
    ``deterministic`` left True, no dropout RNG), so a config's dropout rate
    changes nothing there. The port's step computes the same, even from a
    model left in train mode: with a dropout-0.1 TINY config and JAX's draws,
    loss and pre-clip grad norm within rtol 1e-4 of JAX's, over two steps,
    and the parameters within the tolerance of ``_assert_params_close``."""
    pair = Pair(cfg=TINY_DROPOUT)
    pair.model.train()
    image, is_clean = _batch(8, 16, seed=14)
    for seed in (15, 16):
        ours, theirs = pair.run(image, is_clean, seed)
        assert ours["loss"] == pytest.approx(theirs["loss"], rel=1e-4)
        assert ours["grad_norm"] == pytest.approx(theirs["grad_norm"], rel=1e-4)
    assert not pair.model.training
    _assert_params_close(pair.param_diffs(), LR)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_model_samples_deterministically_after_a_train_step(dtype):
    """A dropout-0.1 TINY model computing in ``dtype``, after one train step:
    two forwards of the model, and two of its ``compute_copy``, give the
    same bits (dropout would draw a new mask each time)."""
    model = _port_model(TINY_DROPOUT, dtype=dtype)
    sched = _schedule()
    opt, _ = make_optimizer(LR, num_warmup_steps=0, num_training_steps=100)
    state = create_train_state(model, opt, *_poison_constants(16))
    step = make_train_step(model, opt, T, sched.alphas, sched.alphas_cumprod, device="cpu")
    image, is_clean = _batch(4, 16, seed=17)
    step(state, image, is_clean, torch.Generator().manual_seed(18))
    x = torch.from_numpy(np.random.RandomState(19).randn(2, 16, 16, 3).astype(np.float32))
    t = torch.tensor([5, 700])
    with torch.no_grad():
        for net in (model, model.compute_copy(dtype)):
            assert not net.training and net.dtype == dtype
            first, second = net(x, t), net(x, t)
            assert torch.isfinite(first).all() and torch.equal(first, second)


def test_make_train_step_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = _port_model(TINY)
    sched = _schedule()
    opt, _ = make_optimizer(LR)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_train_step(model, opt, T, sched.alphas, sched.alphas_cumprod)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        UNet2DModel(UNet2DConfig(**TINY))


def test_scratch_unet_train_step_at_32px():
    """One f32 step of the full-width scratch UNet (113.7M parameters) at
    batch 2, bench.py's optimizer settings with no warmup: its loss against
    the JAX package's loss on the same weights, batch and draws (rtol 1e-4),
    a finite pre-clip grad norm, and every parameter moved by at most lr
    (Adam's first step is g/|g| times lr)."""
    cfg = dataclasses.asdict(DEFAULT_SCRATCH_CONFIG)
    model = UNet2DModel(DEFAULT_SCRATCH_CONFIG, device="cpu", generator=torch.Generator().manual_seed(4))
    params = _to_jax(model)
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    sched = _schedule()
    trigger, target, mask = _poison_constants(32)
    image, is_clean = _batch(2, 32, seed=12)
    is_clean = np.array([True, False])
    t, noise = _jax_draws(jax.random.PRNGKey(5), 2, 32)
    alphas, acp = jnp.asarray(sched.alphas.numpy()), jnp.asarray(sched.alphas_cumprod.numpy())
    _, R, x_start = jax_poison_batch(jnp.asarray(image), jnp.asarray(is_clean), jnp.asarray(trigger),
                                     jnp.asarray(target), jnp.asarray(mask))
    apply = jax.jit(JaxUNet2DModel(JAX_SCRATCH).apply)
    want = float(jax_backdoor_loss(lambda p, x, tt: apply({"params": p}, x, tt), params, alphas, acp, x_start, R,
                                   jnp.asarray(t), jnp.asarray(noise)))

    lr = 2e-4
    opt, _ = make_optimizer(lr, num_warmup_steps=0, num_training_steps=10_000)
    state = create_train_state(model, opt, trigger, target, mask)
    step = make_train_step(model, opt, T, sched.alphas, sched.alphas_cumprod, device="cpu")
    state, m = step(state, image, is_clean, None, timesteps=t, noise=noise)
    assert cfg["block_out_channels"] == (128, 128, 256, 256, 512, 512)
    assert float(m["loss"]) == pytest.approx(want, rel=1e-4)
    assert np.isfinite(float(m["grad_norm"])) and float(m["grad_norm"]) > 0
    moved = max((p.detach() - before[k]).abs().max().item() for k, p in state.params.items())
    assert 0 < moved <= lr + 1e-6  # plus the f32 rounding of parameters of order 1
