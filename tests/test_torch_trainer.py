"""The port's trainer against the JAX package on the CPU: EMA, the epoch
loop (losses and final parameters step for step, with JAX's own draws handed
to the port's step), the sample grids (JAX's initial and per-step noise
handed to the port's pipeline), checkpoints (sync and async round trips,
the save on the way out, resume) and the HF export read by both packages."""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from baddiffusion_tpu.data.datasets import DatasetLoader as JaxDatasetLoader
from baddiffusion_tpu.io.hf import flax_to_torch_state_dict, torch_to_flax_params
from baddiffusion_tpu.models import UNet2DConfig as JaxUNet2DConfig
from baddiffusion_tpu.models import UNet2DModel as JaxUNet2DModel
from baddiffusion_tpu.pipelines import DiffusionPipeline as JaxDiffusionPipeline
from baddiffusion_tpu.schedulers import DDPMConfig as JaxDDPMConfig
from baddiffusion_tpu.schedulers import DDPMScheduler as JaxDDPMScheduler
from baddiffusion_tpu.training import create_train_state as jax_create_train_state
from baddiffusion_tpu.training import checkpoint as jax_checkpoint
from baddiffusion_tpu.training import ema as jax_ema
from baddiffusion_tpu.training import make_optimizer as jax_make_optimizer
from baddiffusion_tpu.training import make_train_step as jax_make_train_step
from baddiffusion_tpu.training.trainer import sample_grids as jax_sample_grids
from baddiffusion_tpu.training.trainer import train_loop as jax_train_loop
from baddiffusion_tpu.utils.trackers import Tracker as JaxTracker
from baddiffusion_tpu_torch.data import DatasetLoader
from baddiffusion_tpu_torch.models import UNet2DConfig, UNet2DModel
from baddiffusion_tpu_torch.pipelines import DiffusionPipeline
from baddiffusion_tpu_torch.schedulers import DDPMConfig, DDPMScheduler
from baddiffusion_tpu_torch.training import (
    create_train_state,
    ema_decay,
    ema_init,
    ema_update,
    ep_model_path,
    finish_async_saves,
    has_trainer_state,
    load_trainer_state,
    make_optimizer,
    make_train_step,
    sample_grids,
    save_checkpoint,
    save_trainer_state,
    train_loop,
    trainer,
)
from baddiffusion_tpu_torch.utils import Tracker

# the TINY model of tests/test_torch_training.py with one AttnDownBlock2D /
# AttnUpBlock2D pair, so that the attention kernel's plain twin is on the path
TINY = dict(
    sample_size=16, layers_per_block=1, block_out_channels=(8, 16), down_block_types=("DownBlock2D", "AttnDownBlock2D"),
    up_block_types=("AttnUpBlock2D", "UpBlock2D"), norm_num_groups=4, attention_head_dim=4,
)
T = 1000
LR = 1e-3
SEED = 7
# FAKE at 16 px, 16 images, batch 4: 4 steps an epoch
DATA = dict(fake_size=16, image_size=16, batch_size=4, seed=0)
POISON = dict(trigger_type="BOX_8", target_type="CORNER", poison_rate=0.25)


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    """Trackers without tensorboard (importing it here pulls TensorFlow in,
    about 17 s): the JSONL stream is what both loops always write."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


def _schedule():
    return DDPMScheduler(DDPMConfig()).create_state().schedule


def _jax_draws(key, b, size):
    """The draws the JAX step makes from ``key``: split → randint(t), normal(ε)."""
    k_t, k_eps = jax.random.split(key)
    return (np.array(jax.random.randint(k_t, (b,), 0, T)),
            np.array(jax.random.normal(k_eps, (b, size, size, 3), jnp.float32)))


def _port_model(seed=0):
    """A seeded port UNet whose biases and GroupNorm affines are not 0 and 1."""
    model = UNet2DModel(UNet2DConfig(**TINY), device="cpu", generator=torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias") or ("norm" in name and name.endswith("weight")):
                p.add_(0.05 * torch.randn(p.shape, generator=g))
    return model


def _to_jax(model):
    """The model's weights as JAX params, copied: on the CPU ``jnp.asarray``
    of a numpy view may alias the torch parameter, which training moves."""
    return jax.tree_util.tree_map(jnp.asarray, torch_to_flax_params({k: v.numpy().copy()
                                                                     for k, v in model.state_dict().items()}))


class Run:
    """The port's trainer pieces on the CPU: FAKE loader, TINY model, Adam
    on a cosine schedule, the step, and the pipeline the loop samples from."""

    def __init__(self, model_seed=0, warmup=0):
        self.dsl = DatasetLoader("FAKE", **DATA).set_poison(**POISON).prepare_dataset()
        self.model = _port_model(model_seed)
        self.scheduler = DDPMScheduler(DDPMConfig())
        sched = _schedule()
        self.opt, self.lr_schedule = make_optimizer(LR, num_warmup_steps=warmup, num_training_steps=100)
        self.state = create_train_state(self.model, self.opt, self.dsl.trigger, self.dsl.target, self.dsl.mask)
        self.step = make_train_step(self.model, self.opt, T, sched.alphas, sched.alphas_cumprod, device="cpu")

    def make_pipeline(self, state):
        return DiffusionPipeline(self.model, self.scheduler, device="cpu")

    def loop(self, out_dir, epochs, **kw):
        tracker = Tracker(os.path.join(out_dir, "logs"))
        args = dict(dsl=self.dsl, train_step=self.step, state=self.state, lr_schedule=self.lr_schedule, epochs=epochs,
                    tracker=tracker, out_dir=out_dir, make_pipeline=self.make_pipeline, seed=SEED,
                    save_image_epochs=100, save_model_epochs=100, log_every=1, sample_n=4, sampling_steps=2)
        args.update(kw)
        try:
            self.state, global_step = train_loop(**args)
        finally:
            tracker.close()
        return global_step


def _log(out_dir):
    with open(os.path.join(out_dir, "logs", "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _records(out_dir):
    """The steps' records (the loop also logs each checkpoint's stall)."""
    return [r for r in _log(out_dir) if "loss" in r]


def _stalls(out_dir):
    return [r for r in _log(out_dir) if "ckpt_stall_s" in r]


def _assert_params_close(diffs, lr, steps):
    """Adam's first steps are sign-like (m̂/√v̂ = g/|g| at step 1): where a
    gradient element is within rounding of zero, the two sides may move it
    by anything up to ±lr a step. So, as in tests/test_torch_training.py's
    two-step test: every parameter within 2·lr per step of JAX's, and all but
    1e-3 of them within 1e-6 (both sides f32 on the CPU). The attention key
    biases are such elements throughout: softmax ignores a shift shared by a
    query's scores, so their gradient is 0 but for rounding, and they are
    held to the first bound only (measured over 8 steps: 63 of their 64
    elements past 1e-6, 3 of the other 45,195 parameters)."""
    flat = np.concatenate([d.ravel() for d in diffs.values()])
    assert flat.max() <= 2 * steps * lr + 1e-6, flat.max()
    rest = np.concatenate([d.ravel() for k, d in diffs.items() if not k.endswith("key.bias")])
    assert (rest > 1e-6).mean() <= 1e-3, (rest > 1e-6).mean()


def _state_tensors(state):
    names = list(state.params)
    out = {f"params/{k}": p.detach().clone() for k, p in state.params.items()}
    out.update({f"mu/{k}": m.clone() for k, m in zip(names, state.opt_state.mu)})
    out.update({f"nu/{k}": v.clone() for k, v in zip(names, state.opt_state.nu)})
    return out, state.opt_state.count, state.step


def _assert_same_state(a, b):
    ta, count_a, step_a = _state_tensors(a)
    tb, count_b, step_b = _state_tensors(b)
    assert (count_a, step_a) == (count_b, step_b)
    assert ta.keys() == tb.keys()
    for k in ta:
        assert torch.equal(ta[k], tb[k]), k


def _decode(path):
    with Image.open(path) as img:
        return np.asarray(img)


# ---------------------------------------------------------------------- EMA

EMA_CASES = {
    "default": {},
    "warmup": dict(use_warmup=True, inv_gamma=1.0, power=2.0 / 3.0),
    "warmup_after_3_min_0.5": dict(use_warmup=True, power=0.75, update_after_step=3, min_decay=0.5),
    "max_0.9": dict(max_decay=0.9),
}


@pytest.mark.parametrize("case", sorted(EMA_CASES))
def test_ema_matches_jax_over_20_steps(case):
    """The decay at every step, and the shadow parameters after each of 20
    updates from moving parameters, within f32 atol 1e-7 of JAX's."""
    kw = EMA_CASES[case]
    for s in range(0, 40):
        assert float(ema_decay(s, **kw)) == pytest.approx(float(jax_ema.ema_decay(jnp.int32(s), **kw)), rel=1e-6, abs=0)
    rng = np.random.RandomState(9)
    shapes = {"a": (3, 4), "b": (5,), "c": (2, 2, 2)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    ours = ema_init({k: torch.from_numpy(v) for k, v in params.items()})
    theirs = jax_ema.ema_init({k: jnp.asarray(v) for k, v in params.items()})
    for _ in range(20):
        params = {k: v + 0.1 * rng.randn(*v.shape).astype(np.float32) for k, v in params.items()}
        ours = ema_update(ours, {k: torch.from_numpy(v) for k, v in params.items()}, **kw)
        theirs = jax_ema.ema_update(theirs, {k: jnp.asarray(v) for k, v in params.items()}, **kw)
        for k in shapes:
            np.testing.assert_allclose(ours.params[k].numpy(), np.asarray(theirs.params[k]), atol=1e-7, rtol=0)
    assert ours.step == int(theirs.step) == 20
    assert not np.allclose(ours.params["a"].numpy(), params["a"])


# ---------------------------------------------------------------- train_loop


def test_train_loop_matches_jax(tmp_path, monkeypatch):
    """Two epochs of 4 steps on FAKE (16 px, batch 4), the TINY model with
    an attention pair: the port's loop, its step given JAX's draws of each
    step (``fold_in(PRNGKey(seed), step)``), against the JAX package's loop.
    The per-step losses in metrics.jsonl within rtol 1e-4, the LR, epoch and
    step of each record equal, the final parameters within the sign-like
    Adam tolerance of ``_assert_params_close``; both loops checkpoint the
    last epoch, and the port's samples its grids."""
    run = Run()
    jax_params = _to_jax(run.model)
    base_key = jax.random.PRNGKey(SEED)

    def injected(state, image_u8, is_clean, generator):
        assert isinstance(generator, torch.Generator) and image_u8.dtype == torch.uint8
        t, noise = _jax_draws(jax.random.fold_in(base_key, state.step), image_u8.shape[0], DATA["image_size"])
        return run.step(state, image_u8, is_clean, None, timesteps=t, noise=noise)

    port_dir = str(tmp_path / "port")
    assert run.loop(port_dir, epochs=2, train_step=injected) == 8

    # the JAX loop's grids and checkpoint are left out (the grids have their
    # own test below): its sampler and orbax would add about 20 s of compile
    # and import on the CPU
    jax_saves = []
    monkeypatch.setattr(jax_checkpoint, "save_checkpoint", lambda out, st, epoch, *a, **k: jax_saves.append(epoch))
    jdsl = JaxDatasetLoader("FAKE", **DATA).set_poison(**POISON).prepare_dataset()
    jmodel = JaxUNet2DModel(JaxUNet2DConfig(**TINY))
    jopt, jlr = jax_make_optimizer(LR, num_warmup_steps=0, num_training_steps=100)
    jstate = jax_create_train_state(jax_params, jopt, jdsl.trigger, jdsl.target, jdsl.mask)
    sched = _schedule()
    jstep = jax_make_train_step(jmodel, jopt, T, jnp.asarray(sched.alphas.numpy()), jnp.asarray(sched.alphas_cumprod.numpy()))
    jax_dir = str(tmp_path / "jax")
    jtracker = JaxTracker(os.path.join(jax_dir, "logs"))
    jstate, jsteps = jax_train_loop(
        dsl=jdsl, train_step=jstep, state=jstate, lr_schedule=jlr, epochs=2, tracker=jtracker, out_dir=jax_dir,
        make_pipeline=lambda st: None, seed=SEED, save_image_epochs=100, save_model_epochs=100, log_every=1)
    jtracker.close()
    assert jsteps == 8 and jax_saves == [1]

    ours, theirs = _records(port_dir), _records(jax_dir)
    assert [r["_step"] for r in ours] == [r["_step"] for r in theirs] == list(range(8))
    for a, b in zip(ours, theirs):
        assert a["loss"] == pytest.approx(b["loss"], rel=1e-4)
        assert (a["lr"], a["epoch"], a["step"]) == pytest.approx((b["lr"], b["epoch"], b["step"]), rel=1e-6)
    assert len({r["loss"] for r in ours}) == 8
    want = flax_to_torch_state_dict(jax.device_get(jstate.params))
    _assert_params_close({k: np.abs(p.detach().numpy() - want[k]) for k, p in run.state.params.items()}, LR, 8)
    assert run.state.step == run.state.opt_state.count == int(jstate.step) == 8
    with open(os.path.join(port_dir, "data.json")) as f:
        assert json.load(f) == {"epoch": 1, "step": 8, "ckpt": "ckpt"}
    # the one save's seconds, which the JAX loop does not log
    stalls = _stalls(port_dir)
    assert [(r["_step"], r["epoch"]) for r in stalls] == [(8, 1)] and stalls[0]["ckpt_stall_s"] > 0
    assert len(_log(port_dir)) == 9
    for sub in ("samples", "backdoor_samples"):
        assert sorted(os.listdir(os.path.join(port_dir, sub))) == ["ep1.png", "ep1_t0.png"]
        assert _decode(os.path.join(port_dir, sub, "ep1.png")).shape == (38, 38, 3)


def test_loop_draws_are_seeded_by_step_and_the_model_stays_trainable(tmp_path):
    """With its own generators the loop is deterministic: the same losses
    twice. Each step's generator depends on (seed, step) alone. Sampling the
    grids leaves the training model as the train step runs it: no inference
    tensors, gradients on, eval mode, and its ``compute_copy`` (a bf16 twin
    for sampling) copies no gradient."""
    losses = []
    for i in range(2):
        run = Run()
        run.loop(str(tmp_path / f"r{i}"), epochs=2, save_image_epochs=1)
        losses.append([r["loss"] for r in _records(str(tmp_path / f"r{i}"))])
        assert all(os.path.exists(tmp_path / f"r{i}" / "samples" / f"ep{e}.png") for e in (0, 1))
    assert losses[0] == losses[1] and len(set(losses[0])) == 8
    seeds = {trainer.step_seed(s, k) for s in (0, 1, 7) for k in (0, 1, 2, 2**32)}
    assert len(seeds) == 12 and trainer.step_seed(7, 3) == trainer.step_seed(7, 3)
    assert all(0 <= s < 2**64 for s in seeds)
    for p in run.model.parameters():
        assert not p.is_inference() and p.requires_grad and p.grad is not None
    assert not run.model.training
    twin = run.model.compute_copy(torch.bfloat16)
    assert all(p.grad is None for p in twin.parameters())
    assert all(p.grad is not None for p in run.model.parameters())
    run.loop(str(tmp_path / "r1"), epochs=3, start_epoch=2, start_step=8)
    assert np.isfinite([r["loss"] for r in _records(str(tmp_path / "r1"))]).all()


def test_sampling_failure_is_logged_and_training_goes_on(tmp_path, capsys):
    run = Run()

    class Broken(DiffusionPipeline):
        def __call__(self, *a, **k):
            raise RuntimeError("sampler exploded")

    out = str(tmp_path / "run")
    run.make_pipeline = lambda st: Broken(run.model, run.scheduler, device="cpu")
    assert run.loop(out, epochs=1) == 4
    assert "sampling failed" in capsys.readouterr().out
    assert not os.path.exists(os.path.join(out, "samples"))
    assert has_trainer_state(out) and os.path.exists(os.path.join(out, "unet", "config.json"))


def test_profile_steps_write_a_trace(tmp_path):
    """The operator's trace of a profiled step holds the loop's, the feed
    consumer's, the step's, the optimizer's and the UNet's spans."""
    run = Run()
    run.loop(str(tmp_path / "run"), epochs=1, profile_steps=1)
    assert os.path.getsize(tmp_path / "run" / "profile" / "trace.json") > 0
    with open(tmp_path / "run" / "profile" / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"] if e.get("cat") == "user_annotation"}
    assert {"train.step", "train.forward", "train.backward", "optim.update", "data.wait", "train.sync_loss",
            "unet.forward", "unet.mid"} <= names


def test_sample_grids_match_jax(tmp_path):
    """The qualitative grids of a JAX pipeline and of the port's pipeline on
    its HF export, the port given JAX's initial noise
    (``normal(PRNGKey(seed))``) and per-step noise through ``noise_source``:
    the same uint8 grids, clean and backdoor, final and first frames, within
    one level where f32 rounding crosses a boundary."""
    cfg = JaxUNet2DConfig(**TINY)
    jmodel = JaxUNet2DModel(cfg)
    params = jax.device_get(jax.jit(jmodel.init_params)(jax.random.PRNGKey(0)))
    jpipe = JaxDiffusionPipeline(jmodel, params, JaxDDPMScheduler(JaxDDPMConfig()))
    jpipe.save_pretrained(str(tmp_path / "pipe"))
    pipe = DiffusionPipeline.from_pretrained(str(tmp_path / "pipe"), device="cpu")
    trigger = DatasetLoader("FAKE", **DATA).set_poison(**POISON).trigger
    seed, steps, n = 3, 5, 4
    shape = (n, 16, 16, 3)
    key = jax.random.PRNGKey(seed)
    noise = np.array(jax.random.normal(key, shape, jnp.float32))
    chain_noise = {}
    k = key
    for i in range(steps):
        k, sub = jax.random.split(k)
        chain_noise[i] = torch.from_numpy(np.array(jax.random.normal(sub, shape, jnp.float32)))

    jax_sample_grids(jpipe, trigger, str(tmp_path / "jax"), "x", sample_n=n, num_inference_steps=steps, seed=seed)
    sample_grids(pipe, trigger, str(tmp_path / "port"), "x", sample_n=n, num_inference_steps=steps, seed=seed,
                 noise=noise, noise_source=chain_noise.__getitem__)
    for sub in ("samples", "backdoor_samples"):
        for name in ("epx.png", "epx_t0.png"):
            ours, theirs = (_decode(tmp_path / side / sub / name).astype(int) for side in ("port", "jax"))
            assert ours.shape == theirs.shape == (38, 38, 3)
            assert np.abs(ours - theirs).max() <= 1 and (ours != theirs).mean() < 0.01, (sub, name)
    clean = _decode(tmp_path / "port" / "samples" / "epx.png")
    assert not np.array_equal(clean, _decode(tmp_path / "port" / "backdoor_samples" / "epx.png"))


# --------------------------------------------------------------- checkpoints


def _trained_run(tmp_path, epochs=1):
    run = Run()
    run.loop(str(tmp_path / "trained"), epochs=epochs)
    return run


@pytest.mark.parametrize("async_save", [False, True], ids=["sync", "async"])
def test_checkpoint_round_trip_is_bitwise(tmp_path, async_save):
    """Parameters, Adam's mu and nu, count and step come back bit for bit
    into a fresh state, from a save the training then moves past (the state
    is updated in place: the save must have copied it). Async: each save
    goes to a fresh ckpt.v{N}; data.json names it only once its write is
    done, and the directories it supersedes go only then."""
    run = _trained_run(tmp_path)
    snapshot = Run(model_seed=3)
    for src, dst in zip(run.state.params.values(), snapshot.state.params.values()):
        dst.data.copy_(src)
    for src, dst in zip(run.state.opt_state.mu + run.state.opt_state.nu,
                        snapshot.state.opt_state.mu + snapshot.state.opt_state.nu):
        dst.copy_(src)
    snapshot.state.opt_state.count, snapshot.state.step = run.state.opt_state.count, run.state.step
    out = str(tmp_path / "ckpt_run")
    save_checkpoint(out, run.state, 4, run.make_pipeline, async_save=async_save)
    if async_save:
        assert not os.path.exists(os.path.join(out, "data.json"))
    batch = next(run.dsl.epoch_batches(5))
    run.step(run.state, batch["image_u8"], batch["is_clean"], torch.Generator().manual_seed(0))  # past the save
    finish_async_saves()
    with open(os.path.join(out, "data.json")) as f:
        assert json.load(f) == {"epoch": 4, "step": 4, "ckpt": "ckpt.v0" if async_save else "ckpt"}
    fresh = Run(model_seed=5)
    state, epoch, step = load_trainer_state(out, fresh.state)
    assert state is fresh.state and (epoch, step) == (4, 4) and has_trainer_state(out)
    _assert_same_state(state, snapshot.state)
    pipe = DiffusionPipeline.from_pretrained(out, device="cpu")
    for k, p in snapshot.state.params.items():
        assert torch.equal(pipe.unet.state_dict()[k], p), k

    if async_save:
        save_trainer_state(out, run.state, 5, async_save=True)
        save_trainer_state(out, run.state, 6, async_save=True)  # waits for v1, publishes it, drops v0
        names = os.listdir(out)
        assert "ckpt.v1" in names and "ckpt.v0" not in names
        with open(os.path.join(out, "data.json")) as f:
            assert json.load(f) == {"epoch": 5, "step": 5, "ckpt": "ckpt.v1"}
        finish_async_saves()
        assert sorted(n for n in os.listdir(out) if n.startswith("ckpt")) == ["ckpt.v2"]
        save_trainer_state(out, run.state, 7)  # a sync save supersedes every version
        assert sorted(n for n in os.listdir(out) if n.startswith("ckpt")) == ["ckpt"]
        _, epoch, step = load_trainer_state(out, fresh.state)
        assert (epoch, step) == (7, 5)
        _assert_same_state(fresh.state, run.state)


def test_async_writer_file_reads_back_bitwise_with_every_dtype(tmp_path):
    """The trainer state's file, written by the async writer thread
    (``write_safetensors``: header, then each host buffer through
    ``file.write``), read back by safetensors' own ``load_file`` bitwise:
    the state's f32 parameters and moments and int64 count and step, and a
    tensor of every other dtype the writer takes."""
    from safetensors.torch import load_file

    from baddiffusion_tpu_torch.training.checkpoint import SAFETENSORS_DTYPES, write_safetensors

    run = _trained_run(tmp_path)
    out = str(tmp_path / "async")
    flat = save_trainer_state(out, run.state, 1, async_save=True)
    finish_async_saves()
    back = load_file(os.path.join(out, "ckpt.v0", "state.safetensors"))
    assert {t.dtype for t in flat.values()} == {torch.float32, torch.int64}
    assert set(back) == set(flat)
    for k, t in flat.items():
        assert back[k].dtype == t.dtype and back[k].shape == t.shape and torch.equal(back[k], t), k
    g = torch.Generator().manual_seed(0)
    every = {str(dt): (torch.randn(3, 5, generator=g) * 50).to(dt) for dt in SAFETENSORS_DTYPES}
    every["empty"], every["scalar"] = torch.zeros(0, 4), torch.tensor(2.5)
    write_safetensors(str(tmp_path / "every.safetensors"), every)
    back = load_file(str(tmp_path / "every.safetensors"))
    for k, t in every.items():
        assert back[k].dtype == t.dtype and back[k].shape == t.shape and torch.equal(back[k], t), k
    with pytest.raises(ValueError, match="contiguous host tensors"):
        write_safetensors(str(tmp_path / "bad.safetensors"), {"x": torch.zeros(4, 4).t()})


def test_load_refuses_a_checkpoint_of_another_model(tmp_path):
    run = _trained_run(tmp_path)
    save_trainer_state(str(tmp_path / "c"), run.state, 0)
    other = Run()
    other.state.params["extra"] = torch.nn.Parameter(torch.zeros(2))
    with pytest.raises(ValueError, match="missing"):
        load_trainer_state(str(tmp_path / "c"), other.state)
    wrong = Run()
    name = next(iter(wrong.state.params))
    wrong.state.params[name] = torch.nn.Parameter(torch.zeros(3))
    with pytest.raises(ValueError, match=name):
        load_trainer_state(str(tmp_path / "c"), wrong.state)
    assert ep_model_path("out", 3) == os.path.join("out", "epochs", "ep3")


def test_final_checkpoint_skipped_when_already_saved(monkeypatch, tmp_path):
    """Normal completion: the last epoch's periodic checkpoint already holds
    the final step, so the save on the way out is skipped. After a crash it
    runs, and the crash still propagates, even when that save fails too. A
    step that raised inside the optimizer's in-place update (Adam's count
    ahead of the step) is not saved."""
    calls = []
    monkeypatch.setattr(trainer, "save_checkpoint", lambda out, state, epoch, *a, **k: calls.append(epoch))
    run = Run()
    run.loop(str(tmp_path / "a"), epochs=1, save_model_epochs=1)
    assert calls == [0]

    def boom(state, image_u8, is_clean, generator):
        raise RuntimeError("step failed")

    calls.clear()
    with pytest.raises(RuntimeError, match="step failed"):
        run.loop(str(tmp_path / "b"), epochs=1, train_step=boom)
    assert calls == [0]

    def failing_save(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(trainer, "save_checkpoint", failing_save)
    with pytest.raises(RuntimeError, match="step failed"):
        run.loop(str(tmp_path / "c"), epochs=1, train_step=boom)

    monkeypatch.setattr(trainer, "save_checkpoint", lambda out, state, epoch, *a, **k: calls.append(epoch))

    def torn(state, image_u8, is_clean, generator):
        state.opt_state.count += 1
        raise RuntimeError("died in the update")

    calls.clear()
    with pytest.raises(RuntimeError, match="died in the update"):
        run.loop(str(tmp_path / "d"), epochs=1, train_step=torn)
    assert calls == []


def test_resume_matches_the_uninterrupted_run(tmp_path):
    """Train 2 epochs (checkpoint at epoch 1, step 8), restore into a fresh
    model and state, and resume to 3 epochs: the reference's quirk re-runs
    the saved epoch, so the resumed loop starts at epoch 1, step 8, runs 8
    steps and ends at step 16. The run that simply goes on from its live
    state the same way ends with the same bits, and both logged the same
    losses; the LR schedule resumed from Adam's restored count."""
    first = Run(warmup=5)
    out = str(tmp_path / "run")
    assert first.loop(out, epochs=2) == 8
    resumed = Run(model_seed=11, warmup=5)
    _, start_epoch, start_step = load_trainer_state(out, resumed.state)
    assert (start_epoch, start_step) == (1, 8) and resumed.state.opt_state.count == 8
    assert resumed.loop(out, epochs=3, start_epoch=start_epoch, start_step=start_step) == 16
    assert first.loop(str(tmp_path / "straight"), epochs=3, start_epoch=1, start_step=8) == 16
    _assert_same_state(resumed.state, first.state)
    recs = _records(out)
    assert [r["_step"] for r in recs] == list(range(16)) and [r["epoch"] for r in recs[8:]] == [1] * 4 + [2] * 4
    assert [r["loss"] for r in recs[8:]] == [r["loss"] for r in _records(str(tmp_path / "straight"))]
    with open(os.path.join(out, "data.json")) as f:
        assert json.load(f) == {"epoch": 2, "step": 16, "ckpt": "ckpt"}


def test_hf_export_loads_in_both_packages(tmp_path):
    """The port's export (``save_checkpoint``, also per epoch) loads in the
    JAX package with the same weights; the JAX package's export loads in the
    port's ``from_pretrained`` with the same weights."""
    run = _trained_run(tmp_path)
    out = str(tmp_path / "export")
    save_checkpoint(out, run.state, 2, run.make_pipeline, save_all_model_epochs=True)
    for path in (out, ep_model_path(out, 2)):
        jpipe = JaxDiffusionPipeline.from_pretrained(path)
        got = flax_to_torch_state_dict(jax.device_get(jpipe.params))
        assert got.keys() == run.model.state_dict().keys()
        for k, p in run.model.state_dict().items():
            np.testing.assert_array_equal(got[k], p.numpy(), err_msg=k)
    jpipe.save_pretrained(str(tmp_path / "from_jax"))
    pipe = DiffusionPipeline.from_pretrained(str(tmp_path / "from_jax"), device="cpu")
    for k, p in run.model.state_dict().items():
        assert torch.equal(pipe.unet.state_dict()[k], p), k
    assert pipe.scheduler.config.__dict__ == run.scheduler.config.__dict__
