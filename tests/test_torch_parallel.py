"""The port's scale-out (``baddiffusion_tpu_torch/parallel/``) against the
JAX package on the CPU: the data helpers against ``host_shard_slice`` and
``global_batch_from_host_shards``, the FSDP and tensor-parallel spec tables
against ``fsdp_param_specs`` and ``unet_param_specs`` on the same tree, and
the train step on 2 or 4 ranks (replicated, FSDP, TP at data 1 × model 2, TP
+ FSDP at 2 × 2; grad_accum 1 and 2) against the one-rank port step and the
JAX single-process step on the same global batch, weights and draws; the
ranks agree bitwise, and a kill/restart resume is bitwise in each layout.

The ranks are this file run as a script, one process a rank over gloo on a
``FileStore`` under ``tmp_path`` (no TCP port, so pytest-xdist workers cannot
collide), each with a timeout; one launch trains every layout of a world
size, and a fresh one resumes them. The file takes about 60 s (the JAX
steps' compiles, and starting the rank processes, are most of it).

Tolerances (f32 on the CPU): loss and pre-clip gradient norm within rtol
1e-5 of the one-rank port step (the data ranks' sums run in another order)
and rtol 1e-4 of JAX's; parameters as ``test_torch_training.py`` holds them
to JAX (Adam's first steps are sign-like: every element within 2·lr a step,
all but 1e-3 of them within 1e-6).
"""

import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:  # run as a rank's script
    sys.path.insert(0, ROOT)

from baddiffusion_tpu_torch import parallel  # noqa: E402
from baddiffusion_tpu_torch.data import Backdoor, trigger_mask  # noqa: E402
from baddiffusion_tpu_torch.models import DEFAULT_SCRATCH_CONFIG, UNet2DConfig, UNet2DModel  # noqa: E402
from baddiffusion_tpu_torch.io import load_unet  # noqa: E402
from baddiffusion_tpu_torch.parallel import distributed  # noqa: E402
from baddiffusion_tpu_torch.pipelines import DiffusionPipeline  # noqa: E402
from baddiffusion_tpu_torch.schedulers import DDPMConfig, DDPMScheduler  # noqa: E402
from baddiffusion_tpu_torch.training import (  # noqa: E402
    create_train_state,
    load_trainer_state,
    make_optimizer,
    make_train_step,
    save_checkpoint,
)

# a TINY UNet with attention: widths 16 and 32, so a tensor-parallel
# threshold of 16 splits every conv and dense layer but conv_out
TINY = dict(
    sample_size=16, layers_per_block=1, block_out_channels=(16, 32), norm_num_groups=4, attention_head_dim=8,
    down_block_types=("DownBlock2D", "AttnDownBlock2D"), up_block_types=("AttnUpBlock2D", "UpBlock2D"),
)
T, LR, BATCH, SIZE, STEPS = 1000, 1e-3, 8, 16, 3
TP_THRESHOLD, FSDP_MIN = 16, 1  # the JAX package's multi-process test splits the tiny model this way
LAYOUTS = {  # id -> (ranks, model_parallel, param_sharding, grad_accum)
    "replicated-k1": (2, 1, "replicated", 1),
    "replicated-k2": (2, 1, "replicated", 2),
    "fsdp-k2": (2, 1, "fsdp", 2),
    "tp-k1": (2, 2, "replicated", 1),
    "tp_fsdp-k2": (4, 2, "fsdp", 2),
}
RANK_TIMEOUT_S = 240


def _port_model(seed=0):
    """A seeded TINY port UNet with biases and GroupNorm affines moved off 0
    and 1, so their gradients count."""
    model = UNet2DModel(UNet2DConfig(**TINY), device="cpu", generator=torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias") or ("norm" in name and name.endswith("weight")):
                p.add_(0.05 * torch.randn(p.shape, generator=g))
    return model


def _constants():
    bd = Backdoor()
    trigger = bd.get_trigger("BOX_8", 3, SIZE)
    return trigger, bd.get_target("CORNER", trigger), trigger_mask(trigger)


def _batches():
    rng = np.random.RandomState(7)
    return [(rng.randint(0, 256, (BATCH, SIZE, SIZE, 3)).astype(np.uint8), np.arange(BATCH) % 3 != i % 3)
            for i in range(STEPS)]


def _schedule():
    return DDPMScheduler(DDPMConfig()).create_state().schedule


def _one_rank_world(weights, grad_accum, layout_args=None):
    """(model, state, step) on the CPU, on this rank's layout when
    ``layout_args`` = (model_parallel, param_sharding)."""
    model = UNet2DModel(UNet2DConfig(**TINY), device="cpu")
    model.load_state_dict(weights)
    opt, _ = make_optimizer(LR, num_warmup_steps=0, num_training_steps=100)
    state = create_train_state(model, opt, *_constants())
    layout = None
    if layout_args is not None:
        mp, sharding = layout_args
        layout = parallel.ParallelLayout(parallel.make_mesh("cpu", mp), model, sharding, grad_accum=grad_accum,
                                         tp_threshold=TP_THRESHOLD, fsdp_min_size=FSDP_MIN)
        state = parallel.place_train_state(state, layout)
    sched = _schedule()
    step = make_train_step(model, opt, T, sched.alphas, sched.alphas_cumprod, grad_accum=grad_accum, device="cpu",
                           layout=layout)
    return model, state, step, layout


def _run(state, step, layout, draws, lo, hi):
    """Steps ``lo`` … ``hi − 1`` on this rank's rows, with the global draws."""
    out = []
    for i in range(lo, hi):
        image, is_clean = _batches()[i]
        batch = {"image_u8": image, "is_clean": is_clean}
        if layout is not None:
            batch = layout.batch(batch)
        t, noise = draws[f"t{i}"], draws[f"noise{i}"]
        state, m = step(state, torch.from_numpy(batch["image_u8"]), torch.from_numpy(batch["is_clean"]), None,
                        timesteps=torch.from_numpy(t), noise=torch.from_numpy(noise))
        out.append([float(m["loss"]), float(m["grad_norm"])])
    return state, out


# ------------------------------------------------------------ the rank script


def rank_main(rank, world, store_path, phase, cases, work):
    """One rank, for each layout in ``cases`` (comma-separated, each of
    ``world`` ranks): ``train`` runs STEPS steps and saves a checkpoint after
    step 2 (of 3), with the HF export of a whole copy of the model;
    ``resume`` (fresh processes: the first ones have exited) restores it and
    runs step 3. Each writes its metrics and a digest of the whole
    parameters; rank 0 also the parameters (and those it saved)."""
    torch.set_num_threads(1)
    distributed.initialize("cpu", store=torch.distributed.FileStore(store_path, world), rank=rank, world_size=world,
                           timeout_s=RANK_TIMEOUT_S)
    weights = torch.load(os.path.join(work, "weights.pt"))
    for case in cases.split(","):
        ranks, mp, sharding, k = LAYOUTS[case]
        draws = dict(np.load(os.path.join(work, f"draws-k{k}.npz")))
        _, state, step, layout = _one_rank_world(weights, k, (mp, sharding))
        ckpt = os.path.join(work, f"ckpt-{case}")
        saved = None
        if phase == "train":
            state, metrics = _run(state, step, layout, draws, 0, STEPS - 1)
            saved = {n: t.detach().clone() for n, t in layout.full_params(state.params).items()}
            save_checkpoint(ckpt, state, epoch=0, layout=layout, make_pipeline=lambda st: DiffusionPipeline(
                layout.full_model(st.params), DDPMScheduler(DDPMConfig()), device="cpu"))
            state, more = _run(state, step, layout, draws, STEPS - 1, STEPS)
            metrics += more
        else:
            state, epoch, start = load_trainer_state(ckpt, state, layout)
            assert (epoch, start) == (0, STEPS - 1), (epoch, start)
            state, metrics = _run(state, step, layout, draws, STEPS - 1, STEPS)
        full = {n: t.detach().clone() for n, t in layout.full_params(state.params).items()}
        digest = hashlib.sha256(json.dumps(metrics).encode())
        for n in sorted(full):
            digest.update(full[n].numpy().tobytes())
        result = {"metrics": metrics, "digest": digest.hexdigest(), "params": full if rank == 0 else None,
                  "saved": saved if rank == 0 else None}
        torch.save(result, os.path.join(work, f"{phase}-{case}-rank{rank}.pt"))
    distributed.shutdown()


def launch(tmp_path, world, args, timeout=RANK_TIMEOUT_S):
    """Run this file as ``world`` ranks with ``args``; returns their output."""
    store = os.path.join(str(tmp_path), "store-" + hashlib.sha256(repr(args).encode()).hexdigest()[:16])
    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"}
    env.pop("WORLD_SIZE", None)
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(r), str(world), store, *map(str, args)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} of {world} ({args}) failed:\n{out[-4000:]}"
    return outs


# -------------------------------------------------------------- JAX's side


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The shared inputs (seeded weights; JAX's own draws of t and ε for
    each step, global batch, grad_accum 1 and 2) and the two references at
    each grad_accum: the one-rank port step and the JAX step."""
    import jax
    import jax.numpy as jnp

    from baddiffusion_tpu.io.hf import torch_to_flax_params
    from baddiffusion_tpu.models import UNet2DConfig as JaxUNet2DConfig
    from baddiffusion_tpu.models import UNet2DModel as JaxUNet2DModel
    from baddiffusion_tpu.training import create_train_state as jax_create_train_state
    from baddiffusion_tpu.training import make_optimizer as jax_make_optimizer
    from baddiffusion_tpu.training import make_train_step as jax_make_train_step

    work = str(tmp_path_factory.mktemp("parallel"))
    weights = _port_model().state_dict()
    torch.save(weights, os.path.join(work, "weights.pt"))
    sched = _schedule()
    out = {"work": work, "weights": weights}
    for k in (1, 2):
        jmodel = JaxUNet2DModel(JaxUNet2DConfig(**TINY))
        jopt, _ = jax_make_optimizer(LR, num_warmup_steps=0, num_training_steps=100)
        jstate = jax_create_train_state(
            jax.tree_util.tree_map(jnp.asarray, torch_to_flax_params({n: v.numpy() for n, v in weights.items()})),
            jopt, *_constants())
        jstep = jax_make_train_step(jmodel, jopt, T, jnp.asarray(sched.alphas.numpy()),
                                    jnp.asarray(sched.alphas_cumprod.numpy()), grad_accum=k)
        draws, jax_metrics = {}, []
        for i, (image, is_clean) in enumerate(_batches()):
            key = jax.random.PRNGKey(100 + i)
            keys = [key] if k == 1 else list(jax.random.split(key, k))
            ts, noises = [], []
            for kk in keys:  # the JAX step's draws: per micro-batch, split -> randint(t), normal(eps)
                k_t, k_eps = jax.random.split(kk)
                ts.append(np.asarray(jax.random.randint(k_t, (BATCH // k,), 0, T)))
                noises.append(np.asarray(jax.random.normal(k_eps, (BATCH // k, SIZE, SIZE, 3), jnp.float32)))
            draws[f"t{i}"], draws[f"noise{i}"] = np.concatenate(ts), np.concatenate(noises)
            jstate, m = jstep(jstate, jnp.asarray(image), jnp.asarray(is_clean), key)
            jax_metrics.append([float(m["loss"]), float(m["grad_norm"])])
        np.savez(os.path.join(work, f"draws-k{k}.npz"), **draws)
        from baddiffusion_tpu.io.hf import flax_to_torch_state_dict

        _, state, step, _ = _one_rank_world(weights, k)
        state, port_metrics = _run(state, step, None, draws, 0, STEPS)
        out[k] = {
            "port": (port_metrics, {n: p.detach().clone() for n, p in state.params.items()}),
            "jax": (jax_metrics, {n: torch.from_numpy(np.array(v))
                                  for n, v in flax_to_torch_state_dict(jax.device_get(jstate.params)).items()}),
        }
    return out


def _assert_params_close(got, want, steps):
    flat = torch.cat([(got[n] - want[n]).abs().flatten() for n in want])
    assert flat.max() <= 2 * steps * LR + 1e-6, flat.max()
    assert (flat > 1e-6).double().mean() <= 1e-3, (flat > 1e-6).double().mean()


@pytest.fixture(scope="module")
def rank_runs(reference, tmp_path_factory):
    """The layouts' ranks: for each world size, one launch trains every
    layout of that size, then a fresh launch resumes them (the first
    processes have exited: a kill/restart). Returns the work dir."""
    work, tmp = reference["work"], tmp_path_factory.mktemp("stores")
    for world in sorted({ranks for ranks, _, _, _ in LAYOUTS.values()}):
        cases = ",".join(c for c, (ranks, _, _, _) in LAYOUTS.items() if ranks == world)
        for phase in ("train", "resume"):
            launch(tmp, world, [phase, cases, work])
    return work


@pytest.mark.parametrize("case", list(LAYOUTS))
def test_multi_rank_step_matches_one_rank_and_jax_and_resumes_bitwise(reference, rank_runs, case):
    ranks, mp, sharding, k = LAYOUTS[case]
    work = rank_runs
    got = [torch.load(os.path.join(work, f"train-{case}-rank{r}.pt")) for r in range(ranks)]
    # the ranks agree bitwise on every loss, grad norm and parameter
    assert len({g["digest"] for g in got}) == 1, [g["metrics"] for g in got]
    metrics, params = got[0]["metrics"], got[0]["params"]
    for name, rtol in (("port", 1e-5), ("jax", 1e-4)):
        want_metrics, want_params = reference[k][name]
        np.testing.assert_allclose(metrics, want_metrics, rtol=rtol, err_msg=name)
        _assert_params_close(params, want_params, STEPS)
    # the HF export, written by rank 0 from a whole copy of the model, holds the parameters at the save
    exported = load_unet(os.path.join(work, f"ckpt-{case}"), subfolder="unet", device="cpu").state_dict()
    assert set(exported) == set(got[0]["saved"])
    assert all(torch.equal(exported[n], p) for n, p in got[0]["saved"].items())
    # kill/restart: fresh ranks restored the checkpoint saved after step 2 and repeated step 3's bits
    resumed = [torch.load(os.path.join(work, f"resume-{case}-rank{r}.pt")) for r in range(ranks)]
    assert len({g["digest"] for g in resumed}) == 1
    assert resumed[0]["metrics"] == metrics[-1:]
    for n, p in params.items():
        assert torch.equal(resumed[0]["params"][n], p), n


# -------------------------------------------------- specs and data helpers


def _jax_specs_in_port_dims(jax_specs, model):
    """The JAX spec tree as ``{port name: spec per port dim}``: the leaf
    path mapped as ``io.hf`` maps it, HWIO and [I, O] kernels turned OIHW and
    [O, I]."""
    import jax
    from jax.sharding import PartitionSpec

    from baddiffusion_tpu_torch.io.hf import _module_name

    shapes = {n: p.dim() for n, p in model.named_parameters()}
    out = {}
    leaves = jax.tree_util.tree_flatten_with_path(jax_specs, is_leaf=lambda x: isinstance(x, PartitionSpec))[0]
    for path, spec in leaves:
        keys = [p.key for p in path]
        leaf = keys[-1]
        name = ".".join([_module_name(k) for k in keys[:-1]] + ["weight" if leaf in ("kernel", "scale") else leaf])
        nd = shapes[name]
        flax = tuple(spec) + (None,) * (nd - len(spec))
        order = {4: (3, 2, 0, 1), 2: (1, 0)}.get(nd, tuple(range(nd))) if leaf == "kernel" else tuple(range(nd))
        out[name] = tuple(flax[d] for d in order)
    return out


@pytest.mark.parametrize("which", ["scratch", "tiny"])
def test_spec_tables_match_jax(which):
    """The TP and FSDP tables over the same tree: the full-width scratch UNet
    at the default thresholds (TP 256, FSDP 2^16) and data 2 and 4, and the
    TINY UNet at the tests' thresholds; the composed TP + FSDP table as
    ``train_state_specs`` composes it."""
    import jax

    from baddiffusion_tpu.models import UNet2DConfig as JaxUNet2DConfig
    from baddiffusion_tpu.models import UNet2DModel as JaxUNet2DModel
    from baddiffusion_tpu.models.unet2d import DEFAULT_SCRATCH_CONFIG as JAX_SCRATCH
    from baddiffusion_tpu.parallel.sharding_rules import _add_fsdp_axis, fsdp_param_specs, unet_param_specs

    if which == "scratch":
        model, jmodel, size = UNet2DModel(DEFAULT_SCRATCH_CONFIG, device="cpu"), JaxUNet2DModel(JAX_SCRATCH), 32
        tp, fmin = 256, 2**16
    else:
        model, jmodel, size = (UNet2DModel(UNet2DConfig(**TINY), device="cpu"),
                               JaxUNet2DModel(JaxUNet2DConfig(**TINY)), 16)
        tp, fmin = TP_THRESHOLD, FSDP_MIN
    shapes = jax.eval_shape(lambda: jmodel.init_params(jax.random.PRNGKey(0), sample_size=size))
    jtp = unet_param_specs(shapes, tp)
    assert parallel.unet_param_specs(model, tp) == _jax_specs_in_port_dims(jtp, model)
    split = sum(any(s) for s in parallel.unet_param_specs(model, tp).values())
    assert split > 10, split
    for data in (2, 4):
        assert parallel.fsdp_param_specs(model, data, fmin) == _jax_specs_in_port_dims(
            fsdp_param_specs(shapes, data, fmin), model)
        composed = jax.tree.map(lambda leaf, s: _add_fsdp_axis(leaf, s, data, fmin), shapes, jtp)
        specs = parallel.train_state_specs(model, data, 2, "fsdp", tp, fmin)
        assert specs["params"] == _jax_specs_in_port_dims(composed, model)
        assert specs["mu"] == specs["nu"] == specs["params"] and specs["count"] == specs["step"] == ()


def test_data_helpers_match_jax():
    """``host_shard_slice`` is JAX's; ``local_rows`` keeps what each process
    contributes to JAX's ``global_batch_from_host_shards``, and over
    micro-batches each rank's rows of every micro-batch."""
    import jax

    from baddiffusion_tpu.parallel import make_mesh as jax_make_mesh
    from baddiffusion_tpu.parallel.distributed import global_batch_from_host_shards
    from baddiffusion_tpu.parallel.distributed import host_shard_slice as jax_host_shard_slice

    for total, count in ((12, 3), (16, 4), (8, 2), (9, 2)):
        for i in range(count):
            assert distributed.host_shard_slice(total, i, count) == jax_host_shard_slice(total, i, count)
    batch = {"image_u8": np.arange(16 * 2 * 2 * 3, dtype=np.uint8).reshape(16, 2, 2, 3),
             "is_clean": np.arange(16) % 3 == 0}
    for count in (2, 4):
        parts = [distributed.local_rows(batch, r, count) for r in range(count)]
        for r, part in enumerate(parts):
            for key in batch:
                np.testing.assert_array_equal(part[key], batch[key][jax_host_shard_slice(16, r, count)])
        glued = {key: np.concatenate([p[key] for p in parts]) for key in batch}
        assembled = global_batch_from_host_shards(glued, jax_make_mesh(devices=jax.devices()[:count]))
        for key in batch:
            np.testing.assert_array_equal(np.asarray(assembled[key]), batch[key])
        # grad_accum 2: rank r keeps rows [r·m/W, (r+1)·m/W) of each micro-batch of m = 8 rows
        parts = [distributed.local_rows(batch, r, count, grad_accum=2)["image_u8"] for r in range(count)]
        for j in range(2):
            micro = np.concatenate([p[j * 8 // count:(j + 1) * 8 // count] for p in parts])
            np.testing.assert_array_equal(micro, batch["image_u8"][j * 8:(j + 1) * 8])
    with pytest.raises(ValueError, match="does not split"):
        distributed.local_rows(batch, 0, 3)
    # without a mesh (one rank) the batch's layout keeps every row
    assert parallel.batch_sharding(None, grad_accum=2).count == 1
    assert all(parallel.shard_batch(batch, None)[k] is batch[k] for k in batch)


def test_peer_waits_for_the_decode_cache_while_its_writer_heartbeats(tmp_path):
    """A rank other than 0 waits for rank 0's decode cache only while a
    writer's scratch file is seen and its heartbeat advances: with none it
    returns after the grace time (a dataset root per host), with one it
    returns once the cache is installed, and when the heartbeat stops it
    returns after the stall time (the writer died)."""
    import threading
    import time

    from baddiffusion_tpu_torch.data.datasets import _wait_for_peer_cache

    cache = str(tmp_path / "c.npy")
    t0 = time.monotonic()
    _wait_for_peer_cache(cache, grace_s=0.3, stall_s=5.0)
    assert not os.path.exists(cache) and time.monotonic() - t0 < 3
    scratch = cache + ".tmp.123"
    open(scratch, "w").close()

    def writer():  # heartbeats past the grace time, then installs the cache
        for _ in range(6):
            time.sleep(0.25)
            os.utime(scratch)
        os.replace(scratch, cache)

    thread = threading.Thread(target=writer)
    thread.start()
    t0 = time.monotonic()
    _wait_for_peer_cache(cache, grace_s=0.3, stall_s=5.0)
    thread.join(timeout=10)
    assert not thread.is_alive() and os.path.exists(cache) and time.monotonic() - t0 >= 1.0
    os.remove(cache)
    open(scratch, "w").close()  # a writer that stopped
    t0 = time.monotonic()
    _wait_for_peer_cache(cache, grace_s=0.3, stall_s=1.0)
    assert not os.path.exists(cache) and 1.0 <= time.monotonic() - t0 < 5


def barrier_main(rank, world, store_path, phase, work):
    """``barrier``: rank 1 never reaches the barrier rank 0 waits at;
    ``join``: a rank whose peer never starts."""
    import time

    timeout = 3.0
    if phase == "join":
        t0 = time.monotonic()
        try:
            distributed.initialize("cpu", store=torch.distributed.FileStore(store_path, 2), rank=0, world_size=2,
                                   timeout_s=timeout)
        except Exception as exc:  # the join's own error, whichever the backend raises
            print(f"JOIN_RAISED {time.monotonic() - t0:.1f} {type(exc).__name__}", flush=True)
        return
    distributed.initialize("cpu", store=torch.distributed.FileStore(store_path, world), rank=rank, world_size=world,
                           timeout_s=60)
    if rank == 0:
        t0 = time.monotonic()
        try:
            distributed.barrier("never", timeout_s=timeout)
        except TimeoutError as exc:
            print(f"BARRIER_RAISED {time.monotonic() - t0:.1f} {exc}", flush=True)
        distributed.signal("done", "1")
    else:
        distributed.wait_for("done", timeout_s=60)


def test_a_missing_peer_raises_within_the_timeout(tmp_path):
    outs = launch(tmp_path, 2, ["barrier", str(tmp_path)], timeout=90)
    raised = [line.split() for line in outs[0].splitlines() if line.startswith("BARRIER_RAISED")]
    assert raised and float(raised[0][1]) < 10, outs[0][-2000:]
    assert "1 of 2 ranks arrived" in outs[0]
    outs = launch(tmp_path, 1, ["join", str(tmp_path)], timeout=90)
    raised = [line.split() for line in outs[0].splitlines() if line.startswith("JOIN_RAISED")]
    assert raised and float(raised[0][1]) < 30, outs[0][-2000:]


if __name__ == "__main__":
    r, w, store_file, what = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    if what in ("barrier", "join"):
        barrier_main(r, w, store_file, what, sys.argv[5])
    else:
        rank_main(r, w, store_file, what, sys.argv[5], sys.argv[6])
