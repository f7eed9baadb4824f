"""The port's command line against the JAX package on the CPU: ``config.setup``
in every mode (resolved fields, run-dir name, allow-list errors, resume's
stored learning rate), the CLI's train+measure end to end on the TINY arch,
``--sample_segment`` running in every mode (a measure with it writes what
one without it writes), the measure's
``score.json`` against the JAX ``run_measure`` on one seeded TINY UNet with
JAX's noise handed in, and the factory's model half."""

import dataclasses
import json
import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits
from PIL import Image

import baddiffusion_tpu.metrics.fid  # noqa: F401  (the modules, which the packages' fid() shadows)
import baddiffusion_tpu_torch.metrics.fid  # noqa: F401
from baddiffusion_tpu import cli as jax_cli
from baddiffusion_tpu import factory as jax_factory
from baddiffusion_tpu.config import SCHED_CHOICES
from baddiffusion_tpu.config import setup as jax_setup
from baddiffusion_tpu.io.hf import flax_to_torch_state_dict
from baddiffusion_tpu.schedulers import DDIMConfig as JaxDDIMConfig
from baddiffusion_tpu.schedulers import DDIMScheduler as JaxDDIMScheduler
from baddiffusion_tpu.schedulers import DPMSolverConfig as JaxDPMSolverConfig
from baddiffusion_tpu.schedulers import DPMSolverMultistepScheduler as JaxDPMSolverMultistepScheduler
from baddiffusion_tpu.schedulers import KarrasVeConfig as JaxKarrasVeConfig
from baddiffusion_tpu.schedulers import KarrasVeScheduler as JaxKarrasVeScheduler
from baddiffusion_tpu.schedulers import ScoreSdeVeConfig as JaxScoreSdeVeConfig
from baddiffusion_tpu.schedulers import ScoreSdeVeScheduler as JaxScoreSdeVeScheduler
from baddiffusion_tpu_torch import cli, factory
from baddiffusion_tpu_torch.config import device_from_gpu, setup, shares_card
from baddiffusion_tpu_torch.parallel import make_mesh
from baddiffusion_tpu_torch.pipelines import sampler


@pytest.fixture(autouse=True)
def few_threads():
    """Two threads a BLAS/OpenMP pool (torch's, scipy's): the suite runs
    several pytest-xdist workers at once, and pools as wide as the machine
    then spin against each other (a 4 s test took 3 minutes)."""
    with threadpool_limits(limits=2):
        yield


RUN = "res_None_FAKE_ep1_c1.0_p0.25_BOX_14-CORNER"


@pytest.fixture(autouse=True)
def quiet_trackers(monkeypatch):
    """Trackers without tensorboard (importing it pulls TensorFlow in, about
    17 s); the JSONL stream is what both CLIs always write."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


@pytest.fixture
def tiny_arch(monkeypatch):
    monkeypatch.setenv("BADDIFFUSION_TINY_ARCH", "1")


def train_args(result, extra=()):
    return ["--mode", "train", "--dataset", "FAKE", "--batch", "128", "--poison_rate", "0.1",
            "--result", str(result), "-o", *extra]


def _fields(config) -> dict:
    """The resolved fields both packages share; the run dir by its name (the
    two packages write under different roots) and the device apart."""
    d = dataclasses.asdict(config)
    for key in ("output_dir", "ckpt"):
        d[key] = d[key] and os.path.basename(d[key])
    for key in ("gpu", "result"):
        d.pop(key)
    return d


def _both(tmp_path, argv_of):
    """``setup`` of each package on ``argv_of(root)``, each under its own root."""
    return (jax_setup(argv_of(tmp_path / "jax")), setup(argv_of(tmp_path / "port")))


TRAIN_CASES = {
    "defaults": [],
    "named": ["--trigger", "BOX_14", "--target", "HAT", "--epoch", "50", "--postfix", "xyz"],
    "grad-accum": ["--batch", "32", "--learning_rate", "1e-4"],
    "fclip-w": ["--fclip", "w", "--sched", "DDIM-SCHED", "--save_image_epochs", "3"],
    "extras": ["--remat", "off", "--fake_size", "256", "--measure_sample_n", "64", "--sampling_steps", "20",
               "--eval_dtype", "bf16", "--image_size", "16", "--async_ckpt", "--capture_every", "5"],
}


@pytest.mark.parametrize("extra", TRAIN_CASES.values(), ids=TRAIN_CASES.keys())
@pytest.mark.parametrize("mode", ["train", "train+measure"])
def test_train_setup_matches_jax(tmp_path, mode, extra):
    def argv(root):
        args = train_args(root, extra)
        args[1] = mode
        return args

    jc, pc = _both(tmp_path, argv)
    assert _fields(pc) == _fields(jc)
    for name in ("args.json", "config.json") + (("measure.json",) if mode == "train+measure" else ()):
        assert os.path.exists(os.path.join(pc.output_dir, name)), name
    with open(os.path.join(pc.output_dir, "args.json")) as f:
        port_args = json.load(f)
    with open(os.path.join(jc.output_dir, "args.json")) as f:
        jax_args = json.load(f)
    assert {k: v for k, v in port_args.items() if k != "result"} == {k: v for k, v in jax_args.items() if k != "result"}


EVAL_CASES = {
    "resume": ["--mode", "resume"],
    "sampling": ["--mode", "sampling", "--fclip", "w", "--eval_max_batch", "8", "--sched", "UNIPC-SCHED"],
    "measure": ["--mode", "measure", "--sample_ep", "3", "--measure_steps", "7", "--sample_segment", "50"],
    "measure-ep-negative": ["--mode", "measure", "--sample_ep", "-1"],
}


@pytest.mark.parametrize("extra", EVAL_CASES.values(), ids=EVAL_CASES.keys())
def test_eval_mode_setup_matches_jax(tmp_path, extra):
    """resume/sampling/measure reload args.json from each package's own run
    dir and apply only the mode's flags; resume keeps the rate the run
    trained with (the 32 px scratch 2e-4, not the fine-tune default)."""
    jc0, pc0 = _both(tmp_path, lambda root: train_args(root, ["--trigger", "BOX_8", "--learning_rate", "3e-4"]))
    jc = jax_setup(extra[:2] + ["--ckpt", jc0.output_dir] + extra[2:])
    pc = setup(extra[:2] + ["--ckpt", pc0.output_dir] + extra[2:])
    assert _fields(pc) == _fields(jc)
    assert pc.trigger == "BOX_8" and pc.output_dir == pc0.output_dir
    written = {"sampling": "sampling.json", "measure": "measure.json"}.get(extra[1])
    if written:
        assert os.path.exists(os.path.join(pc.output_dir, written))


def test_resume_keeps_scratch_learning_rate(tmp_path):
    jc0, pc0 = _both(tmp_path, lambda root: train_args(root, ["--postfix", "lr0"]))
    jc = jax_setup(["--mode", "resume", "--ckpt", jc0.output_dir])
    pc = setup(["--mode", "resume", "--ckpt", pc0.output_dir])
    assert pc.learning_rate == jc.learning_rate == pytest.approx(2e-4)


ERROR_CASES = {
    "indivisible-batch": (lambda root: train_args(root, ["--batch", "48"]), ValueError, "divisible"),
    "default-batch-512": (lambda root: ["--mode", "train", "--dataset", "FAKE", "--result", str(root), "-o"],
                          ValueError, "divisible"),
    "unknown-dataset": (lambda root: ["--mode", "train", "--batch", "128", "--result", str(root), "-o"],
                        NotImplementedError, "dataset"),
}


@pytest.mark.parametrize("case", ERROR_CASES.values(), ids=ERROR_CASES.keys())
def test_setup_errors_match_jax(tmp_path, case):
    argv_of, exc, match = case
    with pytest.raises(exc, match=match):
        jax_setup(argv_of(tmp_path / "jax"))
    with pytest.raises(exc, match=match):
        setup(argv_of(tmp_path / "port"))


def test_allow_list_and_overwrite_errors_match_jax(tmp_path):
    jc0, pc0 = _both(tmp_path, lambda root: train_args(root, ["--postfix", "f"]))
    for fn, run in ((jax_setup, jc0), (setup, pc0)):
        with pytest.raises(NotImplementedError, match="isn't used in mode"):
            fn(["--mode", "sampling", "--ckpt", run.output_dir, "--epoch", "9"])
        with pytest.raises(ValueError, match="overwrite"):
            fn([a for a in train_args(os.path.dirname(run.output_dir), ["--postfix", "f"]) if a != "-o"])


def test_gpu_flag_selects_the_device(tmp_path, monkeypatch):
    assert [device_from_gpu(g) for g in (None, "0", "3", "cpu", "cuda:1")] == ["cuda", "cuda:0", "cuda:3", "cpu",
                                                                              "cuda:1"]
    # one process drives one device: a list of cards needs one process a card (torchrun)
    with pytest.raises(ValueError, match="torchrun"):
        device_from_gpu("0,1")
    # under torchrun, rank r takes the r-th entry, or cuda:LOCAL_RANK without a list
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert [device_from_gpu(g) for g in ("0,1", "2,3", "0,0", "0", None)] == ["cuda:1", "cuda:3", "cuda:0",
                                                                             "cuda:0", "cuda:1"]
    assert [shares_card(g) for g in ("0,1", "0,0", "0", "cpu")] == [False, True, True, True]
    monkeypatch.delenv("WORLD_SIZE")
    monkeypatch.delenv("LOCAL_RANK")
    config = setup(train_args(tmp_path, ["--gpu", "cpu"]))
    assert config.device == torch.device("cpu")
    # the eval modes take the device from their own command line, never from args.json
    assert setup(["--mode", "measure", "--ckpt", config.output_dir]).gpu is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        setup(train_args(tmp_path, ["--postfix", "g"])).device


@pytest.mark.parametrize("flags", [["--model_parallel", "2"], ["--param_sharding", "fsdp"]], ids=["tp", "fsdp"])
def test_mesh_flags_and_multi_process_raise(tmp_path, monkeypatch, flags):
    """The mesh flags take effect over several ranks (tests/test_torch_parallel*.py
    run them). A process that torchrun started as one of several ranks but
    that has not joined its process group raises rather than train alone on
    the whole batch; a model axis that does not divide the ranks raises."""
    config = setup(train_args(tmp_path, flags + ["--gpu", "cpu"]))
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="has not joined its process group"):
        cli.run_train(config)
    monkeypatch.delenv("WORLD_SIZE")
    with pytest.raises(ValueError, match="does not divide 1 ranks"):
        make_mesh("cpu", model_parallel=2)


def small_proxy(monkeypatch, dim=64):
    """Both packages' default FID extractor as the proxy with a ``dim``-wide
    projection (the JAX ``_proxy_extractor(dim)`` and the port's
    ``proxy_extractor(dim=dim)``, the same draws), so the Fréchet distance's
    sqrtm is dim², not 2048² (test_torch_metrics.py holds the 2048-d FID to
    the JAX package's)."""
    jax_fid = sys.modules["baddiffusion_tpu.metrics.fid"]
    port_fid = sys.modules["baddiffusion_tpu_torch.metrics.fid"]
    monkeypatch.setattr(jax_fid, "default_extractor", lambda: (jax_fid._proxy_extractor(dim), dim))
    monkeypatch.setattr(port_fid, "default_extractor", lambda device=None: (port_fid.proxy_extractor(device, dim), dim))


def test_cli_train_measure_sampling_resume_end_to_end(tmp_path, monkeypatch, tiny_arch):
    """The JAX e2e smoke's arguments (tests/test_cli_e2e.py): batch 64 →
    grad-accum 2, one global-128 step on FAKE 128; then sampling mode and a
    resume on the same run dir. The FID on a 64-d proxy."""
    small_proxy(monkeypatch)
    monkeypatch.chdir(tmp_path)
    cli.main([
        "--mode", "train+measure", "--dataset", "FAKE", "--batch", "64",
        "--epoch", "1", "--fake_size", "128", "--poison_rate", "0.25",
        "--trigger", "BOX_14", "--target", "CORNER",
        "--measure_sample_n", "4", "--eval_max_batch", "4",
        "--sampling_steps", "2", "--measure_steps", "2",
        "--result", str(tmp_path), "-o", "--gpu", "cpu",
    ])
    out = os.path.join(str(tmp_path), RUN)
    for f in ("args.json", "config.json", "measure.json", "data.json", "model_index.json", "score.json"):
        assert os.path.exists(os.path.join(out, f)), f
    for d in ("unet", "scheduler", "samples", "backdoor_samples", "measure/clean_noclip", "measure/backdoor_noclip"):
        assert os.path.isdir(os.path.join(out, d)), d
    assert len(os.listdir(os.path.join(out, "measure", "backdoor_noclip"))) == 4
    assert len(os.listdir(os.path.join(str(tmp_path), "measure", "FAKE"))) == 4  # the cwd-relative real-image dump
    with open(os.path.join(out, "data.json")) as f:
        step_before = json.load(f)["step"]
    assert step_before == 1
    with open(os.path.join(out, "score.json")) as f:
        sc = json.load(f)
    assert set(sc) == {"FID_proxy_noclip", "MSE_noclip", "SSIM_noclip"}
    assert all(np.isfinite(v) for v in sc.values()) and -1.0 <= sc["SSIM_noclip"] <= 1.0

    cli.main(["--mode", "sampling", "--ckpt", out, "--gpu", "cpu"])
    assert os.path.exists(os.path.join(out, "sampling.json"))
    assert os.path.exists(os.path.join(out, "samples", "epfinal_noclip.png"))
    cli.main(["--mode", "resume", "--ckpt", out, "--gpu", "cpu"])
    with open(os.path.join(out, "data.json")) as f:
        assert json.load(f)["step"] > step_before


def test_sample_segment_runs_in_every_mode(tmp_path, monkeypatch, tiny_arch):
    """``--sample_segment`` is parsed in every mode and every mode's chains
    run in segments: train+measure's grids and measure, then sampling,
    measure and resume on the run dir (the JAX CLI sets it in the same
    places)."""
    small_proxy(monkeypatch)
    monkeypatch.chdir(tmp_path)
    segmented = []
    real = sampler.Chain.run_eager

    def run_eager(self, init, model_fn, draw, segment_steps=None):
        if segment_steps:
            segmented.append(segment_steps)
        return real(self, init, model_fn, draw, segment_steps)

    monkeypatch.setattr(sampler.Chain, "run_eager", run_eager)
    cli.main(["--mode", "train+measure", "--dataset", "FAKE", "--batch", "64", "--epoch", "1", "--fake_size", "64",
              "--measure_sample_n", "2", "--eval_max_batch", "2", "--sampling_steps", "3", "--measure_steps", "3",
              "--sample_segment", "2", "--result", str(tmp_path), "-o", "--gpu", "cpu"])
    (out,) = [str(p) for p in tmp_path.glob("res_*")]
    runs = {"train+measure": len(segmented)}
    for mode in ("sampling", "measure", "resume"):
        config = setup(["--mode", mode, "--ckpt", out, "--sample_segment", "2", "--gpu", "cpu"])
        assert config.sample_segment == 2
        before = len(segmented)
        cli.main(["--mode", mode, "--ckpt", out, "--sample_segment", "2", "--gpu", "cpu"])
        runs[mode] = len(segmented) - before
    # grids: clean + backdoor; measure: clean + backdoor; resume's grids again
    assert runs == {"train+measure": 4, "sampling": 2, "measure": 2, "resume": 2}, runs
    assert set(segmented) == {2}


def test_measure_with_sample_segment_writes_what_it_writes_without(tmp_path, monkeypatch, tiny_arch):
    """One seeded TINY UNet in a run dir, measured with and without
    ``--sample_segment 3`` (DDPM, 7 steps: segments of 3, 3 and 1): the same
    PNG files byte for byte and the same ``score.json``."""
    small_proxy(monkeypatch)
    config = setup(train_args(tmp_path, ["--fake_size", "64", "--trigger", "BOX_14", "--target", "CORNER",
                                         "--gpu", "cpu"]))
    _, scheduler, get_pipeline = factory.get_model_sched(32, 3, rng_seed=3, device="cpu")
    get_pipeline(scheduler, device="cpu").save_pretrained(config.output_dir)
    flags = ["--measure_sample_n", "6", "--eval_max_batch", "4", "--measure_steps", "7", "--gpu", "cpu"]
    got = {}
    for name, extra in (("whole", []), ("segmented", ["--sample_segment", "3"])):
        os.makedirs(tmp_path / name)
        monkeypatch.chdir(tmp_path / name)
        cli.run_measure(setup(["--mode", "measure", "--ckpt", config.output_dir] + flags + extra))
        files = {}
        for sub in ("clean_noclip", "backdoor_noclip"):
            d = os.path.join(config.output_dir, "measure", sub)
            files.update({(sub, f): open(os.path.join(d, f), "rb").read() for f in sorted(os.listdir(d))})
        with open(os.path.join(config.output_dir, "score.json")) as f:
            got[name] = files, json.load(f)
        shutil.rmtree(os.path.join(config.output_dir, "measure"))
    assert len(got["whole"][0]) == 12
    assert got["segmented"] == got["whole"]


def test_cli_runs_on_cuda_by_default(tmp_path, monkeypatch, tiny_arch):
    """No --gpu and no CUDA: the run raises, it does not carry on on the CPU."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["--mode", "train", "--dataset", "FAKE", "--batch", "128", "--epoch", "1", "--fake_size", "128",
                  "--result", str(tmp_path), "-o"])


def _png_dir(path):
    return np.stack([np.asarray(Image.open(os.path.join(path, f"{i}.png"))) for i in range(len(os.listdir(path)))])


def test_measure_matches_jax_run_measure(tmp_path, monkeypatch, tiny_arch):
    """One seeded TINY JAX UNet written as an HF pipeline into a run dir;
    the JAX ``run_measure`` and the port's on a copy of it, DDIM (η = 0: the
    initial noise is the only draw) with JAX's ``normal(PRNGKey(seed))``
    handed to the port through ``measure_noise``. PNG rounding of f32
    samples that differ in their last bits can move a pixel by one level.
    Observed: the clean PNGs are identical, 2 of the 49,152 backdoor pixel
    values differ by one level; the scores differ by 8.8e-6 (MSE), 3.5e-5
    (SSIM) and 2.0e-7 (FID_proxy) relative, against rtol 1e-3, 1e-3, 1e-2.
    The FID runs on the proxy projected to 64-d on both sides (the 2048-d
    FID's sqrtm takes 10+ s a call; test_torch_metrics.py holds it)."""
    small_proxy(monkeypatch)
    jc = jax_setup(train_args(tmp_path / "jax", ["--fake_size", "64", "--trigger", "BOX_14", "--target", "CORNER"]))
    model, params, scheduler, get_pipeline = jax_factory.get_model_sched(32, 3, rng_seed=3, dtype=jnp.float32)
    get_pipeline(params, scheduler).save_pretrained(jc.output_dir)
    port_dir = str(tmp_path / "port" / os.path.basename(jc.output_dir))
    shutil.copytree(jc.output_dir, port_dir)
    flags = ["--sched", "DDIM-SCHED", "--measure_sample_n", "16", "--eval_max_batch", "16", "--measure_steps", "10"]

    shape = (16, 32, 32, 3)
    jax_noise = np.asarray(jax.random.normal(jax.random.PRNGKey(0), shape, np.float32))
    monkeypatch.setattr(cli, "measure_noise", lambda seed, s, device: torch.tensor(jax_noise, device=device))
    os.makedirs(tmp_path / "jax_cwd")
    monkeypatch.chdir(tmp_path / "jax_cwd")
    jax_cli.run_measure(jax_setup(["--mode", "measure", "--ckpt", jc.output_dir] + flags))
    os.makedirs(tmp_path / "port_cwd")
    monkeypatch.chdir(tmp_path / "port_cwd")
    cli.run_measure(setup(["--mode", "measure", "--ckpt", port_dir, "--gpu", "cpu"] + flags))

    np.testing.assert_array_equal(_png_dir(tmp_path / "port_cwd" / "measure" / "FAKE"),
                                  _png_dir(tmp_path / "jax_cwd" / "measure" / "FAKE"))
    for sub in ("clean_noclip", "backdoor_noclip"):
        a = _png_dir(os.path.join(port_dir, "measure", sub)).astype(int)
        b = _png_dir(os.path.join(jc.output_dir, "measure", sub)).astype(int)
        assert a.shape == b.shape == shape and np.abs(a - b).max() <= 1 and (a != b).mean() < 1e-3, sub
    with open(os.path.join(port_dir, "score.json")) as f:
        got = json.load(f)
    with open(os.path.join(jc.output_dir, "score.json")) as f:
        want = json.load(f)
    assert set(got) == set(want) == {"FID_proxy_noclip", "MSE_noclip", "SSIM_noclip"}
    assert got["MSE_noclip"] == pytest.approx(want["MSE_noclip"], rel=1e-3)
    assert got["SSIM_noclip"] == pytest.approx(want["SSIM_noclip"], rel=1e-3)
    assert got["FID_proxy_noclip"] == pytest.approx(want["FID_proxy_noclip"], rel=1e-2)


@pytest.fixture(scope="module")
def jax_tiny():
    """The JAX package's TINY scratch model and params, made once."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("BADDIFFUSION_TINY_ARCH", "1")
        model, params, _, _ = jax_factory.get_model_sched(32, 3, dtype=jnp.float32)
    return model, params


@pytest.mark.parametrize("name", SCHED_CHOICES)
@pytest.mark.parametrize("clip", [False, True])
def test_get_model_sched_matches_jax(name, clip, tiny_arch, jax_tiny):
    """Per name: the JAX get_model_sched's scheduler and pipeline (its own
    two steps, on one TINY model made once) against the port's."""
    jm, _params = jax_tiny
    make, kind = jax_factory._sched_spec(name)
    js = make(clip)
    jgp = jax_factory._make_get_pipeline(jm, kind, clip)
    pm, ps, pgp = factory.get_model_sched(32, 3, noise_sched_type=name, clip_sample=clip, dtype=torch.float32,
                                          device="cpu")
    assert dataclasses.asdict(pm.config) == {k: v for k, v in dataclasses.asdict(jm.config).items()
                                             if k in dataclasses.asdict(pm.config)}
    assert ps.hf_class_name == js.hf_class_name
    jp, pp = jgp(_params, js), pgp(ps, device="cpu")
    assert (pp.default_inference_steps, pp.hf_class_name, pp.clip_each_step) == (
        jp.default_inference_steps, jp.hf_class_name, jp.clip_each_step)


def test_scratch_config_is_the_jax_default(monkeypatch):
    monkeypatch.delenv("BADDIFFUSION_TINY_ARCH", raising=False)
    from baddiffusion_tpu.models.unet2d import DEFAULT_SCRATCH_CONFIG as JAX_SCRATCH

    cfg = factory.scratch_config(32, 3)
    want = dataclasses.replace(JAX_SCRATCH, sample_size=32, in_channels=3, out_channels=3)
    fields = dataclasses.asdict(cfg)
    assert fields == {k: v for k, v in dataclasses.asdict(want).items() if k in fields}
    assert cfg.block_out_channels == (128, 128, 256, 256, 512, 512)
    with pytest.raises(NotImplementedError, match="model_type"):
        factory.get_model_sched(32, 3, model_type="NOPE", device="cpu")


STORED = {
    "ddim": (lambda: JaxDDIMScheduler(JaxDDIMConfig()), 50, "DDIMPipeline"),
    "dpm": (lambda: JaxDPMSolverMultistepScheduler(JaxDPMSolverConfig()), 50, "PNDMPipeline"),
    "sde": (lambda: JaxScoreSdeVeScheduler(JaxScoreSdeVeConfig()), 2000, "ScoreSdeVePipeline"),
    "karras": (lambda: JaxKarrasVeScheduler(JaxKarrasVeConfig()), 50, "KarrasVePipeline"),
}


@pytest.mark.parametrize("stored", STORED.values(), ids=STORED.keys())
def test_get_pretrained_infers_the_kind_like_jax(tmp_path, tiny_arch, stored):
    """A JAX-written checkpoint whose stored scheduler is DDIM, DPM-Solver,
    ScoreSdeVe or KarrasVe keeps its pipeline kind when reloaded without
    --sched (tests/test_factory.py:109-136), and its weights load bitwise."""
    make, steps, hf_cls = stored
    _m, params, _s, get_pipeline = jax_factory.get_model_sched(16, 3)
    sched = make()
    get_pipeline(params, sched).save_pretrained(str(tmp_path))
    _jm, jparams, jsched, jgp = jax_factory.get_pretrained(str(tmp_path))
    model, psched, pgp = factory.get_trained(str(tmp_path), dtype=torch.float32, device="cpu")
    assert type(psched).__name__ == type(jsched).__name__ and psched.hf_class_name == sched.hf_class_name
    jp, pp = jgp(jparams, jsched), pgp(psched, device="cpu")
    assert (pp.default_inference_steps, pp.hf_class_name) == (jp.default_inference_steps, jp.hf_class_name) == (
        steps, hf_cls)
    want = flax_to_torch_state_dict(jax.tree_util.tree_map(np.asarray, params))
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), want[k])
    # a --sched overrides the stored scheduler, as in the JAX package
    _m2, s2, pgp2 = factory.get_pretrained(str(tmp_path), noise_sched_type="UNIPC-SCHED", clip_sample=True,
                                           device="cpu")
    assert s2.hf_class_name == "UniPCMultistepScheduler" and pgp2(s2, device="cpu").clip_each_step == 1.0


def test_get_pretrained_clip_override_and_default_alias(tmp_path, tiny_arch, monkeypatch):
    """The clip override goes into a stored DDPM config; a *-DEFAULT alias
    builds its checkpoint's architecture with fresh weights (the alias's hub
    id pointed at a local JAX-written dir, as in both packages)."""
    _m, params, sched, get_pipeline = jax_factory.get_model_sched(16, 3)
    get_pipeline(params, sched).save_pretrained(str(tmp_path))
    _jm, _jp, jsched, _ = jax_factory.get_pretrained(str(tmp_path), clip_sample=True)
    _pm, psched, _ = factory.get_pretrained(str(tmp_path), clip_sample=True, device="cpu")
    assert psched.config.clip_sample is jsched.config.clip_sample is True
    name = factory.DiffuserModelSched.DDPM_CIFAR10_32
    monkeypatch.setitem(factory.HUB_ALIASES, name, str(tmp_path))
    monkeypatch.setitem(jax_factory.HUB_ALIASES, name, str(tmp_path))
    alias = factory.DiffuserModelSched.DDPM_CIFAR10_DEFAULT
    jm, jparams, js, _ = jax_factory.get_model_sched(16, 3, model_type=alias)
    pm, ps, pgp = factory.get_model_sched(16, 3, model_type=alias, rng_seed=5, device="cpu")
    assert pm.config == factory.UNet2DConfig.load(str(tmp_path), subfolder="unet")
    assert ps.hf_class_name == js.hf_class_name and pgp(ps, device="cpu").unet is pm
    loaded, _, _ = factory.get_pretrained(str(tmp_path), device="cpu")
    assert not torch.equal(pm.conv_in.weight, loaded.conv_in.weight)  # fresh weights, not the checkpoint's


def test_checkpoint_errors(tmp_path):
    with pytest.raises(FileNotFoundError, match="network egress"):
        factory.resolve_checkpoint_path("DDPM-CIFAR10-32")
    os.makedirs(tmp_path / "ldm")
    with open(tmp_path / "ldm" / "model_index.json", "w") as f:
        json.dump({"_class_name": "LDMPipeline", "vqvae": ["diffusers", "VQModel"]}, f)
    # an LDM index takes the LDM branch, which needs the unet/ and vqvae/ it names
    with pytest.raises(FileNotFoundError, match="unet"):
        factory.get_pretrained(str(tmp_path / "ldm"), device="cpu")
