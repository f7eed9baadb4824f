"""The port's nine further examples (``baddiffusion_tpu_torch/examples/``) on
the CPU at a tiny size, each through its ``run(...)``, with its outputs
under ``tmp_path``; and each ``main()``'s flags against the JAX script's
(read from ``examples/<name>.py`` with ``ast``): the same names and
defaults, the output paths moved under ``torch_examples_out/``, plus
``--gpu``."""

import ast
import dataclasses
import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import baddiffusion_tpu_torch.metrics.fid  # noqa: F401  (the module, which the package's fid() shadows)
from baddiffusion_tpu_torch import factory
from baddiffusion_tpu_torch.config import setup
from baddiffusion_tpu_torch.data import DatasetLoader
from baddiffusion_tpu_torch.examples import (
    accum_variants,
    anp_dose_response,
    anp_frontier,
    bf16_drift,
    mfu_analysis,
    profile_attribution,
    sampler_sweep,
    sampling_batch_sweep,
    stage_fake_datasets,
)
from baddiffusion_tpu_torch.models import UNet2DConfig, UNet2DModel

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = UNet2DConfig(sample_size=8, layers_per_block=1, block_out_channels=(8, 16), norm_num_groups=4,
                    attention_head_dim=8, down_block_types=("DownBlock2D", "AttnDownBlock2D"),
                    up_block_types=("AttnUpBlock2D", "UpBlock2D"))


@pytest.fixture(autouse=True)
def few_threads():
    with threadpool_limits(limits=2):
        yield


@pytest.fixture(autouse=True)
def quiet(monkeypatch):
    """No tensorboard (importing it pulls TensorFlow), and the FID's proxy
    projected to 64-d (its 2048² sqrtm is test_torch_metrics.py's)."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    port_fid = sys.modules["baddiffusion_tpu_torch.metrics.fid"]
    monkeypatch.setattr(port_fid, "default_extractor", lambda device=None: (port_fid.proxy_extractor(device, 64), 64))


@pytest.fixture
def run_dir(tmp_path, monkeypatch):
    """A backdoored-run directory as the command line leaves it (args.json,
    config.json, the HF pipeline) with a seeded TINY-arch scratch UNet at
    32 px; the working directory is ``tmp_path`` (the measure's dump)."""
    monkeypatch.setenv("BADDIFFUSION_TINY_ARCH", "1")
    monkeypatch.chdir(tmp_path)
    config = setup(["--mode", "train", "--dataset", "FAKE", "--batch", "128", "--poison_rate", "0.1",
                    "--fake_size", "64", "--trigger", "BOX_14", "--target", "CORNER", "--result",
                    str(tmp_path / "runs"), "-o", "--gpu", "cpu"])
    _, scheduler, get_pipeline = factory.get_model_sched(32, 3, rng_seed=3, device="cpu")
    get_pipeline(scheduler, device="cpu").save_pretrained(config.output_dir)
    return config.output_dir


def test_sampling_batch_sweep(tmp_path):
    out = str(tmp_path / "sweep.json")
    res = sampling_batch_sweep.run([1, 2], [0, 2], steps=3, out=out, model_config=TINY, device="cpu")
    assert [(r["segment"], r["batch"]) for r in res["rows"]] == [(None, 1), (None, 2), (2, 1), (2, 2)]
    assert all(r["imgs_per_sec"] > 0 and r["steps"] == 3 for r in res["rows"])
    assert res["device"] == "cpu" and res["winner"] in res["rows"]
    with open(out) as f:
        assert json.load(f) == res


def test_sampler_sweep(run_dir, tmp_path):
    out = str(tmp_path / "out" / "SWEEP.json")
    table = sampler_sweep.run(run_dir, n=2, time_n=2, out=out, scheds=["DDIM-SCHED", "SCORE-SDE-VE-SCHED"],
                              gpu="cpu", steps=3)
    assert set(table) == {"DDIM-SCHED", "SCORE-SDE-VE-SCHED", sampler_sweep.KARRAS_ROW, "device"}
    for sched in ("DDIM-SCHED", "SCORE-SDE-VE-SCHED"):
        row = table[sched]
        assert row["steps"] == 3 and row["measure_sample_n"] == 2 and row["imgs_per_sec"] > 0
        assert all(np.isfinite(row[k]) for k in ("FID_proxy", "MSE", "SSIM"))
    assert os.path.exists(os.path.join(run_dir, "karras_ve_samples", "grid.png"))
    assert os.path.isdir(tmp_path / "measure" / "FAKE")
    with open(out) as f:
        assert json.load(f) == table
    # a second run skips what the table holds
    assert sampler_sweep.run(run_dir, n=2, time_n=2, out=out, scheds=["DDIM-SCHED"], gpu="cpu", steps=3) == table


def test_bf16_drift(run_dir, tmp_path):
    out = str(tmp_path / "drift")
    summary = bf16_drift.run(run_dir, n=3, steps=3, batch=2, out=out, device="cpu")
    assert set(summary["delta_bf16_minus_f32"]) == {"MSE", "SSIM", "FID_proxy"}
    for tag in ("f32", "bf16"):
        assert all(np.isfinite(summary[tag][k]) for k in ("MSE", "SSIM", "FID_proxy"))
        assert len(os.listdir(os.path.join(out, f"clean_{tag}"))) == 3
    assert summary["f32"]["MSE"] != summary["bf16"]["MSE"] and summary["device"] == "cpu"
    with open(os.path.join(out, "drift.json")) as f:
        assert json.load(f) == summary


ANP_FLAGS = ["--batch", "8", "--fake_size", "16"]


def _fake_measure_dump(tmp_path):
    from baddiffusion_tpu_torch.utils.image import save_images

    save_images(np.random.RandomState(0).rand(3, 32, 32, 3), str(tmp_path / "measure" / "FAKE"))


def test_anp_dose_response(run_dir, tmp_path):
    _fake_measure_dump(tmp_path)
    out = str(tmp_path / "out" / "ANP_SWEEP.json")
    table = anp_dose_response.run(run_dir, budgets=[1.0, 4.0], epoch=1, n=2, sampling_steps=2, eval_dtype="fp32",
                                  out=out, gpu="cpu", anp_flags=ANP_FLAGS)
    assert set(table) == {"1", "4"}
    for row in table.values():
        assert os.path.isdir(row["run_dir"]) and row["run_dir"].startswith(str(tmp_path / "out"))
        assert all(np.isfinite(row[k]) for k in ("MSE_best", "SSIM_best", "MSE_final", "SSIM_final",
                                                  "clean_FID_proxy"))
    with open(out) as f:
        assert json.load(f) == table


def test_anp_frontier(run_dir, tmp_path):
    _fake_measure_dump(tmp_path)
    out = str(tmp_path / "out" / "ANP_FRONTIER.json")
    table = anp_frontier.run(run_dir, budgets=[0.5], lrs=[1e-4, 5e-4], epochs=[1], n=2, sampling_steps=2,
                             eval_dtype="bf16", out=out, gpu="cpu", anp_flags=ANP_FLAGS)
    assert set(table) == {"pb0.5_lr0.0001_ep1", "pb0.5_lr0.0005_ep1"}
    for row in table.values():
        assert all(np.isfinite(row[k]) for k in ("MSE_best", "MSE_final", "SSIM_final", "clean_FID_proxy"))


def _jax_example(name):
    spec = importlib.util.spec_from_file_location(f"jax_example_{name}", os.path.join(REPO, "examples", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_stage_fake_datasets_writes_the_jax_scripts_datasets(tmp_path):
    """MNIST and CIFAR10 staged by each package: the same columns and, image
    by image, the same pixels and labels; the port's loader reads them."""
    import datasets as hfds

    jax_stage = _jax_example("stage_fake_datasets")
    paths = stage_fake_datasets.run(["MNIST", "CIFAR10"], root=str(tmp_path / "port"), n=6)
    assert paths == [str(tmp_path / "port" / "MNIST"), str(tmp_path / "port" / "CIFAR10")]
    for name in ("MNIST", "CIFAR10"):
        jax_stage.stage(name, str(tmp_path / "jax"), 6)
        got, want = (hfds.load_from_disk(str(tmp_path / side / name)) for side in ("port", "jax"))
        assert got.column_names == want.column_names and got.features == want.features
        col = stage_fake_datasets.SPECS[name][0]
        for a, b in zip(got, want):
            np.testing.assert_array_equal(np.asarray(a[col]), np.asarray(b[col]))
            assert a["label"] == b["label"]
    dsl = DatasetLoader("MNIST", root=str(tmp_path / "port"), batch_size=2)
    dsl.set_poison("NONE", "TRIGGER", poison_rate=0.0).prepare_dataset()
    assert next(dsl.epoch_batches(0))["image_u8"].shape == (2, 32, 32, 1)
    with pytest.raises(ValueError, match="unknown dataset"):
        stage_fake_datasets.run(["SVHN"], root=str(tmp_path))


@pytest.mark.parametrize("which", ["train", "sample"])
def test_profile_attribution(which):
    stats = profile_attribution.run(which, device="cpu", batch=2, sampling_steps=2, model_config=TINY, top=5)
    assert stats["device"] == "cpu" and not any(k.startswith("hbm_") for k in stats)
    assert stats["rows"] and all(ms >= 0 for _, _, ms in stats["rows"])
    assert [ms for _, _, ms in stats["rows"]] == sorted((ms for _, _, ms in stats["rows"]), reverse=True)


def test_mfu_analysis_counts_the_step_and_the_chain():
    """FLOPs of a train step and of a chain on the TINY UNet; on the CPU no
    time is turned into a device rate. The chain's count is its steps times
    one forward; a step's, about three forwards at its batch (backward twice
    the forward)."""
    step = mfu_analysis.train_main(True, image_size=32, batch=4, device="cpu", model_config=TINY, iters=1)
    chain = mfu_analysis.sampling_main(False, batch=4, steps=5, device="cpu", model_config=TINY)
    one = mfu_analysis.sampling_main(False, batch=4, steps=1, device="cpu", model_config=TINY)
    assert chain["flops"] == 5 * one["flops"] > 0
    assert 2.5 * one["flops"] < step["flops"] < 3.5 * one["flops"]
    assert "mfu" not in step and step["device"] == "cpu" and step["peak_flops"] == 989e12
    model = UNet2DModel(dataclasses.replace(TINY, sample_size=32), device="cpu")
    x, t = torch.zeros(4, 32, 32, 3), torch.full((4,), 500)
    conv = model.conv_in
    want = 2 * 4 * 32 * 32 * conv.out_channels * conv.in_channels * 9
    assert mfu_analysis.count_flops(lambda: conv(x)) == want
    assert mfu_analysis.count_flops(lambda: model(x, t)) == one["flops"]


def test_accum_variants(monkeypatch):
    monkeypatch.setattr(accum_variants, "GLOBAL", 8)
    monkeypatch.setattr(accum_variants, "ACCUM", 4)
    rows = accum_variants.run(["loop@2", "remat_full", "scan", "unrolled"], iters=1, hbm=True, image_size=8,
                              device="cpu", model_config=TINY)
    assert [r["variant"] for r in rows] == ["loop@2", "remat_full", "scan", "unrolled"]
    for r in rows[:2]:
        assert r["step_ms"] > 0 and r["samples_per_sec"] > 0 and "hbm_gib_per_step" not in r
        assert r["device_ms_per_step"] >= 0 and 0.0 <= r["idle_share"] < 1.0
    assert all("no eager counterpart" in r["error"] for r in rows[2:])
    with pytest.raises(ValueError, match="do not divide"):
        accum_variants.run(["loop@3"], device="cpu", model_config=TINY)
    assert accum_variants._structure("loop") == (4, False) and accum_variants._structure("remat_full") == (1, True)


def _jax_flags(name):
    """{flag: default} of the JAX script's argparse calls (literal defaults;
    store_true flags default False)."""
    tree = ast.parse(open(os.path.join(REPO, "examples", f"{name}.py")).read())
    consts = {t.id: node.value for node in tree.body if isinstance(node, ast.Assign)
              for t in node.targets if isinstance(t, ast.Name)}

    def value(node):  # a literal, or a module-level constant holding one
        return ast.literal_eval(consts[node.id] if isinstance(node, ast.Name) else node)

    flags = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "add_argument":
            kw = {k.arg: k.value for k in node.keywords}
            default = value(kw["default"]) if "default" in kw else None
            if "action" in kw and ast.literal_eval(kw["action"]) == "store_true":
                default = False
            flags[ast.literal_eval(node.args[0]).lstrip("-")] = default
    return flags


EXAMPLES = {
    "sampling_batch_sweep": (sampling_batch_sweep, {}),
    "sampler_sweep": (sampler_sweep, {"out": os.path.join("torch_examples_out", "SWEEP.json")}),
    "bf16_drift": (bf16_drift, {"out": os.path.join("torch_examples_out", "bf16_drift")}),
    "anp_dose_response": (anp_dose_response, {"out": os.path.join("torch_examples_out", "ANP_SWEEP.json")}),
    "anp_frontier": (anp_frontier, {"out": os.path.join("torch_examples_out", "ANP_FRONTIER.json")}),
    "stage_fake_datasets": (stage_fake_datasets, {}),
    "mfu_analysis": (mfu_analysis, {}),
    "accum_variants": (accum_variants, {"variants": ["loop", "remat_full"]}),
}


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_main_flags_are_the_jax_scripts(name):
    """Every JAX flag with its default; the port's own: the output paths
    (under the git-ignored torch_examples_out/; sampling_batch_sweep's ``""``
    writes nothing in both), accum_variants' variants (``scan`` and
    ``scan_u4`` have no eager counterpart), and ``--gpu``."""
    module, moved = EXAMPLES[name]
    want = _jax_flags(name)
    want.update(moved)
    parser = module.parser()
    got = {a.dest: a.default for a in parser._actions if a.dest != "help"}
    if name != "stage_fake_datasets":
        assert got.pop("gpu") is None
    assert got == want
    for path in moved.values():
        assert not isinstance(path, str) or path.startswith("torch_examples_out")


def test_profile_attribution_takes_the_jax_scripts_argument(monkeypatch):
    """The JAX script reads ``sys.argv[1]`` (default ``train``)."""
    seen = []
    monkeypatch.setattr(profile_attribution, "run", lambda which, device: seen.append((which, device)))
    profile_attribution.main([])
    profile_attribution.main(["sample", "--gpu", "cpu"])
    assert seen == [("train", "cuda"), ("sample", "cpu")]
    assert "argv[1] if len(sys.argv) > 1 else \"train\"" in open(os.path.join(REPO, "examples",
                                                                               "profile_attribution.py")).read()
