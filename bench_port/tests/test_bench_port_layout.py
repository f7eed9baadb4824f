"""BENCHMARK.json against the files the harness finds by name, and a cell, a
configuration, a traffic mix and a per-layer metric added as new files only
(about 25 s: one small run on the CPU)."""

import json
import os
import re
import shutil
import time

import torch

from bench_port import harness

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _bench(root=ROOT):
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def test_benchmark_names_its_pieces():
    bench = _bench()
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["bench_port"]
    assert 1 <= bench["run_seconds"] <= 51
    for config in bench["configs"]:
        assert NAME.match(config["name"]) and config["file"].startswith("bench_port/")
        with open(os.path.join(ROOT, config["file"])) as f:
            assert json.load(f)["reduced"] == config["reduced"] == []
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for cell in bench["workloads"]:
        assert cell["chips"] == 1 and NAME.match(cell["name"])
        assert os.path.exists(os.path.join(ROOT, "bench_port", "traffic", cell["traffic"] + ".json"))
        assert os.path.exists(os.path.join(ROOT, "bench_port", "limits", cell["name"] + ".json"))
        resolved = harness.resolve(ROOT, cell["name"])
        assert "setup_s" in resolved.end_to_end and len(resolved.end_to_end) >= 2 and resolved.per_layer
    for metric in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(metric["name"]) and UNIT.match(metric["unit"]) and metric["better"] in ("lower", "higher")
    for metric in bench["per_layer"]:
        module = harness.reader(ROOT, metric["name"])
        assert (module.LAYER, module.MOVES) == (metric["layer"], metric["moves"])
        moved = e2e[metric["moves"]]
        for cell in metric["workloads"]:  # every cell that reports it reports what it moves
            assert "workloads" not in moved or cell in moved["workloads"]


def test_forbidden_names_are_compared_whole(monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "baddiffusion_tpu_torch_fake", object())
    assert not [m for m in harness.forbidden_modules() if m.startswith("baddiffusion_tpu_torch")]
    monkeypatch.setitem(sys.modules, "jaxlib.fake", object())
    assert "jaxlib.fake" in harness.forbidden_modules()


def test_a_new_cell_is_new_files_only(tmp_path):
    """A configuration, a traffic mix, a cell's limits and a per-layer metric
    added as files (and entries in BENCHMARK.json), then run: no file of the
    harness is edited."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "bench_port"), root / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    os.symlink(os.path.join(ROOT, "baddiffusion_tpu_torch"), root / "baddiffusion_tpu_torch")  # the program
    bench = _bench()
    with open(os.path.join(ROOT, "bench_port", "configs", "ddpm-cifar10-32.json")) as f:
        config = json.load(f)
    config["unet"]["block_out_channels"] = [32, 64, 64, 64]
    (root / "bench_port" / "configs" / "tiny-ddpm.json").write_text(json.dumps(config))
    with open(os.path.join(ROOT, "bench_port", "traffic", "attack_finetune_32.json")) as f:
        traffic = json.load(f)
    traffic.update(global_batch=4, micro_batch=2, dataset_size=12, trace_steps=1, reference_rows=2)
    (root / "bench_port" / "traffic" / "tiny_finetune.json").write_text(json.dumps(traffic))
    (root / "bench_port" / "limits" / "tiny.finetune.json").write_text(json.dumps({"grad_gap": 0.05}))
    (root / "bench_port" / "metrics" / "host_ms.train.py").write_text(
        'LAYER = "train step"\nMOVES = "train_samples_per_s"\n\n\ndef read(ctx):\n'
        '    return 1e3 * ctx.timeline.window_s / ctx.steps\n')
    bench["configs"].append({"name": "tiny-ddpm", "source": "https://huggingface.co/google/ddpm-cifar10-32",
                             "file": "bench_port/configs/tiny-ddpm.json", "reduced": ["block_out_channels"],
                             "why": "a test's"})
    bench["workloads"].append({"name": "tiny.finetune", "config": "tiny-ddpm", "traffic": "tiny_finetune",
                               "chips": 1, "why": "a test's"})
    for metric in bench["end_to_end"]:
        if metric["name"] == "train_samples_per_s":
            metric["workloads"].append("tiny.finetune")
    bench["per_layer"].append({"name": "host_ms.train", "unit": "ms", "better": "lower", "source": "host_clock",
                               "layer": "train step", "moves": "train_samples_per_s",
                               "workloads": ["tiny.finetune"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = harness.resolve(str(root), "tiny.finetune")
    assert cell.traffic["global_batch"] == 4 and cell.unet["block_out_channels"] == [32, 64, 64, 64]
    assert cell.per_layer == ["host_ms.train"]
    result = harness.run_cell(str(root), "tiny.finetune", 5, 1.0, True, torch.device("cpu"), time.time())
    assert result["metrics"]["host_ms.train"]["value"] > 0
    assert list(result)[-1] == "checks" and result["correct"]
