"""The benchmark's own tests: ``python -m pytest bench_port/tests -q`` from the
checkout's root (on the CPU; a test marked ``cuda`` runs only on a card)."""

import json
import os
import shutil

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skips without one")


@pytest.fixture(autouse=True)
def _skip_without_card(request):
    if request.node.get_closest_marker("cuda") is not None:
        import torch

        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA device")


@pytest.fixture(scope="session")
def finetune_root(tmp_path_factory):
    """A checkout whose BENCHMARK.json also holds ``cifar10-32.finetune``,
    from the benchmark's own traffic and limits files: the finetune
    generator's comparison runs on the CPU at 32 px (the measured finetune
    cell, at 256 px, is too large for a CPU test)."""
    root = tmp_path_factory.mktemp("finetune") / "checkout"
    shutil.copytree(os.path.join(ROOT, "bench_port"), root / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    os.symlink(os.path.join(ROOT, "baddiffusion_tpu_torch"), root / "baddiffusion_tpu_torch")
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["workloads"].append({"name": "cifar10-32.finetune", "config": "ddpm-cifar10-32",
                               "traffic": "attack_finetune_32", "chips": 1, "why": "the CPU tests'"})
    for metric in bench["end_to_end"] + bench["per_layer"]:
        if metric["name"] == "train_samples_per_s" or metric["name"].endswith(".train"):
            metric["workloads"].append("cifar10-32.finetune")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return str(root)
