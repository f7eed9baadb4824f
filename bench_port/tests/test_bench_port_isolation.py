"""What a run loads and where it refuses (about 40 s: three fresh
interpreters, one of them a small run on the CPU)."""

import ast
import glob
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "baddiffusion_tpu"}


def _python(code, cwd=ROOT, env_extra=None):
    env = dict(os.environ, PYTHONPATH=cwd, **(env_extra or {}))
    env.pop("JAX_PLATFORMS", None)
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=600)


def test_a_run_loads_nothing_of_jax():
    """A small run on the CPU through the harness in a fresh interpreter,
    every module it loaded compared by its whole top-level name."""
    code = (
        "import json, sys, time, torch\n"
        "from bench_port import harness\n"
        "r = harness.run_cell('.', 'cifar10-32.measure', 3, 0.5, True, torch.device('cpu'), time.time(),\n"
        "    overrides=dict(batch=2, clean_rows=1, snapshot_every=2, trace_steps=1,\n"
        "                   reference_rows=2))\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n"
    )
    out = _python(code)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "baddiffusion_tpu_torch" in loaded and not loaded & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    code = (
        "import json, sys\n"
        "import bench_port.reference.unet, bench_port.reference.train, bench_port.reference.diffusion\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n"
    )
    out = _python(code)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not loaded & (FORBIDDEN | {"baddiffusion_tpu_torch"})
    for path in glob.glob(os.path.join(ROOT, "bench_port", "reference", "*.py")):
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            names = [a.name for a in node.names] if isinstance(node, ast.Import) else (
                [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                assert name.split(".")[0] not in FORBIDDEN | {"baddiffusion_tpu_torch"}, (path, name)


def test_no_card_no_result():
    """Without a CUDA device a run exits non-zero and prints no result."""
    out = subprocess.run([sys.executable, "-m", "bench_port.run", "--workload", "cifar10-32.measure", "--seed",
                          "2147483653", "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert "{" not in out.stdout


def test_benchmark_files_alone_do_not_run(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's folder: no
    program to measure, so no result."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "bench_port"), tmp_path / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = dict(os.environ, PYTHONPATH=str(tmp_path))
    out = subprocess.run([sys.executable, "-m", "bench_port.run", "--workload", "cifar10-32.measure", "--seed",
                          "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
                         timeout=300, env=env)
    assert out.returncode != 0 and "{" not in out.stdout
    # past the look for a card too: the program is missing
    out = _python("import time, torch\nfrom bench_port import harness\n"
                  "harness.run_cell('.', 'cifar10-32.measure', 1, 1.0, False, torch.device('cpu'), time.time())\n",
                  cwd=str(tmp_path))
    assert out.returncode != 0 and "No module named 'baddiffusion_tpu_torch'" in out.stderr
