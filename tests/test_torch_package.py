"""Package rules of the PyTorch port: it stands alone (no JAX, no
``baddiffusion_tpu``), imports without nvcc or a GPU, runs on CUDA by default
and raises rather than falling back to the CPU."""

import ast
import importlib
import os
import pkgutil

import pytest
import torch

import baddiffusion_tpu_torch
from baddiffusion_tpu_torch import ops
from baddiffusion_tpu_torch.models import UNet2DConfig, UNet2DModel
from baddiffusion_tpu_torch.ops import _build
from baddiffusion_tpu_torch.pipelines import DiffusionPipeline
from baddiffusion_tpu_torch.schedulers import DDPMScheduler

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE_DIR = os.path.dirname(baddiffusion_tpu_torch.__file__)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "baddiffusion_tpu")
TINY = UNet2DConfig(
    sample_size=8, layers_per_block=1, block_out_channels=(8, 16), norm_num_groups=4, attention_head_dim=8,
    down_block_types=("DownBlock2D", "AttnDownBlock2D"), up_block_types=("AttnUpBlock2D", "UpBlock2D"),
)


def _sources():
    files = [os.path.join(ROOT, "chip_smoke.py"), os.path.join(ROOT, "scripts", "time_attention.py")]
    for dirpath, _, names in os.walk(PACKAGE_DIR):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", _sources(), ids=lambda p: os.path.relpath(p, ROOT))
def test_imports_nothing_of_jax_or_the_jax_package(path):
    for module in _imported_modules(path):
        top = module.split(".")[0]
        assert top not in FORBIDDEN, f"{os.path.relpath(path, ROOT)} imports {module}"


# the trainer's modules, which the import checks above and below must reach
TRAINER_MODULES = ("utils.logging", "utils.image", "utils.samples", "utils.trackers", "data.datasets",
                   "data.prefetch", "training.ema", "training.checkpoint", "training.trainer")
# the sampler zoo's modules, likewise
ZOO_MODULES = ("schedulers.ddim", "schedulers.dpmsolver", "schedulers.deis", "schedulers.unipc", "schedulers.pndm",
               "schedulers.heun", "schedulers.lms", "schedulers.sde_ve", "schedulers.karras_ve", "pipelines.sampler",
               "pipelines.pipeline", "factory")


def test_every_module_imports_without_nvcc_or_a_gpu():
    names = [m.name for m in pkgutil.walk_packages([PACKAGE_DIR], prefix="baddiffusion_tpu_torch.")]
    assert "baddiffusion_tpu_torch.ops._build" in names and "baddiffusion_tpu_torch.pipelines.pipeline" in names
    for modules in (TRAINER_MODULES, ZOO_MODULES):
        assert {f"baddiffusion_tpu_torch.{m}" for m in modules} <= set(names)
        checked = {os.path.relpath(p, PACKAGE_DIR) for p in _sources()}
        assert {m.replace(".", os.sep) + ".py" for m in modules} <= checked
    for name in names:
        importlib.import_module(name)


def test_scipy_is_imported_only_where_the_lms_table_is_built():
    """K-LMS builds its coefficient table with scipy, imported inside that
    function; no module of the port imports it at the top."""
    for path in _sources():
        with open(path) as f:
            tree = ast.parse(f.read(), filename=path)
        top = [n for n in tree.body if isinstance(n, (ast.Import, ast.ImportFrom))]
        names = [a.name for n in top if isinstance(n, ast.Import) for a in n.names]
        names += [n.module for n in top if isinstance(n, ast.ImportFrom) and n.module]
        assert not any(m.split(".")[0] == "scipy" for m in names), f"{os.path.relpath(path, ROOT)} imports scipy"


def test_default_device_raises_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        UNet2DModel(TINY)
    unet = UNet2DModel(TINY, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DiffusionPipeline(unet, DDPMScheduler())
    DiffusionPipeline(unet, DDPMScheduler(), device="cpu").save_pretrained(str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DiffusionPipeline.from_pretrained(str(tmp_path))
    assert DiffusionPipeline.from_pretrained(str(tmp_path), device="cpu").device.type == "cpu"


def test_kernel_wrappers_refuse_other_devices():
    """Only CPU tensors take the plain path; anything else goes to the kernel
    checks and is refused there, never quietly computed."""
    x = torch.empty(1, 2, 2, 32, device="meta")
    w = torch.empty(32, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        ops.groupnorm_silu(x, w, w, 32)
    stats = torch.empty(1, 32, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        ops.groupnorm_silu_forward(x, w, w, 32)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        ops.groupnorm_silu_backward(x, w, w, stats, stats, x, 32)
    q = torch.empty(1, 2, 4, 8, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        ops.attention(q, q, q, 0.5)


def test_build_needs_nvcc_only_when_building(monkeypatch):
    monkeypatch.setenv("PATH", "")
    monkeypatch.setenv("CUDA_HOME", os.path.join(ROOT, "no-such-toolkit"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()
    assert _build.build([]) >= 0.0  # nothing to build needs no toolkit


def test_library_names_follow_the_sources():
    paths = {name: _build.library_path(name) for name in _build.SOURCES}
    assert len(set(paths.values())) == len(_build.SOURCES)
    for name, path in paths.items():
        assert os.path.dirname(path) == _build.BUILD_DIR
        assert os.path.basename(path).startswith(f"lib{name}-")
        assert os.path.exists(os.path.join(_build.CSRC_DIR, name + ".cu"))
        assert _build.library_path(name) == path
