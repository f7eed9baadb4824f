"""Package rules of the PyTorch port: it stands alone (no JAX, no
``baddiffusion_tpu``), imports without nvcc or a GPU, runs on CUDA by default
and raises rather than falling back to the CPU."""

import ast
import importlib
import json
import os
import pkgutil
import subprocess
import sys

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
    files = [os.path.join(ROOT, "chip_smoke.py"), os.path.join(ROOT, "scripts", "time_attention.py"),
             os.path.join(ROOT, "scripts", "check_repeatable.py"), os.path.join(ROOT, "scripts", "scaleout_nccl.py")]
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
# the command lines, the measure and the defense, likewise
CLI_MODULES = ("config", "cli", "anp_cli", "metrics._prng", "metrics.image", "metrics.fid", "models.inception",
                  "defense.anp", "io.hf", "device")
# the latent-diffusion path, the NCSN++ blocks and score matching, likewise
LATENT_MODULES = ("models.vae", "models.blocks", "models.resnet", "pipelines.ldm", "training.score_matching",
                  "model_configs")
# the device-time profiler and the reference's demos, likewise
DEMO_MODULES = ("utils.profiling", "examples.attack_demo", "examples.defense_demo", "examples.train_sde_ve")
# the scale-out modules, likewise
PARALLEL_MODULES = ("parallel.distributed", "parallel.mesh", "parallel.sharding_rules", "parallel.layout")
# segment mode, the PNG codec and the further examples, likewise
SEGMENT_MODULES = ("pipelines.segments", "native.pngio", "examples.sampling_batch_sweep", "examples.sampler_sweep",
                   "examples.bf16_drift", "examples.anp_dose_response", "examples.anp_frontier",
                   "examples.stage_fake_datasets", "examples.profile_attribution", "examples.mfu_analysis",
                   "examples.accum_variants")


def test_every_module_imports_without_nvcc_or_a_gpu():
    names = [m.name for m in pkgutil.walk_packages([PACKAGE_DIR], prefix="baddiffusion_tpu_torch.")]
    assert "baddiffusion_tpu_torch.ops._build" in names and "baddiffusion_tpu_torch.pipelines.pipeline" in names
    for modules in (TRAINER_MODULES, ZOO_MODULES, CLI_MODULES, LATENT_MODULES, DEMO_MODULES, PARALLEL_MODULES,
                    SEGMENT_MODULES):
        assert {f"baddiffusion_tpu_torch.{m}" for m in modules} <= set(names)
        checked = {os.path.relpath(p, PACKAGE_DIR) for p in _sources()}
        assert {m.replace(".", os.sep) + ".py" for m in modules} <= checked
    for name in names:
        importlib.import_module(name)


def test_new_modules_load_no_jax_in_a_fresh_interpreter():
    """Importing each command-line, metric and defense module (and the package's
    entry points) in a fresh interpreter leaves no JAX, flax, optax or
    ``baddiffusion_tpu`` module in ``sys.modules``."""
    modules = (CLI_MODULES + LATENT_MODULES + DEMO_MODULES + PARALLEL_MODULES + SEGMENT_MODULES
               + ("metrics", "defense", "parallel", "native"))
    names = [f"baddiffusion_tpu_torch.{m}" for m in modules]
    code = ("import importlib, json, sys\n"
            f"for name in {names!r}:\n"
            "    importlib.import_module(name)\n"
            "    bad = sorted(m for m in sys.modules if m.split('.')[0] in " + repr(FORBIDDEN) + ")\n"
            "    print(json.dumps([name, bad]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120,
                         env={k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"})
    assert out.returncode == 0, out.stderr
    lines = [json.loads(line) for line in out.stdout.splitlines() if line.startswith("[")]
    assert [name for name, _ in lines] == names
    assert all(not bad for _, bad in lines), lines


def test_scipy_is_imported_only_where_the_lms_table_is_built():
    """K-LMS builds its coefficient table with scipy, imported inside that
    function, as the FID's sqrtm does; no module of the port imports it at
    the top."""
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


def test_latent_path_and_score_step_default_to_cuda(monkeypatch, tmp_path):
    """The VQ-VAE, the LDM pipeline (and its reload) and the score step run
    on the card unless the caller asks for the CPU."""
    from baddiffusion_tpu_torch.models import VQModel, VQModelConfig
    from baddiffusion_tpu_torch.pipelines import LDMPipeline
    from baddiffusion_tpu_torch.training import make_optimizer, make_ve_train_step

    vq_cfg = VQModelConfig(block_out_channels=(8,), norm_num_groups=4, sample_size=8)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        VQModel(vq_cfg)
    vq, unet = VQModel(vq_cfg, device="cpu"), UNet2DModel(TINY, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LDMPipeline(vq, unet, DDPMScheduler())
    LDMPipeline(vq, unet, DDPMScheduler(), device="cpu").save_pretrained(str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LDMPipeline.from_pretrained(str(tmp_path))
    assert LDMPipeline.from_pretrained(str(tmp_path), device="cpu").device.type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_ve_train_step(unet, make_optimizer(1e-4)[0], [0.01, 1.0])


def test_command_lines_default_to_cuda(monkeypatch, tmp_path):
    """No --gpu and no CUDA: the CLI's and anp_cli's runs raise, they do not
    carry on on the CPU."""
    from baddiffusion_tpu_torch import anp_cli, cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["--mode", "train", "--dataset", "FAKE", "--batch", "128", "--epoch", "1", "--fake_size", "128",
                  "--result", str(tmp_path), "-o"])
    os.makedirs(tmp_path / "run")
    with open(tmp_path / "run" / "args.json", "w") as f:
        json.dump({"trigger": "BOX_14", "target": "CORNER", "dataset": "FAKE", "poison_rate": 0.1}, f)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        anp_cli.main(["--ckpt", str(tmp_path / "run"), "--output_dir", str(tmp_path / "anp"), "--fake_size", "16"])


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
