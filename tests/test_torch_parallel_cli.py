"""The port's command lines on two ranks, on the CPU: a ``DiffusionPipeline``
call split over the data ranks gives the one-rank call's images; ``cli.main``
train+measure on two ranks (the JAX e2e smoke's arguments, TINY arch) writes
the run dir once, and its measure directory's PNGs are byte for byte those
of a one-rank measure of the same run, with ``score.json`` from rank 0 alone;
``anp_cli`` on two ranks writes the JAX package's score keys; a run dir that
rank 0 refuses stops its peer too (the run-dir handshake).

The ranks are this file run as a script, one process a rank over gloo on a
``FileStore`` under ``tmp_path`` (no TCP port), with a timeout; the two
ranks run the pipeline, the CLI and the ANP in one launch. The file takes
about 30 s. Tolerance: the split pipeline's images within 1e-6 of the
one-rank call's (the same draws; only the UNet's batch differs).
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:  # run as a rank's script
    sys.path.insert(0, ROOT)

from baddiffusion_tpu_torch import anp_cli, cli, parallel  # noqa: E402
from baddiffusion_tpu_torch.config import setup  # noqa: E402
from baddiffusion_tpu_torch.models import UNet2DConfig, UNet2DModel  # noqa: E402
from baddiffusion_tpu_torch.parallel import distributed  # noqa: E402
from baddiffusion_tpu_torch.pipelines import DiffusionPipeline  # noqa: E402
from baddiffusion_tpu_torch.schedulers import DDPMConfig, DDPMScheduler  # noqa: E402

RUN = "res_None_FAKE_ep1_c1.0_p0.25_BOX_14-CORNER"
CLI_ARGS = ["--mode", "train+measure", "--dataset", "FAKE", "--batch", "64", "--epoch", "1", "--fake_size", "128",
            "--poison_rate", "0.25", "--trigger", "BOX_14", "--target", "CORNER", "--measure_sample_n", "6",
            "--eval_max_batch", "2", "--sampling_steps", "2", "--measure_steps", "2", "-o", "--gpu", "cpu"]
ANP_ARGS = ["--epoch", "2", "--batch", "16", "--fake_size", "32", "--measure_sample_n", "4", "--sampling_steps", "2",
            "--gpu", "cpu"]
PIPE_BATCH, PIPE_STEPS = 3, 3  # 3 rows over 2 ranks: one row of padding
RANK_TIMEOUT_S = 300


def _pipeline():
    cfg = UNet2DConfig(sample_size=8, layers_per_block=1, block_out_channels=(8, 16), norm_num_groups=4,
                       attention_head_dim=8, down_block_types=("DownBlock2D", "AttnDownBlock2D"),
                       up_block_types=("AttnUpBlock2D", "UpBlock2D"))
    unet = UNet2DModel(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    return DiffusionPipeline(unet, DDPMScheduler(DDPMConfig()), device="cpu")


def _pipeline_call(pipe):
    return pipe(batch_size=PIPE_BATCH, generator=torch.Generator().manual_seed(4), num_inference_steps=PIPE_STEPS,
                save_every_step=True, capture_every=1)


def _small_proxy(dim=64):
    """The FID extractor as the port's proxy with a 64-wide projection (as
    ``test_torch_cli.small_proxy`` sets it), so the sqrtm is small."""
    port_fid = sys.modules["baddiffusion_tpu_torch.metrics.fid"]
    return port_fid, lambda device=None: (port_fid.proxy_extractor(device, dim), dim)


def rank_main(rank, world, store_path, work):
    """One rank: the split pipeline call (rank 0 saves its images), then
    ``cli.main`` train+measure, then ``anp_cli.main`` on the run."""
    torch.set_num_threads(1)
    sys.modules["torch.utils.tensorboard"] = None  # importing it pulls TensorFlow in
    os.environ["BADDIFFUSION_TINY_ARCH"] = "1"
    port_fid, extractor = _small_proxy()
    port_fid.default_extractor = extractor
    distributed.initialize("cpu", store=torch.distributed.FileStore(store_path, world), rank=rank, world_size=world,
                           timeout_s=RANK_TIMEOUT_S)
    pipe = _pipeline()
    pipe.mesh = parallel.make_mesh("cpu")
    out = _pipeline_call(pipe)
    if rank == 0:
        np.savez(os.path.join(work, "pipeline.npz"), images=out.images, movie=out.movie)
    os.chdir(work)  # the measure's real-image dump is cwd-relative
    cli.main(CLI_ARGS + ["--result", work])
    anp_cli.main(["--ckpt", os.path.join(work, RUN), "--output_dir", os.path.join(work, "anp")] + ANP_ARGS)
    # the same run dir again without -o: rank 0 refuses it, and its peer hears so through the store
    try:
        setup([a for a in CLI_ARGS if a != "-o"] + ["--result", work])
        print(f"REFUSAL {rank} none", flush=True)
    except (ValueError, RuntimeError) as exc:
        print(f"REFUSAL {rank} {type(exc).__name__}: {exc}", flush=True)
    print(f"RANK_DONE {rank}", flush=True)
    distributed.shutdown()


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """The two ranks' launch; returns (work dir, each rank's output)."""
    work = str(tmp_path_factory.mktemp("parallel_cli"))
    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"}
    env.pop("WORLD_SIZE", None)
    store = os.path.join(work, "store")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(r), "2", store, work],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env) for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=RANK_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"RANK_DONE {r}" in out, f"rank {r} failed:\n{out[-4000:]}"
    return work, outs


def test_split_pipeline_call_gives_the_one_rank_images(two_ranks):
    work, _ = two_ranks
    got = np.load(os.path.join(work, "pipeline.npz"))
    want = _pipeline_call(_pipeline())
    assert got["images"].shape == want.images.shape == (PIPE_BATCH, 8, 8, 3)
    assert got["movie"].shape == want.movie.shape == (PIPE_STEPS, PIPE_BATCH, 8, 8, 3)
    np.testing.assert_allclose(got["images"], want.images, atol=1e-6, rtol=0)
    np.testing.assert_allclose(got["movie"], want.movie, atol=1e-6, rtol=0)


def test_two_rank_train_writes_the_run_once(two_ranks):
    work, outs = two_ranks
    run = os.path.join(work, RUN)
    for f in ("args.json", "config.json", "measure.json", "data.json", "model_index.json", "score.json"):
        assert os.path.exists(os.path.join(run, f)), f
    with open(os.path.join(run, "data.json")) as f:
        assert json.load(f)["step"] == 1  # one global-128 step, split over the ranks
    with open(os.path.join(run, "logs", "metrics.jsonl")) as f:
        assert sum("loss" in json.loads(line) for line in f) == 1  # rank 0 alone logs
    assert "rank 1 of 2: data 2 x model 1" in outs[1]
    assert {"ep0.png", "ep0_t0.png"} <= set(os.listdir(os.path.join(run, "samples")))


def test_two_rank_measure_is_the_one_rank_measure(two_ranks, monkeypatch):
    """The two ranks' measure directories against a one-rank measure of the
    same run: every PNG byte for byte, and the same scores; rank 1 sampled
    its share and left the scoring to rank 0."""
    work, outs = two_ranks
    run = os.path.join(work, RUN)
    with open(os.path.join(run, "score.json")) as f:
        two_rank_scores = json.load(f)
    assert set(two_rank_scores) == {"FID_proxy_noclip", "MSE_noclip", "SSIM_noclip"}
    assert "rank 1: sampled its chunks; rank 0 scores them" in outs[1]
    saved = os.path.join(work, "two_rank_measure")
    shutil.copytree(os.path.join(run, "measure"), saved)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    port_fid, extractor = _small_proxy()
    monkeypatch.setattr(port_fid, "default_extractor", extractor)
    monkeypatch.chdir(work)
    cli.main(["--mode", "measure", "--ckpt", run, "--gpu", "cpu"])
    for branch in ("clean_noclip", "backdoor_noclip"):
        files = sorted(os.listdir(os.path.join(saved, branch)))
        assert files == sorted(f"{i}.png" for i in range(6)), files
        for name in files:
            with open(os.path.join(saved, branch, name), "rb") as a, open(os.path.join(run, "measure", branch, name),
                                                                          "rb") as b:
                assert a.read() == b.read(), (branch, name)
    with open(os.path.join(run, "score.json")) as f:
        assert json.load(f) == two_rank_scores


def test_a_refused_run_dir_stops_every_rank(two_ranks):
    _, outs = two_ranks
    assert "REFUSAL 0 ValueError: Output directory" in outs[0], outs[0][-2000:]
    assert "REFUSAL 1 RuntimeError: rank 1: rank 0 refused the run dir" in outs[1], outs[1][-2000:]


def test_two_rank_anp_writes_the_jax_score_keys(two_ranks):
    work, _ = two_ranks
    out = os.path.join(work, "anp", f"res_anp_2_lr0.0001_pb4.0_{os.path.join(work, RUN)}")
    with open(os.path.join(out, "score.json")) as f:
        sc = json.load(f)
    assert set(sc) == {"MSE", "MSE_best", "MSE_ep1", "MSE_ep2", "SSIM", "SSIM_best", "SSIM_ep1", "SSIM_ep2"}
    assert sc["MSE_best"] == min(sc["MSE_ep1"], sc["MSE_ep2"])
    assert sc["SSIM_best"] == max(sc["SSIM_ep1"], sc["SSIM_ep2"])
    with open(os.path.join(out, "logs", "metrics.jsonl")) as f:
        steps = [r for r in map(json.loads, f) if "loss" in r]
    assert len(steps) == 4 and all(np.isfinite([r["loss"], r["clean_mse"], r["backdoor_mse"]]).all() for r in steps)
    assert os.path.exists(os.path.join(out, "unet", "config.json"))


if __name__ == "__main__":
    rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
