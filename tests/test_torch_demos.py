"""The reference's demos as the port's modules (``baddiffusion_tpu_torch.
examples``), end to end on the CPU at a tiny size (about 10 s alone): 2
train steps, 4 images, 5-step chains on a two-level 16 px UNet (SSIM's
11-tap window needs 16 px). The JAX demos are scripts with no callable at a
small size, and the JAX package stays as it is, so their parity rests on
the component tests that already hold (the train step, ANP, the VE score
step, the samplers, the metrics); here: the files each writes, the defense
reading the attack's run, the JAX demos' initial noise bit for bit, and
each ``main()``'s flags and defaults."""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
from PIL import Image
from threadpoolctl import threadpool_limits

from baddiffusion_tpu_torch import factory
from baddiffusion_tpu_torch.examples import attack_demo, defense_demo, train_sde_ve
from baddiffusion_tpu_torch.models import UNet2DConfig

TINY = UNet2DConfig(
    sample_size=16, layers_per_block=1, block_out_channels=(16, 32),
    down_block_types=("DownBlock2D", "AttnDownBlock2D"), up_block_types=("AttnUpBlock2D", "UpBlock2D"),
    norm_num_groups=8, attention_head_dim=8,
)
TINY_SCORE = dataclasses.replace(train_sde_ve.SCORE_MODEL_CONFIG, sample_size=16, layers_per_block=1,
                                 block_out_channels=(16, 32), down_block_types=TINY.down_block_types,
                                 up_block_types=TINY.up_block_types, norm_num_groups=8)
SMALL = dict(n=4, sampling_steps=5, batch=4, fake_size=8, device="cpu", log_every=1)
GRID_PX = 4 * 16 + 5 * 2  # a 4x4 grid of 16 px images, 2 px borders


@pytest.fixture(autouse=True)
def few_threads():
    """Two threads a BLAS/OpenMP pool: the suite runs several workers at once."""
    with threadpool_limits(limits=2):
        yield


def test_initial_noise_is_the_jax_demos():
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (4, 16, 16, 3), dtype=np.float32))
    np.testing.assert_array_equal(attack_demo.initial_noise((4, 16, 16, 3)), want)


def _grid(path):
    with Image.open(path) as im:
        return im.size


def test_attack_then_defense(tmp_path, capsys):
    run = str(tmp_path / "attack")
    res = attack_demo.run(2, run, model_config=TINY, **SMALL)
    keys = ("backdoor_mse", "backdoor_ssim", "clean_mse_to_target", "clean_ssim_to_target")
    assert all(np.isfinite(res[k]) for k in keys) and res["train_steps_per_s"] > 0
    assert sorted(os.listdir(run)) == ["args.json", "backdoor_grid.png", "clean_grid.png", "model_index.json",
                                       "result.json", "scheduler", "unet"]
    with open(os.path.join(run, "result.json")) as f:
        assert json.load(f) == {k: res[k] for k in keys}
    with open(os.path.join(run, "args.json")) as f:
        assert json.load(f) == {"trigger": "BOX_14", "target": "CORNER", "poison_rate": 0.3, "dataset": "FAKE",
                                "learning_rate": 2e-4}
    assert _grid(os.path.join(run, "backdoor_grid.png")) == _grid(os.path.join(run, "clean_grid.png")) == (GRID_PX,) * 2
    assert "step 2: loss=" in capsys.readouterr().out
    model, scheduler, _ = factory.get_trained(run, device="cpu")
    assert model.config == TINY and scheduler.config.num_train_timesteps == 1000

    out = str(tmp_path / "defense")
    got = defense_demo.run(run, 2, out=out, **SMALL)
    assert np.isfinite(got["backdoor_mse_before"]) and np.isfinite(got["backdoor_mse_after"])
    # before ANP: the attack's own backdoor chain, on the same noise and draws
    assert got["backdoor_mse_before"] == pytest.approx(res["backdoor_mse"], rel=1e-5)
    assert got["backdoor_mse_after"] != got["backdoor_mse_before"]  # γ/β moved
    with open(os.path.join(out, "result.json")) as f:
        assert json.load(f) == {k: got[k] for k in ("backdoor_mse_before", "backdoor_mse_after")}
    assert "anp step 2: clean_mse=" in capsys.readouterr().out


def test_train_sde_ve(tmp_path):
    out = str(tmp_path / "ve")
    row = train_sde_ve.run(2, 4, n=4, out=out, dataset="FAKE", sampling_steps=5, fake_size=8,
                           model_config=TINY_SCORE, device="cpu", log_every=1)
    assert np.isfinite(row["FID_proxy"]) and np.isfinite(row["final_loss"])
    assert row["steps"] == 5 and row["measure_sample_n"] == 4 and row["train_steps"] == 2
    assert sorted(os.listdir(out)) == ["model_index.json", "pc_grid.png", "pc_samples", "ref_images", "result.json",
                                       "scheduler", "unet"]
    assert len(os.listdir(os.path.join(out, "pc_samples"))) == len(os.listdir(os.path.join(out, "ref_images"))) == 4
    with open(os.path.join(out, "result.json")) as f:
        assert json.load(f) == {k: v for k, v in row.items() if k not in ("train_s", "train_steps_per_s", "sample_s")}
    with open(os.path.join(out, "model_index.json")) as f:
        assert json.load(f)["_class_name"] == "ScoreSdeVePipeline"
    _, scheduler, get_pipeline = factory.get_trained(out, device="cpu")
    assert get_pipeline(scheduler, device="cpu").default_inference_steps == 2000
    assert scheduler.config.sigma_max == 50.0


@pytest.mark.parametrize("module, argv, want", [
    (attack_demo, [], dict(steps=3000, out="attack_demo_out", device="cuda")),
    (attack_demo, ["--steps", "7", "--out", "x", "--gpu", "cpu"], dict(steps=7, out="x", device="cpu")),
    (defense_demo, ["--ckpt", "r"], dict(ckpt="r", steps=300, budget=4.0, lr=1e-4, out="defense_demo_out",
                                         device="cuda")),
    (train_sde_ve, [], dict(steps=4000, batch=128, lr=2e-4, sigma_max=50.0, n=256, out="sde_ve_out",
                            dataset="CIFAR10", device="cuda")),
])
def test_main_parses_the_jax_flags(monkeypatch, module, argv, want):
    seen = {}

    def fake_run(*args, **kwargs):
        names = {attack_demo: ("steps", "out"), defense_demo: ("ckpt", "steps", "budget", "lr"),
                 train_sde_ve: ("steps", "batch", "lr", "sigma_max", "n", "out", "dataset")}[module]
        seen.update(dict(zip(names, args)), **kwargs)
        return {"train_s": 1.0, "train_steps_per_s": 1.0, "sample_s": 1.0, "anp_s": 1.0, "anp_steps_per_s": 1.0}

    monkeypatch.setattr(module, "run", fake_run)
    module.main(argv)
    assert seen == want
