"""The comparison that decides ``correct``: a sound small run passes; the
control (the reference one precision below the cell's, in the program's
place) and the program broken underneath each come out not correct. On the
CPU at small batches, with the cells' own limits (about 2 min).

Faults planted, as each cell can have them: a step that returns its state
unchanged; half of the batch left out (training: the mean over the other
half; sampling: half the rows not stepped); an answer altered where it is
produced (sampling: one row of a step's result; training: one byte of a
fed image, and the poison rate the loader is given doubled). The exchange between chips
is not a fault these one-card cells can have. The card's full-size readings
of the control are ``bench_port/control.py``'s."""

import time

import pytest
import torch

from bench_port import control, harness

SMALL = {
    "cifar10-32.finetune": dict(global_batch=4, micro_batch=4, dataset_size=16, trace_steps=1, reference_rows=4),
    "cifar10-32.measure": dict(batch=4, clean_rows=2, snapshot_every=2, trace_steps=1, reference_rows=4),
}


def _run(root, cell, seed=11):
    torch.manual_seed(0)
    return harness.run_cell(root, cell, seed, 1.0, False, torch.device("cpu"), time.time(), overrides=SMALL[cell])


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_sound_run_is_correct(cell, finetune_root):
    result = _run(finetune_root, cell)
    assert result["correct"], result["checks"]


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_control_is_not_correct(cell, finetune_root):
    torch.manual_seed(0)
    row = control.readings(finetune_root, cell, 11, 1.0, torch.device("cpu"), overrides=SMALL[cell])
    assert row["program_correct"] and not row["lower_correct"], (row["program"], row["lower"])


def _state_unchanged(monkeypatch):
    from baddiffusion_tpu_torch.training.optim import Optimizer

    def update(self, grads, state, params, norm=None):
        state.count += 1
        return torch.zeros(())

    monkeypatch.setattr(Optimizer, "update", update)


def _half_batch(monkeypatch):
    from baddiffusion_tpu_torch.training.train import TrainStep

    original = TrainStep.loss

    def loss(self, state, image_u8, is_clean, generator, timesteps=None, noise=None):
        h = image_u8.shape[0] // 2
        cut = lambda v: None if v is None else v[:h]
        return original(self, state, image_u8[:h], is_clean[:h], generator, cut(timesteps), cut(noise))

    monkeypatch.setattr(TrainStep, "loss", loss)


def _poison_rate_doubled(monkeypatch):
    from baddiffusion_tpu_torch.data.datasets import DatasetLoader

    original = DatasetLoader.set_poison

    def set_poison(self, trigger_type, target_type, poison_rate=0.2, **kw):
        return original(self, trigger_type, target_type, poison_rate=2 * poison_rate, **kw)

    monkeypatch.setattr(DatasetLoader, "set_poison", set_poison)


def _feed_altered(monkeypatch):
    from baddiffusion_tpu_torch.data.datasets import DatasetLoader

    original = DatasetLoader.epoch_batches

    def epoch_batches(self, epoch=0):
        for batch in original(self, epoch):
            batch["image_u8"][0, 0, 0, 0] ^= 1
            yield batch

    monkeypatch.setattr(DatasetLoader, "epoch_batches", epoch_batches)


def _step_with(monkeypatch, change):
    from baddiffusion_tpu_torch.schedulers.ddpm import DDPMScheduler

    original = DDPMScheduler.step

    def step(self, state, model_output, step_index, sample, noise=None):
        state, prev, x0 = original(self, state, model_output, step_index, sample, noise)
        return state, change(sample, prev), x0

    monkeypatch.setattr(DDPMScheduler, "step", step)


def _altered(prev):
    out = prev.clone()
    out[0] += 0.05
    return out


def _half_rows(sample, prev):
    out = prev.clone()
    out[prev.shape[0] // 2:] = sample[prev.shape[0] // 2:]
    return out


FAULTS = {
    ("cifar10-32.finetune", "state unchanged"): _state_unchanged,
    ("cifar10-32.finetune", "half the batch"): _half_batch,
    ("cifar10-32.finetune", "poison rate doubled"): _poison_rate_doubled,
    ("cifar10-32.finetune", "answer altered in the feed"): _feed_altered,
    ("cifar10-32.measure", "state unchanged"): lambda mp: _step_with(mp, lambda sample, prev: sample),
    ("cifar10-32.measure", "half the batch"): lambda mp: _step_with(mp, _half_rows),
    ("cifar10-32.measure", "answer altered"): lambda mp: _step_with(mp, lambda sample, prev: _altered(prev)),
}


@pytest.mark.parametrize("cell,fault", sorted(FAULTS))
def test_fault_is_not_correct(cell, fault, monkeypatch, finetune_root):
    FAULTS[(cell, fault)](monkeypatch)
    result = _run(finetune_root, cell)
    assert not result["correct"], result["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["cifar10-32.finetune", "cifar10-32.measure"])
def test_control_on_the_card(cell, finetune_root):
    """The control at the cell's own size on the card: not correct, on three
    seeds, where the program is."""
    for seed in (2147483901, 2147483902, 2147483903):
        row = control.readings(finetune_root, cell, seed, 5.0, torch.device("cuda"))
        assert row["program_correct"] and not row["lower_correct"], (row["program"], row["lower"])
