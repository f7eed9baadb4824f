"""``chip_smoke.py``'s timing helper on the CPU, with the card's calls stubbed
out: a profiler session that records no device events must not fail the
smoke. The helper lives in ``baddiffusion_tpu_torch.utils.profiling``, which
the smoke imports."""

import importlib.util
import os

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


class _EmptySession:
    """A profiler session that recorded nothing."""

    def __init__(self, **_):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def key_averages(self):
        return []


def test_device_profile_times_with_cuda_events_when_the_profiler_records_nothing(monkeypatch, capsys):
    from baddiffusion_tpu_torch.utils import profiling

    smoke = _load_smoke()
    assert smoke.device_profile is profiling.device_profile
    monkeypatch.setattr(profiling, "profile", _EmptySession)
    monkeypatch.setattr(profiling.torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(profiling.torch.cuda, "synchronize", lambda *args: None)
    timed = []

    def time_ms(fn, reps, repeats):
        timed.append((reps, repeats))
        fn()
        return 2.5

    monkeypatch.setattr(profiling, "time_ms", time_ms)
    calls = []
    wall, dev_ms, kernels, host = smoke.device_profile(lambda: calls.append(1), reps=4)
    assert (wall, dev_ms, kernels, host) == (2.5, 2.5, {profiling.EVENT_TIMED: 2.5}, {})
    assert timed == [(4, 1)]
    assert len(calls) == 1 + profiling.PROFILE_ATTEMPTS * 4 + 1  # warm-up, the empty sessions, the timed window
    out = capsys.readouterr().out
    assert out.count("recorded no device events") == profiling.PROFILE_ATTEMPTS
    assert "timed with CUDA events" in out
    # the readers of its result still work: the window lands in "other"
    assert "other 2.5000 ms (100.0%)" in smoke.breakdown(kernels)
    assert smoke.top_host_ops(host, 1) == ""


def test_zoo_names_and_designed_forwards_match_a_cpu_chain():
    """Phase 7's chains: the factory's names past DDPM, and Karras-VE; each
    engine makes the UNet forwards ``zoo_forwards`` designs (counted here
    with a stand-in model on the CPU, at a short length)."""
    import torch

    from baddiffusion_tpu_torch import factory
    from baddiffusion_tpu_torch.pipelines import sample_chain

    smoke = _load_smoke()
    names = {v for k, v in vars(factory.DiffuserModelSched).items() if k.endswith("_SCHED")}
    names -= {factory.DiffuserModelSched.DDPM_SCHED, factory.DiffuserModelSched.LDM_SCHED}
    assert set(smoke.ZOO_NAMES) == names | {"KARRAS-VE"} and len(smoke.ZOO_NAMES) == 14
    for name in smoke.ZOO_NAMES:
        scheduler, kind = smoke.zoo_scheduler(name)
        steps, want = smoke.zoo_forwards(scheduler, kind, 6)
        calls = []

        def model(x, t):
            calls.append(t)
            return smoke.standin(x, t)

        state = scheduler.set_timesteps(scheduler.create_state(), 6)
        init = torch.randn(2, 4, 4, 3, generator=torch.Generator().manual_seed(0))
        sample, _ = sample_chain(scheduler, state, model, init, generator=torch.Generator().manual_seed(1))
        assert len(calls) == want and torch.isfinite(sample).all(), name
        assert steps == len(state.timesteps)


def test_phase9_kernel_calls_follow_the_published_configs():
    """Phase 9's designed (K1, K3, bias_shift) launches a module call are what the
    full-width CompVis/ldm-celebahq-256 and google/ncsnpp-celebahq-256
    modules hold (built on the meta device: no memory, no weights)."""
    import torch

    from baddiffusion_tpu_torch import model_configs as mc
    from baddiffusion_tpu_torch.models import UNet2DModel, VQModel

    smoke = _load_smoke()

    def built(cls, config):
        with torch.device("meta"):
            model = cls.__new__(cls)
            torch.nn.Module.__init__(model)
            model._build(config)
        return model

    unet, vq = built(UNet2DModel, mc.LDM_CELEBA_HQ_256_UNET), built(VQModel, mc.LDM_CELEBA_HQ_256_VQ)
    assert {"UNet2DModel": smoke.kernel_calls(unet), "Encoder": smoke.kernel_calls(vq.encoder, vq.quant_conv),
            "Decoder": smoke.kernel_calls(vq.decoder, vq.post_quant_conv)} == smoke.LDM_KERNEL_CALLS
    assert smoke.kernel_calls(built(UNet2DModel, mc.NCSNPP_CELEBA_HQ_256)) == smoke.NCSNPP_KERNEL_CALLS
    want = smoke.want_launches({"UNet2DModel": 2, "Decoder": 1}, smoke.LDM_KERNEL_CALLS, steps=3, step=(5, 1, 7))
    assert want == {"groupnorm_silu": 2 * 45 + 23 + 15, "groupnorm_silu_backward": 15, "attention": 2 * 16 + 1 + 3,
                    "bias_shift": 2 * 67 + 29 + 21, "bias_shift_backward": 21, "vq_nearest": 1}
