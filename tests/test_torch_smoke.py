"""``chip_smoke.py``'s timing helper on the CPU, with the card's calls stubbed
out: a profiler session that records no device events must not fail the
smoke."""

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
    smoke = _load_smoke()
    monkeypatch.setattr(smoke, "profile", _EmptySession)
    monkeypatch.setattr(smoke.torch.cuda, "synchronize", lambda *args: None)
    timed = []

    def time_ms(fn, reps, repeats):
        timed.append((reps, repeats))
        fn()
        return 2.5

    monkeypatch.setattr(smoke, "time_ms", time_ms)
    calls = []
    wall, dev_ms, kernels, host = smoke.device_profile(lambda: calls.append(1), reps=4)
    assert (wall, dev_ms, kernels, host) == (2.5, 2.5, {smoke.EVENT_TIMED: 2.5}, {})
    assert timed == [(4, 1)]
    assert len(calls) == 1 + smoke.PROFILE_ATTEMPTS * 4 + 1  # warm-up, the empty sessions, the timed window
    out = capsys.readouterr().out
    assert out.count("recorded no device events") == smoke.PROFILE_ATTEMPTS
    assert "timed with CUDA events" in out
    # the readers of its result still work: the window lands in "other"
    assert "other (elementwise, copies, cat, plain norms) 2.5000 ms (100.0%)" in smoke.breakdown(kernels)
    assert smoke.top_host_ops(host, 1) == ""
