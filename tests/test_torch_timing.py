"""``tools/timing.py``'s profiler readout, on recorded profiles made up
here: up to ``PROFILE_TRIES`` profiles are taken for one that recorded
every launch (some kernel, each a whole multiple of ``reps`` times);
failing that the last gives each kernel's mean per recorded launch, or
"not measured" where its records cannot tell the launches per call."""
import sys
import types
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))

import timing  # noqa: E402

# kernel_ms only calls fn and torch.cuda.synchronize around the profiles
TORCH = types.SimpleNamespace(
    cuda=types.SimpleNamespace(synchronize=lambda: None))


def _replay(monkeypatch, records):
    """profile_kernels that returns ``records`` one profile at a time."""
    seen = iter(records)
    monkeypatch.setattr(timing, "profile_kernels",
                        lambda torch, fn, reps: next(seen))


@pytest.mark.parametrize("records,want,tries", [
    ([{"k": (2.0, 20)}], {"k": 0.1}, 1),
    # a kernel launched twice a call: 40 records over 20 calls
    ([{"a": (1.0, 40), "b": (2.0, 20)}], {"a": 0.05, "b": 0.1}, 1),
    # a profile that recorded no kernel is taken again
    ([{}, {"k": (2.0, 20)}], {"k": 0.1}, 2),
    # so is one that lost launches, whose sum would be too small
    ([{"k": (1.5, 15)}, {}, {"k": (2.0, 20)}], {"k": 0.1}, 3),
    ([{}, {"k": (1.9, 19)}, {}], {}, 3),
    # no complete profile: the last one's mean per recorded launch, times
    # the launches per call its records tell (19 of 20, 37 of 40)
    ([{}, {}, {"a": (1.9, 19), "b": (3.7, 37)}], {"a": 0.1, "b": 0.2}, 3),
    # too few records to tell a kernel's launches per call
    ([{}, {}, {"a": (1.9, 19), "b": (0.5, 5)}], {}, 3),
])
def test_kernel_ms_counts_only_complete_profiles(monkeypatch, records, want,
                                                 tries):
    _replay(monkeypatch, records)
    per, n, counts = timing.kernel_ms(TORCH, lambda: None, 20)
    assert n == tries
    assert per == pytest.approx(want)
    assert counts == {k: c for k, (_, c) in records[n - 1].items()}


def test_device_ms_sums_kernels_or_says_not_measured(monkeypatch):
    _replay(monkeypatch, [{"a": (1.0, 40), "b": (2.0, 20)}])
    assert timing.device_ms(TORCH, lambda: None) == (
        pytest.approx(0.15), 1, {"a": 40, "b": 20})
    _replay(monkeypatch, [{}, {}, {"k": (1.0, 9)}])
    assert timing.device_ms(TORCH, lambda: None) == (
        "not measured", timing.PROFILE_TRIES, {"k": 9})
