"""The comparison that decides ``correct`` fails what it should: the
control (the reference with its carry across windows broken, in the
program's place), and the program with its timed path broken underneath,
driven through the rest of a run on the CPU (the harness's look for a
card skipped)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from chipbench import check, control, gen, run
from chipbench.tests import small



@pytest.fixture(autouse=True)
def one_thread():
    """Small tensors under several test workers: one thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

@pytest.mark.parametrize("seed", [2**31 + 1, 7, 123456789])
def test_control_comes_out_not_correct(seed):
    spec = small.spec()
    out = control.control(spec, seed, 6, "cpu")
    assert out["compared"] == 6 and out["differ"] >= 1
    # and the true reference in the program's place passes
    recs = [gen.recording(spec["config"], spec["traffic"], seed, 0)]
    answers = check.reference_answers(spec["config"], recs, {0: 5}, "cpu",
                                      carry=True)
    assert check.compare(spec["config"], recs, answers, "cpu")[1] == 0


def _state_unchanged(monkeypatch):
    """The relaxed machines' step returns their state unchanged."""
    from repro_torch.kernels import ops
    monkeypatch.setattr(ops, "a2_state_call", lambda *a, **k: None)
    monkeypatch.setattr(ops, "a2_state_vmapped", lambda *a, **k: None)


def _half_the_batch(monkeypatch):
    """Each window's update sees the first half of its events only."""
    from repro_torch.core.events import EventStream
    from repro_torch.core.streaming import StagedWindow, StreamingMiner
    real = StreamingMiner.update

    def update(self, window, final=False):
        w = window.stream if isinstance(window, StagedWindow) else window
        half = len(w.types) // 2
        return real(self, EventStream(w.types[:half], w.times[:half],
                                      w.num_types), final=final)
    monkeypatch.setattr(StreamingMiner, "update", update)


def _answer_altered(monkeypatch):
    """One count of each window's deepest level is off by one where the
    miner produces it."""
    from repro_torch.core.streaming import StreamingMiner
    real = StreamingMiner.update

    def update(self, window, final=False):
        res = real(self, window, final=final)
        level = max(i for i, c in enumerate(res.counts) if np.size(c))
        res.counts[level][0] += 1
        return res
    monkeypatch.setattr(StreamingMiner, "update", update)


@pytest.mark.parametrize("traffic,fault", [
    ("single", _state_unchanged),
    ("single", _half_the_batch),
    ("single", _answer_altered),
    ("fleet8", _answer_altered),
])
def test_a_broken_timed_path_comes_out_not_correct(monkeypatch, traffic,
                                                   fault):
    fault(monkeypatch)
    rec = run.measure(small.spec(traffic), 2**31 + 9, 0.05, False, "cpu")
    out = run.report(rec, False, {"platform": "cpu"})
    assert out["correct"] is False and out["failed"] >= 1
