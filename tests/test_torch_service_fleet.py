"""The port's multi-tenant service as a fleet, on the CPU (plain kernel
versions): same-shape and heterogeneous tenants fuse through K6 (the
plain tallies count the lanes) and stay bit-identical to standalone
miners; the event-length guardrail splits a spread group; admission,
backpressure, round-robin fairness and watchdog retry (no double
counting) behave as in the reference; and a session checkpoint written by
either package restores into the other and finishes the stream
bit-identically. Tolerance: exact equality of every integer.
"""

import numpy as np
import pytest
import torch

from repro.core.events import EventStream as RefStream
from repro.service import SessionConfig as RefConfig
from repro.service.session import MiningSession as RefSession
from repro_torch.core import EventStream
from repro_torch.kernels import tally
from repro_torch.service import (AdmissionError, BackpressureError,
                                 MiningService, SchedulerPolicy,
                                 SessionConfig)
from repro_torch.service.session import MiningSession

# The plain versions step small tensors, one event at a time: intra-op
# threads only contend with the other test processes.
torch.set_num_threads(1)

CPU = "cpu"
NUM_TYPES = 5


def tie_heavy(seed, n=240):
    rng = np.random.default_rng(seed)
    times = (np.cumsum(rng.choice([0, 0, 1, 2], size=n)) + 1).astype(np.int32)
    types = rng.integers(0, NUM_TYPES, size=n).astype(np.int32)
    return types, times


def split(types, times, k, stream=EventStream):
    n = types.size
    cuts = [n * j // k for j in range(k + 1)]
    return [stream(types[a:b], times[a:b], NUM_TYPES)
            for a, b in zip(cuts[:-1], cuts[1:])]


def assert_results_equal(a, b, msg=""):
    assert len(a.frequent) == len(b.frequent), msg
    for fa, fb, ca, cb in zip(a.frequent, b.frequent, a.counts, b.counts):
        np.testing.assert_array_equal(fa.etypes, fb.etypes, err_msg=msg)
        np.testing.assert_array_equal(fa.tlo, fb.tlo, err_msg=msg)
        np.testing.assert_array_equal(fa.thi, fb.thi, err_msg=msg)
        np.testing.assert_array_equal(ca, cb, err_msg=msg)


def cfg_kw(**kw):
    return dict(dict(intervals=((0, 4),), theta=3, max_level=3,
                     history_limit=4), **kw)


def feed(svc, sid, wins):
    for j, w in enumerate(wins):
        svc.ingest(sid, w, final=j == len(wins) - 1)


def check_standalone(svc, sid, cfg, wins, msg):
    deltas = svc.poll(sid)
    assert len(deltas) == len(wins), msg
    standalone = cfg.make_miner(device=CPU)
    for j, (d, w) in enumerate(zip(deltas, wins)):
        ref = standalone.update(w, final=j == len(wins) - 1)
        assert_results_equal(d.result, ref, f"{msg} window {j}")
    return deltas


# ---------------------------------------------------------------- fusion


@pytest.fixture
def ref_kernel_probe(monkeypatch):
    """Pin the reference's segmented-kernel probe on, so that its ``hybrid``
    resolves as one device with the kernel does (the port's rule); its
    counting then runs on its XLA scans, with the same counts."""
    import repro.core.hybrid as ref_hybrid
    monkeypatch.setattr(ref_hybrid, "_mapc_kernel_available", lambda: True)


def test_batcher_fuses_same_shape_sessions():
    """Same-key tenants share one fused (K6) launch: the batcher's fused
    requests and the K6 plain versions' lane tallies agree."""
    svc = MiningService(device=CPU)
    tenants = []
    for i in range(4):
        cfg = SessionConfig(**cfg_kw())
        sid = svc.create_session(f"t{i}", cfg)
        wins = split(*tie_heavy(i, n=200), 3)
        feed(svc, sid, wins)
        tenants.append((sid, cfg, wins))
    tally.reset_counts()
    svc.pump()
    b = svc.batcher
    assert b.batches > 0
    assert b.fused_requests >= 2 * b.batches
    fused = ("a2_state_vmapped", "a1_state_vmapped", "a1_mapc_vmapped")
    plain, lanes = tally.plain_counts(), tally.plain_lane_counts()
    assert sum(plain.get(k, 0) for k in fused) == b.batches
    assert sum(lanes.values()) == b.fused_requests
    assert sum(b.lanes_per_launch.values()) == b.batches
    assert svc.stats()["kernel"]["plain_lanes"] == lanes
    for sid, cfg, wins in tenants:
        check_standalone(svc, sid, cfg, wins, sid)


@pytest.mark.parametrize("engine", ["ptpe", "mapconcatenate"])
def test_heterogeneous_window_tenants_fuse_and_stay_exact(engine):
    """Tenants whose windows differ fourfold in event count (and whose
    batches differ in M) fuse into shared K6 launches and stay
    bit-identical to standalone miners."""
    svc = MiningService(device=CPU)
    tenants = []
    for i, n in enumerate((180, 700, 260)):
        cfg = SessionConfig(**cfg_kw(engine=engine))
        sid = svc.create_session(f"t{i}", cfg)
        wins = split(*tie_heavy(i, n=n), 3)
        feed(svc, sid, wins)
        tenants.append((sid, cfg, wins))
    svc.pump()
    assert svc.batcher.batches > 0, "heterogeneous tenants no longer fuse"
    assert svc.batcher.fused_requests >= 2 * svc.batcher.batches
    for sid, cfg, wins in tenants:
        check_standalone(svc, sid, cfg, wins, f"{engine} {sid}")


def test_oversized_group_splits_and_stays_exact():
    """The event-length guardrail cuts a group whose lanes' event buffers
    spread beyond ``MAX_PAD_RATIO``; each side still fuses or runs alone,
    and every tenant stays exact."""
    svc = MiningService(policy=SchedulerPolicy(max_concurrent_lanes=8),
                        device=CPU)
    tenants = []
    for i, n in enumerate((120, 130, 125, 2400)):
        cfg = SessionConfig(**cfg_kw(engine="ptpe", max_level=2))
        sid = svc.create_session(f"mix-{i}", cfg)
        wins = split(*tie_heavy(i, n=n), 3)
        feed(svc, sid, wins)
        tenants.append((sid, cfg, wins))
    svc.pump()
    assert svc.batcher.split_groups > 0
    assert svc.batcher.batches > 0
    for sid, cfg, wins in tenants:
        check_standalone(svc, sid, cfg, wins, sid)


# ---------------------------------------------- admission / backpressure


def test_admission_control_and_backpressure():
    svc = MiningService(policy=SchedulerPolicy(max_sessions=2,
                                               max_pending_windows=2),
                        device=CPU)
    cfg = SessionConfig(intervals=((0, 4),), theta=3)
    svc.create_session("a", cfg)
    svc.create_session("b", cfg)
    with pytest.raises(AdmissionError, match="capacity"):
        svc.create_session("c", cfg)
    with pytest.raises(AdmissionError, match="already"):
        svc.create_session("a", cfg)
    wins = split(*tie_heavy(0, n=120), 3)
    svc.ingest("a", wins[0])
    svc.ingest("a", wins[1])
    with pytest.raises(BackpressureError, match="depth"):
        svc.ingest("a", wins[2])
    svc.pump()
    svc.ingest("a", wins[2], final=True)  # queue drained → accepted again
    svc.pump()
    assert len(svc.poll("a")) == 3
    assert svc.stats()["scheduler"]["backpressure"] >= 1
    svc.close_session("b")  # closing a tenant frees its admission slot
    svc.create_session("c", cfg)


def test_round_robin_fairness():
    """A firehose tenant must not starve a trickle tenant."""
    svc = MiningService(policy=SchedulerPolicy(max_pending_windows=16,
                                               max_batch_sessions=2),
                        device=CPU)
    cfg = SessionConfig(intervals=((0, 4),), theta=3, max_level=2)
    svc.create_session("fire", cfg)
    svc.create_session("drip", cfg)
    for w in split(*tie_heavy(0, n=400), 8):
        svc.ingest("fire", w)
    for w in split(*tie_heavy(1, n=100), 2):
        svc.ingest("drip", w)
    svc.scheduler.step()
    assert svc.session("fire").windows_done == 1
    assert svc.session("drip").windows_done == 1
    svc.pump()
    assert svc.session("drip").windows_done == 2
    assert svc.session("fire").windows_done == 8


def test_policy_table_raises(tmp_path):
    """The service installs the table its policy names when it was fitted
    on the service's device, and says so in ``stats()["calibration"]``;
    one fitted on another device degrades to the heuristic. (The name is
    from before the calibration slice, when a table raised.)"""
    from repro_torch.core import calibrate

    table = calibrate.CalibrationTable(
        device_kind="cpu:plain", hw={"hbm_bw": 1e10, "ici_bw": 1e10},
        coeffs={"ptpe": [1e-3, 0, 0, 0, 0, 0]}, grid=[{"n_events": 64}],
        segment_counts=[1])
    try:
        for kind, source in (("cpu:plain", "calibrated"),
                             ("cuda:NVIDIA H100 80GB HBM3x1/shards1",
                              "heuristic")):
            table.device_kind = kind
            path = table.save(str(tmp_path / f"{source}.json"))
            svc = MiningService(policy=SchedulerPolicy(policy_table=path),
                                device=CPU)
            cal = svc.stats()["calibration"]
            assert cal["source"] == source
            assert cal["table_path"] == path
            assert calibrate.get_policy().source == source
    finally:
        calibrate.clear_policy()


# ------------------------------------------------------- watchdog retry


def test_watchdog_retry_double_buffered_no_double_count():
    """A failure mid-run, while the next step's windows are already
    staged: the retry rewinds every lane to its snapshot, nothing is
    counted twice (meter rows, windows), and every tenant equals its
    standalone miner; a lone tenant failing twice recovers too."""
    cfg = SessionConfig(**cfg_kw())
    svc = MiningService(policy=SchedulerPolicy(max_sessions=3), device=CPU)
    streams = [tie_heavy(30 + i, n=220) for i in range(3)]
    sids = []
    for i, (types, times) in enumerate(streams):
        sid = svc.create_session(f"dbuf-{i}", cfg)
        feed(svc, sid, split(types, times, 4))
        sids.append(sid)
    flaky = svc.session(sids[1])
    real_update = flaky.miner.update
    state = {"calls": 0, "failed": False}

    def flaky_update(window, final=False):
        state["calls"] += 1
        if state["calls"] == 3 and not state["failed"]:
            state["failed"] = True
            raise RuntimeError("transient mid-run failure")
        return real_update(window, final=final)

    flaky.miner.update = flaky_update
    svc.pump()
    assert svc.scheduler.watchdog.retries == 1
    for (types, times), sid in zip(streams, sids):
        s = svc.session(sid)
        assert s.windows_done == 4 and s.staged_count == 0
        assert len(s.meter.rows) == s.windows_done
        deltas = check_standalone(svc, sid, cfg, split(types, times, 4), sid)
        assert [d.window_idx for d in deltas] == [0, 1, 2, 3]


# ------------------------------------------------ checkpoint, both ways


@pytest.mark.parametrize("direction", ["port_to_ref", "ref_to_port"])
def test_session_checkpoint_crosses_packages(ref_kernel_probe, tmp_path,
                                             direction):
    """A session saved mid-stream by one package (bounded history, so its
    counters carry base, suffix and escrow leaves) restores cold into the
    other, which then finishes the stream bit-identically to an
    uninterrupted run."""
    kw = cfg_kw(history_limit=3, lcap=1)
    types, times = tie_heavy(4, n=300)
    cut, k = 4, 8
    oracle = MiningSession("s", SessionConfig(**kw), device=CPU)
    for j, w in enumerate(split(types, times, k)):
        oracle.enqueue(w, final=j == k - 1)
    while oracle.pending:
        oracle.step()
    want = oracle.poll()

    if direction == "port_to_ref":
        first = MiningSession("s", SessionConfig(**kw), device=CPU)
        resumed = RefSession("s", RefConfig(**kw))
        first_wins, rest = split(types, times, k), split(types, times, k,
                                                         RefStream)
    else:
        first = RefSession("s", RefConfig(**kw))
        resumed = MiningSession("s", SessionConfig(**kw), device=CPU)
        first_wins, rest = (split(types, times, k, RefStream),
                            split(types, times, k))
    for w in first_wins[:cut]:
        first.enqueue(w)
        first.step()
    first.save(tmp_path)
    resumed.restore(tmp_path)
    assert resumed.windows_done == cut
    for j, w in enumerate(rest[cut:]):
        resumed.enqueue(w, final=cut + j == k - 1)
        resumed.step()
    got = resumed.poll()
    assert len(got) == k
    for d, r in zip(got, want):
        assert d.window_idx == r.window_idx
        assert_results_equal(d.result, r.result,
                             f"{direction} window {d.window_idx}")


def test_checkpoint_rejects_config_mismatch(tmp_path):
    s = MiningSession("s", SessionConfig(intervals=((0, 4),), theta=3),
                      device=CPU)
    s.enqueue(split(*tie_heavy(0, n=60), 1)[0])
    s.step()
    s.save(tmp_path)
    other = MiningSession("s", SessionConfig(intervals=((0, 4),), theta=99),
                          device=CPU)
    with pytest.raises(ValueError, match="hash"):
        other.restore(tmp_path)
