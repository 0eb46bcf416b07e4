"""SIGKILL, restart and resume of the port's mining daemon on the CPU
(``--device cpu``), for every engine × two-pass: the daemon SIGKILLs
itself after a seeded number of window commits (after the commit, before
its checkpoint), a supervisor thread restarts it cold from its data
directory, and the client rides through the outage on its reconnect and
backoff path. The per-window deltas equal an uninterrupted standalone
port session's bit for bit. The kill points are the reference's
(tests/test_daemon.py) and fall on the same window boundaries, since
``kill_point`` draws alike in both packages.

The lifecycle, SIGTERM and cross-package data directories are
tests/test_torch_daemon.py (one file would outlast its share of a worker).
"""

import signal
import threading

import pytest
import torch

from repro_torch.runtime import kill_point
from repro_torch.service import MiningClient, SessionConfig
from test_torch_daemon import (local_reference,  # noqa: F401
                               one_thread_daemons, sock_dir, spawn_daemon,
                               split_by_index, tie_heavy)

torch.set_num_threads(1)

# the reference's per-combination seeds (fixed: the kill point must be
# deterministic run to run)
_CRASH_SEEDS = {("hybrid", False): 101, ("hybrid", True): 102,
                ("ptpe", False): 103, ("ptpe", True): 104,
                ("mapconcatenate", False): 105,
                ("mapconcatenate", True): 106}


@pytest.mark.parametrize("engine", ["hybrid", "ptpe", "mapconcatenate"])
@pytest.mark.parametrize("two_pass", [False, True])
def test_sigkill_restart_resume_bit_identical(tmp_path, sock_dir, engine,
                                              two_pass):
    seed = _CRASH_SEEDS[(engine, two_pass)]
    cfg = SessionConfig(intervals=((0, 4),), theta=3, max_level=3,
                        engine=engine, two_pass=two_pass, history_limit=4)
    wins = split_by_index(tie_heavy(17, n=200), 5)
    crash_at = kill_point(seed, 1, len(wins))  # a real window boundary

    proc, addr = spawn_daemon(tmp_path, sock_dir, crash_after=crash_at)
    procs = [proc]
    crashed = threading.Event()

    def supervise():
        proc.wait()
        if proc.returncode == -signal.SIGKILL:
            crashed.set()
            procs.append(spawn_daemon(tmp_path, sock_dir)[0])  # restart

    sup = threading.Thread(target=supervise, daemon=True)
    sup.start()
    c = MiningClient(addr, "kill", cfg, rng_seed=seed, deadline_s=240.0)
    try:
        for j, w in enumerate(wins):
            c.submit(w, final=(j == len(wins) - 1))
        got = sorted(c.drain(deadline_s=240), key=lambda d: d["window_idx"])
        sup.join(timeout=240)
        assert not sup.is_alive()
        assert crashed.is_set(), \
            f"daemon was not SIGKILLed at commit {crash_at}"
        ref = local_reference(cfg, wins)
        assert len(got) == len(ref), \
            f"crash at commit {crash_at}: windows lost or duplicated"
        for r, g in zip(ref, got):
            assert r == g, f"window {r['window_idx']} diverged across SIGKILL"
        stats = c.stats()
        assert stats["recovery"]["cold_boots"] == 1
        assert stats["recovery"]["sessions_restored"] == 1
        assert stats["kernel"]["launches"] == {}  # the CPU: plain versions
        assert "internal" not in stats["wire"]["errors"]
        c.close_session()
    finally:
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
                p.wait(timeout=90)
    assert procs[-1].returncode == 0
