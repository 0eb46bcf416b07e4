"""The port's mining daemon on the CPU (``--device cpu``): the pidfile,
heartbeat and SIGTERM lifecycle, a stale pidfile after SIGKILL, SIGTERM
mid-stream committing the staged windows, and a daemon data directory
(``SESSIONS.json``, each session's newest checkpoint, ``wire/last_seq``)
crossing packages both ways: written by a port daemon and cold-booted by
the reference's ``WireServer``, and the reverse. The windows still to
come then give the deltas of an uninterrupted standalone port session.
Tolerance: exact equality of every integer.

Daemons are real subprocesses over Unix sockets (in-process threads
cannot be SIGKILLed honestly), their output in a file. SIGKILL, restart
and resume for every engine × two-pass is tests/test_torch_daemon_crash.py.
"""

import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core.hybrid as ref_hybrid
from repro.checkpoint import ckpt as ref_ckpt
from repro.core.events import EventStream as RefStream
from repro.service import MiningService as RefService
from repro.service import SessionConfig as RefConfig
from repro.service import client as ref_client
from repro.service import wire as ref_wire
from repro_torch.checkpoint import ckpt
from repro_torch.core import EventStream
from repro_torch.service import (MiningClient, MiningDaemon, MiningSession,
                                 SessionConfig)
from repro_torch.service.wire import delta_payload

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (the repository root's smoke script)

# The plain versions step small tensors, one event at a time: intra-op
# threads only contend with the other test processes.
torch.set_num_threads(1)

NUM_TYPES = 5
SRC = str(Path(__file__).resolve().parents[1] / "src")
# a Unix socket's path holds at most 107 bytes
MAX_SOCKET_PATH = 107


def tie_heavy(seed, n=240, stream=EventStream):
    rng = np.random.default_rng(seed)
    gaps = rng.choice([0, 0, 1, 2], size=n)
    times = (np.cumsum(gaps) + 1).astype(np.int32)
    types = rng.integers(0, NUM_TYPES, size=n).astype(np.int32)
    return stream(types, times, NUM_TYPES)


def split_by_index(stream, k, cls=EventStream):
    n = stream.types.shape[0]
    cuts = [0] + [n * j // k for j in range(1, k)] + [n]
    return [cls(stream.types[a:b], stream.times[a:b], stream.num_types)
            for a, b in zip(cuts[:-1], cuts[1:])]


def local_reference(cfg, wins):
    """A standalone port session's wire-form deltas over ``wins``."""
    s = MiningSession("ref", cfg, device="cpu")
    for j, w in enumerate(wins):
        s.enqueue(w, final=(j == len(wins) - 1))
    while s.queue_depth:
        p = s.prepare()
        s.commit(p, s.execute(p))
    return [delta_payload(d) for d in s.poll()]


@pytest.fixture(autouse=True)
def one_thread_daemons(monkeypatch):
    """The daemons inherit one intra-op thread, as this process has: the
    plain versions step small tensors, and more threads only contend with
    the other test processes."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


@pytest.fixture
def sock_dir(tmp_path):
    """A directory for the daemon's socket: ``tmp_path`` when its path is
    short enough, else a short ``mkdtemp`` directory, removed afterwards."""
    if len(str(tmp_path / "d.sock")) < MAX_SOCKET_PATH - 8:
        yield tmp_path
        return
    d = Path(tempfile.mkdtemp(prefix="fem"))
    try:
        yield d
    finally:
        shutil.rmtree(d, ignore_errors=True)


def spawn_daemon(tmp_path, sock_dir, crash_after=None):
    """Foreground port daemon subprocess on the CPU (``chip_smoke``'s
    ``start_daemon``, as path G starts one on the card), on a Unix socket
    in ``sock_dir``, its output appended to ``tmp_path/daemon.out``;
    returns (Popen, address) once the pidfile reports the bound socket."""
    proc, _ = chip_smoke.start_daemon(tmp_path / "data", sock_dir / "d.sock",
                                      tmp_path / "daemon.out",
                                      crash_after=crash_after, device="cpu")
    return proc, f"unix:{sock_dir / 'd.sock'}"


def stop_daemon(proc):
    if proc.poll() is None:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=90)
        except subprocess.TimeoutExpired:
            proc.kill()
            raise


# ----------------------------------------------------------- lifecycle


def test_daemon_lifecycle_pidfile_heartbeat_sigterm(tmp_path, sock_dir):
    proc, addr = spawn_daemon(tmp_path, sock_dir)
    pidfile = tmp_path / "data" / "daemon.pid"
    try:
        doc = MiningDaemon.status(pidfile)
        assert doc is not None and doc["pid"] == proc.pid
        assert doc["address"] == addr
        assert doc["data_dir"] == str(tmp_path / "data")

        cfg = SessionConfig(intervals=((0, 4),), theta=3, max_level=3)
        c = MiningClient(addr, "hb", cfg, rng_seed=0)
        pong = c.ping()
        assert pong["op"] == "ping" and not pong["draining"]
        c.open()
        c.submit(tie_heavy(0, n=40))
        stats = c.stats()
        # the heartbeat thread feeds the gauges the runbook monitors
        assert stats["daemon"]["heartbeat_ts"] > 0
        assert stats["daemon"]["uptime_s"] >= 0
        assert time.time() - stats["daemon"]["heartbeat_ts"] < 30
        assert stats["recovery"]["cold_boots"] == 0
        # the sessions manifest is written atomically at open
        manifest = json.loads((tmp_path / "data" / "SESSIONS.json")
                              .read_text())
        assert manifest["sessions"]["hb"]["theta"] == 3
        c.close()

        # graceful stop via the pidfile (SIGTERM + wait)
        assert MiningDaemon.stop(pidfile, timeout_s=90)
        proc.wait(timeout=30)
        assert proc.returncode == 0
        assert MiningDaemon.status(pidfile) is None
        assert not pidfile.exists()
        log = (tmp_path / "daemon.out").read_text()
        assert "device cpu" in log and "[daemon] stopped." in log
        assert ckpt.latest_step(tmp_path / "data" / "hb") is not None
    finally:
        if proc.poll() is None:
            proc.kill()


def test_pidfile_written_once_ready(tmp_path, sock_dir, monkeypatch):
    """The pidfile is the daemon's readiness signal: whoever reads it may
    SIGTERM the daemon or read its gauges at once, so when it is written
    the SIGTERM handler is installed and the first heartbeat is set;
    otherwise a daemon preempted between binding its socket and those
    steps dies of the signal's default action, or reports a heartbeat of
    0. Run in this process, its signal handlers recorded rather than
    installed."""
    from repro_torch.obs import REGISTRY
    from repro_torch.service.daemon import DaemonConfig

    installed = {}
    monkeypatch.setattr(signal, "signal",
                        lambda sig, handler: installed.setdefault(sig, handler))
    REGISTRY.gauge("daemon_heartbeat_ts").set(0.0)
    d = MiningDaemon(DaemonConfig(address=f"unix:{sock_dir / 'r.sock'}",
                                  data_dir=str(tmp_path / "data"),
                                  device="cpu"))
    seen = {}
    write = d._write_pidfile

    def write_then_stop():
        seen["sigterm"] = signal.SIGTERM in installed
        seen["heartbeat_ts"] = REGISTRY.gauge("daemon_heartbeat_ts").value
        write()
        seen["pidfile"] = MiningDaemon.read_pidfile(
            tmp_path / "data" / "daemon.pid")
        d.server._stop.set()  # then drain and return

    monkeypatch.setattr(d, "_write_pidfile", write_then_stop)
    d.run()
    assert seen["sigterm"] and seen["heartbeat_ts"] > 0
    assert seen["pidfile"]["address"] == f"unix:{sock_dir / 'r.sock'}"
    assert not (tmp_path / "data" / "daemon.pid").exists()


def test_stale_pidfile_detected_after_sigkill(tmp_path, sock_dir):
    proc, _ = spawn_daemon(tmp_path, sock_dir)
    pidfile = tmp_path / "data" / "daemon.pid"
    proc.kill()  # SIGKILL: no cleanup, pidfile left behind
    proc.wait(timeout=30)
    assert pidfile.exists()
    deadline = time.monotonic() + 10
    while MiningDaemon.status(pidfile) is not None \
            and time.monotonic() < deadline:
        time.sleep(0.05)
    assert MiningDaemon.status(pidfile) is None  # stale: cleaned up
    assert not pidfile.exists()
    assert MiningDaemon.stop(pidfile)  # nothing to stop


def test_sigterm_midstream_commits_staged_windows(tmp_path, sock_dir):
    """SIGTERM lands while submitted windows are still queued or staged
    (``pipeline_depth=2``, the daemon's default). The drain quiesces the
    staged preps and mines and checkpoints everything queued; after a cold
    restart every window is present exactly once, equal to an
    uninterrupted standalone session."""
    cfg = SessionConfig(intervals=((0, 4),), theta=3, max_level=3,
                        history_limit=4)
    wins = split_by_index(tie_heavy(11, n=220), 5)

    proc, addr = spawn_daemon(tmp_path, sock_dir)
    c = MiningClient(addr, "term", cfg, rng_seed=3, deadline_s=180.0)
    for j, w in enumerate(wins):
        c.submit(w, final=(j == len(wins) - 1))
    proc.send_signal(signal.SIGTERM)  # most windows still pending/staged
    proc.wait(timeout=120)
    assert proc.returncode == 0
    c.close()

    proc2, addr2 = spawn_daemon(tmp_path, sock_dir)
    try:
        c2 = MiningClient(addr2, "term", cfg, rng_seed=4, deadline_s=180.0)
        c2.next_seq = c.next_seq  # same producer, resumed
        got = sorted(c2.drain(deadline_s=180), key=lambda d: d["window_idx"])
        assert got == local_reference(cfg, wins), \
            "SIGTERM dropped or duplicated a staged window"
        stats = c2.stats()
        assert stats["recovery"]["cold_boots"] >= 1
        assert stats["recovery"]["sessions_restored"] >= 1
        c2.close()
    finally:
        stop_daemon(proc2)


# ------------------------------------------- data directory, both ways


@pytest.fixture
def ref_kernel_probe(monkeypatch):
    """Pin the reference's segmented-kernel probe on, so that its ``hybrid``
    resolves as the port's does: a ``hybrid`` session's checkpoint then
    crosses the packages."""
    monkeypatch.setattr(ref_hybrid, "_mapc_kernel_available", lambda: True)


def wake_accept(srv):
    """Shut the reference server's listener down before its ``shutdown``
    closes it: a close alone does not wake its accept thread on Linux, and
    the join would wait out its timeout."""
    try:
        srv._listener.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass


CROSS_KW = dict(intervals=((0, 4),), theta=3, max_level=2, history_limit=4)


def finish_on(client_cls, addr, cfg, wins, first, next_seq):
    """Submit ``wins[first:]`` after a restart (the producer resumed at
    ``next_seq``), then drain every window's delta."""
    c = client_cls(addr, "cross", cfg, rng_seed=5, deadline_s=180.0)
    c.next_seq = next_seq
    for j in range(first, len(wins)):
        c.submit(wins[j], final=(j == len(wins) - 1))
    got = sorted(c.drain(deadline_s=180), key=lambda d: d["window_idx"])
    stats = c.stats()
    c.close()
    return got, stats


def test_data_dir_port_daemon_to_reference_server(tmp_path, sock_dir,
                                                  ref_kernel_probe):
    """A port daemon takes the first 3 of 5 windows and is SIGTERMed; the
    reference's ``WireServer`` cold-boots from its data directory (the
    manifest, the checkpoints, ``wire/last_seq``), takes the last 2 from a
    reference client and delivers all 5 deltas, equal to a standalone port
    session."""
    kw = dict(CROSS_KW, engine="hybrid")
    wins = split_by_index(tie_heavy(21, n=200), 5)
    proc, addr = spawn_daemon(tmp_path, sock_dir)
    c = MiningClient(addr, "cross", SessionConfig(**kw), rng_seed=0,
                     deadline_s=180.0)
    for w in wins[:3]:
        c.submit(w)
    stop_daemon(proc)
    assert proc.returncode == 0
    c.close()
    data = tmp_path / "data"
    step = ckpt.latest_step(data / "cross")
    assert int(ref_ckpt.read_leaf(data / "cross", "wire/last_seq",
                                  step=step)) == 3

    srv = ref_wire.WireServer(RefService(), "127.0.0.1:0", data_dir=data)
    assert srv.start()
    try:
        assert srv.sessions["cross"].applied == 3
        assert srv.sessions["cross"].config == RefConfig(**kw)
        ref_wins = split_by_index(tie_heavy(21, n=200, stream=RefStream), 5,
                                  RefStream)
        got, stats = finish_on(ref_client.MiningClient, srv.address,
                               RefConfig(**kw), ref_wins, 3, 4)
    finally:
        wake_accept(srv)
        srv.shutdown(drain=False)
    assert srv.unexpected == []
    assert stats["recovery"]["sessions_restored"] >= 1
    assert got == local_reference(SessionConfig(**kw), wins)


def test_data_dir_reference_server_to_port_daemon(tmp_path, sock_dir,
                                                  ref_kernel_probe):
    """The reverse: the reference's ``WireServer`` takes the first 3 of 5
    windows and shuts down with a drain; a port daemon cold-boots from its
    data directory, takes the last 2 from a port client and delivers all
    5 deltas, equal to a standalone port session."""
    kw = dict(CROSS_KW, engine="hybrid")
    data = tmp_path / "data"
    srv = ref_wire.WireServer(RefService(), "127.0.0.1:0", data_dir=data)
    srv.start()
    try:
        ref_wins = split_by_index(tie_heavy(23, n=200, stream=RefStream), 5,
                                  RefStream)
        c = ref_client.MiningClient(srv.address, "cross", RefConfig(**kw),
                                    rng_seed=0, deadline_s=180.0)
        for w in ref_wins[:3]:
            c.submit(w)
        c.close()
    finally:
        wake_accept(srv)
        srv.shutdown(drain=True)
    assert srv.unexpected == []
    assert int(ckpt.read_leaf(data / "cross", "wire/last_seq")) == 3

    wins = split_by_index(tie_heavy(23, n=200), 5)
    proc, addr = spawn_daemon(tmp_path, sock_dir)
    try:
        got, stats = finish_on(MiningClient, addr, SessionConfig(**kw),
                               wins, 3, 4)
        assert stats["recovery"]["cold_boots"] == 1
        assert stats["recovery"]["sessions_restored"] == 1
    finally:
        stop_daemon(proc)
    assert proc.returncode == 0
    assert got == local_reference(SessionConfig(**kw), wins)


# ------------------------------------------------------------ the CLI


def test_mine_serve_detached_daemon_and_wire_load_on_cpu(tmp_path, sock_dir,
                                                        capsys):
    """``mine_serve --listen --daemon`` double-forks a port daemon (exec'd
    fresh), ``--daemon-status`` finds it, ``wire_load --verify`` drives it
    and re-mines locally on the CPU, and ``--daemon-stop`` drains it. The
    launcher that detaches runs in its own process (it forks); the status
    and stop calls run here."""
    from repro_torch.launch import mine_serve, wire_load

    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + (os.pathsep + env["PYTHONPATH"]
                               if env.get("PYTHONPATH") else "")
    data = tmp_path / "data"
    addr = f"unix:{sock_dir / 'd.sock'}"
    started = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.mine_serve", "--listen",
         addr, "--daemon", "--data-dir", str(data), "--device", "cpu"],
        env=env, capture_output=True, text=True, timeout=180)
    assert started.returncode == 0, started.stderr
    doc = MiningDaemon.read_pidfile(data / "daemon.pid")
    try:
        assert f"daemon pid {doc['pid']} on {addr}" in started.stdout
        assert mine_serve.main(["--daemon-status", "--data-dir",
                                str(data)]) == 0
        assert str(doc["pid"]) in capsys.readouterr().out
        assert wire_load.main(["--connect", addr, "--sessions", "2",
                               "--seconds", "2", "--max-level", "2",
                               "--verify", "--device", "cpu",
                               "--producers", "2"]) == 0
        assert mine_serve.main(["--daemon-stop", "--data-dir",
                                str(data)]) == 0
        assert "[serve] daemon stopped." in capsys.readouterr().out
        assert mine_serve.main(["--daemon-status", "--data-dir",
                                str(data)]) == 1
        log = (data / "daemon.log").read_text()
        assert "device cpu" in log and "[daemon] stopped." in log
    finally:
        if MiningDaemon.status(data / "daemon.pid") is not None:
            os.kill(doc["pid"], signal.SIGKILL)


def test_mine_serve_help_names_the_daemon_flags(capsys):
    """``mine_serve``'s help names the daemon flags and the calibration
    and profiling flags (``--calibrate``, ``--policy-table``,
    ``--profile-dir``), and not the reference's ``--no-kernel`` (the port
    always launches a kernel); the daemon's own CLI takes
    ``--policy-table``."""
    from repro_torch.launch import mine_serve
    from repro_torch.service import daemon

    with pytest.raises(SystemExit):
        mine_serve.main(["--help"])
    out = capsys.readouterr().out
    for flag in ("--listen", "--daemon", "--daemon-status", "--daemon-stop",
                 "--data-dir", "--checkpoint-every", "--device",
                 "--calibrate", "--policy-table", "--profile-dir"):
        assert flag in out, flag
    assert "--no-kernel" not in out
    with pytest.raises(SystemExit):
        daemon.main(["--help"])
    assert "--policy-table" in capsys.readouterr().out
