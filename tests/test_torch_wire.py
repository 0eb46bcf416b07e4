"""The port's wire transport against the reference's, on the CPU: frames
are byte-identical for every frame type; the payload codecs
(``encode_events``, ``config_to_wire``, ``delta_payload``) equal the
reference's; torn frames raise the same typed errors; ``parse_address``
and the fault injector decide alike; a session checkpoint's transport
leaf (``wire/last_seq``) reads the same in both packages; a checkpoint
quiesces the pipelined scheduler's staged preps first; and ``stats()``
arrives over the wire as numbers. Tolerance: exact equality of every
byte and integer.

Clients and servers of both packages talking to each other are
tests/test_torch_wire_cross.py; daemons are tests/test_torch_daemon*.py.
"""

import json
import shutil
import socket
import struct
import tempfile

import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as ref_ckpt
from repro.core.events import EventStream as RefStream
from repro.runtime import faultinject as ref_fi
from repro.service import MiningSession as RefSession
from repro.service import SessionConfig as RefConfig
from repro.service import wire as ref_wire
from repro_torch.checkpoint import ckpt
from repro_torch.core import EventStream
from repro_torch.obs import REGISTRY
from repro_torch.runtime import FaultInjector, FaultSpec, StepFailure, kill_point
from repro_torch.service import (MiningClient, MiningService, MiningSession,
                                 SchedulerPolicy, SessionConfig, WireServer,
                                 wire)

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


def small_kw(**kw):
    return dict(dict(intervals=((0, 4),), theta=3, max_level=3,
                     history_limit=4), **kw)


def local_deltas(cfg, wins):
    """A standalone port session's wire-form deltas over ``wins``."""
    s = MiningSession("ref", cfg, device=CPU)
    for j, w in enumerate(wins):
        s.enqueue(w, final=(j == len(wins) - 1))
    while s.queue_depth:
        p = s.prepare()
        s.commit(p, s.execute(p))
    return [wire.delta_payload(d) for d in s.poll()]


# --------------------------------------------------------------- framing


def test_header_constants_equal_reference():
    assert (wire.MAGIC, wire.PROTO_VERSION, wire.MAX_PAYLOAD) == (
        ref_wire.MAGIC, ref_wire.PROTO_VERSION, ref_wire.MAX_PAYLOAD)
    assert wire.HEADER.format == ref_wire.HEADER.format
    assert wire.HEADER.size == 24
    assert ({m.name: int(m) for m in wire.FrameType}
            == {m.name: int(m) for m in ref_wire.FrameType})
    assert ({m.name: int(m) for m in wire.Status}
            == {m.name: int(m) for m in ref_wire.Status})


@pytest.mark.parametrize("ftype", [m.name for m in wire.FrameType])
def test_encode_frame_bytes_equal_reference(ftype):
    """Every frame type, with an empty, a JSON and a binary payload, a
    large seq and a flag: the port's bytes are the reference's, and each
    package reads the other's frame back."""
    types, times = tie_heavy(1, n=30)
    payloads = (b"", b'{"op": "ping"}',
                wire.encode_events("arr-0", EventStream(types, times,
                                                        NUM_TYPES)))
    for k, payload in enumerate(payloads):
        seq, flags = (1 << 40) + k, k
        port = wire.encode_frame(
            wire.Frame(wire.FrameType[ftype], seq, payload, flags))
        ref = ref_wire.encode_frame(
            ref_wire.Frame(ref_wire.FrameType[ftype], seq, payload, flags))
        assert port == ref
        for reader, raw in ((wire.read_frame, ref),
                            (ref_wire.read_frame, port)):
            a, b = socket.socketpair()
            try:
                a.sendall(raw)
                got = reader(b)
            finally:
                a.close()
                b.close()
            assert (got.ftype, got.seq, got.payload, got.flags) == (
                int(wire.FrameType[ftype]), seq, payload, flags)


def test_payload_codecs_equal_reference():
    """``encode_events`` bytes, ``decode_events`` both ways,
    ``config_to_wire`` (and its JSON) and ``config_from_wire`` equal the
    reference's; so does ``delta_payload`` of the same windows mined by a
    port and a reference session."""
    types, times = tie_heavy(2, n=120)
    for final in (False, True):
        port = wire.encode_events("s-1", EventStream(types, times,
                                                     NUM_TYPES), final)
        ref = ref_wire.encode_events("s-1", RefStream(types, times,
                                                      NUM_TYPES), final)
        assert port == ref
        sid, stream, fin = wire.decode_events(ref)
        assert (sid, fin, stream.num_types) == ("s-1", final, NUM_TYPES)
        np.testing.assert_array_equal(stream.types, types)
        np.testing.assert_array_equal(stream.times, times)
    for kw in (small_kw(), small_kw(engine="ptpe", two_pass=False,
                                    history_limit=None, lcap=8),
               dict(intervals=((1, 5), (5, 10)), theta_mode="cumulative")):
        port = wire.config_to_wire(SessionConfig(**kw))
        ref = ref_wire.config_to_wire(RefConfig(**kw))
        assert port == ref
        assert wire._j(port) == ref_wire._j(ref)
        back = wire.config_from_wire(json.loads(ref_wire._j(ref)))
        assert back == SessionConfig(**kw)
        assert ckpt.config_fingerprint(back) == ref_ckpt.config_fingerprint(
            ref_wire.config_from_wire(json.loads(wire._j(port))))
    with pytest.raises(wire.ProtocolError):
        wire.config_from_wire({"bogus": 1})

    kw = small_kw(engine="ptpe")
    wins = split(types, times, 3)
    ref_s = RefSession("r", RefConfig(**kw))
    for j, w in enumerate(split(types, times, 3, RefStream)):
        ref_s.enqueue(w, final=j == 2)
    while ref_s.queue_depth:
        p = ref_s.prepare()
        ref_s.commit(p, ref_s.execute(p))
    want = [ref_wire.delta_payload(d) for d in ref_s.poll()]
    assert local_deltas(SessionConfig(**kw), wins) == want
    assert wire._j(want) == ref_wire._j(want)


def _torn(mutate, module):
    raw = bytearray(module.encode_frame(
        module.Frame(module.FrameType.POLL, 7, b'{"a": 1}')))
    if mutate == "magic":
        raw[0] ^= 0xFF
    elif mutate == "version":
        raw[4] = 99
    elif mutate == "crc":
        raw[-1] ^= 0xFF  # flip a payload byte: CRC no longer matches
    elif mutate == "length":
        struct.pack_into("!I", raw, 16, module.MAX_PAYLOAD + 1)
    elif mutate == "eof":
        raw = raw[:10]  # torn mid-header, then the peer closes
    a, b = socket.socketpair()
    a.sendall(bytes(raw))
    a.close()
    try:
        module.read_frame(b)
    except Exception as e:  # noqa: BLE001 — the error is what is compared
        return type(e).__name__, getattr(e, "code", None), getattr(
            e, "fatal", None)
    finally:
        b.close()
    return None


@pytest.mark.parametrize("mutate", ["magic", "version", "crc", "length",
                                    "eof"])
def test_torn_frames_raise_same_typed_errors(mutate):
    port, ref = _torn(mutate, wire), _torn(mutate, ref_wire)
    assert port is not None
    name, code, fatal = port
    assert (name, None if code is None else int(code), fatal) == (
        ref[0], None if ref[1] is None else int(ref[1]), ref[2])
    want = {"magic": "BAD_FRAME", "version": "BAD_VERSION",
            "crc": "BAD_CRC", "length": "BAD_FRAME", "eof": None}[mutate]
    assert (code.name if code is not None else None) == want


@pytest.mark.parametrize("address", [
    "0.0.0.0:88", "unix:/tmp/x.sock", ("h", 5), ["h", "6"], "::1:9",
    "localhost:0", "nonsense", "host:", ":80", "unix:"])
def test_parse_address_equal_reference(address):
    def run(fn):
        try:
            return fn(address)
        except ValueError:
            return "ValueError"
    assert run(wire.parse_address) == run(ref_wire.parse_address)


def test_fault_injector_and_kill_points_equal_reference():
    frames = [bytes([i % 256]) * (10 + 3 * i) for i in range(200)]
    for spec in (dict(seed=42, drop=0.2, duplicate=0.2, truncate=0.1),
                 dict(seed=7, drop=0.05, duplicate=0.05, truncate=0.02,
                      max_faults=12),
                 dict(seed=3, drop=0.15, duplicate=0.15, truncate=0.10)):
        port = FaultInjector(FaultSpec(**spec))
        ref = ref_fi.FaultInjector(ref_fi.FaultSpec(**spec))
        assert FaultSpec(**spec).active == ref_fi.FaultSpec(**spec).active
        assert [port.plan(f) for f in frames] == [ref.plan(f) for f in frames]
        assert port.injected == ref.injected and port.total_injected > 0
    assert not FaultSpec().active
    for seed in range(30):
        assert kill_point(seed, 1, 5) == ref_fi.kill_point(seed, 1, 5)
    assert kill_point(19, 4, 16) == ref_fi.kill_point(19, 4, 16)
    with pytest.raises(ValueError):
        kill_point(0, 3, 3)


def test_jsonify_turns_tensors_into_numbers():
    doc = wire._jsonify({"a": torch.tensor(3), "b": torch.arange(3),
                         "c": np.int64(4), "d": np.float32(0.5),
                         "e": (np.arange(2), torch.tensor([1.5])), 5: None})
    assert doc == {"a": 3, "b": [0, 1, 2], "c": 4, "d": 0.5,
                   "e": [[0, 1], [1.5]], "5": None}
    json.dumps(doc)


# ------------------------------------------------------------ durability


@pytest.fixture
def ref_kernel_probe(monkeypatch):
    """Pin the reference's segmented-kernel probe on, so that its ``hybrid``
    resolves as the port's does (one device with the kernel): a ``hybrid``
    checkpoint then restores across the packages."""
    import repro.core.hybrid as ref_hybrid
    monkeypatch.setattr(ref_hybrid, "_mapc_kernel_available", lambda: True)


def test_checkpoint_leaves_read_by_reference(tmp_path, ref_kernel_probe):
    """``MiningSession.save(extra=)`` writes ``wire/last_seq`` into the
    same atomic checkpoint; the reference's ``read_leaf`` reads it, the
    port's reads the reference's, and ``prune`` keeps the same newest
    checkpoints in both packages."""
    types, times = tie_heavy(4, n=160)
    cfg = SessionConfig(**small_kw())
    s = MiningSession("leaf", cfg, device=CPU)
    for j, w in enumerate(split(types, times, 4)):
        s.enqueue(w)
        p = s.prepare()
        s.commit(p, s.execute(p))
        s.save(tmp_path / "port", extra={
            "wire/last_seq": np.asarray(10 + j, np.int64)})
    root = tmp_path / "port" / "leaf"
    assert ref_ckpt.latest_step(root) == ckpt.latest_step(root) == 4
    for step in (None, 2):
        want = 13 if step is None else 11
        for read in (ckpt.read_leaf, ref_ckpt.read_leaf):
            leaf = read(root, "wire/last_seq", step=step)
            assert leaf.dtype == np.int64 and int(leaf) == want
    assert ckpt.read_leaf(root, "wire/nope", default=-1) == -1
    assert ckpt.read_leaf(tmp_path / "none", "wire/last_seq") is None
    (root / "step_00000009.tmp").mkdir()
    assert ckpt.prune(root, keep=2) == 3  # two old steps + the torn .tmp
    assert sorted(d.name for d in root.iterdir()) == [
        "step_00000003", "step_00000004"]
    assert ref_ckpt.prune(root, keep=2) == 0
    # the session state restores in the reference, extra leaf ignored
    ref = RefSession("leaf", RefConfig(**small_kw()))
    ref.restore(tmp_path / "port")
    assert ref.windows_done == 4


def test_checkpoint_quiesces_staged_preps(tmp_path):
    """With ``pipeline_depth=2`` the scheduler holds prepared-but-
    uncommitted windows that live in neither the pending queue nor the
    miner state. ``checkpoint_all`` returns them to the queue first, so a
    cold restore mines every window exactly once (the reference's
    tests/test_wire.py pattern)."""
    svc = MiningService(policy=SchedulerPolicy(pipeline_depth=2),
                        device=CPU)
    cfgs, feeds = {}, {}
    for i, seed in enumerate((0, 5)):
        cfg = SessionConfig(**small_kw())
        sid = svc.create_session(f"q{i}", cfg)
        wins = split(*tie_heavy(seed, n=200), 4)
        cfgs[sid], feeds[sid] = cfg, wins
        for j, w in enumerate(wins):
            svc.ingest(sid, w, final=(j == len(wins) - 1))
    svc.scheduler.step()  # leaves next step's preps staged
    assert svc.scheduler._staged, "pipelined step should stage preps"
    staged = dict(svc.scheduler._staged)
    before = REGISTRY.counter("scheduler_quiesced_preps_total").value
    ckpts = REGISTRY.counter("service_checkpoints_total").value
    paths = svc.checkpoint_all(tmp_path)
    assert sorted(paths) == sorted(cfgs)
    assert REGISTRY.counter(
        "scheduler_quiesced_preps_total").value - before == len(staged)
    assert REGISTRY.counter("service_checkpoints_total").value - ckpts == 2
    assert not svc.scheduler._staged and svc.scheduler._plan == []
    stats = svc.stats()
    assert stats["recovery"]["checkpoint_s"] > 0
    assert {"wire", "recovery", "daemon", "kernel"} <= set(stats)

    svc2 = MiningService(policy=SchedulerPolicy(pipeline_depth=2),
                         device=CPU)
    for sid, cfg in cfgs.items():
        svc2.create_session(sid, cfg)
        svc2.session(sid).restore(tmp_path)
    svc2.pump()
    for sid, wins in feeds.items():
        got = [wire.delta_payload(d) for d in svc2.poll(sid)]
        assert got == local_deltas(cfgs[sid], wins), sid


def test_retry_snapshots_off_surfaces_step_failure(monkeypatch):
    """``SchedulerPolicy.retry_snapshots=False`` takes no pre-step
    snapshot, so a failed step raises ``StepFailure`` at once instead of
    being retried; with it on, the step is retried from its snapshot."""
    for retry in (False, True):
        svc = MiningService(policy=SchedulerPolicy(
            retry_snapshots=retry, pipeline_depth=1), batching=False,
            device=CPU)
        sid = svc.create_session("r", SessionConfig(**small_kw()))
        wins = split(*tie_heavy(6, n=120), 2)
        for j, w in enumerate(wins):
            svc.ingest(sid, w, final=j == 1)
        s = svc.session(sid)
        calls = {"n": 0}
        execute = s.execute

        def flaky(prep):
            calls["n"] += 1
            if calls["n"] == 1:
                raise RuntimeError("injected device failure")
            return execute(prep)
        monkeypatch.setattr(s, "execute", flaky)
        if not retry:
            with pytest.raises(StepFailure):
                svc.scheduler.step()
            continue
        svc.pump()
        assert svc.scheduler.watchdog.retries == 1
        assert ([wire.delta_payload(d) for d in svc.poll(sid)]
                == local_deltas(SessionConfig(**small_kw()), wins))


# ------------------------------------------------------------ the server


def test_stats_over_the_wire_are_numbers(tmp_path):
    """STATS_OK carries the reference's wire, recovery and daemon blocks
    beside the port's kernel block, every count a JSON number."""
    srv = WireServer(MiningService(device=CPU), "127.0.0.1:0",
                     data_dir=tmp_path / "d")
    srv.start()
    try:
        cfg = SessionConfig(**small_kw())
        wins = split(*tie_heavy(8, n=120), 2)
        c = MiningClient(srv.address, "st", cfg, rng_seed=0)
        for j, w in enumerate(wins):
            c.submit(w, final=j == 1)
        got = sorted(c.drain(deadline_s=120), key=lambda d: d["window_idx"])
        assert got == local_deltas(cfg, wins)
        stats = c.stats()
        for block in ("wire", "recovery", "daemon", "kernel", "scheduler"):
            assert block in stats, block
        assert stats["wire"]["frames_rx"] > 0
        assert stats["recovery"]["checkpoints"] >= 2
        assert isinstance(stats["recovery"]["checkpoint_s"], float)
        assert stats["kernel"]["launches"] == {}
        assert all(isinstance(v, int)
                   for v in stats["kernel"]["plain"].values())
        assert stats["kernel"]["plain"].get("a2_count_state", 0) > 0
        c.close_session()
    finally:
        srv.shutdown(drain=False)
    assert srv.unexpected == []


def test_unexpected_failure_is_typed_and_written_to_stderr(tmp_path,
                                                          capfd):
    """A handler failure the server does not expect keeps the server
    serving (typed ``INTERNAL``), lands in ``unexpected`` and is written to
    stderr with its traceback as it is appended."""
    svc = MiningService(device=CPU)
    srv = WireServer(svc, "127.0.0.1:0", data_dir=tmp_path / "d",
                     auto_pump=False)
    srv.start()
    try:
        def broken():
            raise RuntimeError("stats exploded")
        svc.stats = broken
        c = MiningClient(srv.address, "u", SessionConfig(**small_kw()),
                         rng_seed=0, deadline_s=10.0)
        with pytest.raises(Exception) as ei:
            c.stats()
        assert "INTERNAL" in str(ei.value)
        assert c.ping()["op"] == "ping"  # still serving
        c.close()
    finally:
        srv.shutdown(drain=False)
    assert srv.unexpected and "stats exploded" in srv.unexpected[0]
    err = capfd.readouterr().err
    assert "[wire] unexpected failure: STATS" in err
    assert "Traceback" in err and "stats exploded" in err


def test_short_unix_socket_under_a_short_dir():
    """A Unix socket's path must fit in 107 bytes: the tests and the smoke
    run bind under a short ``mkdtemp`` directory."""
    d = tempfile.mkdtemp(prefix="fem")
    addr = f"unix:{d}/s.sock"
    srv = WireServer(MiningService(device=CPU), addr, auto_pump=False)
    try:
        assert srv.start() == addr and len(addr) < 107
        c = MiningClient(addr, "u", SessionConfig(**small_kw()), rng_seed=0)
        assert c.ping()["op"] == "ping"
        c.close()
    finally:
        srv.shutdown(drain=False)
        shutil.rmtree(d, ignore_errors=True)
    assert srv.unexpected == []
