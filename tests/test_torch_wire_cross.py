"""Clients and servers of the two packages talking to each other over the
wire, on the CPU: a reference ``MiningClient`` (and the reference's raw
frames) drives a port ``WireServer``, and a port client drives a
reference server. Each gives per-window deltas equal to a standalone port
session with duplicated frames (deduplicated), sequence gaps (typed
``OUT_OF_ORDER``), poll redelivery until ack, an unknown session, an
admission rejection, backpressure and a fault-injected link; and after
every test ``server.unexpected == []``. Tolerance: exact equality of
every integer. The sessions mine two levels: the transport never touches
the counts, and the reference's compiles at a third level would double
the file's time (level 3 and every engine are held through the service in
tests/test_torch_service*.py and through the daemon in
tests/test_torch_daemon*.py).

The reference's ``hybrid`` resolves to ptpe on a CPU without its kernel
probe, the port's as one card with the kernel does: the probe is pinned
for the whole module, so both servers mine alike.
"""

import json
import socket
import time

import numpy as np
import pytest
import torch

import repro.core.hybrid as ref_hybrid
from repro.core.events import EventStream as RefStream
from repro.launch import wire_load as ref_load
from repro.service import MiningService as RefService
from repro.service import SchedulerPolicy as RefPolicy
from repro.service import SessionConfig as RefConfig
from repro.service import client as ref_client
from repro.service import wire as ref_wire
from repro_torch.core import EventStream
from repro_torch.launch import wire_load
from repro_torch.runtime import FaultSpec
from repro_torch.service import (MiningService, MiningSession,
                                 SchedulerPolicy, SessionConfig, client,
                                 wire)

# The plain versions step small tensors, one event at a time: intra-op
# threads only contend with the other test processes.
torch.set_num_threads(1)

CPU = "cpu"
NUM_TYPES = 5
DIRECTIONS = ("ref-client-port-server", "port-client-ref-server")


def tie_heavy(seed, n=160):
    rng = np.random.default_rng(seed)
    times = (np.cumsum(rng.choice([0, 0, 1, 2], size=n)) + 1).astype(np.int32)
    types = rng.integers(0, NUM_TYPES, size=n).astype(np.int32)
    return types, times


def split(types, times, k, stream=EventStream):
    n = types.size
    cuts = [n * j // k for j in range(k + 1)]
    return [stream(types[a:b], times[a:b], NUM_TYPES)
            for a, b in zip(cuts[:-1], cuts[1:])]


KW = dict(intervals=((0, 4),), theta=3, max_level=2, history_limit=4)


def standalone(wins, final=True):
    """A standalone port session's wire-form deltas over ``wins`` (the
    last one final unless ``final`` is false)."""
    s = MiningSession("alone", SessionConfig(**KW), device=CPU)
    for j, w in enumerate(wins):
        s.enqueue(w, final=final and j == len(wins) - 1)
    while s.queue_depth:
        p = s.prepare()
        s.commit(p, s.execute(p))
    return [wire.delta_payload(d) for d in s.poll()]


class Side:
    """One direction's client package (its wire codec, client classes,
    config and stream types) and the other package's server."""

    def __init__(self, direction, server):
        port_client = direction.startswith("port")
        self.wire = wire if port_client else ref_wire
        self.client = client.MiningClient if port_client \
            else ref_client.MiningClient
        self.faulty = wire_load.FaultyClient if port_client \
            else ref_load.FaultyClient
        self.config = SessionConfig if port_client else RefConfig
        self.stream = EventStream if port_client else RefStream
        self.server = server

    def wins(self, seed, k=4):
        return split(*tie_heavy(seed), k, self.stream)

    def raw_conn(self):
        kind, target = self.wire.parse_address(self.server.address)
        sock = socket.socket(
            socket.AF_UNIX if kind == "unix" else socket.AF_INET,
            socket.SOCK_STREAM)
        sock.settimeout(60.0)
        sock.connect(target)
        return sock

    def rpc(self, sock, ftype, seq, payload):
        sock.sendall(self.wire.encode_frame(
            self.wire.Frame(self.wire.FrameType[ftype], seq, payload)))
        return self.wire.read_frame(sock)

    def open(self, sock, sid, req=9_000_000, **kw):
        return self.rpc(sock, "OPEN_SESSION", req, json.dumps(
            {"session": sid, "config": self.wire.config_to_wire(
                self.config(**dict(KW, **kw)))}).encode())

    def poll_until(self, sock, sid, want, req_base=8_100_000):
        deadline = time.monotonic() + 120.0
        n = 0
        while time.monotonic() < deadline:
            n += 1
            reply = self.rpc(sock, "POLL", req_base + n, json.dumps(
                {"session": sid, "ack_through": -1}).encode())
            deltas = json.loads(reply.payload)["deltas"]
            if len(deltas) >= want:
                return sorted(deltas, key=lambda d: d["window_idx"])
            time.sleep(0.01)
        raise AssertionError(f"timed out waiting for {want} deltas")


def make_server(port_server, tmp, **policy):
    if port_server:
        return wire.WireServer(
            MiningService(policy=SchedulerPolicy(**policy), device=CPU),
            "127.0.0.1:0", data_dir=tmp, auto_pump=not policy)
    return ref_wire.WireServer(RefService(policy=RefPolicy(**policy)),
                               "127.0.0.1:0", data_dir=tmp,
                               auto_pump=not policy)


def stop(srv):
    # wake the accept thread first (a close alone does not on Linux), so
    # the reference server's shutdown does not wait out its join timeout
    try:
        srv._listener.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    srv.shutdown(drain=False)
    assert srv.unexpected == [], srv.unexpected


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    """One port and one reference server for the module, the reference's
    kernel probe pinned while they live."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_hybrid, "_mapc_kernel_available", lambda: True)
        out = {}
        for direction in DIRECTIONS:
            srv = make_server(direction.endswith("port-server"),
                              tmp_path_factory.mktemp("data"))
            srv.start()
            out[direction] = srv
        yield out
        for srv in out.values():
            stop(srv)


@pytest.fixture(params=DIRECTIONS)
def side(request, servers):
    s = Side(request.param, servers[request.param])
    yield s
    assert s.server.unexpected == [], s.server.unexpected


# -------------------------------------------------------------- clients


def test_client_drives_the_other_server(side):
    wins = side.wins(3)
    c = side.client(side.server.address, "clean", side.config(**KW),
                    rng_seed=0)
    # the registry is the process's: count this test's errors from here
    internal = c.stats()["wire"]["errors"].get("internal", 0)
    for j, w in enumerate(wins):
        c.submit(w, final=(j == len(wins) - 1))
    got = sorted(c.drain(deadline_s=120), key=lambda d: d["window_idx"])
    assert got == standalone(split(*tie_heavy(3), 4))
    stats = c.stats()
    assert stats["recovery"]["checkpoints"] >= 1
    assert stats["wire"]["errors"].get("internal", 0) == internal
    assert c.close_session() == []
    assert "clean" not in side.server.sessions


def test_faulty_link_still_bit_identical(side):
    """Deterministic drop/duplicate/truncate on the client's send path
    (the client package's ``FaultyClient``): retries, reconnects and the
    server's dedup keep the deltas equal to a clean standalone run."""
    wins = side.wins(13, k=5)
    c = side.faulty(side.server.address, "faulty", side.config(**KW),
                    fault_spec=FaultSpec(seed=3, drop=0.15, duplicate=0.15,
                                         truncate=0.10),
                    rng_seed=4, deadline_s=120.0, rpc_timeout_s=1.0)
    for j, w in enumerate(wins):
        c.submit(w, final=(j == len(wins) - 1))
    got = sorted(c.drain(deadline_s=120), key=lambda d: d["window_idx"])
    assert c.injector.total_injected > 0  # the link really was nasty
    assert got == standalone(split(*tie_heavy(13), 5))
    c.close()


# ----------------------------------------------------------- raw frames


def test_duplicated_batch_frames_never_double_count(side):
    """Replaying an EVENT_BATCH yields one application and a duplicate
    ACK; a ping between send and replay defeats the connection's reply
    cache, forcing the replay down the sequence-number dedup path."""
    wins = side.wins(5)
    sock = side.raw_conn()
    assert side.open(sock, "dup").ftype == side.wire.FrameType.SESSION_OK
    dup_acks = 0
    for j, w in enumerate(wins):
        payload = side.wire.encode_events("dup", w,
                                          final=(j == len(wins) - 1))
        for replay in range(3):
            reply = side.rpc(sock, "EVENT_BATCH", j + 1, payload)
            assert reply.ftype == side.wire.FrameType.ACK
            doc = json.loads(reply.payload)
            assert doc["applied"] == j + 1
            dup_acks += doc["duplicate"]
            side.rpc(sock, "CONTROL", 7_000_000 + 10 * j + replay,
                     json.dumps({"op": "ping"}).encode())
    assert dup_acks == 2 * len(wins)
    got = side.poll_until(sock, "dup", len(wins))
    assert got == standalone(split(*tie_heavy(5), 4))
    sock.close()


def test_sequence_gap_refused_with_out_of_order(side):
    sock = side.raw_conn()
    side.open(sock, "gap")
    reply = side.rpc(sock, "EVENT_BATCH", 5,
                     side.wire.encode_events("gap", side.wins(1)[0]))
    assert reply.ftype == side.wire.FrameType.STATUS
    doc = json.loads(reply.payload)
    assert (doc["code"], doc["code_name"], doc["expect"]) == (
        int(side.wire.Status.OUT_OF_ORDER), "OUT_OF_ORDER", 1)
    sock.close()


def test_poll_redelivers_until_acked(side):
    sock = side.raw_conn()
    side.open(sock, "redeliver")
    w = side.wins(2)[0]
    side.rpc(sock, "EVENT_BATCH", 1, side.wire.encode_events("redeliver", w))
    p1 = side.poll_until(sock, "redeliver", 1)
    p2 = json.loads(side.rpc(sock, "POLL", 8_000_002, json.dumps(
        {"session": "redeliver", "ack_through": -1}).encode()
    ).payload)["deltas"]
    assert p1 and p1 == p2  # unacked: redelivered
    assert p1 == standalone(split(*tie_heavy(2), 4)[:1], final=False)
    p3 = json.loads(side.rpc(sock, "POLL", 8_000_003, json.dumps(
        {"session": "redeliver",
         "ack_through": p1[-1]["window_idx"]}).encode()).payload)["deltas"]
    assert p3 == []  # acked: dropped from the cache
    sock.close()


def test_unknown_session_is_typed_status(side):
    sock = side.raw_conn()
    w = side.wins(0)[0]
    for ftype, seq, payload in (
            ("EVENT_BATCH", 1, side.wire.encode_events("ghost", w)),
            ("POLL", 8_000_000, json.dumps({"session": "ghost"}).encode()),
            ("CLOSE_SESSION", 8_000_001,
             json.dumps({"session": "ghost"}).encode())):
        reply = side.rpc(sock, ftype, seq, payload)
        assert reply.ftype == side.wire.FrameType.STATUS
        assert json.loads(reply.payload)["code_name"] == "UNKNOWN_SESSION"
    sock.close()


# ----------------------------------------------- refusals on own servers


@pytest.fixture
def probe(monkeypatch):
    monkeypatch.setattr(ref_hybrid, "_mapc_kernel_available", lambda: True)


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_admission_rejection_is_typed_status(tmp_path, direction):
    srv = make_server(direction.endswith("port-server"), tmp_path / "d",
                      max_sessions=1)
    srv.start()
    try:
        side = Side(direction, srv)
        sock = side.raw_conn()
        assert side.open(sock, "a").ftype == side.wire.FrameType.SESSION_OK
        r2 = side.open(sock, "b", req=9_000_001)
        assert r2.ftype == side.wire.FrameType.STATUS
        assert json.loads(r2.payload)["code_name"] == "ADMISSION_REJECTED"
        # same session, different config: also a typed refusal
        r3 = side.open(sock, "a", req=9_000_002, theta=4)
        assert json.loads(r3.payload)["code_name"] == "CONFIG_CONFLICT"
        # same config: resumed
        r4 = side.open(sock, "a", req=9_000_003)
        assert json.loads(r4.payload)["resumed"] is True
        sock.close()
    finally:
        stop(srv)


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_backpressure_surfaces_as_typed_status(tmp_path, direction, probe):
    srv = make_server(direction.endswith("port-server"), tmp_path / "d",
                      max_pending_windows=1)
    srv.start()
    try:
        side = Side(direction, srv)
        sock = side.raw_conn()
        side.open(sock, "bp")
        wins = side.wins(7, k=3)
        r1 = side.rpc(sock, "EVENT_BATCH", 1,
                      side.wire.encode_events("bp", wins[0]))
        assert r1.ftype == side.wire.FrameType.ACK
        r2 = side.rpc(sock, "EVENT_BATCH", 2,
                      side.wire.encode_events("bp", wins[1]))
        assert r2.ftype == side.wire.FrameType.STATUS
        doc = json.loads(r2.payload)
        assert doc["code_name"] == "BACKPRESSURE"
        assert doc["queue_depth"] >= 1
        # the refusal did not consume the seq: drain, retry, accepted
        srv.service.pump()
        r3 = side.rpc(sock, "EVENT_BATCH", 2,
                      side.wire.encode_events("bp", wins[1], final=True))
        assert r3.ftype == side.wire.FrameType.ACK
        srv.service.pump()
        got = side.poll_until(sock, "bp", 2)
        assert got == standalone(split(*tie_heavy(7), 3)[:2])
        stats = json.loads(side.rpc(sock, "STATS", 8_200_000, b"").payload)
        assert stats["wire"]["backpressure"] >= 1
        sock.close()
    finally:
        stop(srv)
