"""Fault-tolerant wire transport for the mining service (port of
``repro.service.wire``: the same frames, byte for byte, so a client of
either package talks to a server of either package, and the same
on-disk recovery state, so a data directory written by either server
cold-boots the other).

The paper's chip-on-chip loop puts the acquisition hardware (the MEA)
and the miner (the GPGPU) on one board; at fleet scale they are
different *machines*, and the link between them is a failure domain the
in-process ``MiningService`` never had. This module is the networked
front: a length-prefixed binary frame protocol over TCP or Unix-domain
sockets, and ``WireServer`` — the server loop that makes disconnects,
crashes, and restarts invisible to the counts.

Framing (all integers big-endian)::

    offset  size  field
    0       4     magic     0x46454D31 ("FEM1")
    4       1     version   PROTO_VERSION (1)
    5       1     type      FrameType
    6       2     flags     reserved (0)
    8       8     seq       session sequence (EVENT_BATCH) / request id
    16      4     length    payload bytes (<= MAX_PAYLOAD)
    20      4     crc32     zlib.crc32 of the payload
    24      ...   payload

Control/stats payloads are JSON; event batches are a packed binary
record (see ``encode_events``). Every frame is CRC-checked; a torn or
mutated frame yields a typed ``STATUS`` reply (``BAD_FRAME`` /
``BAD_CRC`` / ``BAD_VERSION``) — never a crashed server thread, and
never a silent drop.

Exactly-once ingest: each session's batches carry a client-assigned
monotonic sequence number starting at 1. The server applies ``seq ==
applied + 1`` only; a replayed batch (retry after a lost ACK) is
acknowledged without re-applying (``wire_dedup_hits_total``), and a gap
is refused with ``OUT_OF_ORDER`` so the client rewinds. The ACK carries
both ``applied`` (in memory) and ``durable`` (checkpointed): the
sequence horizon is saved as a ``wire/last_seq`` leaf *inside* the
session's atomic checkpoint, so after a crash the restored mining state
and the restored dedup horizon cannot disagree — the client resends
everything past ``durable`` and the re-mined windows are bit-identical.

Backpressure and shed decisions travel as typed status codes
(``Status.BACKPRESSURE`` with the queue depth) instead of silent drops,
and are counted (``wire_backpressure_total``) next to the scheduler's
own shed counters in ``MiningService.stats()``.

A failure the server does not expect (a kernel that fails to build or
launch on the card, say) is typed to the client as ``INTERNAL`` and
appended to ``WireServer.unexpected`` while the server keeps serving, as
in the reference; the port also writes each such entry to stderr as it
appends it, so that nothing hides it.
"""

from __future__ import annotations

import dataclasses
import enum
import json
import os
import signal
import socket
import struct
import sys
import threading
import time
import traceback
import zlib
from pathlib import Path

import numpy as np
import torch

from repro_torch.checkpoint import ckpt
from repro_torch.core.events import EventStream
from repro_torch.obs import REGISTRY, span

from .scheduler import AdmissionError, BackpressureError, UnknownSessionError
from .session import SessionConfig, WindowDelta

MAGIC = 0x46454D31  # "FEM1": Frequent Episode Mining, wire v1
PROTO_VERSION = 1
MAX_PAYLOAD = 16 << 20
HEADER = struct.Struct("!IBBHQII")
_EVENTS_HEAD = struct.Struct("!HIIB")


class FrameType(enum.IntEnum):
    HELLO = 1
    HELLO_OK = 2
    OPEN_SESSION = 3
    SESSION_OK = 4
    CLOSE_SESSION = 5
    EVENT_BATCH = 6
    ACK = 7
    POLL = 8
    DELTAS = 9
    STATS = 10
    STATS_OK = 11
    CONTROL = 12
    CONTROL_OK = 13
    STATUS = 14


class Status(enum.IntEnum):
    """Machine-readable status codes carried by STATUS frames."""

    OK = 0
    BACKPRESSURE = 1  # session queue full: slow down or spool
    SHED = 2  # window refused and not queued anywhere
    UNKNOWN_SESSION = 3  # never admitted, or already evicted
    ADMISSION_REJECTED = 4  # service at tenant capacity
    BAD_FRAME = 5  # malformed frame or payload
    BAD_CRC = 6  # payload CRC mismatch
    BAD_VERSION = 7  # protocol version not supported
    OUT_OF_ORDER = 8  # sequence gap: client must rewind
    DUPLICATE = 9  # batch already applied (informational)
    CONFIG_CONFLICT = 10  # session exists with a different config
    SESSION_CLOSED = 11  # final batch already ingested
    SHUTTING_DOWN = 12  # server draining: reconnect after restart
    INTERNAL = 13  # unexpected server-side failure


class ProtocolError(RuntimeError):
    """Malformed wire data. ``code`` is the typed status the server
    reports; ``fatal`` marks the byte stream as unsynchronized (framing
    broken — the connection must close; a payload-level error keeps it)."""

    code = Status.BAD_FRAME
    fatal = False


class BadMagic(ProtocolError):
    fatal = True


class BadCrc(ProtocolError):
    code = Status.BAD_CRC
    fatal = True


class BadVersion(ProtocolError):
    code = Status.BAD_VERSION
    fatal = True


class FrameTooLarge(ProtocolError):
    fatal = True


class ConnectionClosed(RuntimeError):
    """Peer went away (EOF mid-frame or clean close)."""


@dataclasses.dataclass(frozen=True)
class Frame:
    ftype: int
    seq: int
    payload: bytes = b""
    flags: int = 0


def encode_frame(frame: Frame) -> bytes:
    if len(frame.payload) > MAX_PAYLOAD:
        raise FrameTooLarge(f"payload {len(frame.payload)} > {MAX_PAYLOAD}")
    head = HEADER.pack(
        MAGIC,
        PROTO_VERSION,
        int(frame.ftype),
        frame.flags,
        frame.seq,
        len(frame.payload),
        zlib.crc32(frame.payload) & 0xFFFFFFFF,
    )
    return head + frame.payload


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionClosed(f"EOF after {len(buf)}/{n} bytes")
        buf.extend(chunk)
    return bytes(buf)


def read_frame(sock: socket.socket) -> Frame:
    """Read one frame off a socket; raises a typed ``ProtocolError`` on
    malformed data and ``ConnectionClosed`` on EOF."""
    head = _recv_exact(sock, HEADER.size)
    magic, version, ftype, flags, seq, length, crc = HEADER.unpack(head)
    if magic != MAGIC:
        raise BadMagic(f"bad magic {magic:#010x}")
    if version != PROTO_VERSION:
        raise BadVersion(f"unsupported protocol version {version}")
    if length > MAX_PAYLOAD:
        raise FrameTooLarge(f"payload {length} > {MAX_PAYLOAD}")
    payload = _recv_exact(sock, length) if length else b""
    if zlib.crc32(payload) & 0xFFFFFFFF != crc:
        raise BadCrc(f"payload CRC mismatch on frame type {ftype}")
    return Frame(ftype, seq, payload, flags)


# ------------------------------------------------------------- payloads


def _j(obj) -> bytes:
    return json.dumps(obj, sort_keys=True).encode()


def _unj(payload: bytes):
    try:
        return json.loads(payload.decode())
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ProtocolError(f"bad JSON payload: {e}") from None


def encode_events(session_id: str, stream: EventStream, final: bool = False) -> bytes:
    """EVENT_BATCH payload: session id + the window's raw int32 arrays."""
    sid = session_id.encode()
    n = int(stream.types.shape[0])
    return (_EVENTS_HEAD.pack(len(sid), n, stream.num_types, int(final))
            + sid
            + np.ascontiguousarray(stream.types, "<i4").tobytes()
            + np.ascontiguousarray(stream.times, "<i4").tobytes())


def decode_events(payload: bytes) -> tuple[str, EventStream, bool]:
    if len(payload) < _EVENTS_HEAD.size:
        raise ProtocolError("event batch shorter than its header")
    sid_len, n, num_types, final = _EVENTS_HEAD.unpack_from(payload)
    want = _EVENTS_HEAD.size + sid_len + 8 * n
    if len(payload) != want:
        raise ProtocolError(f"event batch length {len(payload)} != expected {want}")
    off = _EVENTS_HEAD.size
    try:
        sid = payload[off:off + sid_len].decode()
    except UnicodeDecodeError as e:
        raise ProtocolError(f"bad session id: {e}") from None
    off += sid_len
    types = np.frombuffer(payload, "<i4", count=n, offset=off)
    times = np.frombuffer(payload, "<i4", count=n, offset=off + 4 * n)
    try:
        stream = EventStream(types.copy(), times.copy(), num_types)
    except ValueError as e:
        raise ProtocolError(f"invalid event stream: {e}") from None
    return sid, stream, bool(final)


def config_to_wire(cfg: SessionConfig) -> dict:
    return dataclasses.asdict(cfg)


def config_from_wire(d: dict) -> SessionConfig:
    """Rebuild a ``SessionConfig`` normalizing JSON's list/tuple drift —
    the checkpoint config fingerprint is ``repr``-based, so a round-trip
    through the wire (or the sessions manifest) must reproduce the exact
    dataclass, tuples included."""
    fields = {f.name for f in dataclasses.fields(SessionConfig)}
    unknown = set(d) - fields
    if unknown:
        raise ProtocolError(f"unknown session config fields {sorted(unknown)}")
    kw = dict(d)
    if "intervals" in kw:
        try:
            kw["intervals"] = tuple(tuple(int(x) for x in iv) for iv in kw["intervals"])
        except (TypeError, ValueError) as e:
            raise ProtocolError(f"bad intervals: {e}") from None
    try:
        return SessionConfig(**kw)
    except (TypeError, ValueError) as e:
        raise ProtocolError(f"bad session config: {e}") from None


def delta_payload(d: WindowDelta) -> dict:
    """The wire-facing form of one mined window — also what the load
    generator's ``--verify`` computes locally, so the wire codec and the
    verification codec cannot drift."""
    return {
        "window_idx": int(d.window_idx),
        "n_events": int(d.n_events),
        "final": bool(d.final),
        "episodes": [[list(et), int(c)] for et, c in d.episodes()],
    }


def _jsonify(obj):
    """Best-effort JSON coercion for stats snapshots (numpy and torch
    scalars and arrays show up in meter rows, registry families and the
    kernel tally): every number arrives as a number, never as its
    ``repr``."""
    if isinstance(obj, dict):
        return {str(k): _jsonify(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonify(v) for v in obj]
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().tolist()
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    return repr(obj)


def parse_address(address) -> tuple[str, object]:
    """``"host:port"`` | ``"unix:/path"`` | ``(host, port)`` →
    ``("tcp", (host, port))`` or ``("unix", path)``."""
    if isinstance(address, (tuple, list)):
        return "tcp", (str(address[0]), int(address[1]))
    if address.startswith("unix:"):
        return "unix", address[5:]
    host, _, port = address.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"address {address!r} is not host:port or unix:path")
    return "tcp", (host, int(port))


# --------------------------------------------------------------- server


@dataclasses.dataclass
class WireSessionState:
    """Transport-side per-session state: the exactly-once horizon and the
    at-least-once delivery cache. ``applied`` is the highest batch seq in
    the live mining state; ``durable`` the highest covered by an on-disk
    checkpoint (what survives SIGKILL). ``delta_cache`` holds delivered-
    but-unacknowledged poll results so a reply lost to a dropped
    connection is re-delivered on the next poll (clients dedup by
    ``window_idx``)."""

    config: SessionConfig
    applied: int = 0
    durable: int = 0
    delta_cache: list = dataclasses.field(default_factory=list)


class WireServer:
    """Socket front for a ``MiningService``: one reader thread per
    connection, one pump thread mining pending windows and checkpointing
    every ``checkpoint_every`` steps. All service access is serialized
    under one lock — the wire layer adds fault tolerance, not a second
    scheduler.

    ``crash_after_commits`` is the fault-injection hook: the process
    SIGKILLs itself the moment total committed windows reach the given
    count — after the commit, *before* the checkpoint, the exact spot
    where a naive transport double-counts or loses windows on restart.
    """

    def __init__(
        self,
        service,
        address: str = "127.0.0.1:0",
        *,
        data_dir: str | os.PathLike | None = None,
        checkpoint_every: int = 1,
        keep_checkpoints: int = 2,
        pump_interval_s: float = 0.002,
        auto_pump: bool = True,
        crash_after_commits: int | None = None,
    ):
        self.service = service
        self._requested_address = address
        self.data_dir = Path(data_dir) if data_dir is not None else None
        self.checkpoint_every = checkpoint_every
        self.keep_checkpoints = keep_checkpoints
        self.pump_interval_s = pump_interval_s
        self.auto_pump = auto_pump
        self.crash_after_commits = crash_after_commits
        self.sessions: dict[str, WireSessionState] = {}
        self.commits = 0
        self.draining = False
        self.unexpected: list[str] = []  # handler bugs; fuzz asserts empty
        self.address: str | None = None
        self._lock = threading.RLock()
        self._listener: socket.socket | None = None
        self._conns: set[socket.socket] = set()
        self._threads: list[threading.Thread] = []
        self._stop = threading.Event()
        self._running = False
        self._steps_since_ckpt = 0

    def _record_unexpected(self, entry: str) -> None:
        """Keep serving, but let no unexpected failure pass unseen: called
        from the handler that caught it, this appends the entry to
        ``unexpected`` and writes it, with its traceback, to stderr."""
        self.unexpected.append(entry)
        print(f"[wire] unexpected failure: {entry}", file=sys.stderr)
        traceback.print_exc(file=sys.stderr)
        sys.stderr.flush()

    # ---------------------------------------------------------- lifecycle

    def start(self) -> str:
        """Bind, recover from the data dir if present, and serve. Returns
        the bound address (resolved port for ``host:0``)."""
        kind, target = parse_address(self._requested_address)
        if kind == "unix":
            if os.path.exists(target):
                os.unlink(target)  # stale socket from a crashed server
            sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            sock.bind(target)
            self.address = f"unix:{target}"
        else:
            sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            sock.bind(target)
            host, port = sock.getsockname()[:2]
            self.address = f"{host}:{port}"
        sock.listen(64)
        self._listener = sock
        if self.data_dir is not None:
            self.recover()
        self._running = True
        t = threading.Thread(target=self._accept_loop, daemon=True, name="wire-accept")
        t.start()
        self._threads.append(t)
        if self.auto_pump:
            t = threading.Thread(target=self._pump_loop, daemon=True, name="wire-pump")
            t.start()
            self._threads.append(t)
        return self.address

    def shutdown(self, drain: bool = True) -> None:
        """Graceful stop: refuse new windows (``SHUTTING_DOWN``), mine
        what is queued, quiesce staged preps, checkpoint every session,
        then tear the sockets down. SIGKILL can interrupt any point of
        this — that is what the checkpoints are for."""
        self.draining = True
        if self._listener is not None:
            try:
                # shut down before closing: on Linux a close alone does
                # not wake the accept thread blocked on the listener
                self._listener.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                self._listener.close()
            except OSError:
                pass
        with self._lock:
            if drain:
                with span("daemon.drain", pending=self.service.scheduler.pending_windows):
                    self.service.scheduler.drain()
            if self.data_dir is not None:
                self._checkpoint_locked()
                self._write_manifest_locked()
        self._running = False
        self._stop.set()
        for conn in list(self._conns):
            try:
                conn.close()
            except OSError:
                pass
        for t in self._threads:
            t.join(timeout=5.0)
        self._threads.clear()

    # ----------------------------------------------------------- recovery

    def recover(self) -> int:
        """Cold-boot recovery: rebuild every session named by the
        sessions manifest from its newest complete checkpoint, restoring
        the mining state, the pending queue, the unpolled results, and
        the wire dedup horizon in one consistent cut. Returns sessions
        restored."""
        manifest = self.data_dir / "SESSIONS.json"
        if not manifest.exists():
            return 0
        doc = json.loads(manifest.read_text())
        restored = 0
        with span("wire.recover", sessions=len(doc.get("sessions", {}))):
            for sid, cfgd in sorted(doc.get("sessions", {}).items()):
                cfg = config_from_wire(cfgd)
                self.service.create_session(sid, cfg)
                s = self.service.session(sid)
                applied = 0
                step = ckpt.latest_step(self.data_dir / sid)
                if step is not None:
                    s.restore(self.data_dir, step=step)
                    applied = int(
                        ckpt.read_leaf(
                            self.data_dir / sid, "wire/last_seq", step=step, default=0
                        ),
                    )
                    REGISTRY.counter("recovery_windows_requeued_total").inc(
                        len(s.pending)
                    )
                self.sessions[sid] = WireSessionState(
                    config=cfg, applied=applied, durable=applied
                )
                REGISTRY.counter("recovery_sessions_total").inc()
                restored += 1
        REGISTRY.counter("recovery_boots_total").inc()
        return restored

    def _write_manifest_locked(self) -> None:
        if self.data_dir is None:
            return
        self.data_dir.mkdir(parents=True, exist_ok=True)
        doc = {
            "sessions": {
                sid: config_to_wire(st.config) for sid, st in self.sessions.items()
            },
        }
        tmp = self.data_dir / "SESSIONS.json.tmp"
        tmp.write_text(json.dumps(doc, indent=1, sort_keys=True))
        os.replace(tmp, self.data_dir / "SESSIONS.json")

    def _checkpoint_locked(self) -> None:
        if self.data_dir is None:
            return
        snap = {sid: st.applied for sid, st in self.sessions.items()}
        self.service.checkpoint_all(
            self.data_dir,
            extra=lambda sid: {"wire/last_seq": np.asarray(snap.get(sid, 0), np.int64)},
        )
        for sid, seq in snap.items():
            if sid in self.service.scheduler.sessions:
                self.sessions[sid].durable = seq
                ckpt.prune(self.data_dir / sid, keep=self.keep_checkpoints)
        self._steps_since_ckpt = 0

    # --------------------------------------------------------------- pump

    def pump_once(self) -> bool:
        """One scheduler step (if work is pending) + the crash hook + the
        checkpoint cadence. Returns whether a step ran."""
        with self._lock:
            if not self.service.scheduler.pending_windows:
                return False
            before = sum(s.windows_done for s in self.service.scheduler.sessions.values())
            self.service.scheduler.step()
            after = sum(s.windows_done for s in self.service.scheduler.sessions.values())
            self.commits += max(0, after - before)
            if (self.crash_after_commits is not None
                    and self.commits >= self.crash_after_commits):
                # fault injection: die at a window-commit boundary,
                # after the commit and before the checkpoint — a real
                # SIGKILL, no cleanup, no atexit
                os.kill(os.getpid(), signal.SIGKILL)
            self._steps_since_ckpt += 1
            if (self.data_dir is not None and self.checkpoint_every
                    and self._steps_since_ckpt >= self.checkpoint_every):
                self._checkpoint_locked()
            return True

    def _pump_loop(self) -> None:
        while self._running:
            try:
                if not self.pump_once():
                    self._stop.wait(self.pump_interval_s)
            except Exception as e:  # noqa: BLE001 — keep serving
                self._record_unexpected(f"pump: {e!r}")
                self._stop.wait(self.pump_interval_s)

    # -------------------------------------------------------- connections

    def _accept_loop(self) -> None:
        while self._running or not self._stop.is_set():
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return  # listener closed: shutdown
            REGISTRY.gauge("wire_connections").inc(1)
            REGISTRY.counter("wire_connections_total").inc()
            self._conns.add(conn)
            t = threading.Thread(
                target=self._serve_conn, args=(conn,), daemon=True, name="wire-conn"
            )
            t.start()

    def _send(self, conn: socket.socket, frames: list[Frame]) -> None:
        for f in frames:
            raw = encode_frame(f)
            conn.sendall(raw)
            REGISTRY.counter("wire_frames_total", dir="tx").inc()
            REGISTRY.counter("wire_bytes_total", dir="tx").inc(len(raw))

    def _serve_conn(self, conn: socket.socket) -> None:
        # single-entry reply cache: at-most-once execution for a frame
        # duplicated in flight (POLL is not idempotent — re-executing it
        # would drop deltas into a reply the client discards as stale)
        last_key, last_replies = None, None
        try:
            while True:
                try:
                    frame = read_frame(conn)
                except ConnectionClosed:
                    return
                except ProtocolError as e:
                    REGISTRY.counter("wire_errors_total", code=e.code.name.lower()).inc()
                    try:
                        self._send(conn, [self._status(0, e.code, str(e))])
                    except OSError:
                        pass
                    return  # stream unsynchronized: close
                except OSError:
                    return
                REGISTRY.counter("wire_frames_total", dir="rx").inc()
                REGISTRY.counter("wire_bytes_total", dir="rx").inc(
                    HEADER.size + len(frame.payload)
                )
                key = (frame.ftype, frame.seq)
                if key == last_key and last_replies is not None:
                    REGISTRY.counter("wire_rpc_replays_total").inc()
                    self._send(conn, last_replies)
                    continue
                try:
                    replies = self._handle(frame)
                except ProtocolError as e:  # payload-level: stream intact
                    REGISTRY.counter("wire_errors_total", code=e.code.name.lower()).inc()
                    replies = [self._status(frame.seq, e.code, str(e))]
                    if e.fatal:
                        self._send(conn, replies)
                        return
                except Exception as e:  # noqa: BLE001 — typed, not torn
                    name = (FrameType(frame.ftype).name
                            if frame.ftype in FrameType._value2member_map_
                            else str(frame.ftype))
                    self._record_unexpected(f"{name}: {e!r}")
                    REGISTRY.counter("wire_errors_total", code="internal").inc()
                    replies = [self._status(frame.seq, Status.INTERNAL, repr(e))]
                self._send(conn, replies)
                # cache only success replies: a BACKPRESSURE retry of the
                # same seq must re-execute against the drained queue
                if any(f.ftype == FrameType.STATUS for f in replies):
                    last_key, last_replies = None, None
                else:
                    last_key, last_replies = key, replies
        except OSError:
            return
        finally:
            self._conns.discard(conn)
            try:
                conn.close()
            except OSError:
                pass
            REGISTRY.gauge("wire_connections").inc(-1)

    # ------------------------------------------------------------ handlers

    @staticmethod
    def _status(seq: int, code: Status, detail: str = "", **extra) -> Frame:
        return Frame(
            FrameType.STATUS,
            seq,
            _j({"code": int(code), "code_name": code.name, "detail": detail, **extra}),
        )

    def _handle(self, frame: Frame) -> list[Frame]:
        ftype = frame.ftype
        if ftype == FrameType.HELLO:
            with self._lock:
                return [
                    Frame(
                        FrameType.HELLO_OK,
                        frame.seq,
                        _j(
                            {
                                "version": PROTO_VERSION,
                                "draining": self.draining,
                                "sessions": {
                                    sid: st.applied for sid, st in self.sessions.items()
                                },
                            }
                        ),
                    )
                ]
        if ftype == FrameType.OPEN_SESSION:
            return self._handle_open(frame)
        if ftype == FrameType.CLOSE_SESSION:
            return self._handle_close(frame)
        if ftype == FrameType.EVENT_BATCH:
            return self._handle_batch(frame)
        if ftype == FrameType.POLL:
            return self._handle_poll(frame)
        if ftype == FrameType.STATS:
            with self._lock:
                stats = _jsonify(self.service.stats())
            return [Frame(FrameType.STATS_OK, frame.seq, _j(stats))]
        if ftype == FrameType.CONTROL:
            return self._handle_control(frame)
        raise ProtocolError(f"unknown frame type {ftype}")

    def _handle_open(self, frame: Frame) -> list[Frame]:
        doc = _unj(frame.payload)
        sid = doc.get("session")
        if not isinstance(sid, str) or not sid:
            raise ProtocolError("open_session: missing session id")
        cfg = config_from_wire(doc.get("config") or {})
        with self._lock:
            st = self.sessions.get(sid)
            if st is not None:
                if (ckpt.config_fingerprint(st.config) != ckpt.config_fingerprint(cfg)):
                    return [self._status(
                        frame.seq, Status.CONFIG_CONFLICT,
                        f"session {sid!r} exists with a different config")]
                return [Frame(FrameType.SESSION_OK, frame.seq, _j({
                    "session": sid, "applied": st.applied,
                    "durable": st.durable, "resumed": True}))]
            if self.draining:
                return [self._status(frame.seq, Status.SHUTTING_DOWN,
                                     "server is draining")]
            try:
                self.service.create_session(sid, cfg)
            except AdmissionError as e:
                return [self._status(frame.seq, Status.ADMISSION_REJECTED, str(e))]
            self.sessions[sid] = WireSessionState(config=cfg)
            self._write_manifest_locked()
            return [Frame(FrameType.SESSION_OK, frame.seq, _j({
                "session": sid, "applied": 0, "durable": 0,
                "resumed": False}))]

    def _handle_close(self, frame: Frame) -> list[Frame]:
        doc = _unj(frame.payload)
        sid = doc.get("session")
        with self._lock:
            st = self.sessions.get(sid)
            if st is None:
                return [
                    self._status(
                        frame.seq, Status.UNKNOWN_SESSION, f"unknown session {sid!r}"
                    )
                ]
            s = self.service.close_session(sid)
            deltas = st.delta_cache + [delta_payload(d) for d in s.poll()]
            del self.sessions[sid]
            self._write_manifest_locked()
            return [Frame(FrameType.SESSION_OK, frame.seq, _j({
                "session": sid, "applied": st.applied, "deltas": deltas,
                "closed": True}))]

    def _handle_batch(self, frame: Frame) -> list[Frame]:
        sid, stream, final = decode_events(frame.payload)
        seq = frame.seq
        with self._lock, span("wire.ingest", session=sid, seq=seq):
            st = self.sessions.get(sid)
            if st is None:
                return [
                    self._status(seq, Status.UNKNOWN_SESSION, f"unknown session {sid!r}")
                ]
            if seq <= st.applied:
                REGISTRY.counter("wire_dedup_hits_total").inc()
                return [Frame(FrameType.ACK, seq, _j({
                    "applied": st.applied, "durable": st.durable,
                    "duplicate": True}))]
            if self.draining:
                return [self._status(seq, Status.SHUTTING_DOWN, "server is draining")]
            if seq > st.applied + 1:
                REGISTRY.counter("wire_out_of_order_total").inc()
                return [
                    self._status(
                        seq,
                        Status.OUT_OF_ORDER,
                        f"expected seq {st.applied + 1}, " f"got {seq}",
                        expect=st.applied + 1,
                    )
                ]
            try:
                self.service.ingest(sid, stream, final=final)
            except BackpressureError as e:
                REGISTRY.counter("wire_backpressure_total").inc()
                depth = self.service.session(sid).queue_depth
                return [self._status(seq, Status.BACKPRESSURE, str(e), queue_depth=depth)]
            except UnknownSessionError:
                return [
                    self._status(seq, Status.UNKNOWN_SESSION, f"unknown session {sid!r}")
                ]
            except RuntimeError as e:
                return [self._status(seq, Status.SESSION_CLOSED, str(e))]
            st.applied = seq
            return [Frame(FrameType.ACK, seq, _j({
                "applied": st.applied, "durable": st.durable,
                "duplicate": False}))]

    def _handle_poll(self, frame: Frame) -> list[Frame]:
        doc = _unj(frame.payload)
        sid = doc.get("session")
        ack_through = doc.get("ack_through", -1)
        with self._lock:
            st = self.sessions.get(sid)
            if st is None:
                return [
                    self._status(
                        frame.seq, Status.UNKNOWN_SESSION, f"unknown session {sid!r}"
                    )
                ]
            if isinstance(ack_through, int):
                st.delta_cache = [
                    d for d in st.delta_cache if d["window_idx"] > ack_through
                ]
            try:
                fresh = self.service.poll(sid)
            except UnknownSessionError:
                fresh = []
            st.delta_cache.extend(delta_payload(d) for d in fresh)
            return [Frame(FrameType.DELTAS, frame.seq, _j({
                "session": sid, "deltas": st.delta_cache,
                "applied": st.applied, "durable": st.durable}))]

    def _handle_control(self, frame: Frame) -> list[Frame]:
        doc = _unj(frame.payload)
        op = doc.get("op")
        if op == "ping":
            return [Frame(FrameType.CONTROL_OK, frame.seq, _j({
                "op": op, "ts": time.time(),
                "draining": self.draining}))]
        if op == "drain":
            with self._lock:
                steps = self.service.scheduler.drain()
                if self.data_dir is not None:
                    self._checkpoint_locked()
            return [Frame(FrameType.CONTROL_OK, frame.seq, _j({
                "op": op, "steps": steps}))]
        if op == "checkpoint":
            with self._lock:
                if self.data_dir is None:
                    return [self._status(frame.seq, Status.INTERNAL,
                                         "server has no data dir")]
                self._checkpoint_locked()
                self._write_manifest_locked()
                durable = {sid: st.durable for sid, st in self.sessions.items()}
            return [Frame(FrameType.CONTROL_OK, frame.seq, _j({
                "op": op, "durable": durable}))]
        if op == "shutdown":
            self._stop.set()  # daemon's run loop observes and drains
            return [Frame(FrameType.CONTROL_OK, frame.seq, _j({"op": op}))]
        raise ProtocolError(f"unknown control op {op!r}")

    # ---------------------------------------------------------- test hooks

    @property
    def stop_requested(self) -> bool:
        return self._stop.is_set()

    def wait_stop(self, timeout: float | None = None) -> bool:
        return self._stop.wait(timeout)
