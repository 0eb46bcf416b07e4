"""Fault-tolerant mining client: exactly-once ingest over a lossy wire
(port of ``repro.service.client``; its frames are the reference's, so it
drives a server of either package).

``MiningClient`` is the producer-side half of the transport contract in
``wire.py``. It hides every transient failure mode the link can produce —
dropped/duplicated/truncated frames, severed connections, a server that
was SIGKILLed and restarted — behind a blocking API whose observable
behavior is: every submitted window is counted exactly once, and polled
deltas arrive exactly once, in window order.

The machinery:

* **Deadlines + retries.** Every RPC has a deadline; transport errors
  and timeouts trigger reconnect + retry with exponential backoff and
  decorrelated jitter (full-jitter would synchronize a fleet of array
  clients hammering a restarting server).
* **Monotonic sequence numbers.** Each ``submit`` gets ``seq = applied +
  1``. A retried batch whose first ACK was lost is deduplicated
  server-side; an ``OUT_OF_ORDER`` status rewinds the client's cursor to
  the server's expected seq.
* **Resend buffer + durability horizon.** Batches are buffered until the
  server reports them ``durable`` (covered by an on-disk checkpoint).
  After a server crash the restored ``applied`` may be behind what we
  submitted — everything past it is resent from the buffer, re-mined,
  and lands bit-identical.
* **Poll cursor.** Deltas are delivered at-least-once (the server keeps
  them cached until acknowledged via ``ack_through``); the client dedups
  by ``window_idx`` so the caller sees each window once.
"""

from __future__ import annotations

import random
import socket
import time

from repro_torch.core.events import EventStream
from repro_torch.obs import REGISTRY

from . import wire
from .session import SessionConfig
from .wire import (
    ConnectionClosed, Frame, FrameType, ProtocolError, Status, parse_address
)


class WireError(RuntimeError):
    """Typed server-side refusal (carries the ``Status`` code)."""

    def __init__(self, code: Status, detail: str = "", info: dict | None = None):
        super().__init__(f"{code.name}: {detail}")
        self.code = code
        self.detail = detail
        self.info = info or {}


class DeadlineExceeded(WireError):
    def __init__(self, detail: str):
        super().__init__(Status.INTERNAL, detail)


class MiningClient:
    """One session's producer endpoint. Not thread-safe (one array, one
    stream, one client — run several clients for several arrays).

    ``backoff_base``/``backoff_cap`` bound the reconnect schedule;
    ``rng_seed`` makes the jitter deterministic for tests.
    """

    # client request ids live far above any session batch seq so a
    # duplicated request frame can never collide with a batch in the
    # server's per-connection reply cache
    _REQ_BASE = 1 << 32

    def __init__(
        self,
        address: str,
        session_id: str,
        config: SessionConfig | None = None,
        *,
        deadline_s: float = 30.0,
        connect_timeout_s: float = 5.0,
        rpc_timeout_s: float = 5.0,
        backoff_base: float = 0.05,
        backoff_cap: float = 2.0,
        max_attempts: int = 64,
        rng_seed: int | None = None,
    ):
        self.address = address
        self.session_id = session_id
        self.config = config or SessionConfig()
        self.deadline_s = deadline_s
        self.connect_timeout_s = connect_timeout_s
        # per-attempt reply timeout: a dropped frame must cost one rpc
        # timeout and a retry, not the whole deadline
        self.rpc_timeout_s = rpc_timeout_s
        self.backoff_base = backoff_base
        self.backoff_cap = backoff_cap
        self.max_attempts = max_attempts
        self._rng = random.Random(rng_seed)
        self._sock: socket.socket | None = None
        self._req = self._REQ_BASE
        self.applied = 0  # highest seq the server has in memory
        self.durable = 0  # highest seq the server has on disk
        self.next_seq = 1
        self._resend: dict[int, tuple[bytes, bool]] = {}  # seq -> payload
        self._seen_windows: set[int] = set()
        self.deltas_received = 0
        self.reconnects = 0

    # ---------------------------------------------------------- transport

    def _connect(self) -> socket.socket:
        kind, target = parse_address(self.address)
        fam = socket.AF_UNIX if kind == "unix" else socket.AF_INET
        sock = socket.socket(fam, socket.SOCK_STREAM)
        sock.settimeout(self.connect_timeout_s)
        sock.connect(target)
        return sock

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def _drop_connection(self) -> None:
        self.close()
        self.reconnects += 1
        REGISTRY.counter("client_reconnects_total").inc()

    def _backoff(self, attempt: int, deadline: float) -> None:
        # decorrelated jitter, capped, never sleeping past the deadline
        hi = min(self.backoff_cap, self.backoff_base * (2 ** attempt))
        delay = self._rng.uniform(0, hi)
        delay = min(delay, max(0.0, deadline - time.monotonic()))
        if delay > 0:
            time.sleep(delay)

    def _ensure_session(self, deadline: float) -> None:
        """(Re)connect and resynchronize: open/resume the session, learn
        the server's ``applied``/``durable`` horizons, and resend every
        buffered batch past ``applied`` (lost to a crash or to frames
        that never arrived)."""
        self._sock = self._connect()
        self._arm_timeout(deadline)
        reply = self._rpc_once(
            Frame(
                FrameType.OPEN_SESSION,
                self._next_req(),
                wire._j(
                    {
                        "session": self.session_id,
                        "config": wire.config_to_wire(self.config),
                    },
                ),
            ),
        )
        doc = wire._unj(reply.payload)
        self.applied = int(doc["applied"])
        self.durable = int(doc.get("durable", self.applied))
        self._trim_resend()
        for seq in sorted(self._resend):
            if seq <= self.applied:
                continue
            payload, _final = self._resend[seq]
            ack = self._rpc_once(Frame(FrameType.EVENT_BATCH, seq, payload))
            self._absorb_ack(ack)

    def _next_req(self) -> int:
        self._req += 1
        return self._req

    def _arm_timeout(self, deadline: float) -> None:
        self._sock.settimeout(
            max(0.05, min(self.rpc_timeout_s, deadline - time.monotonic()))
        )

    def _rpc_once(self, frame: Frame) -> Frame:
        """Send one frame and read its reply on the live socket. Raises
        transport errors through; raises ``WireError`` for STATUS replies
        (except DUPLICATE acks, which are success)."""
        self._sock.sendall(wire.encode_frame(frame))
        while True:
            reply = wire.read_frame(self._sock)
            # a reply to an earlier request (duplicated frame in flight,
            # or a retry racing its first attempt's reply) is stale: skip
            if reply.seq != frame.seq:
                REGISTRY.counter("client_stale_replies_total").inc()
                continue
            break
        if reply.ftype == FrameType.STATUS:
            doc = wire._unj(reply.payload)
            raise WireError(Status(doc["code"]), doc.get("detail", ""), doc)
        return reply

    def _rpc(self, make_frame, deadline_s: float | None = None) -> Frame:
        """At-least-once RPC with reconnect/backoff; the server's dedup
        layers make the composite exactly-once. ``make_frame()`` is
        called fresh per attempt so rewinds take effect."""
        deadline = time.monotonic() + (
            self.deadline_s if deadline_s is None else deadline_s
        )
        last = None
        for attempt in range(self.max_attempts):
            if time.monotonic() >= deadline:
                break
            try:
                if self._sock is None:
                    self._ensure_session(deadline)
                self._arm_timeout(deadline)
                return self._rpc_once(make_frame())
            except (ConnectionClosed, ProtocolError, OSError) as e:
                last = e
                self._drop_connection()
                self._backoff(attempt, deadline)
            except WireError as e:
                if e.code in (Status.BACKPRESSURE, Status.SHUTTING_DOWN):
                    # transient: wait out the queue / the restart
                    last = e
                    self._backoff(attempt, deadline)
                    if e.code == Status.SHUTTING_DOWN:
                        self._drop_connection()
                    continue
                if e.code == Status.OUT_OF_ORDER and "expect" in e.info:
                    # crash rewound the server; resync via reconnect
                    last = e
                    self._drop_connection()
                    continue
                raise
        raise DeadlineExceeded(
            f"RPC failed after {self.max_attempts} attempts / "
            f"{self.deadline_s}s: {last!r}")

    # ---------------------------------------------------------------- api

    def open(self) -> None:
        """Eagerly open/resume the session (otherwise lazy on first RPC)."""
        self._rpc(
            lambda: Frame(FrameType.CONTROL, self._next_req(), wire._j({"op": "ping"}))
        )

    def submit(self, window: EventStream, final: bool = False) -> int:
        """Ingest one partition window, exactly once, surviving any
        transient failure. Returns the batch's sequence number."""
        payload = wire.encode_events(self.session_id, window, final=final)
        seq = self.next_seq
        self._resend[seq] = (payload, final)
        ack = self._rpc(lambda: Frame(FrameType.EVENT_BATCH, seq, payload))
        self._absorb_ack(ack)
        self.next_seq = max(self.next_seq, seq) + 1
        return seq

    def _absorb_ack(self, ack: Frame) -> None:
        doc = wire._unj(ack.payload)
        self.applied = max(self.applied, int(doc["applied"]))
        self.durable = max(self.durable, int(doc.get("durable", 0)))
        self._trim_resend()

    def _trim_resend(self) -> None:
        # only durability releases a batch: an applied-but-uncheckpointed
        # window still dies with the server
        for seq in [s for s in self._resend if s <= self.durable]:
            del self._resend[seq]

    def poll(self, ack: bool = True) -> list[dict]:
        """Fetch mined window deltas; each window is returned exactly
        once across any number of retries/redeliveries."""
        reply = self._rpc(
            lambda: Frame(
                FrameType.POLL,
                self._next_req(),
                wire._j(
                    {
                        "session": self.session_id,
                        "ack_through": (
                            max(self._seen_windows) if ack and self._seen_windows else -1
                        ),
                    },
                ),
            ),
        )
        doc = wire._unj(reply.payload)
        self.applied = max(self.applied, int(doc.get("applied", 0)))
        self.durable = max(self.durable, int(doc.get("durable", 0)))
        self._trim_resend()
        fresh = []
        for d in doc["deltas"]:
            if d["window_idx"] in self._seen_windows:
                continue
            self._seen_windows.add(d["window_idx"])
            fresh.append(d)
        self.deltas_received += len(fresh)
        return fresh

    def drain(
        self, poll_interval_s: float = 0.01, deadline_s: float | None = None
    ) -> list[dict]:
        """Poll until every submitted window's delta has arrived."""
        deadline = time.monotonic() + (
            self.deadline_s if deadline_s is None else deadline_s
        )
        want = self.next_seq - 1
        out = []
        while True:
            out.extend(self.poll())
            if len(self._seen_windows) >= want:
                return out
            if time.monotonic() >= deadline:
                raise DeadlineExceeded(
                    f"drain: {len(self._seen_windows)}/{want} windows "
                    f"after {deadline_s or self.deadline_s}s")
            time.sleep(poll_interval_s)

    def stats(self) -> dict:
        reply = self._rpc(lambda: Frame(FrameType.STATS, self._next_req(), b""))
        return wire._unj(reply.payload)

    def control(self, op: str, deadline_s: float | None = None, **kw) -> dict:
        reply = self._rpc(
            lambda: Frame(FrameType.CONTROL, self._next_req(), wire._j({"op": op, **kw})),
            deadline_s=deadline_s,
        )
        return wire._unj(reply.payload)

    def ping(self) -> dict:
        return self.control("ping")

    def close_session(self) -> list[dict]:
        """Close the session server-side; returns any final deltas."""
        reply = self._rpc(
            lambda: Frame(
                FrameType.CLOSE_SESSION,
                self._next_req(),
                wire._j({"session": self.session_id}),
            ),
        )
        doc = wire._unj(reply.payload)
        fresh = [
            d for d in doc.get("deltas", []) if d["window_idx"] not in self._seen_windows
        ]
        for d in fresh:
            self._seen_windows.add(d["window_idx"])
        self.deltas_received += len(fresh)
        self.close()
        return fresh

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
