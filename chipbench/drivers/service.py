"""Loop driver ``service``: the arrays as sessions of one
``MiningService`` (ingest → step → poll), the cross-session batcher fusing
their kernel launches. Each array keeps ``queue_depth`` windows submitted
ahead; when a window's delta is polled the array submits its next one
(closed loop). A window's latency runs from its ``ingest`` to the ``poll``
that returns its delta."""

from __future__ import annotations

from repro_torch.core.events import EventStream
from repro_torch.service import MiningService, SchedulerPolicy, SessionConfig

from chipbench.drivers import Done, RanOut


def session_config(config: dict) -> SessionConfig:
    return SessionConfig(
        intervals=tuple(tuple(iv) for iv in config["intervals"]),
        theta=config["theta"], theta_mode=config["theta_mode"],
        max_level=config["max_level"], window_ms=config["window_ms"],
        engine=config["engine"], two_pass=config["two_pass"],
        history_limit=config["history_limit"], lcap=config["lcap"],
        num_segments=config["num_segments"])


class Driver:
    def __init__(self, config, traffic, recordings, device):
        self.config = config
        self.traffic = traffic
        self.recs = recordings
        n = len(recordings)
        self.svc = MiningService(policy=SchedulerPolicy(
            max_sessions=n, max_batch_sessions=n), device=device)
        self.sids = [f"array-{i}" for i in range(n)]
        cfg = session_config(config)
        for sid in self.sids:
            self.svc.create_session(sid, cfg)
        self.next = [0] * n
        self.t_submit: dict = {}
        self.done: list[Done] = []
        self.results: dict = {i: {} for i in range(n)}

    def _submit(self, i: int, clock) -> None:
        types, times, bounds = self.recs[i]
        p = self.next[i]
        if p + 1 >= len(bounds) - 1:  # the recording's last window is cut
            raise RanOut(f"array {i} ran out of its recording at window {p}")
        lo, hi = int(bounds[p]), int(bounds[p + 1])
        self.svc.ingest(self.sids[i], EventStream(
            types[lo:hi], times[lo:hi], self.config["channels"]))
        self.t_submit[(i, p)] = clock()
        self.next[i] += 1

    def _poll(self, clock, record: bool) -> list[int]:
        """Collect every returned delta; the arrays that got one."""
        back = []
        for i, sid in enumerate(self.sids):
            for delta in self.svc.poll(sid):
                t = clock()
                p = delta.window_idx
                self.results[i][p] = delta.result
                if record:
                    self.done.append(Done(i, p, delta.n_events,
                                          self.t_submit[(i, p)], t))
                back.append(i)
        return back

    def warm(self, clock) -> None:
        for _ in range(self.traffic["warmup_windows"]):
            for i in range(len(self.sids)):
                self._submit(i, clock)
        self.svc.pump()
        self._poll(clock, record=False)

    def run(self, deadline: float, clock, after_window) -> None:
        for _ in range(self.traffic["queue_depth"]):
            for i in range(len(self.sids)):
                self._submit(i, clock)
        while clock() < deadline:
            self.svc.scheduler.step()
            for i in self._poll(clock, record=True):
                if clock() < deadline:
                    self._submit(i, clock)
            after_window()

    def submitted(self) -> int:
        return sum(self.next)

    def finish(self, clock) -> None:
        """Mine what was submitted before the close; its deltas are
        checked, and not counted in the rate."""
        self.svc.pump()
        self._poll(clock, record=False)

    def close(self) -> None:
        self.svc = None
