"""Loop driver ``miner``: one array through ``StreamingMiner.update``, as
``launch.mine`` runs it, window after window (closed loop: the next
window is handed over when the last one's delta is back)."""

from __future__ import annotations

from repro_torch.core.events import EventStream
from repro_torch.core.streaming import StreamingMiner

from chipbench.drivers import Done, RanOut


def make_miner(config: dict, device, executor=None) -> StreamingMiner:
    return StreamingMiner(
        [tuple(iv) for iv in config["intervals"]], config["theta"],
        max_level=config["max_level"], mode=config["theta_mode"],
        engine=config["engine"], two_pass=config["two_pass"],
        lcap=config["lcap"], num_segments=config["num_segments"],
        history_limit=config["history_limit"], executor=executor,
        device=device)


class Driver:
    def __init__(self, config, traffic, recordings, device):
        if len(recordings) != 1:
            raise ValueError("the miner driver runs one array")
        self.config = config
        self.traffic = traffic
        self.rec = recordings[0]
        self.miner = make_miner(config, device)
        self.next = 0
        self.done: list[Done] = []
        self.results: dict = {0: {}}

    def _window(self, p: int) -> EventStream:
        types, times, bounds = self.rec
        if p + 1 >= len(bounds) - 1:  # the recording's last window is cut
            raise RanOut(f"array 0 ran out of its recording at window {p}")
        lo, hi = int(bounds[p]), int(bounds[p + 1])
        return EventStream(types[lo:hi], times[lo:hi],
                           self.config["channels"])

    def _mine(self, clock) -> Done:
        p = self.next
        w = self._window(p)
        t0 = clock()
        res = self.miner.update(w)
        t1 = clock()
        self.next += 1
        self.results[0][p] = res
        return Done(0, p, len(w), t0, t1)

    def warm(self, clock) -> None:
        for _ in range(self.traffic["warmup_windows"]):
            self._mine(clock)

    def run(self, deadline: float, clock, after_window) -> None:
        while True:
            d = self._mine(clock)
            self.done.append(d)
            after_window()
            if d.returned >= deadline:
                return

    def submitted(self) -> int:
        return self.next

    def finish(self, clock) -> None:
        """Nothing is in flight once ``run`` returns."""

    def close(self) -> None:
        self.miner = None
