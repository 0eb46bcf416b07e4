"""What the traced run reads: the card's activity by ``torch.profiler``
(CUDA activity only, so tracing adds no host-op records to the host's
work), put on the host's clock, and the reductions the per-layer readers
and the ``breakdown`` share."""

from __future__ import annotations

import bisect
import re
import time
from collections import defaultdict

# names the kernels of the two counting families carry (the CUDA sources'
# ``__global__`` functions under ``src/repro_torch/kernels/csrc``): the
# relaxed A2 walks (K1, K3, K6a) and the exact A1 walks (K2, K4, K5,
# K6b-K6d). The segment-parallel fold and stitch kernels serve both
# families (K3's fold is A2's, K4's A1's): each belongs to the family of
# the walk or Map kernel launched last before it (``families``)
FAMILIES = {"a2": re.compile(r"\ba2_\w*(kernel|generic)"),
            "a1": re.compile(r"\ba1_\w*(kernel|generic)")}
_SHARED = re.compile(r"\b\w*(fold|stitch)\w*(kernel|generic)")
_MARKER = re.compile(r"spin|sleep")


class DeviceTrace:
    """One profiler session over the measured loop. ``stop`` returns the
    card's kernels, copies and fills as (name, start, seconds) on the
    host's ``perf_counter`` clock, placed by a marker kernel launched
    (and waited for) just before the loop opens."""

    def __init__(self, cuda: bool):
        self.cuda = cuda
        self.prof = None

    def start(self) -> None:
        if not self.cuda:
            return
        import torch
        self.prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        self.prof.__enter__()
        torch.cuda.synchronize()
        torch.cuda._sleep(20_000)
        torch.cuda.synchronize()
        self.t_mark = time.perf_counter()

    def stop(self) -> list:
        if not self.cuda:
            return []
        import torch
        torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)
        rows = [(e.name, e.time_range.start * 1e-6,
                 (e.time_range.end - e.time_range.start) * 1e-6)
                for e in self.prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        marks = [t0 + d for name, t0, d in rows if _MARKER.search(name)]
        if not marks:
            raise RuntimeError("the profiler recorded no marker kernel")
        shift = self.t_mark - min(marks)
        return [(name, t0 + shift, d) for name, t0, d in rows
                if not _MARKER.search(name)]


def clipped(rec) -> list:
    """The device events inside the measured loop, clipped to it."""
    out = []
    for name, t0, d in rec.device_events:
        a, b = max(t0, rec.t_open), min(t0 + d, rec.t_close)
        if b > a:
            out.append((name, a, b - a))
    return out


def _union(events) -> list:
    spans = sorted((t0, t0 + d) for _, t0, d in events)
    merged: list = []
    for a, b in spans:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def busy_seconds(rec) -> float:
    """Seconds in which some kernel, copy or fill ran on the card."""
    return float(sum(b - a for a, b in _union(clipped(rec))))


def families(events) -> list:
    """Each event's counting family (``"a1"``, ``"a2"`` or None), for
    events in launch order: a fold or stitch kernel takes the family of
    the last walk or Map kernel before it."""
    out, last = [], None
    for name, _, _ in events:
        fam = next((f for f, pat in FAMILIES.items() if pat.search(name)),
                   None)
        if fam is not None:
            last = fam
        elif _SHARED.search(name):
            fam = last
        out.append(fam)
    return out


def family_seconds(rec, family: str) -> float:
    """Device seconds of ``family``'s kernels inside the measured loop."""
    events = sorted(rec.device_events, key=lambda e: e[1])
    total = 0.0
    for (_, t0, d), fam in zip(events, families(events)):
        if fam == family:
            total += max(0.0, min(t0 + d, rec.t_close) - max(t0, rec.t_open))
    return float(total)


def short_name(name: str) -> str:
    """A kernel's name without its argument list."""
    name = name.replace("(anonymous namespace)::", "")
    name = re.sub(r"^void ", "", name)
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            name = name[:i]
            break
    return name[:160]


def self_seconds(spans, names) -> float:
    """Summed self time of the spans called ``names``: each one's length
    less that of the spans directly inside it on its thread."""
    by_tid = defaultdict(list)
    for s in spans:
        by_tid[s.tid].append(s)
    total = 0.0
    for rows in by_tid.values():
        rows.sort(key=lambda s: s.t0)
        starts = [s.t0 for s in rows]
        for s in rows:
            if s.name not in names:
                continue
            end = s.t0 + s.dur
            i = bisect.bisect_left(starts, s.t0)
            inner = 0.0
            for c in rows[i:bisect.bisect_right(starts, end)]:
                if c is not s and c.depth == s.depth + 1 \
                        and c.t0 + c.dur <= end + 1e-9:
                    inner += c.dur
            total += s.dur - inner
    return total


def breakdown(rec) -> dict:
    """The ten device operations that took most time, by kernel name, and
    the card's idle time, summed by what the host was doing at the middle
    of each gap: the program's span opened last among those still open on
    any thread (``no span`` where none was: host work of the program
    outside its spans, or the harness), the ten largest."""
    ops = defaultdict(float)
    events = clipped(rec)
    for name, _, d in events:
        ops[short_name(name)] += d
    gaps = defaultdict(float)
    busy = _union(events)
    edges = [rec.t_open] + [x for ab in busy for x in ab] + [rec.t_close]
    spans = sorted(rec.spans, key=lambda s: s.t0)
    active: list = []
    k = 0
    for a, b in zip(edges[0::2], edges[1::2]):  # gaps, in time order
        if b <= a:
            continue
        mid = (a + b) / 2
        while k < len(spans) and spans[k].t0 <= mid:
            active.append(spans[k])
            k += 1
        active = [s for s in active if s.t0 + s.dur >= mid]
        name = max(active, key=lambda s: s.t0).name if active \
            else "no span"
        gaps[name] += b - a
    top = lambda d: [[k, v] for k, v in sorted(d.items(),  # noqa: E731
                                                key=lambda kv: -kv[1])[:10]]
    return {"device_ops": top(ops), "idle_gaps": top(gaps)}
