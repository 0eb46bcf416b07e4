"""Pass 2 — run-time hot-path auditor (rules TR201–TR205), the port of
``repro.analysis.tracecheck`` restated for PyTorch and the CUDA kernels.

The reference traces jaxprs and compiled HLO. The port has no trace to
read: it runs the counting entry points on small inputs and watches what
they do.

  TR201  (card only) a host synchronisation inside one ``ptpe`` streaming
         commit (``StreamingCounter``'s dispatch of a window: K2, the
         bounded-list counter), apart from its one read of the counts,
         which is made outside: the commit runs under
         ``torch.cuda.set_sync_debug_mode("error")``.
  TR202  a carried state tensor or an output of a counting entry point
         (K1–K6d's wrappers) that is not int32, on small shapes inside the
         fast templates' envelope and outside it.
  TR203  (card only) TR201 for a segment-parallel commit
         (``mapconcatenate``: K4 and its fold).
  TR204  a state-carrying entry point (K1, K2, K6a, K6b) that does not
         advance its state in place: a state tensor whose ``data_ptr()``
         changed, or a state left as it was by events that advance it.
  TR205  the kernel libraries loaded more than once a process
         (``kernels/cuda.py``'s cache), or built while serving: over a
         10-window streaming session per engine, on the CPU no call of
         ``cuda.library`` at all (the plain versions run); on the card no
         library loaded twice and no file added under ``build/kernels/``.

The summary's ``hlo_traffic`` holds ``launch.op_analysis``'s totals of
the plain A1 and A2 counters on the small inputs, under the keys of the
reference's ``audit_hlo``.

Findings carry the source line of the code at fault where there is one
(a synchronising call), so an ``# audit-ok:`` marker there waives them.
Unlike Passes 1 and 3 this pass imports torch and the engines.
"""

from __future__ import annotations

import contextlib
import pathlib
import traceback

import numpy as np

from .findings import Finding

# (N, LCAP) of the small inputs: inside the fast templates' envelope, and
# outside it (the generic instantiations)
SHAPES = ((3, 4), (9, 3))
_ALLOWED_DTYPES = {"torch.int32"}
_PACKAGE = "repro_torch"


def _small_inputs(n, lcap, device, m=2, e=24):
    """Tiny episodes and events on ``device``: ``m`` episodes of ``n``
    levels whose types cycle through 0..n-1 (episode j starts at type j),
    windows (0, 5], and ``e`` events cycling through the same types one
    tick apart, so every level advances and the episodes complete.
    Returns (EpisodeBatch, EventStream)."""
    from repro_torch.core import EpisodeBatch, EventStream
    et = ((np.arange(n)[None] + np.arange(m)[:, None]) % n).astype(np.int32)
    eps = EpisodeBatch(et, np.zeros((m, n - 1), np.int32),
                       np.full((m, n - 1), 5, np.int32))
    types = (np.arange(e) % n).astype(np.int32)
    times = np.arange(1, e + 1, dtype=np.int32)
    return eps, EventStream(types, times, n)


def entry_points(n, lcap, device):
    """name -> (run, state): ``run()`` calls one counting entry point on
    ``_small_inputs`` and returns its outputs; ``state`` lists the tensors
    it carries (advanced in place), empty for the fresh-state ones."""
    from repro_torch.core import init_a1_state, init_a2_state
    from repro_torch.core.mapconcat import cut_windows
    from repro_torch.kernels import a1_count as k_a1
    from repro_torch.kernels import a2_count as k_a2
    from repro_torch.kernels import ops

    eps, stream = _small_inputs(n, lcap, device)
    ev = ops.event_brick(stream.types, stream.times, with_dup=True,
                         device=device)
    lay2 = ops.episode_layout(eps.relaxed(), True, device)
    lay1 = ops.episode_layout(eps, False, device)
    st2 = list(ops.a2_state_layout(init_a2_state(eps.relaxed(), device),
                                   device))
    st1 = list(ops.a1_state_layout(init_a1_state(eps, lcap, device),
                                   device))
    lane2 = list(ops.a2_state_layout(init_a2_state(eps.relaxed(), device),
                                     device))
    lane1 = list(ops.a1_state_layout(init_a1_state(eps, lcap, device),
                                     device))
    # two equal segments, whatever the stream's span against W
    tau = np.round(np.linspace(int(stream.times[0]) - 1,
                               int(stream.times[-1]), 3)).astype(np.int64)
    wt, wtt = cut_windows(stream.types, stream.times, tau,
                          int(eps.max_span.max()))
    segs = ops.segment_bricks(wt, wtt, tau, device)
    m1 = (*ops.mapconcat_layout(eps, False, device), segs)
    m2 = (*ops.mapconcat_layout(eps.relaxed(), True, device), segs)
    mesh = [device] * 2
    k = len(stream.types)
    return {
        "kernels.a2_count_state": (
            lambda: list(k_a2.a2_count_state(*lay2, ev, *st2)), st2),
        "kernels.a1_count_state": (
            lambda: list(k_a1.a1_count_state(*lay1, ev, *st1)), st1),
        "kernels.a2_count_state_lanes": (
            lambda: k_a2.a2_count_state_lanes([((*lay2, ev, *lane2), k)]),
            lane2),
        "kernels.a1_count_state_lanes": (
            lambda: k_a1.a1_count_state_lanes([((*lay1, ev, *lane1), k)]),
            lane1),
        "kernels.a2_mapconcat_kernel": (
            lambda: list(k_a2.a2_mapconcat_kernel(*m2)), []),
        "kernels.a1_mapconcat_kernel": (
            lambda: list(k_a1.a1_mapconcat_kernel(*m1, lcap=lcap)), []),
        "kernels.a1_mapconcat_lanes": (
            lambda: [x for o in k_a1.a1_mapconcat_lanes([m1, m1], lcap=lcap)
                     for x in o], []),
        "kernels.a2_mapconcat_sharded": (
            lambda: list(k_a2.a2_mapconcat_sharded(*m2, devices=mesh)), []),
        "kernels.a1_mapconcat_sharded": (
            lambda: list(k_a1.a1_mapconcat_sharded(*m1, lcap=lcap,
                                                   devices=mesh)), []),
        "kernels.a1_mapconcat_sharded_lanes": (
            lambda: [x for o in k_a1.a1_mapconcat_sharded_lanes(
                [m1, m1], lcap=lcap, devices=mesh) for x in o], []),
    }


def devices() -> list:
    """The devices the pass runs on: the CPU (the plain versions) and,
    where there is one, the card (the kernels)."""
    import torch
    return ["cpu"] + (["cuda"] if torch.cuda.is_available() else [])


def audit_entries(entries, device, label) -> list[Finding]:
    """TR202 and TR204 over ``entries`` ({name: (run, state)}, as
    ``entry_points`` builds them) on ``device``; ``label`` goes into each
    finding's place."""
    import torch
    findings = []
    for name, (run, state) in entries.items():
        where = f"{name}[{device}, {label}]"
        before = [x.clone() for x in state]
        ptrs = [x.data_ptr() for x in state]
        outs = run() or []
        if device != "cpu":
            torch.cuda.synchronize()
        bad = sorted({str(x.dtype) for x in [*outs, *state]}
                     - _ALLOWED_DTYPES)
        if bad:
            findings.append(Finding(
                "TR202", where, 0,
                f"non-int32 dtypes {bad} in a counting entry point's "
                "state or outputs"))
        if state and [x.data_ptr() for x in state] != ptrs:
            findings.append(Finding(
                "TR204", where, 0,
                "a carried state tensor was reallocated — the kernel "
                "advances its state in place"))
        if state and all(torch.equal(a, b) for a, b in zip(state, before)):
            findings.append(Finding(
                "TR204", where, 0,
                "the carried state did not advance over events that "
                "advance it"))
    return findings


def audit_entry_points() -> tuple[list[Finding], dict]:
    """TR202 (int32 state and outputs) and TR204 (state advanced in
    place) over every entry point, at each of ``SHAPES``, on every device
    of ``devices``."""
    findings, traced = [], []
    for device in devices():
        for n, lcap in SHAPES:
            entries = entry_points(n, lcap, device)
            label = f"N={n}, LCAP={lcap}"
            findings.extend(audit_entries(entries, device, label))
            traced += [f"{name}[{device}, {label}]" for name in entries]
    return findings, {"entry_points_run": traced}


def _fault_site(exc: BaseException) -> tuple[str, int, str]:
    """The innermost frame of this package in ``exc``'s traceback: (path
    relative to the package's parent, line, the chain of the package's
    frames)."""
    frames = [f for f in traceback.extract_tb(exc.__traceback__)
              if f"/{_PACKAGE}/" in f.filename.replace("\\", "/")]
    if not frames:
        return "<torch>", 0, str(exc)
    last = frames[-1]
    path = last.filename.replace("\\", "/")
    rel = path[path.rindex(f"/{_PACKAGE}/") + 1:]
    chain = " <- ".join(f"{pathlib.Path(f.filename).name}:{f.lineno} "
                        f"{f.name}" for f in reversed(frames))
    return rel, last.lineno, chain


def audit_syncs() -> tuple[list[Finding], dict]:
    """TR201 and TR203 (card only): one commit of a ``ptpe`` and of a
    ``mapconcatenate`` streaming counter, after a warm-up window, under
    ``torch.cuda.set_sync_debug_mode("error")``; the counts are read
    after it. A synchronising call in the commit is a finding at its
    source line."""
    import torch
    if not torch.cuda.is_available():
        return [], {"sync_audit": "skipped: no CUDA device"}
    from repro_torch.core import EventStream
    from repro_torch.core.streaming import StreamingCounter
    findings, checked = [], []
    for rule, engine in (("TR201", "ptpe"), ("TR203", "mapconcatenate")):
        for n, lcap in SHAPES:
            eps, stream = _small_inputs(n, lcap, "cuda", e=48)
            half = len(stream.types) // 2
            wins = [EventStream(stream.types[a:b], stream.times[a:b], n)
                    for a, b in ((0, half), (half, len(stream.types)))]
            counter = StreamingCounter(eps, engine=engine, lcap=lcap,
                                       num_segments=2, device="cuda")
            counter.update(wins[0])
            torch.cuda.synchronize()
            prev = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            try:
                counter._dispatch(counter._prepare(wins[1], False))
            except RuntimeError as exc:
                path, line, chain = _fault_site(exc)
                findings.append(Finding(
                    rule, path, line,
                    f"{engine} commit at N={n}, LCAP={lcap} synchronises "
                    f"with the host: {chain}"))
            finally:
                torch.cuda.set_sync_debug_mode(prev)
            counter._snapshot()  # the commit's one read of the counts
            checked.append(f"{engine}[N={n}, LCAP={lcap}]")
    return findings, {"sync_commits_checked": checked}


def audit_traffic() -> tuple[list[Finding], dict]:
    """The op-analysis totals (``launch.op_analysis``) of the plain A1 and
    A2 counters on ``_small_inputs`` at the first of ``SHAPES``, on the
    CPU, keyed as the reference's ``audit_hlo`` keys its scan cores."""
    from repro_torch.core.count_a1 import count_a1_vectorized
    from repro_torch.core.count_a2 import count_single_slot
    from repro_torch.launch.op_analysis import analyze

    n, lcap = SHAPES[0]
    eps, stream = _small_inputs(n, lcap, "cpu")
    cases = {
        "count_a1._a1_scan_core": (count_a1_vectorized, (stream, eps),
                                   {"lcap": lcap, "device": "cpu"}),
        "count_a2._a2_scan_core": (count_single_slot, (stream, eps),
                                   {"device": "cpu"}),
    }
    traffic = {name: analyze(fn, args, kw).to_json()
               for name, (fn, args, kw) in cases.items()}
    return [], {"hlo_traffic": traffic}


@contextlib.contextmanager
def _library_log():
    """Count ``cuda.library`` calls, and the loads among them (a name not
    yet in the process's cache), for the block."""
    from repro_torch.kernels import cuda
    log = {"calls": 0, "loads": []}
    real = cuda.library

    def counted(name, signatures):
        log["calls"] += 1
        if name not in cuda._LIBS:
            log["loads"].append(name)
        return real(name, signatures)

    cuda.library = counted
    try:
        yield log
    finally:
        cuda.library = real


def library_sentinel(n_windows: int = 10) -> tuple[list[Finding], dict]:
    """TR205 — a scripted ``n_windows``-window streaming session per
    engine on every device of ``devices``, with ``cuda.library`` counted
    and ``build/kernels/`` listed before and after."""
    from repro_torch.core import EpisodeBatch, EventStream
    from repro_torch.core.streaming import StreamingCounter
    from repro_torch.kernels import cuda

    eps = EpisodeBatch(etypes=np.array([[0, 1, 2], [1, 2, 3]], np.int32),
                       tlo=np.zeros((2, 2), np.int32),
                       thi=np.full((2, 2), 8, np.int32))
    rng = np.random.default_rng(7)

    def windows():
        t0 = 0
        for _ in range(n_windows):
            k = int(rng.integers(40, 90))
            tt = np.sort(rng.integers(t0, t0 + 500, k)).astype(np.int32)
            ty = rng.integers(0, 4, k).astype(np.int32)
            t0 += 500
            yield EventStream(types=ty, times=tt, num_types=4)

    def built():
        return (sorted(p.name for p in cuda.BUILD_DIR.glob("*"))
                if cuda.BUILD_DIR.is_dir() else [])

    findings, summary = [], {}
    for device in devices():
        if device != "cpu":
            cuda.build_all()  # the build belongs before serving
        before = built()
        with _library_log() as log:
            for engine in ("ptpe", "mapconcatenate"):
                sc = StreamingCounter(eps, engine=engine, device=device)
                for win in windows():
                    sc.update(win)
                sc.finalize()
        added = sorted(set(built()) - set(before))
        summary[f"library_calls_{device}"] = log["calls"]
        summary[f"library_loads_{device}"] = log["loads"]
        if device == "cpu" and log["calls"]:
            findings.append(Finding(
                "TR205", "repro_torch/kernels/cuda.py", 0,
                f"a CPU streaming session called cuda.library "
                f"{log['calls']} times — the plain versions load nothing"))
        twice = sorted({x for x in log["loads"]
                        if log["loads"].count(x) > 1})
        if device != "cpu" and twice:
            findings.append(Finding(
                "TR205", "repro_torch/kernels/cuda.py", 0,
                f"libraries loaded more than once a process: {twice}"))
        if added:
            findings.append(Finding(
                "TR205", "repro_torch/kernels/cuda.py", 0,
                f"files added under build/kernels/ while serving on "
                f"{device}: {added}"))
    summary["sentinel_windows"] = n_windows
    return findings, summary


def run(sentinel: bool = True):
    """All of Pass 2. Returns (findings, summary)."""
    findings, summary = audit_entry_points()
    for fn in (audit_traffic, audit_syncs) + \
            ((library_sentinel,) if sentinel else ()):
        f, s = fn()
        findings.extend(f)
        summary.update(s)
    return findings, summary
