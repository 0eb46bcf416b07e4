"""Calibrated dispatch — a measured cost-model policy for engine choice
(PyTorch port of ``repro.core.calibrate``).

The paper's Algorithm 2 picks PTPE vs MapConcatenate from a hand-fitted
``f(N) = a/N + b`` (Eq. 2), a property of one 2009 GPU. This module
measures instead:

* ``measure_grid`` times every engine the port runs over a small
  (N, M, n, q) grid on the device it is given, warm-measured (the first
  ``warmup`` calls are discarded: the caching allocator's first
  allocations and the kernel library's load), each sample ending in the
  host copy of the counts, so every sample is synchronised.
* ``fit_table`` fits one least-squares cost model per engine over
  features seeded by ``analytic_seconds`` (the launch CLI passes the
  memory rates it measured on the device, ``launch.calibrate.measure_hw``),
  minimizing *relative* error: the dispatcher compares ratios.
* ``CalibrationTable`` round-trips through the reference's versioned JSON
  schema (a table document decodes in either package), written
  atomically, cached per device fingerprint.
* ``DispatchPolicy`` is the process-global consult point for
  ``hybrid.count_dispatch``, ``StreamingCounter`` and the batcher's
  fusion gate. With no table it is today's Eq. 2 heuristic exactly; with
  one, counts stay bit-identical — only the engine choice (and so wall
  clock) differs. (A streaming counter's engine does decide which window
  reports an occurrence: segment-parallel commits trail the window by W,
  in the reference too.) Every decision is exported as
  ``dispatch_policy_total{engine=...,source=calibrated|heuristic}``.

One process serves the CPU and the card. ``device_fingerprint(device)``
names the device a call runs on — on the card its name, the count of
cards and the shard count of the mesh in force; on the host
``"cpu:plain"`` (the kernels' plain versions) — and a table steers only
calls whose device has the table's fingerprint: a card table never steers
a CPU call, a one-card table never a 4-shard mesh.

Module-level imports stay stdlib (plus the stdlib ``repro_torch.obs``);
torch and numpy are imported where measurement and fitting need them.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import threading

from repro_torch.obs import REGISTRY

SCHEMA_VERSION = 1
# The reference's: a table document must decode in either package. Bump
# (in both) whenever the feature vector, analytic model or engine set
# changes.
CODE_VERSION = "cal1-feat6-eng4"

ENGINES = ("ptpe", "mapconcatenate", "mapconcat_kernel",
           "mapconcat_sharded")

# Feature vector for the per-engine linear model, scaled to O(1) at grid
# magnitudes so the least-squares system stays well conditioned.
FEATURE_NAMES = ("bias", "events", "episode_cells", "work", "segments",
                 "analytic_ms")
EPS_SECONDS = 1e-7

ENV_TABLE = "REPRO_POLICY_TABLE"
ENV_TABLE_DIR = "REPRO_CALIBRATION_DIR"
ENV_DATA_DIR = "REPRO_DATA_DIR"

# the fingerprint of every call on the host: the kernels' plain versions
CPU_FINGERPRINT = "cpu:plain"


def features(n_episode: int, m: int, n_events: int, q: int,
             analytic_s: float) -> list[float]:
    cells = float(m) * n_episode
    return [1.0,
            n_events / 4096.0,
            cells / 1024.0,
            cells * n_events / float(1 << 22),
            q / 8.0,
            analytic_s * 1e3]


def analytic_seconds(engine: str, n_episode: int, m: int, n_events: int,
                     q: int, devices: int, hw: dict) -> float:
    """Crude roofline seed for one dispatch (not a prediction — a
    *feature*; the fit supplies the device-specific scale).

    Every engine touches ~4 bytes per (event × episode-cell) interaction;
    the segment-parallel family adds a per-segment fold tuple (a, count,
    b) and the sharded form pays the gather between devices
    (``hw["ici_bw"]``) instead of device memory (``hw["hbm_bw"]``). The
    in-kernel fold halves effective traffic."""
    work_bytes = 4.0 * m * n_episode * n_events
    fold_bytes = 16.0 * m * n_episode * max(q, 1)
    t_work = work_bytes / hw["hbm_bw"]
    if engine == "ptpe":
        return t_work
    if engine == "mapconcatenate":
        return t_work + fold_bytes / hw["hbm_bw"]
    if engine == "mapconcat_kernel":
        return 0.5 * t_work + fold_bytes / hw["hbm_bw"]
    if engine == "mapconcat_sharded":
        return (0.5 * t_work / max(devices, 1)
                + fold_bytes / hw["ici_bw"])
    raise ValueError(f"unknown engine {engine!r}")


# --------------------------------------------------------------- grid spec


@dataclasses.dataclass(frozen=True)
class GridSpec:
    """The (N, M, n, q) calibration grid (the reference's). ``interval``
    bounds the inter-event constraint of the synthetic candidates, which
    makes the per-episode span W ≈ ``interval[1] * (N-1)``."""

    episode_sizes: tuple = (2, 3, 5)          # N
    episode_counts: tuple = (16, 128, 512)    # M
    event_counts: tuple = (1024, 4096)        # n
    segment_counts: tuple = (1, 4, 8)         # q (mapc engines only)
    interval: tuple = (5, 10)
    num_types: int = 26
    repeats: int = 3
    warmup: int = 1
    seed: int = 0

    @classmethod
    def smoke(cls) -> "GridSpec":
        """CI-sized grid: one warm-up + one timed sample per point, short
        streams."""
        return cls(episode_sizes=(2, 3), episode_counts=(16, 128),
                   event_counts=(512, 2048), segment_counts=(1, 4),
                   repeats=1)

    def max_span(self, n_episode: int) -> int:
        return self.interval[1] * max(n_episode - 1, 1)

    def points(self):
        """The grid's points as (N, M, n, q, W) tuples (no timing)."""
        out = []
        for n_ep in self.episode_sizes:
            for m in self.episode_counts:
                for n_ev in self.event_counts:
                    for q in self.segment_counts:
                        out.append((n_ep, m, n_ev, q,
                                    self.max_span(n_ep)))
        return out


# ------------------------------------------------------------------ table


def _atomic_write(path: str, text: str) -> None:
    d = os.path.dirname(path) or "."
    os.makedirs(d, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(text)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


@dataclasses.dataclass
class CalibrationTable:
    """Fitted per-engine cost model + the grid it was measured on."""

    device_kind: str               # the device fingerprint it was fitted on
    hw: dict                       # analytic constants used by the fit
    coeffs: dict                   # engine -> list[float] (FEATURE dim)
    grid: list                     # measured points (dicts)
    segment_counts: list           # q candidates the fit saw
    schema: int = SCHEMA_VERSION
    code_version: str = CODE_VERSION
    meta: dict = dataclasses.field(default_factory=dict)

    def predict(self, engine: str, *, n_episode: int, m: int,
                n_events: int, q: int = 1, devices: int = 1) -> float | None:
        """Predicted wall seconds for one dispatch; ``None`` for engines
        the calibration did not measure."""
        c = self.coeffs.get(engine)
        if c is None:
            return None
        a = analytic_seconds(engine, n_episode, m, n_events, q, devices,
                             self.hw)
        phi = features(n_episode, m, n_events, q, a)
        return max(sum(ci * xi for ci, xi in zip(c, phi)), EPS_SECONDS)

    def to_doc(self) -> dict:
        return {"schema": self.schema, "code_version": self.code_version,
                "device_kind": self.device_kind, "hw": self.hw,
                "features": list(FEATURE_NAMES), "coeffs": self.coeffs,
                "segment_counts": list(self.segment_counts),
                "grid": self.grid, "meta": self.meta}

    @classmethod
    def from_doc(cls, doc: dict) -> "CalibrationTable | None":
        """Decode + validate; ``None`` (never raise) on any mismatch so a
        stale cache degrades to the heuristic instead of crashing."""
        try:
            if doc.get("schema") != SCHEMA_VERSION:
                return None
            if doc.get("code_version") != CODE_VERSION:
                return None
            coeffs = {e: [float(x) for x in v]
                      for e, v in doc["coeffs"].items()}
            if any(len(v) != len(FEATURE_NAMES)
                   for v in coeffs.values()):
                return None
            return cls(device_kind=str(doc["device_kind"]),
                       hw={k: float(v) for k, v in doc["hw"].items()},
                       coeffs=coeffs, grid=list(doc.get("grid", [])),
                       segment_counts=[int(q) for q in
                                       doc.get("segment_counts", [1])],
                       schema=int(doc["schema"]),
                       code_version=str(doc["code_version"]),
                       meta=dict(doc.get("meta", {})))
        except (KeyError, TypeError, ValueError, AttributeError):
            return None

    def save(self, path: str) -> str:
        _atomic_write(path, json.dumps(self.to_doc(), indent=1))
        return path


def load_table(path: str) -> CalibrationTable | None:
    """Load + validate a cached table; ``None`` if missing/stale."""
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    return CalibrationTable.from_doc(doc)


_CARD_NAMES: dict[int, str] = {}


def device_fingerprint(device=None) -> str:
    """Cache key of the device a call runs on (default: the card, else the
    host): ``cuda:<name>x<cards>/shards<d>`` with ``d`` the shard count of
    the mesh in force (``core.mapconcat.shard_device_count``), or
    ``"cpu:plain"``. Timings of one never steer another."""
    import torch

    from .mapconcat import _home, shard_device_count
    dev = _home(device)
    if dev.type != "cuda":
        return CPU_FINGERPRINT
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    name = _CARD_NAMES.get(idx)
    if name is None:
        name = _CARD_NAMES[idx] = torch.cuda.get_device_properties(idx).name
    return (f"cuda:{name}x{torch.cuda.device_count()}"
            f"/shards{shard_device_count(dev)}")


def _table_filename(fingerprint: str) -> str:
    return re.sub(r"[^A-Za-z0-9._+-]", "_", fingerprint) + ".json"


def calibration_dir(data_dir: str | None = None) -> str:
    base = (data_dir or os.environ.get(ENV_TABLE_DIR)
            or os.path.join(os.environ.get(ENV_DATA_DIR, "serve-data"),
                            "calibration"))
    return base


def default_table_path(data_dir: str | None = None, device=None) -> str:
    """Per-fingerprint cache location under the service data dir."""
    return os.path.join(calibration_dir(data_dir),
                        _table_filename(device_fingerprint(device)))


# ------------------------------------------------------- measurement + fit


def available_engines(device=None) -> list[str]:
    """Engines a ``count_dispatch`` on ``device`` runs: the segmented
    kernel always engages in the port (``hybrid._mapc_kernel_available``),
    the sharded one where the mesh holds more than one shard."""
    from . import hybrid
    out = ["ptpe", "mapconcatenate"]
    if hybrid._mapc_kernel_available():
        out.append("mapconcat_kernel")
        if hybrid.shard_devices(device) > 1:
            out.append("mapconcat_sharded")
    return out


def _synth_stream(n_events: int, num_types: int, seed: int):
    import numpy as np

    from .events import EventStream
    rng = np.random.default_rng(seed)
    dt = rng.integers(1, 4, size=n_events)
    return EventStream(
        types=rng.integers(0, num_types, size=n_events).astype(np.int32),
        times=np.cumsum(dt).astype(np.int32), num_types=num_types)


def _synth_episodes(m: int, n_episode: int, num_types: int,
                    interval: tuple, seed: int):
    import numpy as np

    from .episodes import EpisodeBatch
    rng = np.random.default_rng(seed)
    et = rng.integers(0, num_types,
                      size=(m, n_episode)).astype(np.int32)
    tlo = np.full((m, n_episode - 1), interval[0], np.int32)
    thi = np.full((m, n_episode - 1), interval[1], np.int32)
    return EpisodeBatch(et, tlo, thi)


def measure_grid(spec: GridSpec | None = None, *,
                 engines: list[str] | None = None,
                 progress=None, device=None) -> list[dict]:
    """Time every available engine over the grid on ``device`` (default:
    the card).

    Returns one dict per (engine, N, M, n, q) point. Warm-measured: the
    first ``spec.warmup`` calls are discarded, the median of
    ``spec.repeats`` timed calls is kept. ``count_dispatch`` ends in the
    host copy of the counts, so every sample covers the device's work.
    """
    import time as _time

    import numpy as np

    from . import hybrid
    spec = spec or GridSpec()
    engines = (list(engines) if engines is not None
               else available_engines(device))
    devices = hybrid.shard_devices(device)
    streams = {n: _synth_stream(n, spec.num_types, spec.seed + n)
               for n in spec.event_counts}
    points: list[dict] = []
    for engine in engines:
        qs = spec.segment_counts if engine != "ptpe" else (1,)
        for n_ep in spec.episode_sizes:
            for m in spec.episode_counts:
                eps = _synth_episodes(m, n_ep, spec.num_types,
                                      spec.interval,
                                      spec.seed + n_ep * 1000 + m)
                for n_ev in spec.event_counts:
                    stream = streams[n_ev]
                    for q in qs:
                        def run():
                            return np.asarray(hybrid.count_dispatch(
                                stream, eps, engine=engine,
                                num_segments=q, device=device))
                        for _ in range(spec.warmup):
                            run()
                        ts = []
                        for _ in range(spec.repeats):
                            t0 = _time.perf_counter()
                            run()
                            ts.append(_time.perf_counter() - t0)
                        sec = float(np.median(ts))
                        pt = {"engine": engine, "n_episode": n_ep,
                              "m": m, "n_events": n_ev, "q": q,
                              "devices": devices,
                              "seconds": round(sec, 6)}
                        points.append(pt)
                        if progress is not None:
                            progress(pt)
    return points


def fit_table(points: list[dict], hw: dict, *,
              device_kind: str | None = None,
              meta: dict | None = None, device=None) -> CalibrationTable:
    """Per-engine least squares over ``features``, weighted by 1/t so the
    fit minimizes *relative* error (numpy's ``lstsq``, as the reference:
    the same points give the same coefficients in both packages).
    ``device_kind`` defaults to ``device``'s fingerprint."""
    import numpy as np
    coeffs: dict[str, list[float]] = {}
    qs = sorted({int(p["q"]) for p in points}) or [1]
    for engine in ENGINES:
        rows = [p for p in points if p["engine"] == engine]
        if len(rows) < len(FEATURE_NAMES):
            continue
        x = np.array([features(p["n_episode"], p["m"], p["n_events"],
                               p["q"],
                               analytic_seconds(engine, p["n_episode"],
                                                p["m"], p["n_events"],
                                                p["q"],
                                                p.get("devices", 1), hw))
                      for p in rows])
        y = np.array([max(p["seconds"], EPS_SECONDS) for p in rows])
        w = 1.0 / y
        c, *_ = np.linalg.lstsq(x * w[:, None], np.ones_like(y),
                                rcond=None)
        coeffs[engine] = [float(v) for v in c]
    kind = (device_kind if device_kind is not None
            else device_fingerprint(device))
    return CalibrationTable(device_kind=kind, hw=dict(hw), coeffs=coeffs,
                            grid=list(points), segment_counts=qs,
                            meta=dict(meta or {}))


# ----------------------------------------------------------------- policy


@dataclasses.dataclass(frozen=True)
class DispatchChoice:
    engine: str
    num_segments: int
    source: str                    # "calibrated" | "heuristic"
    predicted_s: float | None = None


def _bucket(n: int) -> int:
    return 1 << max(int(n) - 1, 1).bit_length()


class DispatchPolicy:
    """Engine/q selection consulted by hybrid, streaming and the batcher.
    Stateless apart from a per-(fingerprint, shape) cache of calibrated
    decisions (dispatch runs per window commit — the consult must cost a
    dict lookup, not a model evaluation). A table steers only calls on a
    device with its fingerprint; every other call takes Eq. 2."""

    def __init__(self, table: CalibrationTable | None = None,
                 path: str | None = None):
        self.table = table
        self.path = path
        self._cache: dict = {}

    @property
    def source(self) -> str:
        return "calibrated" if self.table is not None else "heuristic"

    def _record(self, choice: DispatchChoice) -> DispatchChoice:
        REGISTRY.counter("dispatch_policy_total", engine=choice.engine,
                         source=choice.source).inc()
        return choice

    def _steers(self, device) -> str | None:
        """The call's fingerprint when the table may steer it, else None."""
        if self.table is None:
            return None
        fp = device_fingerprint(device)
        return fp if fp == self.table.device_kind else None

    # ------------------------------------------------------ one-shot path

    def choose(self, *, n_events: int, n_episode: int, m: int,
               shard_devices: int = 1, default_segments: int = 8,
               device=None) -> DispatchChoice:
        """Engine + segment count for one ``count_dispatch`` call;
        ``shard_devices`` is the mesh width the segment axis can shard
        over (``hybrid.shard_devices``), ``device`` the caller's."""
        fp = self._steers(device)
        if fp is None:
            return self._record(self._heuristic_choice(
                n_events=n_events, n_episode=n_episode, m=m,
                shard_devices=shard_devices,
                default_segments=default_segments, device=device))
        key = ("one", fp, n_episode, m, _bucket(n_events), shard_devices,
               default_segments)
        choice = self._cache.get(key)
        if choice is None:
            choice = self._calibrated_choice(
                n_events=n_events, n_episode=n_episode, m=m,
                shard_devices=shard_devices,
                default_segments=default_segments, device=device)
            self._cache[key] = choice
        return self._record(choice)

    def _candidates(self, *, shard_devices: int) -> list[tuple[str, int]]:
        from . import hybrid
        qs = [max(int(q), 1) for q in (self.table.segment_counts or [1])]
        cands = [("ptpe", 1)]
        cands += [("mapconcatenate", q) for q in qs]
        if hybrid._mapc_kernel_available():
            cands += [("mapconcat_kernel", q) for q in qs]
            if shard_devices > 1:
                cands += [("mapconcat_sharded", q) for q in qs]
        return cands

    def _calibrated_choice(self, *, n_events, n_episode, m, shard_devices,
                           default_segments, device) -> DispatchChoice:
        best = None
        n_b = _bucket(n_events)
        for engine, q in self._candidates(shard_devices=shard_devices):
            t = self.table.predict(engine, n_episode=n_episode, m=m,
                                   n_events=n_b, q=q,
                                   devices=shard_devices)
            if t is not None and (best is None or t < best[2]):
                best = (engine, q, t)
        if best is None:
            return self._heuristic_choice(
                n_events=n_events, n_episode=n_episode, m=m,
                shard_devices=shard_devices,
                default_segments=default_segments, device=device)
        return DispatchChoice(best[0], best[1], "calibrated", best[2])

    def _heuristic_choice(self, *, n_events, n_episode, m, shard_devices,
                          default_segments, device) -> DispatchChoice:
        """Eq. 2 (see ``hybrid``): PTPE above the capacity-scaled
        crossover, the segmented kernel — sharded over the mesh when it
        holds more than one device — where the stream is long and the
        batch cannot fill a tile of episodes."""
        from . import hybrid
        mapc_kernel = (hybrid._mapc_kernel_available()
                       and n_events >= hybrid.MAPC_KERNEL_MIN_EVENTS)
        kern = ("mapconcat_sharded" if shard_devices > 1
                else "mapconcat_kernel")
        if m > hybrid.crossover(n_episode, device):
            if mapc_kernel and m <= hybrid.MAPC_KERNEL_MAX_EPISODES:
                engine = kern
            else:
                engine = "ptpe"
        elif mapc_kernel:
            engine = kern
        else:
            engine = "mapconcatenate"
        return DispatchChoice(engine, default_segments, "heuristic")

    # ----------------------------------------------------- streaming path

    def choose_stream(self, *, n_episode: int, m: int,
                      shard_devices: int = 1, n_hint: int | None = None,
                      device=None) -> DispatchChoice:
        """Resolve a streaming counter's ``hybrid`` to ptpe or the
        segment-parallel engine (whose commits ``StreamingCounter`` shards
        itself when the mesh is wider than one device). ``n_hint``
        defaults to the largest calibrated stream length — streaming is
        the long-stream regime by construction."""
        fp = self._steers(device)
        if fp is None:
            return self._record(self._stream_heuristic(n_episode, m,
                                                       device))
        key = ("stream", fp, n_episode, m, shard_devices, n_hint)
        choice = self._cache.get(key)
        if choice is None:
            choice = self._stream_choice(
                n_episode=n_episode, m=m, shard_devices=shard_devices,
                n_hint=n_hint, device=device)
            self._cache[key] = choice
        return self._record(choice)

    def _stream_choice(self, *, n_episode, m, shard_devices, n_hint,
                       device) -> DispatchChoice:
        n = n_hint or max((p["n_events"] for p in self.table.grid),
                          default=4096)
        t_ptpe = self.table.predict("ptpe", n_episode=n_episode, m=m,
                                    n_events=n, q=1,
                                    devices=shard_devices)
        best_mapc = None
        for engine, q in self._candidates(shard_devices=shard_devices):
            if engine == "ptpe":
                continue
            t = self.table.predict(engine, n_episode=n_episode, m=m,
                                   n_events=n, q=q,
                                   devices=shard_devices)
            if t is not None and (best_mapc is None or t < best_mapc):
                best_mapc = t
        if t_ptpe is None and best_mapc is None:
            return self._stream_heuristic(n_episode, m, device)
        if best_mapc is None or (t_ptpe is not None
                                 and t_ptpe <= best_mapc):
            return DispatchChoice("ptpe", 0, "calibrated", t_ptpe)
        return DispatchChoice("mapconcatenate", 0, "calibrated",
                              best_mapc)

    def _stream_heuristic(self, n_episode: int, m: int,
                          device=None) -> DispatchChoice:
        from . import hybrid
        engine = ("ptpe" if m > hybrid.crossover(n_episode, device)
                  else "mapconcatenate")
        return DispatchChoice(engine, 0, "heuristic")

    def choose_segments(self, candidates: list[int], *, engine: str,
                        n_episode: int, m: int, n_events: int,
                        devices: int = 1,
                        device=None) -> tuple[int, str]:
        """Pick a segment count from the caller's *safety-filtered*
        candidate list (stitch bounds stay the caller's job). The
        heuristic keeps the caller's first preference."""
        if not candidates:
            raise ValueError("empty segment candidate list")
        fp = self._steers(device)
        if fp is None:
            return candidates[0], "heuristic"
        key = ("q", fp, engine, n_episode, m, _bucket(n_events),
               tuple(candidates), devices)
        got = self._cache.get(key)
        if got is None:
            n_b = _bucket(n_events)
            scored = []
            for q in candidates:
                t = self.table.predict(engine, n_episode=n_episode, m=m,
                                       n_events=n_b, q=q,
                                       devices=devices)
                if t is not None:
                    scored.append((t, q))
            got = ((min(scored)[1], "calibrated") if scored
                   else (candidates[0], "heuristic"))
            self._cache[key] = got
        return got

    # -------------------------------------------------- fusion-gate prior

    def predict_single(self, engine: str, *, n_episode: int, m: int,
                       n_events: int | None = None, q: int = 1,
                       devices: int = 1, device=None) -> float | None:
        """Calibrated single-launch estimate for the batcher's fusion gate
        (``None`` under the heuristic or on another device: the gate keeps
        its optimistic fuse-first prior). ``n_events`` defaults to the
        largest calibrated stream length — seam keys hold no event
        length."""
        if self._steers(device) is None:
            return None
        if n_events is None:
            n_events = max((p["n_events"] for p in self.table.grid),
                           default=4096)
        return self.table.predict(engine, n_episode=n_episode, m=m,
                                  n_events=_bucket(n_events), q=q,
                                  devices=devices)

    def stats(self) -> dict:
        out = {"source": self.source, "table_path": self.path,
               "device_kind": (self.table.device_kind
                               if self.table else None),
               "code_version": (self.table.code_version
                                if self.table else CODE_VERSION),
               "grid_points": len(self.table.grid) if self.table else 0,
               "engines": (sorted(self.table.coeffs)
                           if self.table else []),
               "decisions": {}}
        for labels, metric in REGISTRY.family_items(
                "dispatch_policy_total"):
            k = (f"{labels.get('engine', '?')}/"
                 f"{labels.get('source', '?')}")
            out["decisions"][k] = (out["decisions"].get(k, 0)
                                   + metric.value)
        return out


# ------------------------------------------------------- process singleton

_POLICY_LOCK = threading.Lock()
_POLICY: DispatchPolicy | None = None


def get_policy() -> DispatchPolicy:
    """The process-global policy. Resolution order: an explicitly
    installed table (``set_policy``/``install_table``), then the
    ``REPRO_POLICY_TABLE`` / ``REPRO_CALIBRATION_DIR`` environment
    opt-ins, else the heuristic. There is deliberately no implicit
    cwd-relative auto-load: a table changes dispatch and must be asked
    for."""
    global _POLICY
    pol = _POLICY
    if pol is None:
        with _POLICY_LOCK:
            pol = _POLICY
            if pol is None:
                pol = _POLICY = _bootstrap_policy()
    return pol


def _bootstrap_policy() -> DispatchPolicy:
    """The environment's table, checked against the process's default
    device (the card, else the host)."""
    path = os.environ.get(ENV_TABLE)
    if path:
        table = load_table(path)
        if table is not None and _matches_device(table):
            return DispatchPolicy(table, path)
        return DispatchPolicy()
    cal_dir = os.environ.get(ENV_TABLE_DIR)
    if cal_dir:
        try:
            path = os.path.join(cal_dir,
                                _table_filename(device_fingerprint()))
        except Exception:
            return DispatchPolicy()
        table = load_table(path)
        if table is not None:
            return DispatchPolicy(table, path)
    return DispatchPolicy()


def _matches_device(table: CalibrationTable, device=None) -> bool:
    try:
        return table.device_kind == device_fingerprint(device)
    except Exception:
        return False


def set_policy(policy: DispatchPolicy | None) -> None:
    """Install (or with ``None`` reset) the process policy."""
    global _POLICY
    with _POLICY_LOCK:
        _POLICY = policy


def clear_policy() -> None:
    set_policy(None)


def install_table(table_or_path, *, require_device_match: bool = True,
                  device=None) -> DispatchPolicy:
    """Install a calibration table as the process policy. A stale table,
    or one fitted on another device than ``device`` (default: the card,
    else the host), degrades to the heuristic (and says so in
    ``stats()``) rather than steering with foreign timings."""
    if isinstance(table_or_path, CalibrationTable):
        table, path = table_or_path, None
    else:
        path = str(table_or_path)
        table = load_table(path)
    if table is not None and require_device_match \
            and not _matches_device(table, device):
        table = None
    pol = DispatchPolicy(table, path)
    set_policy(pol)
    return pol


def policy_stats() -> dict:
    return get_policy().stats()


def calibrate_and_save(spec: GridSpec | None = None, *,
                       hw: dict, out_path: str | None = None,
                       data_dir: str | None = None, progress=None,
                       install: bool = True,
                       device=None) -> tuple[CalibrationTable, str]:
    """One-shot calibration on ``device`` (default: the card): measure,
    fit, cache atomically per fingerprint, and (by default) install as the
    process policy."""
    spec = spec or GridSpec()
    points = measure_grid(spec, progress=progress, device=device)
    table = fit_table(points, hw, device=device,
                      meta={"spec": dataclasses.asdict(spec)})
    path = out_path or default_table_path(data_dir, device)
    table.save(path)
    if install:
        set_policy(DispatchPolicy(table, path))
    return table, path
