"""Device-side observability hooks (port of ``repro.obs.jaxprof``; torch is
imported when a hook is used, so ``repro_torch.obs`` stays stdlib).

* ``annotate(name, device)`` — a ``torch.profiler.record_function`` range
  around an instrumented kernel entry point and, for a CUDA device, an
  NVTX range, so a device timeline captured with ``capture_step`` (or any
  profiler session) carries the dispatch names the host spans use. Both
  ranges are host-side markers: no synchronisation, no device allocation.

* ``capture_step(profile_dir)`` — one ``torch.profiler`` session (CPU
  activity of every thread, and CUDA's where a card is present) around a
  block (``mine_serve --profile-dir`` wraps one scheduler step in it),
  written as a Chrome trace into ``profile_dir``. Capture failures count into
  ``profiler_capture_errors`` instead of raising: profiling must never
  take down the serving loop.

The reference's recompile listener has no counterpart: the port compiles
nothing while it serves (its kernels are built once, before the first
launch).
"""

from __future__ import annotations

import contextlib
import itertools
import os

from .registry import REGISTRY

_CAPTURES = itertools.count()


@contextlib.contextmanager
def _nvtx(name: str):
    import torch
    torch.cuda.nvtx.range_push(name)
    try:
        yield
    finally:
        torch.cuda.nvtx.range_pop()


@contextlib.contextmanager
def annotate(name: str, device=None):
    """Name the enclosed dispatch on the profiler's timeline; on a CUDA
    ``device`` also as an NVTX range."""
    import torch
    with torch.profiler.record_function(name):
        if device is not None and torch.device(device).type == "cuda":
            with _nvtx(name):
                yield
        else:
            yield


def _all_threads() -> dict:
    """Profiler options that record every thread's ranges, not only the
    calling thread's (the service steps its sessions in worker threads);
    none where this torch lacks the option (the card's kernels are traced
    from every thread either way)."""
    import torch
    try:
        return {"experimental_config": torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True)}
    except (AttributeError, TypeError):
        return {}


@contextlib.contextmanager
def capture_step(profile_dir):
    """Capture one ``torch.profiler`` trace of the enclosed block into
    ``profile_dir`` as ``step-<pid>-<n>.json`` (Chrome trace events:
    Perfetto, ``chrome://tracing``). Never raises out of the capture
    machinery itself."""
    prof = None
    try:
        import torch
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        os.makedirs(str(profile_dir), exist_ok=True)
        prof = profile(activities=activities, **_all_threads())
        prof.__enter__()
    except Exception:
        prof = None
        REGISTRY.counter("profiler_capture_errors").inc()
    try:
        yield
    finally:
        if prof is not None:
            try:
                prof.__exit__(None, None, None)
                prof.export_chrome_trace(os.path.join(
                    str(profile_dir),
                    f"step-{os.getpid()}-{next(_CAPTURES)}.json"))
            except Exception:
                REGISTRY.counter("profiler_capture_errors").inc()
