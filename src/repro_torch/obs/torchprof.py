"""Device-side observability hooks (port of ``repro.obs.jaxprof``; torch is
imported when a hook is used, so ``repro_torch.obs`` stays stdlib).

* ``annotate(name, device)`` — a ``torch.profiler.record_function`` range
  around an instrumented kernel entry point and, for a CUDA device, an
  NVTX range, so a device timeline captured with ``capture_step`` (or any
  profiler session) carries the dispatch names the host spans use. Both
  ranges are host-side markers: no synchronisation, no device allocation.
  It also keeps the recompile listener armed.

* ``ensure_recompile_listener()`` — the always-on count of compiles, in
  the ``REGISTRY`` counter ``recompiles{kernel=<name>}``. In the port a
  compile is a build of a CUDA kernel library by ``nvcc`` or a load of
  one (``kernels/cuda.py``: a library is built and loaded at the first
  use of any of its template or generic instantiations), each logged on
  the ``repro_torch.kernels.cuda`` logger, and a ``torch.compile``
  (dynamo) compile, should one ever run (``kernel=torch.compile``).
  Idempotent and self-healing: every call re-attaches the handler,
  restores the logger's level and re-registers the dynamo hook if any of
  them was undone. The logger gets ``propagate=False``: the records are
  counted, not printed.

* ``capture_step(profile_dir)`` — one ``torch.profiler`` session (CPU
  activity of every thread, and CUDA's where a card is present) around a
  block (``mine_serve --profile-dir`` wraps one scheduler step in it),
  written as a Chrome trace into ``profile_dir``. Capture failures count into
  ``profiler_capture_errors`` instead of raising: profiling must never
  take down the serving loop.
"""

from __future__ import annotations

import contextlib
import itertools
import logging
import os
import re
import sys

from .registry import REGISTRY

_CAPTURES = itertools.count()

# the record ``kernels/cuda.py`` logs for each library it builds or loads
_COMPILE_RE = re.compile(r"(?:Compiling|Loading) ([\w.<>-]+)")
_LOGGER_NAME = "repro_torch.kernels.cuda"
DYNAMO_KERNEL = "torch.compile"

_HANDLER: _RecompileHandler | None = None


class _RecompileHandler(logging.Handler):
    def __init__(self):
        super().__init__(level=logging.INFO)

    def emit(self, record):
        m = _COMPILE_RE.search(record.getMessage())
        if m:
            REGISTRY.counter("recompiles", kernel=m.group(1)).inc()


def _on_dynamo_compile(_args) -> None:
    REGISTRY.counter("recompiles", kernel=DYNAMO_KERNEL).inc()


def ensure_recompile_listener() -> bool:
    """Install (or re-arm) the recompilation listener. Returns True when
    the listener is active. Safe to call per dispatch: after the first
    install it is a few lookups. The dynamo hook is registered once
    ``torch._dynamo`` has been imported (``torch.compile`` imports it);
    the listener never imports it itself."""
    global _HANDLER
    try:
        import torch  # noqa: F401  (the port's compiles need torch)
    except ImportError:
        return False
    if _HANDLER is None:
        _HANDLER = _RecompileHandler()
    lg = logging.getLogger(_LOGGER_NAME)
    if _HANDLER not in lg.handlers:
        lg.addHandler(_HANDLER)
    if not lg.isEnabledFor(logging.INFO):
        lg.setLevel(logging.INFO)
    lg.propagate = False
    if "torch._dynamo" in sys.modules:
        from torch._dynamo.callback import callback_handler
        if _on_dynamo_compile not in callback_handler.start_callbacks:
            callback_handler.register_start_callback(_on_dynamo_compile)
    return True


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
    ``device`` also as an NVTX range. Also keeps the recompile listener
    armed (the entry points are the one place every engine passes
    through)."""
    import torch
    ensure_recompile_listener()
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
