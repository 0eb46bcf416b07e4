"""Observability plane of the port (copy of ``repro.obs``'s stdlib layers,
and its device-side hooks on ``torch.profiler``).

* ``registry`` — the process-global labeled metrics registry; the kernel
  launch tally (``kernels.tally``) and ``telemetry.ThroughputMeter`` feed it.
* ``trace`` — nested host-side spans (``stream.prepare``,
  ``stream.launch``, ``kernel.*``) in a ring buffer, exportable as JSONL or
  Chrome trace-event JSON. Spans never synchronise the device: a span
  around a kernel launch measures the enqueue.
* ``torchprof`` (the reference's ``jaxprof``) — device-side hooks:
  ``annotate`` names each kernel entry point on the profiler's timeline
  (``record_function`` plus an NVTX range on the card), and
  ``capture_step`` records one ``torch.profiler`` trace of a block
  (``mine_serve --profile-dir``), and ``ensure_recompile_listener``
  counts kernel library builds and loads (and any ``torch.compile``) into
  ``recompiles{kernel=...}``. It imports torch only when used.
"""

from . import registry, torchprof, trace
from .registry import REGISTRY
from .trace import TRACER, span

__all__ = ["REGISTRY", "TRACER", "registry", "span", "torchprof", "trace"]
