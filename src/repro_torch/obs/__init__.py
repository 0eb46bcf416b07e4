"""Observability plane of the port (copy of ``repro.obs``'s stdlib layers).

* ``registry`` — the process-global labeled metrics registry; the kernel
  launch tally (``kernels.tally``) and ``telemetry.ThroughputMeter`` feed it.
* ``trace`` — nested host-side spans (``stream.prepare``,
  ``stream.launch``, ``kernel.*``) in a ring buffer, exportable as JSONL or
  Chrome trace-event JSON. Spans never synchronise the device: a span
  around a kernel launch measures the enqueue.

The reference's ``jaxprof`` (device-side profiling hooks) has no port yet.
"""

from . import registry, trace
from .registry import REGISTRY
from .trace import TRACER, span

__all__ = ["REGISTRY", "TRACER", "registry", "span", "trace"]
