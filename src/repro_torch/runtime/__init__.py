"""Fault-tolerance runtime of the port: copies of ``repro.runtime.ft``'s
numpy-only step watchdog and elastic re-mesh planning and of
``repro.runtime.faultinject``, the wire's deterministic fault injection,
and the int8 error-feedback gradient compression of
``repro.runtime.compress`` over the port's device tuple."""

from .compress import (compressed_psum_ef, dequantize, quantize,
                       zero_residual)
from .faultinject import FaultInjector, FaultSpec, kill_point
from .ft import (ElasticRuntime, ElasticState, StepFailure, StepWatchdog,
                 WatchdogConfig, plan_elastic_mesh)

__all__ = ["StepFailure", "StepWatchdog", "WatchdogConfig",
           "ElasticRuntime", "ElasticState", "plan_elastic_mesh",
           "quantize", "dequantize", "compressed_psum_ef", "zero_residual",
           "FaultInjector", "FaultSpec", "kill_point"]
