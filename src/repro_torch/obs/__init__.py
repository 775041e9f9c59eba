"""GraphPulse: observability + self-tuning for the serving stack (the port
of the reference package's ``repro/obs``: the same names, formats and
control law).

Three pieces (see each module's docstring for the design):

* ``repro_torch.obs.metrics`` — bounded telemetry primitives (``Reservoir``
  log-binned histograms with documented percentile error, ``MetricsHub``
  registry + JSONL snapshot emitter, schema validation / CLI).
* ``repro_torch.obs.controller`` — ``AdaptiveServeController``, the
  SLO-aware feedback loop steering ``GraphService.reconfigure``.
* ``repro_torch.obs.trace`` — ``LoadTrace`` record/replay format so policy
  changes are benchmarked against recorded traffic.
"""
from repro_torch.obs.controller import (AdaptiveServeController,
                                        ControllerConfig, Decision)
from repro_torch.obs.metrics import (Counter, Gauge, MetricsHub, Reservoir,
                                     validate_file, validate_snapshot)
from repro_torch.obs.trace import LoadTrace, TraceEvent, TraceRecorder

__all__ = [
    "AdaptiveServeController",
    "ControllerConfig",
    "Counter",
    "Decision",
    "Gauge",
    "LoadTrace",
    "MetricsHub",
    "Reservoir",
    "TraceEvent",
    "TraceRecorder",
    "validate_file",
    "validate_snapshot",
]
