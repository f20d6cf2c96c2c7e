"""Telemetry (the port's copy of the parts of ``raft_tpu/obs/`` that the
serving engine and its fleet use):

- :class:`MetricRegistry`: thread-safe counters, gauges and histograms
  (bounded reservoirs), rendered as Prometheus text at the serving CLI's
  ``GET /metrics``;
- :func:`span`: time a block into a histogram, optionally emitting a
  JSONL event;
- :class:`EventSink`: the structured JSONL event log under
  ``RAFT_TELEMETRY_DIR`` (or the serve CLI's telemetry directory).

- :class:`Tracer` / :func:`trace_span`: trace trees emitted as
  ``trace_span`` events through the sink (``obs/trace.py``).

Recording is lock-cheap, never reads a device tensor, and the layer is a
no-op when disabled.  The other modules are imported from where they
live, as in the JAX package: flow quality (``obs/quality.py``), SLO burn
rates (``obs/slo.py``), the cost model (``obs/cost.py``), incidents
(``obs/incident.py``), training telemetry (``obs/train.py``), the health
monitor and forensic bundles (``obs/health.py``) and the stall watchdog
(``obs/watchdog.py``).
"""

from raft_tpu_torch.obs.events import (
    EventSink,
    default_sink,
    reset_default_sink,
)
from raft_tpu_torch.obs.exposition import (
    CONTENT_TYPE as PROMETHEUS_CONTENT_TYPE,
)
from raft_tpu_torch.obs.registry import (
    Counter,
    Gauge,
    Histogram,
    MetricRegistry,
    default_registry,
    span,
)
from raft_tpu_torch.obs.trace import (
    Tracer,
    default_tracer,
    record_span,
    trace_span,
    use_context,
)

__all__ = [
    "Counter",
    "EventSink",
    "Gauge",
    "Histogram",
    "MetricRegistry",
    "PROMETHEUS_CONTENT_TYPE",
    "Tracer",
    "default_registry",
    "default_sink",
    "default_tracer",
    "record_span",
    "reset_default_sink",
    "span",
    "trace_span",
    "use_context",
]
