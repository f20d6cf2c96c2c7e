"""Telemetry (the port's copy of the parts of ``raft_tpu/obs/`` that the
serving engine and its fleet use):

- :class:`MetricRegistry`: thread-safe counters, gauges and histograms
  (bounded reservoirs), rendered as Prometheus text at the serving CLI's
  ``GET /metrics``;
- :func:`span`: time a block into a histogram, optionally emitting a
  JSONL event;
- :class:`EventSink`: the structured JSONL event log under
  ``RAFT_TELEMETRY_DIR`` (or the serve CLI's telemetry directory).

Recording is lock-cheap, never reads a device tensor, and the layer is a
no-op when disabled.  Flow quality (``obs/quality.py``) and SLO burn
rates (``obs/slo.py``) are imported from their modules, as in the JAX
package; traces, incidents and the cost model are not ported yet
(ROADMAP A8).
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

__all__ = [
    "Counter",
    "EventSink",
    "Gauge",
    "Histogram",
    "MetricRegistry",
    "PROMETHEUS_CONTENT_TYPE",
    "default_registry",
    "default_sink",
    "reset_default_sink",
    "span",
]
