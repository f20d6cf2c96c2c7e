"""Online inference serving (the port of ``raft_tpu/serve/``):
``serve/engine.py`` (shape buckets, request micro-batching, continuous
batching at GRU-iteration granularity with early exit, streaming
sessions, backpressure), ``serve/slots.py`` (the slot programs and the
offline :class:`EarlyExitRunner`), ``serve/stats.py``, and the fleet
around the engine: ``serve/fleet.py`` (supervised replicas, rolling
weight updates behind verify, canary and quality gates, the
autoscaler), ``serve/router.py`` (health-gated placement, failover,
hedging, the breaker, session affinity), ``serve/remote.py`` (replicas
on other hosts over the HTTP wire protocol) and ``serve/aot.py``
(warm-start manifests).

Entry point::

    python -m raft_tpu_torch serve --random-init --port 8080   # HTTP
    python -m raft_tpu_torch serve --random-init --replicas 2  # a fleet
"""

from raft_tpu_torch.serve.aot import (
    AOTImportError,
    model_fingerprint,
    read_manifest,
    write_manifest,
)
from raft_tpu_torch.serve.engine import (
    InferenceEngine,
    QueueFullError,
    ServeConfig,
)
from raft_tpu_torch.serve.fleet import (
    FleetConfig,
    Replica,
    ReplicaFleet,
    WeightUpdateError,
)
from raft_tpu_torch.serve.remote import (
    RemoteConfig,
    RemoteEngine,
    RemoteNetworkError,
    RemoteProtocolError,
    RemoteReplica,
    classify_network_error,
)
from raft_tpu_torch.serve.router import (
    FlowRouter,
    RouterConfig,
    is_failover_error,
)
from raft_tpu_torch.serve.slots import EarlyExitRunner
from raft_tpu_torch.serve.stats import Counters, LatencyRecorder

__all__ = [
    "AOTImportError",
    "Counters",
    "EarlyExitRunner",
    "FleetConfig",
    "FlowRouter",
    "InferenceEngine",
    "LatencyRecorder",
    "QueueFullError",
    "RemoteConfig",
    "RemoteEngine",
    "RemoteNetworkError",
    "RemoteProtocolError",
    "RemoteReplica",
    "Replica",
    "ReplicaFleet",
    "RouterConfig",
    "ServeConfig",
    "WeightUpdateError",
    "classify_network_error",
    "is_failover_error",
    "model_fingerprint",
    "read_manifest",
    "write_manifest",
]
