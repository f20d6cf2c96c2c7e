"""Online inference serving (the port of ``raft_tpu/serve/``, one engine on
one device): ``serve/engine.py`` (shape buckets, request micro-batching,
continuous batching at GRU-iteration granularity with early exit,
streaming sessions, backpressure), ``serve/slots.py`` (the slot programs
and the offline :class:`EarlyExitRunner`) and ``serve/stats.py``.

Entry point::

    python -m raft_tpu_torch serve --random-init --port 8080   # HTTP

The replica fleet, the router, the remote fabric and AOT artifacts are
not ported yet (ROADMAP A7).
"""

from raft_tpu_torch.serve.engine import (
    InferenceEngine,
    QueueFullError,
    ServeConfig,
)
from raft_tpu_torch.serve.slots import EarlyExitRunner
from raft_tpu_torch.serve.stats import Counters, LatencyRecorder

__all__ = [
    "Counters",
    "EarlyExitRunner",
    "InferenceEngine",
    "LatencyRecorder",
    "QueueFullError",
    "ServeConfig",
]
