"""Capture-event accounting (the port's copy of ``CompileCounter``,
``raft_tpu/utils/profiling.py:19-60``).

The JAX package counts one compile event per program it builds; the
port's counterpart of a compiled program is a captured CUDA graph
(``utils/graphs.py``), so callers record one event per graph they
capture.  Tests then assert the invariant directly: steady traffic
captures once per key, never per call.  As the JAX counter does, it
mirrors each event into a metric registry (``raft_tpu_torch.obs``)
when given one: the serving engine's ``raft_serve_compiles_total``.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Hashable, Optional


class CaptureCounter:
    """Per-key capture events, thread-safe.

    With a ``registry`` (a :class:`raft_tpu_torch.obs.MetricRegistry`,
    duck-typed), each event also increments the ``metric`` counter,
    labeled by ``labeler(key) -> {label: value}`` (default: one
    ``key=str(key)`` label)."""

    def __init__(self, registry=None,
                 metric: str = "raft_captures_total",
                 labeler: Optional[Callable[[Hashable], dict]] = None
                 ) -> None:
        self._lock = threading.Lock()
        self._counts: Dict[Hashable, int] = {}
        self._metric = (registry.counter(metric,
                                         "program captures (CUDA graphs)")
                        if registry is not None else None)
        self._labeler = labeler

    def record(self, key: Hashable) -> None:
        with self._lock:
            self._counts[key] = self._counts.get(key, 0) + 1
        if self._metric is not None:
            labels = (self._labeler(key) if self._labeler
                      else {"key": str(key)})
            self._metric.inc(1, **labels)

    def count(self, key: Hashable) -> int:
        with self._lock:
            return self._counts.get(key, 0)

    def counts(self) -> Dict[Hashable, int]:
        with self._lock:
            return dict(self._counts)

    def total(self) -> int:
        with self._lock:
            return sum(self._counts.values())
