"""Capture-event accounting (the port's copy of ``CompileCounter``,
``raft_tpu/utils/profiling.py:19-60``).

The JAX package counts one compile event per program it builds; the
port's counterpart of a compiled program is a captured CUDA graph
(``utils/graphs.py``), so callers record one event per graph they
capture.  Tests then assert the invariant directly: steady traffic
captures once per key, never per call.  The JAX counter's optional
mirror into a metric registry is not carried over (ROADMAP A8).
"""

from __future__ import annotations

import threading
from typing import Dict, Hashable


class CaptureCounter:
    """Per-key capture events, thread-safe."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counts: Dict[Hashable, int] = {}

    def record(self, key: Hashable) -> None:
        with self._lock:
            self._counts[key] = self._counts.get(key, 0) + 1

    def count(self, key: Hashable) -> int:
        with self._lock:
            return self._counts.get(key, 0)

    def counts(self) -> Dict[Hashable, int]:
        with self._lock:
            return dict(self._counts)

    def total(self) -> int:
        with self._lock:
            return sum(self._counts.values())
