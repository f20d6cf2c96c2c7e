"""Process-wide metric registry: counters, gauges, histograms, spans (the
port's copy of ``raft_tpu/obs/registry.py``).

The telemetry contract every instrumented path relies on (the serving
engine is the port's first user):

- **Lock-cheap recording.**  A record is one short critical section
  around a dict update (per-metric lock, never a registry-wide one on
  the hot path).  Snapshot/render take the same locks briefly per
  metric; they are a human asking, not the request path.
- **Never a device sync.**  Record methods accept plain Python floats;
  nothing in this package ever reads a device tensor handed to it.
  Callers time with ``perf_counter`` host-side.
- **No-op when disabled.**  A registry built with ``enabled=False``
  returns immediately from every record method, and :func:`span`
  skips its timing entirely when neither registry nor sink is live.

Histograms keep a *bounded reservoir* (a ring of the most recent
``reservoir`` observations) next to lifetime count/sum, so percentiles
reflect recent behavior and memory stays O(reservoir) on a
long-running server — the same windowing the serving layer always had.
"""

from __future__ import annotations

import collections
import re
import threading
import time
from contextlib import contextmanager
from typing import Callable, Dict, Optional, Tuple

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

#: Cardinality guard: max distinct label-sets one metric may hold
#: before new sets fold into the ``overflow="true"`` series
#: (``RAFT_METRIC_MAX_LABELSETS`` overrides).  Unbounded label values
#: (request ids, trace attrs) would otherwise grow ``/metrics`` — and
#: registry memory — without bound on a long-running server.
DEFAULT_MAX_LABELSETS = 256
_OVERFLOW_KEY: Tuple[Tuple[str, str], ...] = (("overflow", "true"),)


def _max_labelsets() -> int:
    import os

    raw = os.environ.get("RAFT_METRIC_MAX_LABELSETS", "")
    try:
        return max(int(raw), 1) if raw else DEFAULT_MAX_LABELSETS
    except ValueError:
        return DEFAULT_MAX_LABELSETS


def _label_key(labels: Dict[str, object]) -> Tuple[Tuple[str, str], ...]:
    for k in labels:
        if not _LABEL_RE.match(k):
            raise ValueError(f"invalid label name {k!r}")
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


class _Metric:
    """Base: one named metric holding one value per label set."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "", registry=None):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        self.name = name
        self.help = help
        self._registry = registry
        self._lock = threading.Lock()
        self._values: Dict[tuple, object] = {}
        self._max_labelsets = _max_labelsets()
        self._overflow_warned = False

    def _enabled(self) -> bool:
        return self._registry is None or self._registry.enabled

    def _guard_locked(self, key: tuple) -> tuple:
        """Cardinality guard; caller holds ``self._lock`` (the
        ``*_locked`` suffix is the repo's lock-discipline convention):
        an unseen
        label set past the cap folds into ``overflow="true"`` — the
        series count stays bounded, the recorded totals stay honest."""
        if key in self._values or len(self._values) < self._max_labelsets:
            return key
        if not self._overflow_warned:
            self._overflow_warned = True
            import warnings

            warnings.warn(
                f"metric {self.name!r} hit the label-cardinality cap "
                f"({self._max_labelsets} label sets; "
                f"RAFT_METRIC_MAX_LABELSETS overrides) — folding new "
                f'label sets into overflow="true"', RuntimeWarning,
                stacklevel=4)
        return _OVERFLOW_KEY

    def items(self):
        """``[(label_tuple, value), ...]`` snapshot (value semantics are
        kind-specific; histograms return ``(count, sum, window list)``)."""
        with self._lock:
            return [(k, self._copy_value(v))
                    for k, v in sorted(self._values.items())]

    def _copy_value(self, v):
        return v


class Counter(_Metric):
    kind = "counter"

    def inc(self, n: float = 1, **labels) -> None:
        if not self._enabled():
            return
        key = _label_key(labels)
        with self._lock:
            key = self._guard_locked(key)
            self._values[key] = self._values.get(key, 0) + n

    def value(self, **labels) -> float:
        with self._lock:
            return self._values.get(_label_key(labels), 0)


class Gauge(_Metric):
    kind = "gauge"

    def set(self, v: float, **labels) -> None:
        if not self._enabled():
            return
        key = _label_key(labels)
        with self._lock:
            key = self._guard_locked(key)
            self._values[key] = float(v)

    def value(self, **labels) -> Optional[float]:
        with self._lock:
            return self._values.get(_label_key(labels))


class _HistState:
    __slots__ = ("count", "sum", "ring")

    def __init__(self, reservoir: int):
        self.count = 0
        self.sum = 0.0
        self.ring: collections.deque = collections.deque(maxlen=reservoir)


class Histogram(_Metric):
    """Lifetime count/sum + bounded reservoir of recent observations."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "", registry=None,
                 reservoir: int = 2048):
        super().__init__(name, help, registry)
        self.reservoir = reservoir

    def observe(self, v: float, **labels) -> None:
        if not self._enabled():
            return
        key = _label_key(labels)
        with self._lock:
            key = self._guard_locked(key)
            st = self._values.get(key)
            if st is None:
                st = self._values[key] = _HistState(self.reservoir)
            st.count += 1
            st.sum += v
            st.ring.append(v)

    def collect(self, **labels):
        """``(count_total, sum_total, window list)`` for one label set
        (zeros/empty when never observed)."""
        with self._lock:
            st = self._values.get(_label_key(labels))
            if st is None:
                return 0, 0.0, []
            return st.count, st.sum, list(st.ring)

    def _copy_value(self, st: _HistState):
        return (st.count, st.sum, list(st.ring))


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricRegistry:
    """Thread-safe, process-wide metric registry.

    ``counter``/``gauge``/``histogram`` are get-or-create (idempotent by
    name; re-registering under a different kind raises, so two
    subsystems cannot silently claim one name for different things).
    Collect hooks run at snapshot/render time to refresh gauges whose
    truth lives elsewhere (queue depth, uptime) — pull, not push, so
    the owning hot path never pays for them.
    """

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}
        self._hooks: list = []

    def _get_or_create(self, kind: str, name: str, help: str, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = _KINDS[kind](name, help, registry=self, **kw)
                self._metrics[name] = m
            elif m.kind != kind:
                raise TypeError(
                    f"metric {name!r} already registered as {m.kind}, "
                    f"requested {kind}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create("counter", name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create("gauge", name, help)

    def histogram(self, name: str, help: str = "",
                  reservoir: int = 2048) -> Histogram:
        return self._get_or_create("histogram", name, help,
                                   reservoir=reservoir)

    def add_collect_hook(self, fn: Callable[["MetricRegistry"], None]):
        with self._lock:
            self._hooks.append(fn)

    def collect(self) -> None:
        """Run collect hooks (refresh pull-style gauges).  A hook that
        raises is counted, not propagated: ``/metrics`` must keep
        serving the rest of the registry."""
        with self._lock:
            hooks = list(self._hooks)
        for fn in hooks:
            try:
                fn(self)
            except Exception:
                self.counter("raft_obs_collect_errors_total",
                             "collect hooks that raised").inc()

    def metrics(self):
        with self._lock:
            return [self._metrics[k] for k in sorted(self._metrics)]

    def snapshot(self) -> dict:
        """JSON-able ``{name: {type, help, values}}`` (labels rendered
        as ``"k=v,k2=v2"`` strings; histograms as count/sum/window
        percentiles)."""
        import numpy as np

        self.collect()
        out = {}
        for m in self.metrics():
            vals = {}
            for key, v in m.items():
                label_s = ",".join(f"{k}={s}" for k, s in key)
                if m.kind == "histogram":
                    count, total, window = v
                    rec = {"count": count, "sum": round(total, 6),
                           "window_count": len(window)}
                    if window:
                        p50, p95, p99 = np.percentile(
                            np.asarray(window, np.float64), [50, 95, 99])
                        rec.update(p50=round(float(p50), 6),
                                   p95=round(float(p95), 6),
                                   p99=round(float(p99), 6))
                    vals[label_s] = rec
                else:
                    vals[label_s] = v
            out[m.name] = {"type": m.kind, "help": m.help, "values": vals}
        return out

    def render_prometheus(self) -> str:
        from raft_tpu_torch.obs.exposition import render

        return render(self)


_default: Optional[MetricRegistry] = None
_default_lock = threading.Lock()


def default_registry() -> MetricRegistry:
    """The process-wide registry (created on first use).  Library spans
    (eval validators) record here; subsystems that own an exposition
    endpoint (the serving engine) build their own."""
    global _default
    if _default is None:
        with _default_lock:
            if _default is None:
                _default = MetricRegistry()
    return _default


@contextmanager
def span(name: str, *, registry: Optional[MetricRegistry] = None,
         sink=None, emit: bool = False, step: Optional[int] = None,
         **labels):
    """Time a block into histogram ``<name>_seconds`` (labels pass
    through), optionally emitting one JSONL event (``emit=True`` uses
    the default sink — no-op unless ``RAFT_TELEMETRY_DIR`` is set).
    A fully disabled layer skips even the clock reads."""
    reg = default_registry() if registry is None else registry
    if sink is None and emit:
        from raft_tpu_torch.obs.events import default_sink

        sink = default_sink()
    do_sink = sink is not None and sink.enabled
    if not (reg.enabled or do_sink):
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        metric = name if name.endswith("_seconds") else f"{name}_seconds"
        reg.histogram(metric).observe(dt, **labels)
        if do_sink:
            sink.emit("span", step=step, name=name,
                      seconds=round(dt, 6), **labels)
