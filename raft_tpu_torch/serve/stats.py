"""Serving metrics: latency percentiles + throughput counters (the port's
copy of ``raft_tpu/serve/stats.py``).

Both classes are thin views over ``raft_tpu_torch.obs.MetricRegistry``
metrics: every figure the JSON ``/v1/stats`` snapshot reports is
derived from the same registry counters/histograms the Prometheus
``GET /metrics`` endpoint renders, so the two surfaces cannot drift
(they can only be read microseconds apart — per-metric locks, no
cross-metric atomic snapshot, which is fine for monitoring).

The engine records one latency sample per completed request (submit ->
result, i.e. including queueing and batching delay — the number a client
actually experiences) into a bounded reservoir, so a long-running
server's ``stats()`` reflects *recent* traffic and memory stays
O(window).  Percentiles are computed on snapshot, not on record: the
record path is on the request hot path, the snapshot path is a human
asking.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional

import numpy as np

from raft_tpu_torch.obs import MetricRegistry


class LatencyRecorder:
    """Bounded reservoir of per-request samples with percentile
    snapshots, backed by a registry histogram
    (``raft_serve_request_latency_seconds`` by default).

    The default shape records seconds and snapshots milliseconds
    (``p50_ms`` etc.); other per-request scalars reuse the same
    reservoir with ``scale``/``suffix`` overridden — the engine's
    ``raft_serve_iters_used`` histogram (iterations consumed before a
    slot retired, continuous-batching mode) uses ``scale=1.0,
    suffix=""`` and snapshots plain ``p50``/``p95``/``p99``/``mean``.

    Thread-safe: requests complete on the device-worker thread while
    ``snapshot`` is called from CLI/HTTP threads."""

    def __init__(self, window: int = 4096,
                 registry: Optional[MetricRegistry] = None,
                 metric: str = "raft_serve_request_latency_seconds",
                 help: str = "client-observed submit->result latency",
                 scale: float = 1e3, suffix: str = "_ms"):
        self._hist = (registry or MetricRegistry()).histogram(
            metric, help, reservoir=window)
        self._scale = float(scale)
        self._suffix = suffix

    def record(self, value: float) -> None:
        self._hist.observe(value)

    def snapshot(self) -> Dict[str, float]:
        """``{count, count_total, window_count, p50<sfx>, p95<sfx>,
        p99<sfx>, mean<sfx>}``.

        ``count_total`` is the LIFETIME number of recorded samples;
        the percentiles and mean are computed over the recent bounded
        window of ``window_count`` samples only (zeros when nothing
        completed).  ``count`` is a backwards-compat alias for
        ``count_total`` (older clients of the wire format read it);
        prefer the explicit names."""
        sfx = self._suffix
        count, _total, window = self._hist.collect()
        if not window:
            return {"count": count, "count_total": count,
                    "window_count": 0, f"p50{sfx}": 0.0,
                    f"p95{sfx}": 0.0, f"p99{sfx}": 0.0,
                    f"mean{sfx}": 0.0}
        vals = np.asarray(window, dtype=np.float64)
        p50, p95, p99 = np.percentile(vals, [50, 95, 99]) * self._scale
        return {"count": count,
                "count_total": count,
                "window_count": int(vals.size),
                f"p50{sfx}": round(float(p50), 3),
                f"p95{sfx}": round(float(p95), 3),
                f"p99{sfx}": round(float(p99), 3),
                f"mean{sfx}": round(float(vals.mean() * self._scale), 3)}


class Counters:
    """Lifetime request/batch counters over registry metrics.

    Lane accounting: a batch of ``real`` requests compiled at batch
    size ``real + padded`` contributes ``real`` real lanes and
    ``padded`` ballast lanes whether it succeeds or fails — a failed
    batch's real lanes land in ``failed_lanes`` instead of
    ``completed``, so ``occupancy`` (real / total lanes) and
    ``mean_batch_fill`` keep describing what the dispatcher packed,
    not just what happened to succeed (errors no longer make the
    batching look *healthier*).  ``occupancy`` is the knob-tuning
    signal for ``max_wait_ms`` vs ``max_batch``; throughput figures
    (``pairs_per_sec*``) count completed lanes only."""

    def __init__(self, registry: Optional[MetricRegistry] = None) -> None:
        r = registry or MetricRegistry()
        self._completed = r.counter("raft_serve_pairs_completed_total",
                                    "successfully served frame pairs")
        self._rejected = r.counter("raft_serve_requests_rejected_total",
                                   "backpressure rejections (HTTP 429)")
        self._errors = r.counter("raft_serve_batch_errors_total",
                                 "device batches that raised")
        self._retries = r.counter(
            "raft_serve_device_retries_total",
            "device-call re-dispatches after a transient error")
        self._batches = r.counter("raft_serve_batches_total",
                                  "device batches dispatched")
        self._ballast = r.counter("raft_serve_lanes_ballast_total",
                                  "batch lanes filled with repeated "
                                  "ballast to reach a compiled size")
        self._failed = r.counter("raft_serve_lanes_failed_total",
                                 "real lanes lost to failed batches")
        # Slot-mode (continuous batching) lane accounting: one
        # iter_step over S slots with A active contributes A active
        # and S total lanes; occupancy = active/total is the signal
        # for sizing `slots`.
        self._slot_steps = r.counter(
            "raft_serve_slot_steps_total",
            "iter_step device calls (continuous-batching mode)")
        self._slot_active = r.counter(
            "raft_serve_slot_lanes_active_total",
            "slot lanes active across iter_step calls")
        self._slot_lanes = r.counter(
            "raft_serve_slot_lanes_total",
            "slot lanes (active or idle) across iter_step calls")
        self._slot_occ = r.gauge(
            "raft_serve_slot_occupancy",
            "active/total slot lanes over the engine lifetime "
            "(continuous-batching mode)")
        self._uptime = r.gauge("raft_serve_uptime_seconds",
                               "seconds since the engine started")
        self._lock = threading.Lock()
        self._t0: Optional[float] = None
        r.add_collect_hook(lambda reg: self._uptime.set(self._uptime_s()))

    def _uptime_s(self) -> float:
        with self._lock:
            return (time.perf_counter() - self._t0) if self._t0 else 0.0

    def mark_started(self) -> None:
        with self._lock:
            self._t0 = time.perf_counter()

    def add_rejected(self, n: int = 1) -> None:
        self._rejected.inc(n)

    def add_retry(self, n: int = 1) -> None:
        self._retries.inc(n)

    def add_batch(self, real: int, padded: int, failed: bool) -> None:
        self._batches.inc()
        self._ballast.inc(padded)
        if failed:
            self._errors.inc()
            self._failed.inc(real)
        else:
            self._completed.inc(real)

    def add_completed(self, n: int = 1) -> None:
        """Slot-mode retirement: requests complete one at a time, not
        per batch (batch accounting happens in :meth:`add_slot_step`)."""
        self._completed.inc(n)

    def add_failed_lanes(self, n: int) -> None:
        """Slot-mode failure: ``n`` live lanes lost to a failed
        encode/iter_step call (counts one batch error)."""
        if n:
            self._errors.inc()
            self._failed.inc(n)

    def add_slot_step(self, active: int, slots: int) -> None:
        """One iter_step over ``slots`` lanes of which ``active`` held
        live requests."""
        self._slot_steps.inc()
        self._slot_active.inc(active)
        self._slot_lanes.inc(slots)
        total = self._slot_lanes.value()
        if total:
            self._slot_occ.set(
                round(self._slot_active.value() / total, 4))

    def snapshot(self, num_chips: int) -> Dict[str, float]:
        uptime = self._uptime_s()
        completed = self._completed.value()
        failed_lanes = self._failed.value()
        ballast = self._ballast.value()
        batches = self._batches.value()
        real_lanes = completed + failed_lanes
        total_lanes = real_lanes + ballast
        # Continuous-batching mode: occupancy/fill describe the slot
        # batch the dispatcher keeps resident, not padded micro-batches
        # (which slot mode never builds).  Request-mode engines have
        # zero slot lanes and keep the micro-batch math unchanged.
        slot_lanes = self._slot_lanes.value()
        if slot_lanes:
            real_lanes = self._slot_active.value()
            total_lanes = slot_lanes
            batches = self._slot_steps.value()
        return {
            "uptime_s": round(uptime, 3),
            "completed": completed,
            "rejected": self._rejected.value(),
            "errors": self._errors.value(),
            "retries": self._retries.value(),
            "batches": batches,
            "slot_steps": self._slot_steps.value(),
            "failed_lanes": failed_lanes,
            "mean_batch_fill": round(real_lanes / batches, 3)
            if batches else 0.0,
            "occupancy": round(real_lanes / total_lanes, 3)
            if total_lanes else 0.0,
            "pairs_per_sec": round(completed / uptime, 3)
            if uptime > 0 else 0.0,
            "pairs_per_sec_per_chip":
                round(completed / uptime / num_chips, 3)
                if uptime > 0 else 0.0,
        }
