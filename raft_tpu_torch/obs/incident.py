"""Flight recorder + cross-signal incident correlation (the port's copy of
``raft_tpu/obs/incident.py``).

The stack emits a dozen independent anomaly signals (``nonfinite_step``,
``stall``, ``serve_retry``, ``replica_crash``, ``fleet_restart``,
``ckpt_fallback``, ``sample_quarantine``, ``quality_drift``,
``stream_restart``, ``slo_burn``, ...) into one JSONL stream, but a
cascading failure — a replica kill that triggers a device-error burst,
retries, a breaker open, and a restart — still reads as N interleaved
lines an operator must mentally re-correlate.  This module closes that
gap the same way ``trace.py`` closed it for latency:

- :class:`FlightRecorder`: a bounded ring of the most recent event
  records, fed by an :meth:`EventSink.add_observer` hook — always on,
  O(1) per event, zero device work — plus named *providers* (engine /
  fleet ``stats()``, resolved configs, cost-book rows) invoked only
  when a bundle is written.
- :class:`IncidentManager`: watches the stream for anomaly events at or
  above ``open_severity``; on trigger it scans the ring backward over
  ``window_s`` to seed the correlated-signal list, opens ONE incident
  (co-occurring anomalies fold into it instead of opening more —
  dedup), writes a self-contained forensic bundle under
  ``<telemetry_dir>/incidents/<id>/``, and closes the incident once the
  stream has been quiet for ``quiet_close_s``.  A post-close
  ``cooldown_s`` rate-limits pathological flapping into
  ``raft_incidents_suppressed_total`` instead of a bundle flood.

Bundle layout (each file self-contained JSON/JSONL)::

    incidents/<id>/incident.json   # id, severity, correlated signals,
                                   # open/close times, status
    incidents/<id>/events.jsonl    # the ring window around the trigger
    incidents/<id>/traces.jsonl    # trace_span records seen in the ring
                                   # (tail-kept trees flushed first via
                                   # trace.py's dropped ring)
    incidents/<id>/metrics.json    # registry snapshot at close
    incidents/<id>/stats.json      # provider outputs (engine/fleet
                                   # stats, cost rows, configs)

Correlated signals are ordered **first-fired first** — in a cascade the
earliest signal is the probable cause.

Re-entrancy: the manager emits ``incident_*`` records through the SAME
sink it observes.  Observers run outside the sink's write lock (see
events.py) and ``incident_*`` events are not triggers, so the recursion
terminates after one extra observe.  The manager's own lock guards
trigger state only; bundle I/O and re-emission happen after release.
"""

from __future__ import annotations

import json
import os
import threading
import time
import uuid
from collections import deque
from typing import Callable, Dict, List, Optional

from raft_tpu_torch.obs import trace as trace_mod
from raft_tpu_torch.obs.events import EventSink
from raft_tpu_torch.obs.registry import MetricRegistry

_SEVERITY_RANK = {"info": 0, "warning": 1, "critical": 2}

#: Anomaly event -> severity.  Only events at or above the manager's
#: ``open_severity`` open an incident; lower ones still join the
#: correlated-signal list of an incident already open.
ANOMALY_EVENTS: Dict[str, str] = {
    # train
    "nonfinite_step": "critical",
    "stall": "critical",
    "ckpt_fallback": "warning",
    "sample_quarantine": "warning",
    # serve / engine
    "serve_retry": "warning",
    "serve_retry_deadline": "critical",
    "serve_batch_error": "warning",
    "serve_slot_error": "warning",
    "serve_admit_error": "warning",
    "serve_iter_error": "warning",
    "replica_crash": "critical",
    "quality_drift": "warning",
    # fleet / router
    "fleet_restart": "warning",
    "fleet_restart_error": "critical",
    "fleet_replica_failed": "critical",
    "fleet_breaker_open": "warning",
    "fleet_quality_drift": "warning",
    "serve_failover": "warning",
    "stream_restart": "warning",
    "stream_stash_error": "warning",
    # multi-host fabric (serve/remote.py, docs/SERVING.md): a request-
    # path wire failure correlates into the partition's incident; the
    # heal-side rejoin and autoscaler moves tag it as context.
    "net_retry": "warning",
    "fleet_remote_rejoin": "info",
    "fleet_scale": "info",
    "fleet_scale_error": "warning",
    # chaos fires are informational: they tag the correlated-signal
    # list (so a drill's bundle says "injected") but never open.
    "chaos_inject": "info",
}


def _severity_of(rec: dict) -> Optional[str]:
    """The anomaly severity of one event record (None = not an
    anomaly).  ``slo_burn`` severity rides the record (page ->
    critical, ticket -> warning); ``fleet_canary_proxy`` is an anomaly
    only when the canary REFUSED the weights (ok=false)."""
    event = rec.get("event")
    if event == "slo_burn":
        return "critical" if rec.get("severity") == "page" else "warning"
    if event == "fleet_canary_proxy":
        return None if rec.get("ok", True) else "warning"
    return ANOMALY_EVENTS.get(event)


class FlightRecorder:
    """Bounded ring of recent event records + bundle-time providers."""

    def __init__(self, capacity: int = 2048):
        self._ring: deque = deque(maxlen=max(int(capacity), 16))
        self._lock = threading.Lock()
        self._providers: Dict[str, Callable[[], object]] = {}

    def observe(self, rec: dict) -> None:
        """Sink-observer entry point: O(1) append, no I/O."""
        with self._lock:
            self._ring.append(rec)

    def add_provider(self, name: str,
                     fn: Callable[[], object]) -> None:
        """Register a snapshot callable (engine/fleet ``stats()``,
        resolved config dicts, cost-book rows) — invoked only when a
        bundle is written, never on the event path."""
        self._providers[name] = fn

    def recent(self, window_s: Optional[float] = None,
               now: Optional[float] = None) -> List[dict]:
        """Ring contents, optionally restricted to the trailing
        ``window_s`` (by ``t_mono``).  ``now`` defaults to the newest
        record's ``t_mono`` — "trailing" means trailing *the stream*,
        which also keeps injectable-clock tests off the wall clock."""
        with self._lock:
            recs = list(self._ring)
        if window_s is None:
            return recs
        if now is None:
            now = (recs[-1].get("t_mono") if recs else None) \
                or time.perf_counter()
        horizon = now - window_s
        return [r for r in recs if r.get("t_mono", now) >= horizon]

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def snapshots(self) -> Dict[str, object]:
        """Invoke every provider (errors degrade to a string — a
        forensic bundle must never crash the path that writes it)."""
        out: Dict[str, object] = {}
        for name, fn in sorted(self._providers.items()):
            try:
                out[name] = fn()
            except Exception as e:
                out[name] = f"provider error: {type(e).__name__}: {e}"
        return out


class IncidentManager:
    """Subscribe to the anomaly seams, correlate, dedup, bundle.

    One manager per telemetry stream (the fleet owns it when engines
    share a sink; a standalone engine owns its own).  ``attach(sink)``
    registers the observer; ``close()`` finalizes any open incident.
    ``clock`` is injectable for deterministic tests."""

    def __init__(self, *,
                 directory: Optional[str] = None,
                 sink: Optional[EventSink] = None,
                 registry: Optional[MetricRegistry] = None,
                 recorder: Optional[FlightRecorder] = None,
                 window_s: float = 10.0,
                 quiet_close_s: float = 30.0,
                 cooldown_s: float = 60.0,
                 open_severity: str = "warning",
                 clock: Callable[[], float] = time.monotonic):
        if open_severity not in _SEVERITY_RANK:
            raise ValueError(f"open_severity {open_severity!r} "
                             "(expected info|warning|critical)")
        self.recorder = recorder or FlightRecorder()
        self._dir = directory or None
        self._sink = sink
        self._registry = registry
        self.window_s = float(window_s)
        self.quiet_close_s = float(quiet_close_s)
        self.cooldown_s = float(cooldown_s)
        self._open_rank = _SEVERITY_RANK[open_severity]
        self._clock = clock
        self._lock = threading.Lock()
        self._open: Optional[dict] = None      # the live incident record
        self._last_anomaly_t = 0.0
        self._last_close_t: Optional[float] = None
        self._seq = 0
        self.opened = 0
        self.suppressed = 0
        self._open_gauge = None
        if registry is not None:
            self._incidents_total = registry.counter(
                "raft_incidents_total",
                "incidents opened, by peak severity")
            self._suppressed_total = registry.counter(
                "raft_incidents_suppressed_total",
                "anomalies that would have opened an incident but fell "
                "in the post-close cooldown")
            self._open_gauge = registry.gauge(
                "raft_incidents_open", "currently open incidents (0/1)")
            self._open_gauge.set(0)

    # -- wiring --------------------------------------------------------

    def attach(self, sink: EventSink) -> None:
        """Feed the recorder (and trigger logic) from ``sink``; also
        adopt it for ``incident_*`` emission and the bundle directory
        when the constructor didn't set them."""
        if self._sink is None:
            self._sink = sink
        if self._dir is None and sink.directory:
            self._dir = os.path.join(sink.directory, "incidents")
        sink.add_observer(self.observe)

    # -- event path ----------------------------------------------------

    def observe(self, rec: dict) -> None:
        """One event record from the stream (sink observer).  Ring
        append always; trigger logic only for anomaly records."""
        self.recorder.observe(rec)
        severity = _severity_of(rec)
        now = self._clock()
        actions: List[tuple] = []
        with self._lock:
            if severity is not None:
                self._anomaly_locked(rec, severity, now, actions)
            self._maybe_close_locked(now, actions)
        self._apply(actions)

    def poll(self, now: Optional[float] = None) -> None:
        """Close-check without an event (supervisor loops call this so
        a quiet stream still closes its incident)."""
        now = self._clock() if now is None else now
        actions: List[tuple] = []
        with self._lock:
            self._maybe_close_locked(now, actions)
        self._apply(actions)

    def close(self) -> None:
        """Finalize: close any open incident (engine/fleet ``stop()``)."""
        actions: List[tuple] = []
        with self._lock:
            if self._open is not None:
                actions.append(("close", self._open, "finalized"))
                self._open = None
        self._apply(actions)

    # -- trigger logic (locked) ---------------------------------------

    def _anomaly_locked(self, rec: dict, severity: str, now: float,
                        actions: List[tuple]) -> None:
        self._last_anomaly_t = now
        if self._open is not None:
            self._fold_locked(self._open, rec, severity, actions)
            return
        if _SEVERITY_RANK[severity] < self._open_rank:
            return
        if (self._last_close_t is not None
                and now - self._last_close_t < self.cooldown_s):
            self.suppressed += 1
            if self._open_gauge is not None:
                self._suppressed_total.inc()
            return
        self._seq += 1
        inc = {
            "id": "inc-%s-%03d-%s" % (
                time.strftime("%Y%m%dT%H%M%S", time.gmtime()),
                self._seq, uuid.uuid4().hex[:6]),
            "status": "open",
            "severity": severity,
            "opened_t_wall": time.time(),
            "opened_t_mono": now,
            "trigger": rec.get("event"),
            "signals": [],          # first-fired order (probable cause)
            "events": 0,
        }
        # Seed the correlated-signal list from the ring's trailing
        # window — the cascade's EARLIER signals (a chaos_inject, the
        # first retries) land in the list even though a later, louder
        # event was the one that opened the incident.
        for prior in self.recorder.recent(self.window_s, now=rec.get(
                "t_mono", now)):
            psev = _severity_of(prior)
            if psev is not None:
                self._fold_locked(inc, prior, psev, actions,
                                  update=False)
        self._open = inc
        self.opened += 1
        if self._open_gauge is not None:
            self._incidents_total.inc(severity=severity)
            self._open_gauge.set(1)
        actions.append(("open", inc, None))

    def _fold_locked(self, inc: dict, rec: dict, severity: str,
                     actions: List[tuple], update: bool = True) -> None:
        inc["events"] += 1
        sig = next((s for s in inc["signals"]
                    if s["event"] == rec.get("event")), None)
        if sig is not None:
            sig["count"] += 1
            sig["last_t_wall"] = rec.get("t_wall")
            return
        inc["signals"].append({
            "event": rec.get("event"),
            "severity": severity,
            "first_t_wall": rec.get("t_wall"),
            "first_t_mono": rec.get("t_mono"),
            "last_t_wall": rec.get("t_wall"),
            "count": 1,
        })
        inc["signals"].sort(key=lambda s: s.get("first_t_mono") or 0.0)
        if _SEVERITY_RANK[severity] > _SEVERITY_RANK[inc["severity"]]:
            inc["severity"] = severity
        if update:
            # A NEW signal kind joining an open incident is worth one
            # incident_update; repeats of known kinds are not (dedup).
            actions.append(("update", inc, rec.get("event")))

    def _maybe_close_locked(self, now: float,
                            actions: List[tuple]) -> None:
        if self._open is None:
            return
        if now - self._last_anomaly_t >= self.quiet_close_s:
            actions.append(("close", self._open, "quiet"))
            self._open = None

    # -- unlocked side effects ----------------------------------------

    def _apply(self, actions: List[tuple]) -> None:
        # Each lifecycle event is a literal sink.emit, so a reader of
        # the source finds every event name.
        for kind, inc, arg in actions:
            if kind == "open":
                self._write_bundle(inc, final=False)
                if self._sink is not None:
                    self._sink.emit("incident_open", **self._fields(inc))
            elif kind == "update":
                if self._sink is not None:
                    self._sink.emit("incident_update", new_signal=arg,
                                    **self._fields(inc))
            elif kind == "close":
                inc["status"] = "closed"
                inc["closed_t_wall"] = time.time()
                inc["close_reason"] = arg
                inc["duration_s"] = round(
                    inc["closed_t_wall"] - inc["opened_t_wall"], 3)
                with self._lock:
                    self._last_close_t = self._clock()
                if self._open_gauge is not None:
                    self._open_gauge.set(0)
                self._write_bundle(inc, final=True)
                if self._sink is not None:
                    self._sink.emit("incident_close",
                                    **self._fields(inc))

    @staticmethod
    def _fields(inc: dict) -> dict:
        return {"incident_id": inc["id"], "severity": inc["severity"],
                "signals": [s["event"] for s in inc["signals"]],
                "events": inc["events"]}

    # -- bundle --------------------------------------------------------

    def _write_bundle(self, inc: dict, final: bool) -> None:
        """Write/refresh the forensic bundle.  Never raises: forensics
        must not take down the stream they describe."""
        if self._dir is None:
            return
        try:
            bdir = os.path.join(self._dir, inc["id"])
            os.makedirs(bdir, exist_ok=True)
            with open(os.path.join(bdir, "incident.json"), "w") as f:
                json.dump(inc, f, indent=2, default=str)
            if not final:
                return
            # Flush tail-kept trace trees parked in the dropped ring so
            # their spans reach the stream (and therefore the recorder)
            # before we cut the window.
            try:
                trace_mod.default_tracer().emit_recent_dropped()
            except Exception:
                pass
            window = self.recorder.recent(
                self.window_s + inc.get("duration_s", 0.0)
                + self.quiet_close_s)
            with open(os.path.join(bdir, "events.jsonl"), "w") as f:
                for rec in window:
                    f.write(json.dumps(rec, default=str) + "\n")
            spans = [r for r in window if r.get("event") == "trace_span"]
            with open(os.path.join(bdir, "traces.jsonl"), "w") as f:
                for rec in spans:
                    f.write(json.dumps(rec, default=str) + "\n")
            if self._registry is not None:
                with open(os.path.join(bdir, "metrics.json"), "w") as f:
                    json.dump(self._registry.snapshot(), f, indent=2,
                              default=str)
            with open(os.path.join(bdir, "stats.json"), "w") as f:
                json.dump(self.recorder.snapshots(), f, indent=2,
                          default=str)
        except Exception:
            pass

    # -- readout -------------------------------------------------------

    def snapshot(self) -> dict:
        with self._lock:
            open_inc = self._open
            return {
                "opened": self.opened,
                "suppressed": self.suppressed,
                "open": None if open_inc is None else {
                    "id": open_inc["id"],
                    "severity": open_inc["severity"],
                    "signals": [s["event"]
                                for s in open_inc["signals"]],
                },
            }
