"""Self-healing replica fleet: N supervised engines behind one router
(the port of ``raft_tpu/serve/fleet.py``).

One :class:`~raft_tpu_torch.serve.engine.InferenceEngine` is a single point
of failure: a crashed device worker takes every in-flight and future
request with it.  The fleet owns N engine replicas and keeps the
*service* alive across individual replica death:

- **Supervision** — a supervisor thread polls each replica's
  ``health()``; a crashed or stalled engine is stopped and REPLACED
  (engines are single-use) with a fresh one, after an exponential
  backoff with jitter (``restart_backoff_s`` doubling to
  ``restart_backoff_max_s``; the jitter keeps co-scheduled replicas
  from thundering back in lock step).  ``max_restart_failures``
  consecutive failed *rebuild attempts* mark the replica ``failed`` —
  a replica that cannot even construct an engine is a config problem,
  not a transient.
- **Warm start** — replica 0 captures the warmup ladder and writes
  the warm-start manifest (``serve/aot.py``); every later engine build
  — fleet bring-up, supervised restart, rolling-update warming, a
  scale-up — replays it in ``start()`` and serves its first request
  with **zero captures**.  The manifest lists keys, not weights, so
  the same manifest warm-starts an engine carrying NEW weights.  All
  engines of the process share one device worker, so a replay (like
  any capture) makes its siblings wait while it runs.
- **Rolling weight updates** — :meth:`ReplicaFleet.update_weights`
  loads checkpoint N+1 on a *warming* engine while the fleet keeps
  serving N, and flips replicas one at a time (old engine drains, new
  one takes over atomically under the replica lock; a
  ``fleet_replica_flip`` event says how many requests the old engine
  still owed at that instant) ONLY after the
  gates pass: the checkpoint verifies (an actual read of the newest
  step: size, checksum and unpickling — the only check that proves the
  bytes decode, the same machinery as ``verify-ckpt``; no fallback to
  an older step), a canary inference on the warming engine
  returns finite flow of the right shape, and a golden-batch QUALITY
  comparison (label-free photometric proxy, ``obs/quality.py``) shows
  the new weights not regressing beyond
  ``FleetConfig.canary_proxy_budget`` vs the live fleet on
  deterministic low-motion frames.  A torn checkpoint, a NaN-producing
  weight set, or finite-but-garbage weights (wild flow the old
  shape+finiteness canary waved through) is refused with
  :class:`WeightUpdateError`; the fleet keeps serving version N.
- **Quality-drift surfacing** — the supervisor also polls each
  replica's quality drift detectors (``engine.quality_drift()``,
  populated when ``ServeConfig.quality_sample_rate > 0``) and
  forwards new firings as ``fleet_quality_drift`` events +
  ``raft_fleet_quality_drift_total``, so one stream shows WHICH
  replica's serving quality walked away from its reference.

- **Memory** — the replicas and a warming engine share one card:
  each engine's resident budget is ``FleetConfig.resident_budget_bytes``,
  by default :data:`~raft_tpu_torch.serve.engine.RESIDENT_FRACTION` of
  the card split over the largest local replica count plus one (the
  warming engine).  A replaced engine is dropped completely (stopped,
  its last reference gone, a collection, the freed blocks given back
  to the card on the device worker): engines hold reference cycles,
  and a graph's private pool lives as long as they do.

The fleet does placement-free supervision only; request routing
(affinity, failover, hedging) lives in
:class:`raft_tpu_torch.serve.router.FlowRouter`, which reads this module's
:class:`Replica` objects.  ``metrics_text()`` aggregates every
replica's registry into one exposition, each sample labeled
``replica="rK"``, with fleet-level counters (restarts, weight updates)
on top — one scrape shows the whole fleet.  With
``ServeConfig.incidents`` the fleet owns ONE incident manager
(``obs/incident.py``) over the shared sink and builds its engines with
``incidents=False``.
"""

from __future__ import annotations

import dataclasses
import gc
import os
import tempfile
import threading
import time
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np

from raft_tpu_torch.obs import EventSink, MetricRegistry
from raft_tpu_torch.obs.exposition import render as render_metrics
from raft_tpu_torch.serve.engine import (RESIDENT_FRACTION,
                                         InferenceEngine, ServeConfig,
                                         on_device)


class WeightUpdateError(RuntimeError):
    """A rolling weight update was refused at a gate (checkpoint failed
    to verify, canary inference failed, golden-batch proxy score
    regressed past ``canary_proxy_budget``) or could not complete.
    The fleet keeps serving its current weights."""


def _golden_frames(h: int, w: int, seed: int = 0,
                   shift: Tuple[int, int] = (2, 1)):
    """Deterministic low-motion golden frame pair for the proxy canary:
    a smoothed random image and a small-translation crop of it.

    Smooth content + small true motion means any sane weight set —
    including a freshly initialized one predicting near-zero flow —
    scores a LOW photometric canary (the residual a couple of pixels
    of uncompensated shift causes on blurred content is tiny), while
    scrambled weights produce wild flow that lands out of bounds or on
    unrelated content and score high.  That separation, not absolute
    accuracy, is what the rolling-update gate needs."""
    rng = np.random.default_rng(seed)
    pad = 8
    base = rng.uniform(0.0, 255.0, (h + 2 * pad, w + 2 * pad, 3))
    kern = np.ones(9) / 9.0
    for ax in (0, 1):
        base = np.apply_along_axis(
            lambda m: np.convolve(m, kern, mode="same"), ax, base)
    lo, hi = float(base.min()), float(base.max())
    base = (base - lo) / max(hi - lo, 1e-6) * 255.0
    dy, dx = shift
    im1 = base[pad:pad + h, pad:pad + w].astype(np.float32)
    im2 = base[pad - dy:pad - dy + h,
               pad - dx:pad - dx + w].astype(np.float32)
    return im1, im2


def _golden_proxy_scores(engine: InferenceEngine, shapes) -> dict:
    """Label-free quality scores of ``engine``'s weights on the golden
    frames, one inference per shape; the scalar ``score`` (mean canary
    score: photometric error + out-of-bounds fraction,
    ``obs/quality.py``) is what the update gate compares."""
    from raft_tpu_torch.obs import quality as quality_mod

    per = []
    for (h, w) in shapes:
        im1, im2 = _golden_frames(int(h), int(w))
        flow = engine.infer(im1, im2, timeout=300)
        s = quality_mod.score_pair(im1, im2, flow)
        per.append({"shape": [int(h), int(w)],
                    "photometric": round(s["photometric"], 5),
                    "valid_frac": round(s["valid_frac"], 4),
                    "canary": round(s["canary"], 5)})
    return {"score": round(float(np.mean([p["canary"] for p in per])),
                           5),
            "per_shape": per}


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """Fleet supervision knobs (:class:`ReplicaFleet`)."""

    replicas: int = 2
    #: Restart backoff ladder: ``restart_backoff_s * 2^k`` capped at
    #: ``restart_backoff_max_s``, ±``restart_jitter`` fraction.  The
    #: level resets after a replica stays healthy ``backoff_reset_s``.
    restart_backoff_s: float = 0.2
    restart_backoff_max_s: float = 10.0
    restart_jitter: float = 0.2
    backoff_reset_s: float = 30.0
    #: Consecutive failed engine REBUILDS (not crashes) before a
    #: replica is marked ``failed`` and left down.
    max_restart_failures: int = 5
    health_poll_s: float = 0.1
    #: Warm-start manifest directory (default: a fresh temp dir per
    #: fleet).
    aot_dir: Optional[str] = None
    #: Write replica 0's manifest after warmup so later engine builds
    #: replay it instead of capturing on their request path.
    auto_export_aot: bool = True
    #: Raw (H, W) image shapes replica 0 captures at bring-up (and
    #: the canary shapes for weight updates, unless overridden).
    warmup_shapes: Tuple[Tuple[int, int], ...] = ()
    canary_shapes: Tuple[Tuple[int, int], ...] = ()
    drain_timeout_s: float = 30.0
    #: Golden-batch proxy gate for rolling weight updates: the warming
    #: engine's label-free quality score (obs/quality.py canary score:
    #: photometric error + out-of-bounds fraction, on deterministic
    #: low-motion golden frames) may regress at most this RELATIVE
    #: fraction vs the live fleet's score before the update is refused
    #: (3.0 = the new weights may score up to 4x worse).  The budget is
    #: deliberately loose: legitimate weight swaps (even between
    #: unrelated random inits) score within ~1.6x of each other on the
    #: golden frames, while scrambled-but-finite weights produce wild
    #: flow and blow past 16x — exactly the failure mode the plain
    #: shape+finiteness canary waves through.  ``None`` disables the
    #: proxy gate (shape/finiteness checks still run).  Uses
    #: ``canary_shapes``/``warmup_shapes``; with neither configured the
    #: proxy gate is skipped (scoring an unwarmed shape would capture).
    canary_proxy_budget: Optional[float] = 3.0
    #: Remote replica specs (``HOST:PORT``) joined behind the same
    #: router (the multi-host fabric, ``serve/remote.py``).  Remote replicas
    #: are supervised by health transitions only — the remote HOST owns
    #: its engine lifecycle, weights, and warmup.
    remote: Tuple[str, ...] = ()
    #: Wire knobs for the remote replicas — a
    #: :class:`raft_tpu_torch.serve.remote.RemoteConfig` (left untyped to keep
    #: the remote module out of the fleet's import graph); ``None``
    #: uses its defaults.
    remote_cfg: Optional[object] = None
    #: Elastic autoscaling of LOCAL replicas (``autoscale_max = 0``
    #: disables it; otherwise ``autoscale_min <= replicas <=
    #: autoscale_max`` must hold).  Signals, hysteresis, and cooldown:
    #: pressure must persist ``autoscale_up_consecutive`` autoscaler
    #: ticks before a grow (fleet queue_frac over
    #: ``autoscale_up_queue_frac``, or SLO burn over
    #: ``autoscale_up_burn_rate`` when set) and
    #: ``autoscale_down_consecutive`` idle ticks before a shrink; every
    #: move opens an ``autoscale_cooldown_s`` window in which no further
    #: move is allowed — the fleet never flaps on one noisy sample.
    autoscale_min: int = 0
    autoscale_max: int = 0
    autoscale_interval_s: float = 2.0
    autoscale_up_queue_frac: float = 0.5
    autoscale_up_burn_rate: Optional[float] = None
    autoscale_down_queue_frac: float = 0.05
    autoscale_up_consecutive: int = 3
    autoscale_down_consecutive: int = 5
    autoscale_cooldown_s: float = 30.0
    #: Each local engine's resident budget (``InferenceEngine``); None:
    #: ``RESIDENT_FRACTION`` of the card over (the largest local replica
    #: count + 1, the warming engine of a rolling update), no budget on
    #: the CPU.
    resident_budget_bytes: Optional[int] = None

    def __post_init__(self):
        if self.replicas < 1:
            raise ValueError("replicas must be >= 1")
        if self.restart_backoff_max_s < self.restart_backoff_s:
            raise ValueError(
                "restart_backoff_max_s must be >= restart_backoff_s")
        if not 0 <= self.restart_jitter < 1:
            raise ValueError("restart_jitter must be in [0, 1)")
        if self.max_restart_failures < 1:
            raise ValueError("max_restart_failures must be >= 1")
        if (self.resident_budget_bytes is not None
                and self.resident_budget_bytes < 1):
            raise ValueError("resident_budget_bytes must be >= 1 (None "
                             "splits the card)")
        if (self.canary_proxy_budget is not None
                and self.canary_proxy_budget <= 0):
            raise ValueError(
                "canary_proxy_budget must be > 0 (None disables the "
                "proxy gate)")
        if self.autoscale_max:
            if self.autoscale_min < 1:
                raise ValueError(
                    "autoscale_min must be >= 1 when autoscaling is on")
            if not (self.autoscale_min <= self.replicas
                    <= self.autoscale_max):
                raise ValueError(
                    f"replicas ({self.replicas}) must start inside "
                    f"[autoscale_min, autoscale_max] = "
                    f"[{self.autoscale_min}, {self.autoscale_max}]")
            if self.autoscale_interval_s <= 0:
                raise ValueError("autoscale_interval_s must be > 0")
            if (self.autoscale_up_consecutive < 1
                    or self.autoscale_down_consecutive < 1):
                raise ValueError(
                    "autoscale_*_consecutive must be >= 1")
            if self.autoscale_cooldown_s < 0:
                raise ValueError("autoscale_cooldown_s must be >= 0")


class _LabeledSink:
    """EventSink wrapper stamping ``replica=<name>`` onto every event an
    engine emits, so one shared JSONL stream stays attributable."""

    def __init__(self, inner: EventSink, **labels):
        self._inner = inner
        self._labels = labels

    def emit(self, event, step=None, **fields):
        self._inner.emit(event, step=step, **{**self._labels, **fields})

    def relabel(self, **labels):
        """Re-stamp (the warming engine becomes a named replica when a
        rolling update adopts it)."""
        self._labels.update(labels)

    def __getattr__(self, name):
        return getattr(self._inner, name)


class Replica:
    """One supervised fleet member: a name (``rK``), the CURRENT engine
    (swapped under the lock on restart and weight flip), a state
    machine, and the router-facing breaker state.

    States: ``init`` → ``ready`` ⇄ ``restarting`` → ``failed`` /
    ``stopped``.  ``generation`` increments on every engine swap — the
    router uses it to avoid striking a fresh engine for its
    predecessor's failures."""

    def __init__(self, index: int):
        self.index = index
        self.name = f"r{index}"
        self._lock = threading.RLock()
        self._engine = None
        self.state = "init"
        self.restarts = 0
        self.generation = 0
        # breaker (router-managed, supervisor-reset)
        self._consec_failures = 0
        self._broken_until = 0.0
        # supervisor book-keeping
        self.restart_failures = 0
        self.backoff_level = 0
        self.ready_since: Optional[float] = None
        # seconds the newest engine took from construction to ready
        # (the manifest replay and the warmup included)
        self.start_s: Optional[float] = None

    @property
    def engine(self):
        with self._lock:
            return self._engine

    def release(self):
        """Give up the current engine without a successor (a restart
        drops the dead engine before it builds the next); returns it.
        The replica is not eligible meanwhile."""
        with self._lock:
            old, self._engine = self._engine, None
            return old

    def adopt(self, engine):
        """Atomically make ``engine`` this replica's engine; returns the
        previous one (caller stops/drains it).  Resets the breaker —
        strikes belong to the old engine."""
        with self._lock:
            old, self._engine = self._engine, engine
            self.generation += 1
            self._consec_failures = 0
            self._broken_until = 0.0
            return old

    def set_state(self, state: str) -> None:
        with self._lock:
            self.state = state
            if state == "ready":
                self.ready_since = time.monotonic()

    def pending(self) -> int:
        eng = self.engine
        if eng is None:
            return 0
        return int(eng.health()["pending"])

    def queue_capacity(self) -> Optional[int]:
        """THIS replica's admission-queue bound, read through the
        engine facade — heterogeneous fleets (a remote with a different
        ``max_queue``) must not be spilled against a shared config's
        capacity.  ``None`` when unknowable (no engine, or a remote
        that has not learned its bound yet)."""
        eng = self.engine
        if eng is None:
            return None
        fn = getattr(eng, "queue_capacity", None)
        return fn() if fn is not None else None

    def breaker_open(self) -> bool:
        with self._lock:
            return time.monotonic() < self._broken_until

    def note_failure(self, threshold: int, cooldown_s: float) -> bool:
        """One failover-class strike.  Returns True when THIS strike
        transitioned the breaker from closed to open — the caller
        (router) emits the ``fleet_breaker_open`` event exactly once
        per open, not once per strike."""
        with self._lock:
            was_open = time.monotonic() < self._broken_until
            self._consec_failures += 1
            if self._consec_failures >= threshold:
                self._broken_until = time.monotonic() + cooldown_s
                return not was_open
            return False

    def note_success(self) -> None:
        with self._lock:
            self._consec_failures = 0

    def eligible(self) -> bool:
        """Router health gate: ready state, closed breaker, and the
        engine itself reporting ready."""
        with self._lock:
            if self.state != "ready" or self._engine is None:
                return False
            if time.monotonic() < self._broken_until:
                return False
            eng = self._engine
        return bool(eng.health()["ready"])


class ReplicaFleet:
    """See module docstring.  Lifecycle::

        fleet = ReplicaFleet(state_dict, model_cfg, serve_cfg,
                             FleetConfig(replicas=2,
                                         warmup_shapes=[(436, 1024)]))
        fleet.start()
        router = FlowRouter(fleet)
        flow = router.infer(image1, image2)
        fleet.update_weights("checkpoints/run1")   # rolling, gated
        fleet.stop()

    ``state_dict`` is the port's; ``device`` (default the card) is every
    local engine's."""

    def __init__(self, state_dict: Mapping, model_cfg,
                 serve_cfg: ServeConfig = ServeConfig(),
                 fleet_cfg: FleetConfig = FleetConfig(), *,
                 registry: Optional[MetricRegistry] = None,
                 sink: Optional[EventSink] = None, device="cuda"):
        self.model_cfg = model_cfg
        self.serve_cfg = serve_cfg
        self.fleet_cfg = fleet_cfg
        self.device = device
        self.registry = registry or MetricRegistry()
        self._sink = sink if sink is not None else EventSink.from_env()
        self._variables = state_dict
        self._var_lock = threading.Lock()
        self.weights_version = 1
        self.replicas: List[Replica] = [
            Replica(i) for i in range(fleet_cfg.replicas)]
        if fleet_cfg.remote:
            # Lazy import: remote.py imports this module's Replica, so
            # the fleet must not import remote at module load.
            from raft_tpu_torch.serve.remote import (RemoteConfig,
                                                     RemoteReplica)

            rcfg = fleet_cfg.remote_cfg or RemoteConfig()
            for addr in fleet_cfg.remote:
                self.replicas.append(
                    RemoteReplica(len(self.replicas), addr, rcfg))
        #: Next fresh replica index — scale-ups keep numbering past any
        #: retired names (a drained r2 never comes back as a different
        #: engine under the same name).
        self._next_index = len(self.replicas)
        self._router = None
        self.aot_dir = fleet_cfg.aot_dir or tempfile.mkdtemp(
            prefix="raft-aot-")
        self.resident_budget_bytes = fleet_cfg.resident_budget_bytes
        if self.resident_budget_bytes is None and str(device) != "cpu":
            import torch

            engines = max(fleet_cfg.replicas, fleet_cfg.autoscale_max) + 1
            self.resident_budget_bytes = int(
                RESIDENT_FRACTION * torch.cuda.get_device_properties(
                    torch.device(device)).total_memory / engines)
        self._started = False
        self._stop_event = threading.Event()
        self._supervisor: Optional[threading.Thread] = None
        self._update_lock = threading.Lock()
        self._warming = None
        self._backoff_rng = np.random.default_rng(0)

        self._restarts = self.registry.counter(
            "raft_fleet_restarts_total",
            "supervised replica restarts, by replica and reason")
        self._weight_updates = self.registry.counter(
            "raft_fleet_weight_updates_total",
            "rolling weight updates, by outcome")
        self._quality_drifts = self.registry.counter(
            "raft_fleet_quality_drift_total",
            "replica-local quality_drift firings surfaced by the "
            "supervisor, by replica and proxy")
        self._scale_events = self.registry.counter(
            "raft_fleet_scale_events_total",
            "autoscaler replica-count changes, by direction")
        # Autoscaler state (supervisor thread only): hysteresis streaks,
        # the cooldown window, and the flap count (direction reversals
        # — the check_regression.py --max-scale-flaps gate reads it off
        # the fleet_scale events).
        self._scale_last_dir: Optional[str] = None
        self._scale_flaps = 0
        self._scale_ups = 0
        self._scale_downs = 0
        self._scale_cooldown_until = 0.0
        self._up_streak = 0
        self._down_streak = 0
        self._autoscale_next = 0.0
        # Quality-drift dedup per (replica, engine generation, proxy)
        # and the cached golden-batch reference scores of the CURRENT
        # serving weights (update_weights' proxy gate; invalidated by
        # each successful flip — the new weights become the reference).
        self._drift_seen: Dict[tuple, int] = {}
        self._golden_ref: Optional[dict] = None
        self._pending_golden: Optional[dict] = None
        self._replica_gauge = self.registry.gauge(
            "raft_fleet_replicas", "replicas by current state")
        self._version_gauge = self.registry.gauge(
            "raft_fleet_weights_version", "serving weights version")
        self.registry.add_collect_hook(self._collect)
        # Incident correlation (obs/incident.py): the fleet owns ONE
        # manager observing the SHARED sink — every engine's
        # _LabeledSink writes through it, so a cross-replica cascade
        # (kill on r0, retries on r1) correlates into one incident.
        # _build_engine forces incidents=False on the engines for the
        # same reason: N engine-level observers on one stream would
        # open N incidents for one cascade.
        self._incidents = None
        if serve_cfg.incidents:
            from raft_tpu_torch.obs import incident as incident_mod

            self._incidents = incident_mod.IncidentManager(
                registry=self.registry,
                window_s=serve_cfg.incident_window_s,
                quiet_close_s=serve_cfg.incident_quiet_s,
                cooldown_s=serve_cfg.incident_cooldown_s)
            self._incidents.attach(self._sink)
            self._incidents.recorder.add_provider("fleet_stats",
                                                  self.stats)
            self._incidents.recorder.add_provider(
                "serve_config",
                lambda: dataclasses.asdict(self.serve_cfg))
            self._incidents.recorder.add_provider(
                "fleet_config",
                lambda: dataclasses.asdict(self.fleet_cfg))

    def bind_router(self, router) -> None:
        """The router registers itself at construction
        (``FlowRouter.__init__``) so graceful scale-down can evacuate
        the victim's streaming sessions (``router.evacuate``) before
        the drain — sessions survive the shrink via ``stream_restart``
        replay instead of dying with their lane."""
        self._router = router

    def _collect(self, _reg) -> None:
        states: Dict[str, int] = {}
        for r in self.replicas:
            states[r.state] = states.get(r.state, 0) + 1
        for state, n in states.items():
            self._replica_gauge.set(n, state=state)
        self._version_gauge.set(self.weights_version)

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    def _build_engine(self, variables=None,
                      replica: str = "?") -> InferenceEngine:
        with self._var_lock:
            v = self._variables if variables is None else variables
        cfg = dataclasses.replace(self.serve_cfg, aot_dir=self.aot_dir,
                                  incidents=False)
        return InferenceEngine(v, self.model_cfg, cfg,
                               sink=_LabeledSink(self._sink,
                                                 replica=replica),
                               device=self.device,
                               resident_budget_bytes=(
                                   self.resident_budget_bytes))

    def _drop(self, engine, drain: bool = False,
              timeout: float = 10.0) -> None:
        """Stop ``engine``, which the caller has taken off its replica:
        its states and graphs go on the device worker in ``stop()``.
        The caller then drops its last reference and calls
        :meth:`_reclaim`."""
        try:
            engine.stop(drain=drain, timeout=timeout)
        except Exception as e:
            self._sink.emit("fleet_stop_error", error=str(e)[:300])

    def _reclaim(self) -> None:
        """Collect dropped engines (they hold reference cycles: their
        weights and whatever else they hold go only with a collection)
        and give the freed blocks back to the card, both on the device
        worker, where no capture can be in flight."""
        if str(self.device) == "cpu":
            gc.collect()
            return
        import torch

        def run():
            gc.collect()
            torch.cuda.empty_cache()

        on_device(self.device, run)

    def start(self) -> "ReplicaFleet":
        """Bring the fleet up: replica 0 warms (capturing whatever the
        manifest doesn't already list) and writes the manifest; the rest
        replay it in ``start()`` and serve their first request without a
        capture."""
        if self._started:
            raise RuntimeError("fleet already started")
        self._started = True
        for r in self.replicas:
            if getattr(r, "is_remote", False):
                # The remote host owns its engine lifecycle; this side
                # only builds the wire client (no device work).
                r.start(sink=self._sink)
                continue
            t0 = time.perf_counter()
            eng = self._build_engine(replica=r.name)
            eng.start()
            if self.fleet_cfg.warmup_shapes:
                # Replays of what the manifest replay captured; captures
                # on replica 0 (or after a warm-start miss).
                eng.warmup(self.fleet_cfg.warmup_shapes)
            r.start_s = time.perf_counter() - t0
            r.adopt(eng)
            r.set_state("ready")
            if (r.index == 0 and self.fleet_cfg.auto_export_aot
                    and eng.compiled_keys()):
                try:
                    eng.export_aot(self.aot_dir)
                except Exception as e:  # export is an optimization,
                    self._sink.emit(     # never a bring-up failure
                        "aot_export_error", error=str(e)[:300])
        self._supervisor = threading.Thread(
            target=self._supervise, name="raft-fleet-supervisor",
            daemon=True)
        self._supervisor.start()
        self._sink.emit("fleet_start", replicas=len(self.replicas),
                        aot_dir=self.aot_dir)
        return self

    def stop(self, drain: bool = True, timeout: float = 30.0) -> None:
        """Stop supervision, any in-progress warming engine, and every
        replica (optionally draining in-flight work).  Safe to call
        while a weight update's warmup is mid-flight: the warming
        engine is stopped and the update fails cleanly."""
        self._stop_event.set()
        if self._supervisor is not None:
            self._supervisor.join(timeout=30)
            self._supervisor = None
        warming = self._warming
        if warming is not None:
            try:
                warming.stop(drain=False, timeout=10)
            except Exception:
                pass
        for r in self.replicas:
            eng = r.engine
            r.set_state("stopped")
            if eng is not None:
                eng.stop(drain=drain, timeout=timeout)
        self._sink.emit("fleet_stop")
        if self._incidents is not None:
            self._incidents.close()

    def __enter__(self) -> "ReplicaFleet":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ------------------------------------------------------------------
    # supervision
    # ------------------------------------------------------------------

    def _supervise(self) -> None:
        poll = self.fleet_cfg.health_poll_s
        while not self._stop_event.wait(poll):
            # Snapshot: _scale_up/_scale_down swap self.replicas
            # copy-on-write on this same thread, but a snapshot keeps
            # the iteration obviously safe either way.
            for r in list(self.replicas):
                if self._stop_event.is_set():
                    return
                if getattr(r, "is_remote", False):
                    # No rebuild across the wire: poll() watches the
                    # health transition and rejoins the replica
                    # (generation bump + breaker reset) when the
                    # partition heals.
                    r.poll(self._sink)
                    continue
                if r.state != "ready":
                    continue
                eng = r.engine
                if eng is None:
                    continue
                if eng.crashed:
                    self._restart(r, "crash")
                    continue
                if eng.health()["stalled"]:
                    self._restart(r, "stall")
                    continue
                if (r.backoff_level
                        and r.ready_since is not None
                        and time.monotonic() - r.ready_since
                        > self.fleet_cfg.backoff_reset_s):
                    r.backoff_level = 0
                self._note_quality_drift(r, eng)
            del eng
            if (self.fleet_cfg.autoscale_max
                    and time.monotonic() >= self._autoscale_next):
                self._autoscale_next = (
                    time.monotonic()
                    + self.fleet_cfg.autoscale_interval_s)
                try:
                    self._autoscale_tick()
                except Exception as e:
                    # A failed scale move must not kill supervision.
                    self._sink.emit(
                        "fleet_scale_error",
                        error=f"{type(e).__name__}: {str(e)[:300]}")
            if self._incidents is not None:
                # Quiet-close poll: an incident over a stream that went
                # silent still closes (and writes its final bundle)
                # without waiting for another event.
                self._incidents.poll()

    def _note_quality_drift(self, r: Replica, eng) -> None:
        """Forward each NEW replica-local quality_drift firing
        (engine drift detectors, obs/quality.py) as one fleet-level
        ``fleet_quality_drift`` event + counter bump.  Dedup is per
        (replica, engine generation, proxy): a restarted or flipped
        engine starts a fresh drift history."""
        try:
            drift = eng.quality_drift()
        except Exception:
            return
        if not drift:
            return
        for proxy, st in drift.items():
            events = int(st.get("events", 0))
            key = (r.name, r.generation, proxy)
            if events > self._drift_seen.get(key, 0):
                self._drift_seen[key] = events
                self._quality_drifts.inc(replica=r.name, proxy=proxy)
                self._sink.emit("fleet_quality_drift", replica=r.name,
                                proxy=proxy, score=st.get("score"),
                                events=events)

    def _backoff(self, level: int) -> float:
        cfg = self.fleet_cfg
        base = min(cfg.restart_backoff_s * 2 ** max(level - 1, 0),
                   cfg.restart_backoff_max_s)
        return base * (1.0 + cfg.restart_jitter
                       * float(self._backoff_rng.uniform(-1, 1)))

    def _restart(self, r: Replica, reason: str) -> None:
        """Drop the dead engine, back off, build + adopt a fresh one
        (manifest replayed in ``start()``: its first request captures
        nothing).  Runs on the supervisor thread; restarts are
        sequential by design."""
        r.set_state("restarting")
        old = r.release()
        crash_reason = getattr(old, "crashed", None)
        self._sink.emit("fleet_restart_begin", replica=r.name,
                        reason=reason, crash=crash_reason)
        if old is not None:
            # drain=False: a crashed/wedged engine cannot finish its
            # queue; fail the stragglers fast so the router fails them
            # over while we rebuild
            self._drop(old, drain=False, timeout=10)
            del old
            self._reclaim()
        while not self._stop_event.is_set():
            r.backoff_level += 1
            backoff = self._backoff(r.backoff_level)
            if self._stop_event.wait(backoff):
                return
            try:
                t0 = time.perf_counter()
                eng = self._build_engine(replica=r.name)
                eng.start()
                r.start_s = time.perf_counter() - t0
            except Exception as e:
                r.restart_failures += 1
                self._sink.emit("fleet_restart_error", replica=r.name,
                                attempt=r.restart_failures,
                                error=f"{type(e).__name__}: "
                                      f"{str(e)[:300]}")
                if (r.restart_failures
                        >= self.fleet_cfg.max_restart_failures):
                    r.set_state("failed")
                    self._sink.emit("fleet_replica_failed",
                                    replica=r.name,
                                    attempts=r.restart_failures)
                    return
                continue
            r.adopt(eng)
            r.restarts += 1
            r.restart_failures = 0
            r.set_state("ready")
            self._restarts.inc(replica=r.name, reason=reason)
            self._sink.emit("fleet_restart", replica=r.name,
                            reason=reason, restarts=r.restarts,
                            backoff_s=round(backoff, 4),
                            start_s=round(r.start_s, 4),
                            aot=dict(eng.aot_info))
            del eng
            return

    # ------------------------------------------------------------------
    # elastic autoscaling (supervisor thread)
    # ------------------------------------------------------------------

    def _local_replicas(self) -> List[Replica]:
        return [r for r in self.replicas
                if not getattr(r, "is_remote", False)]

    def load_signals(self) -> dict:
        """Fleet-wide load snapshot over ELIGIBLE replicas: queue
        pressure summed (pending and capacity pool across the fleet),
        burn rate / occupancy / latency taken at the worst replica
        (a saturated straggler is the scaling signal even when the
        mean looks fine).  Cheap by contract — every per-engine
        ``load_signals()`` reads locks/atomics only."""
        pending = cap = 0
        burn = occ = lat = 0.0
        mfu = None
        for r in list(self.replicas):
            if not r.eligible():
                continue
            eng = r.engine
            fn = getattr(eng, "load_signals", None)
            if fn is None:
                continue
            try:
                sig = fn()
            except Exception:
                continue
            pending += int(sig.get("pending") or 0)
            cap += int(sig.get("max_queue") or 0)
            burn = max(burn, float(sig.get("burn_rate") or 0.0))
            occ = max(occ, float(sig.get("occupancy") or 0.0))
            lat = max(lat, float(sig.get("latency_p95_ms") or 0.0))
            m = sig.get("mfu")
            if m is not None:
                mfu = m if mfu is None else max(mfu, m)
        return {"pending": pending, "max_queue": cap,
                "queue_frac": round(pending / cap, 4) if cap else 0.0,
                "burn_rate": round(burn, 4),
                "occupancy": round(occ, 4), "mfu": mfu,
                "latency_p95_ms": round(lat, 2)}

    def _autoscale_tick(self) -> None:
        """One scaling decision.  Hysteresis + cooldown keep it from
        flapping: pressure must persist ``autoscale_up_consecutive``
        ticks (idle: ``autoscale_down_consecutive``) before a move, and
        each move blocks further moves for ``autoscale_cooldown_s``."""
        cfg = self.fleet_cfg
        sig = self.load_signals()
        up = sig["queue_frac"] >= cfg.autoscale_up_queue_frac
        if cfg.autoscale_up_burn_rate is not None:
            up = up or sig["burn_rate"] >= cfg.autoscale_up_burn_rate
        down = (not up
                and (sig["pending"] == 0
                     or sig["queue_frac"]
                     <= cfg.autoscale_down_queue_frac))
        self._up_streak = self._up_streak + 1 if up else 0
        self._down_streak = self._down_streak + 1 if down else 0
        if time.monotonic() < self._scale_cooldown_until:
            return
        ready_locals = [r for r in self._local_replicas()
                        if r.state == "ready"]
        n = len(ready_locals)
        if (up and self._up_streak >= cfg.autoscale_up_consecutive
                and n < cfg.autoscale_max):
            self._scale_up(sig)
        elif (down
              and self._down_streak >= cfg.autoscale_down_consecutive
              and n > cfg.autoscale_min):
            # Victim = the NEWEST ready local replica: the longest-lived
            # ones hold the warmest affinity history.
            self._scale_down(ready_locals[-1], sig)

    def _scale_up(self, sig: dict) -> None:
        """Grow by one local replica.  The manifest replica 0 wrote at
        bring-up makes this capture-free on the request path: the new
        engine replays it in ``start()``."""
        t0 = time.perf_counter()
        r = Replica(self._next_index)
        self._next_index += 1
        eng = self._build_engine(replica=r.name)
        eng.start()
        if self.fleet_cfg.warmup_shapes:
            eng.warmup(self.fleet_cfg.warmup_shapes)
        r.start_s = time.perf_counter() - t0
        r.adopt(eng)
        r.set_state("ready")
        # Copy-on-write: the router iterates fleet.replicas lock-free.
        self.replicas = self.replicas + [r]
        self._note_scale("up", r, sig, time.perf_counter() - t0)

    def _scale_down(self, victim: Replica, sig: dict) -> None:
        """Shrink by one local replica, gracefully: mark it draining
        (placement stops immediately), move its streaming sessions to
        siblings (``stream_restart reason=scale_down`` replay), then
        drain in-flight work to completion — zero dropped requests by
        construction."""
        t0 = time.perf_counter()
        victim.set_state("draining")
        moved: list = []
        if self._router is not None:
            try:
                moved = self._router.evacuate(victim.name,
                                              reason="scale_down")
            except Exception as e:
                self._sink.emit(
                    "fleet_scale_error", replica=victim.name,
                    error=f"evacuate: {type(e).__name__}: "
                          f"{str(e)[:300]}")
        eng = victim.release()
        if eng is not None:
            self._drop(eng, drain=True,
                       timeout=self.fleet_cfg.drain_timeout_s)
            del eng
            self._reclaim()
        victim.set_state("stopped")
        self.replicas = [r for r in self.replicas if r is not victim]
        self._note_scale("down", victim, sig,
                         time.perf_counter() - t0, moved=len(moved))

    def _note_scale(self, direction: str, r: Replica, sig: dict,
                    seconds: float, **extra) -> None:
        if (self._scale_last_dir is not None
                and self._scale_last_dir != direction):
            self._scale_flaps += 1
        self._scale_last_dir = direction
        if direction == "up":
            self._scale_ups += 1
        else:
            self._scale_downs += 1
        self._scale_cooldown_until = (
            time.monotonic() + self.fleet_cfg.autoscale_cooldown_s)
        self._up_streak = self._down_streak = 0
        self._scale_events.inc(direction=direction)
        self._sink.emit("fleet_scale", direction=direction,
                        replica=r.name, replicas=len(self.replicas),
                        flaps=self._scale_flaps,
                        seconds=round(seconds, 3), signals=sig,
                        **extra)

    # ------------------------------------------------------------------
    # rolling weight updates
    # ------------------------------------------------------------------

    def update_weights(self, source) -> dict:
        """Roll the fleet onto new weights with zero downtime.

        ``source`` is a training run directory (the port's checkpoints:
        the newest step is verified by actually reading it, with no
        fallback to an older one) or an in-memory ``state_dict``.
        Gates: verify-ckpt, then a canary inference on the
        warming engine (finite flow, correct shape), then the
        golden-batch quality-proxy comparison vs the live fleet
        (``canary_proxy_budget``).  Only after all pass does any
        serving replica flip; flips are one replica at a
        time, atomic per replica, old engine drained.  Raises
        :class:`WeightUpdateError` at any gate — the fleet keeps
        serving its current weights."""
        with self._update_lock:
            if not self._started or self._stop_event.is_set():
                raise WeightUpdateError("fleet is not running")
            t0 = time.perf_counter()
            warming = None
            try:
                new_vars, provenance = self._load_verified(source)
                warming = self._build_engine(new_vars,
                                             replica="warming")
                self._warming = warming
                warming.start()
                if self.fleet_cfg.warmup_shapes:
                    warming.warmup(self.fleet_cfg.warmup_shapes)
                canary = self._canary(warming)
            except Exception as e:
                self._abort_update_locked(warming, e)
                if isinstance(e, WeightUpdateError):
                    raise
                raise WeightUpdateError(
                    f"weight update aborted before any flip: "
                    f"{type(e).__name__}: {e}") from e
            # Commit point: gates passed.  New builds (supervised
            # restarts racing this update) must pick up the NEW
            # weights or the fleet would serve two versions forever.
            with self._var_lock:
                self._variables = new_vars
            flipped = []
            try:
                for r in list(self.replicas):
                    if self._stop_event.is_set():
                        break
                    if getattr(r, "is_remote", False):
                        continue  # the remote host rolls its own weights
                    if r.state != "ready":
                        continue  # supervisor rebuilds it on new vars
                    if warming is not None:
                        new_eng, warming = warming, None
                        self._warming = None
                        if isinstance(new_eng._sink, _LabeledSink):
                            new_eng._sink.relabel(replica=r.name)
                    else:
                        new_eng = self._build_engine(new_vars,
                                                     replica=r.name)
                        new_eng.start()
                    old = r.adopt(new_eng)
                    del new_eng
                    # the requests the old engine still owes drain below
                    self._sink.emit(
                        "fleet_replica_flip", replica=r.name,
                        generation=r.generation,
                        in_flight=(0 if old is None
                                   else int(old.health()["pending"])))
                    if old is not None:
                        self._drop(old, drain=True,
                                   timeout=self.fleet_cfg.drain_timeout_s)
                        del old
                        self._reclaim()
                    flipped.append(r.name)
            except Exception as e:
                self._abort_update_locked(warming, e, flipped=flipped)
                raise WeightUpdateError(
                    f"weight update failed mid-roll (flipped: "
                    f"{flipped}; unflipped replicas rebuild onto the "
                    f"new weights on their next restart): "
                    f"{type(e).__name__}: {e}") from e
            if warming is not None:  # no ready replica consumed it
                self._warming = None
                self._drop(warming, drain=False, timeout=5)
                warming = None
                self._reclaim()
            self.weights_version += 1
            if self._pending_golden is not None:
                # The flipped weights are the new golden reference for
                # the NEXT update's proxy comparison.
                self._golden_ref = self._pending_golden
                self._pending_golden = None
            self._weight_updates.inc(ok="true")
            report = {"ok": True, "version": self.weights_version,
                      "flipped": flipped, "provenance": provenance,
                      "canary": canary,
                      "seconds": round(time.perf_counter() - t0, 3)}
            self._sink.emit("fleet_weight_update", **report)
            return report

    def _abort_update_locked(self, warming, exc,
                             flipped: Optional[list] = None) -> None:
        # Caller holds self._update_lock (both call sites sit inside
        # update_weights' critical section; the *_locked suffix is the
        # lock-discipline convention).
        self._warming = None
        self._pending_golden = None
        if warming is not None:
            self._drop(warming, drain=False, timeout=5)
            del warming
            self._reclaim()
        self._weight_updates.inc(ok="false")
        self._sink.emit("fleet_weight_update", ok=False,
                        flipped=flipped or [],
                        error=f"{type(exc).__name__}: {str(exc)[:300]}")

    def _load_verified(self, source):
        """Load + integrity-gate new weights: a ``state_dict``, a weight
        file (the port's own ``.pth`` or a reference-format one, read by
        the loader ``serve --model`` uses) or a run directory.  Never let
        a torn write through: the newest step of a run directory is read
        and checked (size, checksum, unpickling, the saved keys:
        ``verify-ckpt``'s check) BEFORE the model load, and a weight file
        that does not load whole is refused; there is deliberately NO
        fallback to an older step or the old weights — a silent version
        downgrade is worse than a refused update."""
        if isinstance(source, Mapping):
            return dict(source), {"kind": "state_dict"}
        path = os.path.abspath(str(source))
        if not os.path.exists(path):
            raise WeightUpdateError(
                f"checkpoint dir or weight file not found: {path}")
        if not os.path.isdir(path):
            from raft_tpu_torch.convert import load_state_dict_file

            try:
                new_sd = load_state_dict_file(path, self.model_cfg)
            except Exception as e:
                raise WeightUpdateError(
                    f"failed to load weights from {path}: "
                    f"{type(e).__name__}: {e}") from e
            return new_sd, {"kind": "file", "path": path}
        from raft_tpu_torch.train.checkpoint import CheckpointManager

        mgr = CheckpointManager(path)
        try:
            steps = mgr.all_steps()
            if not steps:
                raise WeightUpdateError(
                    f"no checkpoint steps under {path}")
            newest = max(steps)
            report = mgr.verify(newest)
            if not report["ok"]:
                raise WeightUpdateError(
                    f"verify-ckpt gate failed for step {newest}: "
                    f"{report.get('error')}")
            try:
                saved = mgr.read_step(newest)["model"]
            except Exception as e:
                raise WeightUpdateError(
                    f"failed to load weights from {path} step {newest}: "
                    f"{type(e).__name__}: {e}") from e
        finally:
            mgr.close()
        new_sd = {k: v.float() if v.is_floating_point() else v
                  for k, v in saved.items()}
        return new_sd, {"kind": "dir", "path": path, "step": newest,
                        "verified": True}

    def _canary(self, warming) -> dict:
        """Canary gates: the warming engine must (1) produce finite
        flow of the right shape on synthetic frames, and (2) not
        regress the golden-batch quality proxy beyond
        ``canary_proxy_budget`` relative to the live fleet
        (``obs/quality.py`` canary score on deterministic low-motion
        frames — the check that catches finite-but-garbage weights the
        contract checks wave through).  The proxy comparison is
        skipped (recorded, not failed) when no live replica can score
        the reference or no canary/warmup shapes are configured."""
        shapes = (self.fleet_cfg.canary_shapes
                  or self.fleet_cfg.warmup_shapes or ((64, 96),))
        rng = np.random.default_rng(0)
        report = []
        for (h, w) in shapes:
            im1 = rng.uniform(0, 255, (h, w, 3)).astype(np.float32)
            im2 = rng.uniform(0, 255, (h, w, 3)).astype(np.float32)
            try:
                flow = warming.infer(im1, im2, timeout=300)
            except Exception as e:
                raise WeightUpdateError(
                    f"canary inference failed at {h}x{w}: "
                    f"{type(e).__name__}: {e}") from e
            if flow.shape != (h, w, 2):
                raise WeightUpdateError(
                    f"canary flow shape {flow.shape} != {(h, w, 2)}")
            if not np.isfinite(flow).all():
                raise WeightUpdateError(
                    f"canary flow at {h}x{w} contains non-finite "
                    "values — refusing to roll these weights out")
            report.append({"shape": [h, w],
                           "flow_abs_mean":
                               round(float(np.abs(flow).mean()), 4)})
        return {"frames": report,
                "proxy": self._canary_proxy_gate_locked(warming)}

    def _canary_proxy_gate_locked(self, warming) -> Optional[dict]:
        budget = self.fleet_cfg.canary_proxy_budget
        shapes = (self.fleet_cfg.canary_shapes
                  or self.fleet_cfg.warmup_shapes)
        if budget is None or not shapes:
            return None
        ref = self._live_golden_scores_locked(shapes)
        try:
            new = _golden_proxy_scores(warming, shapes)
        except Exception as e:
            raise WeightUpdateError(
                f"canary proxy scoring failed: "
                f"{type(e).__name__}: {e}") from e
        self._pending_golden = new
        if ref is None:
            return {"skipped": "no live reference replica",
                    "new": new["score"]}
        delta = ((new["score"] - ref["score"])
                 / max(abs(ref["score"]), 1e-6))
        ok = delta <= budget
        proxy = {"old": ref["score"], "new": new["score"],
                 "delta_pct": round(100.0 * delta, 2),
                 "budget_pct": round(100.0 * budget, 2),
                 "ok": ok}
        self._sink.emit("fleet_canary_proxy", **proxy)
        if not ok:
            raise WeightUpdateError(
                f"canary proxy regression: golden-batch quality score "
                f"{new['score']:.4f} vs live {ref['score']:.4f} "
                f"({100.0 * delta:+.1f}% > canary_proxy_budget "
                f"{100.0 * budget:.0f}%) — refusing to roll these "
                f"weights out")
        return proxy

    def _live_golden_scores_locked(self, shapes) -> Optional[dict]:
        """Golden-batch scores of the CURRENT serving weights, lazily
        computed on the first eligible replica and cached until a
        successful flip replaces them (the flipped weights become the
        next update's reference)."""
        if self._golden_ref is not None:
            return self._golden_ref
        for r in self.replicas:
            if not r.eligible():
                continue
            eng = r.engine
            if eng is None:
                continue
            try:
                self._golden_ref = _golden_proxy_scores(eng, shapes)
                return self._golden_ref
            except Exception as e:
                self._sink.emit("fleet_canary_proxy_ref_error",
                                replica=r.name,
                                error=f"{type(e).__name__}: "
                                      f"{str(e)[:300]}")
                return None
        return None

    # ------------------------------------------------------------------
    # introspection
    # ------------------------------------------------------------------

    def health(self) -> dict:
        """Fleet readiness: ready ⇔ at least one replica is eligible
        for traffic.  Per-replica detail nested under ``replicas``."""
        reps = {}
        for r in self.replicas:
            eng = r.engine
            h = eng.health() if eng is not None else {"ready": False}
            extra = {}
            drift = (eng.quality_drift() if eng is not None else None)
            if drift is not None:
                extra["quality_drifted"] = any(
                    bool(s.get("drifted")) for s in drift.values())
            reps[r.name] = dict(h, state=r.state, restarts=r.restarts,
                                generation=r.generation,
                                breaker_open=r.breaker_open(), **extra)
        return {"ready": any(r.eligible() for r in self.replicas),
                "weights_version": self.weights_version,
                "replicas": reps}

    def stats(self) -> dict:
        reps = {}
        for r in self.replicas:
            eng = r.engine
            s = eng.stats() if eng is not None else {}
            reps[r.name] = dict(s, state=r.state, restarts=r.restarts,
                                generation=r.generation, start_s=r.start_s)
        return {
            "fleet": {
                "replicas": len(self.replicas),
                "weights_version": self.weights_version,
                "restarts_total": int(sum(
                    v for _, v in self._restarts.items())),
                "aot_dir": self.aot_dir,
                "resident_budget_bytes": self.resident_budget_bytes,
                "incidents": (self._incidents.snapshot()
                              if self._incidents is not None
                              else {"enabled": False}),
                "autoscale": {
                    "enabled": bool(self.fleet_cfg.autoscale_max),
                    "min": self.fleet_cfg.autoscale_min,
                    "max": self.fleet_cfg.autoscale_max,
                    "ups": self._scale_ups,
                    "downs": self._scale_downs,
                    "flaps": self._scale_flaps,
                },
            },
            "replicas": reps,
        }

    def metrics_text(self) -> str:
        """One Prometheus exposition for the whole fleet: fleet-level
        series (restarts, weight updates, router counters — the router
        registers on this registry) plus every replica's engine
        registry with a ``replica`` label merged onto each sample."""
        parts = [render_metrics(self.registry)]
        for r in self.replicas:
            eng = r.engine
            if eng is not None:
                parts.append(render_metrics(
                    eng.registry, extra_labels={"replica": r.name}))
        return "".join(parts)
