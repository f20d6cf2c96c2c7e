"""Health-gated request router for a replica fleet (the port of
``raft_tpu/serve/router.py``).

The router is the fleet's front door: callers ``submit()`` here instead
of on an engine, and the router picks WHICH replica runs the request —
then stands behind it until the future resolves.  The contract that
matters is the last one: **an accepted request is never silently
dropped**.  Every accepted future terminates, either with a flow field
or with the error of its LAST attempt — a replica dying mid-batch costs
the request a failover hop, not an infinite wait.

Placement policy, in order:

1. **Health gate** — replicas that are not ready (crashed, stalled,
   stopping, still restarting) or whose circuit breaker is open get NO
   traffic.  The gate reads the engine's own ``health()`` signal, the
   same one ``GET /v1/healthz`` serves.
2. **Bucket affinity** — requests hash by their padded shape bucket
   (``crc32(bucket) % n``), so each bucket's captured graphs and
   micro-batching concentrate on one replica instead of smearing
   captures across the fleet.
3. **Least-loaded fallback** — when the affine replica is ineligible or
   saturated (pending ≥ 3/4 of ``max_queue``), the least-loaded
   eligible replica takes the request.

Failure handling:

- **Failover**: a request that fails with a *replica-indicting* error
  (:func:`is_failover_error` — replica-fatal chaos faults, an engine
  that stopped/crashed under the request, or a transient device error
  that out-lived the engine's own retry ladder) is re-dispatched on a
  sibling, **at most once per replica** (a tried-set, so a poison
  request that kills every replica fails after N attempts instead of
  cycling forever).  Deterministic request errors (bad shapes) are
  returned to the caller unchanged — re-running them elsewhere would
  only repeat the failure.
- **Hedging**: with ``hedge_timeout_s > 0``, a request still unresolved
  after the timeout gets ONE duplicate dispatch on a different replica;
  first result wins, the loser is ignored (bounded: one hedge per
  request, never to a replica already tried).  This covers stragglers —
  the ``replica_slow`` chaos fault — without the 2x load of
  always-mirror.
- **Circuit breaker**: ``breaker_threshold`` consecutive failover-class
  failures open a replica's breaker for ``breaker_cooldown_s`` (no
  traffic), so a flapping replica can't eat a failover hop from every
  request while the supervisor gets around to restarting it.
- **Backpressure**: when no eligible replica can accept (all queues
  full), ``submit()`` raises :class:`QueueFullError` carrying the
  fleet-wide queue depth — the HTTP edge turns it into a structured
  429 with Retry-After.

Streaming sessions: a session's device state (pinned lane, warm carry)
lives in ONE replica's engine, so the router layers **session
affinity** on top of bucket affinity — the replica picked at open
serves every frame.  That state dies with
the engine; the router's job is to make that loss invisible at the
cost of one cold frame.  It keeps each stream's last frame host-side
and, when the pinned replica was restarted (rolling
``update_weights``, detected by the replica's ``generation`` bump) or
fails over mid-frame, re-opens the session on an eligible replica by
replaying that frame as the new frame 0 — the next pair runs cold and
the stream continues, monotone frame numbering intact
(``stream_restart`` event, ``raft_fleet_stream_restarts_total``).
"""

from __future__ import annotations

import dataclasses
import threading
import time
import zlib
from concurrent.futures import Future
from typing import List, Optional, Set

import numpy as np

from raft_tpu_torch.chaos import is_transient_error
from raft_tpu_torch.obs import EventSink, MetricRegistry
from raft_tpu_torch.obs import trace
from raft_tpu_torch.ops.pad import bucket_hw
from raft_tpu_torch.serve.engine import QueueFullError
from raft_tpu_torch.serve.stats import LatencyRecorder


def is_failover_error(exc: BaseException) -> bool:
    """True when a request failure indicts the REPLICA rather than the
    request — worth re-dispatching on a sibling.  Replica-fatal chaos
    faults carry ``replica_fatal``; an engine that stopped or crashed
    under an in-flight request raises the lifecycle RuntimeErrors; a
    transient device error that exhausted the engine's in-replica retry
    ladder may still succeed on a sibling's device.

    Network taxonomy (multi-host fabric, ``serve/remote.py``):
    connection errors (refused / reset / ``RemoteDisconnected``),
    timeouts (``socket.timeout`` IS ``TimeoutError``), and HTTP-503
    carriers (``http_status`` attribute) all indict the remote HOST —
    a partitioned replica must look exactly like a crashed one."""
    if getattr(exc, "replica_fatal", False):
        return True
    if isinstance(exc, QueueFullError):
        return False
    if isinstance(exc, (ConnectionError, TimeoutError)):
        return True
    if getattr(exc, "http_status", None) == 503:
        return True
    if isinstance(exc, RuntimeError):
        msg = str(exc)
        if ("engine stopped" in msg or "engine crashed" in msg
                or "engine not started" in msg):
            return True
    return is_transient_error(exc)


@dataclasses.dataclass(frozen=True)
class RouterConfig:
    """Routing knobs (``FlowRouter``)."""

    #: Duplicate a still-unresolved request onto a second replica after
    #: this many seconds (0 disables hedging).  Bound it well above the
    #: p99 batch time or the hedge fires on healthy traffic.
    hedge_timeout_s: float = 0.0
    #: Consecutive failover-class failures before a replica's breaker
    #: opens (no traffic until the cooldown passes or the supervisor
    #: restarts it, which resets the breaker).
    breaker_threshold: int = 3
    breaker_cooldown_s: float = 2.0
    #: Affinity saturation point: route past the affine replica once its
    #: pending depth reaches this fraction of ``max_queue``.
    affinity_spill: float = 0.75

    def __post_init__(self):
        if self.hedge_timeout_s < 0:
            raise ValueError("hedge_timeout_s must be >= 0")
        if self.breaker_threshold < 1:
            raise ValueError("breaker_threshold must be >= 1")


class _RoutedRequest:
    """Book-keeping for one accepted request: the caller-facing future,
    the replicas tried, and first-wins settlement (primary vs hedge)."""

    __slots__ = ("image1", "image2", "bucket", "future", "tried",
                 "lock", "hedged", "timer", "t_submit", "last_exc",
                 "trace")

    def __init__(self, image1, image2, bucket):
        self.image1 = image1
        self.image2 = image2
        self.bucket = bucket
        self.future: Future = Future()
        self.tried: Set[str] = set()
        self.lock = threading.RLock()
        self.hedged = False
        self.timer: Optional[threading.Timer] = None
        self.t_submit = time.perf_counter()
        self.last_exc: Optional[BaseException] = None
        # The request's "route" span (None when untraced).  Settlement
        # closes it — a hedged request's two attempt spans both hang
        # off this one node, so the whole story is ONE tree.
        self.trace = None

    def settle_result(self, value) -> bool:
        with self.lock:
            if self.future.done():
                return False
            self._cancel_timer()
            self.future.set_result(value)
            if self.trace is not None:
                self.trace.end(status="ok", hedged=self.hedged,
                               replicas_tried=len(self.tried))
            return True

    def settle_exception(self, exc: BaseException) -> bool:
        with self.lock:
            if self.future.done():
                return False
            self._cancel_timer()
            self.future.set_exception(exc)
            if self.trace is not None:
                self.trace.end(status="error",
                               error=type(exc).__name__,
                               hedged=self.hedged,
                               replicas_tried=len(self.tried))
            return True

    def _cancel_timer(self) -> None:
        if self.timer is not None:
            self.timer.cancel()
            self.timer = None


class _RoutedStream:
    """Router-side record of one streaming session: which replica owns
    its device state, the generation/weights stamps that detect a
    restart, and the last frame (host-side) that seeds a cold re-open.
    ``lock`` serializes the session's frames through the router —
    streams are sequential by contract, so this costs nothing."""

    __slots__ = ("sid", "bucket", "iters", "ttl_s", "replica",
                 "generation", "weights_version", "last_image",
                 "frames", "restarts", "t_last", "lock")

    def __init__(self, sid, bucket, iters, ttl_s, replica,
                 generation, weights_version, image):
        self.sid = sid
        self.bucket = bucket
        self.iters = iters
        self.ttl_s = ttl_s
        self.replica = replica          # name, not the object
        self.generation = generation
        self.weights_version = weights_version
        self.last_image = image
        self.frames = 0                 # router-monotone frame index
        self.restarts = 0
        self.t_last = time.time()
        self.lock = threading.Lock()


class FlowRouter:
    """See module docstring.  ``fleet`` is duck-typed: it exposes
    ``replicas`` (list of :class:`raft_tpu_torch.serve.fleet.Replica`),
    ``serve_cfg`` and ``registry``."""

    def __init__(self, fleet, cfg: RouterConfig = RouterConfig(), *,
                 sink: Optional[EventSink] = None):
        self.fleet = fleet
        self.cfg = cfg
        self.registry: MetricRegistry = fleet.registry
        self._sink = sink if sink is not None else EventSink.from_env()
        self._requests = self.registry.counter(
            "raft_fleet_requests_total",
            "requests dispatched, by target replica")
        self._failovers = self.registry.counter(
            "raft_fleet_failovers_total",
            "requests re-dispatched off a failed replica")
        self._hedges = self.registry.counter(
            "raft_fleet_hedges_total", "hedge duplicates dispatched")
        self._hedge_wins = self.registry.counter(
            "raft_fleet_hedge_wins_total",
            "requests whose hedge finished first")
        self._rejected = self.registry.counter(
            "raft_fleet_rejected_total",
            "submissions rejected (no eligible replica could accept)")
        # Tripwire, asserted == 0 by the chaos drill: incremented only
        # if a terminal path failed to settle an accepted future (a
        # router bug, not an operational condition).
        self._dropped = self.registry.counter(
            "raft_fleet_dropped_total",
            "accepted requests that were never settled (must stay 0)")
        self._latency = LatencyRecorder(
            registry=self.registry,
            metric="raft_fleet_request_latency_seconds")
        self._streams: dict = {}
        self._streams_lock = threading.Lock()
        self._stream_restarts = self.registry.counter(
            "raft_fleet_stream_restarts_total",
            "streaming sessions cold-restarted on a new engine "
            "(weight update or failover)")
        # Fleet-level SLOs (obs/slo.py): the router sees the outcome
        # the CLIENT sees — post-failover, post-hedge — so fleet
        # availability/latency live here, distinct from the per-engine
        # trackers (pre-failover, replica-labeled).  Same conditional-
        # construction contract: every knob 0 (default) builds nothing.
        self._slo = None
        scfg = fleet.serve_cfg
        if scfg.slo_availability_target > 0 or \
                scfg.slo_latency_target_ms > 0:
            from raft_tpu_torch.obs import slo as slo_mod

            policy = slo_mod.scaled_policy(scfg.slo_window_s)
            specs = []
            if scfg.slo_availability_target > 0:
                specs.append(slo_mod.SLOSpec(
                    "fleet_availability", scfg.slo_availability_target,
                    "non-error request fraction the client sees "
                    "(post-failover)", windows=policy))
            if scfg.slo_latency_target_ms > 0:
                specs.append(slo_mod.SLOSpec(
                    "fleet_latency", 0.99,
                    f"client-observed requests under "
                    f"{scfg.slo_latency_target_ms}ms", windows=policy))
            self._slo = slo_mod.SLOTracker(
                specs, registry=self.registry, sink=self._sink)
        # Autoscaling fleets need the router back-reference (graceful
        # scale-down evacuates streams through it); duck-typed so stub
        # fleets in tests need not implement it.
        bind = getattr(fleet, "bind_router", None)
        if bind is not None:
            bind(self)

    # ------------------------------------------------------------------
    # client API (any thread)
    # ------------------------------------------------------------------

    def submit(self, image1, image2) -> Future:
        """Route one frame pair; returns a Future resolving to the
        ``(H, W, 2)`` flow.  Raises :class:`QueueFullError` when no
        eligible replica can accept, ``RuntimeError`` when the fleet
        has no live replica at all."""
        im1 = np.asarray(image1, dtype=np.float32)
        im2 = np.asarray(image2, dtype=np.float32)
        if im1.ndim != 3 or im1.shape[-1] != 3 or im1.shape != im2.shape:
            raise ValueError(
                f"expected two matching (H, W, 3) images, got "
                f"{im1.shape} and {im2.shape}")
        scfg = self.fleet.serve_cfg
        bucket = bucket_hw(im1.shape[0], im1.shape[1],
                           scfg.bucket_multiple, scfg.buckets)
        req = _RoutedRequest(im1, im2, bucket)
        # Root (or, under the HTTP handler's serve_http span, child) of
        # the request's trace tree; the no-op singleton normalizes to
        # None so untraced requests carry no span machinery at all.
        span = trace.default_tracer().begin(
            "route", bucket=f"{bucket[0]}x{bucket[1]}")
        req.trace = span if span else None
        try:
            self._dispatch(req, initial=True)
        except BaseException as e:
            if req.trace is not None:
                req.trace.end(status="error", error=type(e).__name__)
            raise
        return req.future

    def infer(self, image1, image2,
              timeout: Optional[float] = None) -> np.ndarray:
        return self.submit(image1, image2).result(timeout=timeout)

    # ------------------------------------------------------------------
    # streaming sessions (session affinity + cold-restart fallback)
    # ------------------------------------------------------------------

    def _replica_by_name(self, name: str):
        for r in self.fleet.replicas:
            if r.name == name:
                return r
        return None

    def stream_ingest(self, session_id: str, image, *,
                      iters: Optional[int] = None,
                      ttl_s: Optional[float] = None,
                      timeout: Optional[float] = None) -> dict:
        """Fleet-side ``POST /v1/stream/{id}`` semantics (same facade
        as ``InferenceEngine.stream_ingest``): first frame opens the
        session on the bucket-affine replica; later frames go to THAT
        replica.  A restarted or failed owner triggers one cold
        re-open (module docstring); ``flow`` comes back ``None`` on
        any frame that (re-)seeded rather than produced a pair."""
        im = np.asarray(image, dtype=np.float32)
        if im.ndim != 3 or im.shape[-1] != 3:
            raise ValueError(
                f"expected an (H, W, 3) image, got {im.shape}")
        sid = str(session_id)
        scfg = self.fleet.serve_cfg
        with self._streams_lock:
            self._sweep_streams_locked(time.time())
            rst = self._streams.get(sid)
            if rst is None:
                bucket = bucket_hw(im.shape[0], im.shape[1],
                                   scfg.bucket_multiple, scfg.buckets)
                replica = self._pick(bucket, set())
                if replica is None:
                    states = {r.name: r.state
                              for r in self.fleet.replicas}
                    raise RuntimeError(
                        f"no eligible replica to open stream "
                        f"{sid!r} on (fleet states: {states})")
                replica.engine.stream_open(sid, im, iters=iters,
                                           ttl_s=ttl_s)
                rst = _RoutedStream(
                    sid, bucket, iters,
                    float(ttl_s) if ttl_s is not None
                    else scfg.stream_ttl_s,
                    replica.name, replica.generation,
                    getattr(self.fleet, "weights_version", 0), im)
                self._streams[sid] = rst
                self._requests.inc(replica=replica.name)
                return {"session": sid, "frame": 0, "warm": False,
                        "flow": None}
        with rst.lock:
            replica = self._replica_by_name(rst.replica)
            wv = getattr(self.fleet, "weights_version", 0)
            if (replica is None or not replica.eligible()
                    or replica.generation != rst.generation):
                reason = ("weights_update"
                          if wv != rst.weights_version
                          else "replica_lost")
                replica = self._restart_stream(rst, reason, set())
            try:
                out = replica.engine.stream_ingest(sid, im,
                                                   timeout=timeout)
            except QueueFullError:
                raise  # backoff, session intact — client retries
            except Exception as e:
                if not is_failover_error(e):
                    raise
                if replica.generation == rst.generation:
                    replica.note_failure(self.cfg.breaker_threshold,
                                         self.cfg.breaker_cooldown_s)
                replica = self._restart_stream(rst, "failover",
                                               {replica.name})
                out = replica.engine.stream_ingest(sid, im,
                                                   timeout=timeout)
            self._requests.inc(replica=replica.name)
            rst.last_image = im
            rst.frames += 1
            rst.t_last = time.time()
            return {"session": sid, "frame": rst.frames,
                    "warm": bool(out["warm"]), "flow": out["flow"]}

    def stream_close(self, session_id: str) -> dict:
        """Close a stream everywhere; returns the owning engine's
        summary when it is still reachable, a router-side one when the
        device state is already gone (restart raced the close)."""
        sid = str(session_id)
        with self._streams_lock:
            rst = self._streams.pop(sid, None)
        if rst is None:
            raise ValueError(f"unknown session {session_id!r} "
                             "(expired, closed, or never opened)")
        with rst.lock:
            summary = None
            replica = self._replica_by_name(rst.replica)
            if (replica is not None
                    and replica.generation == rst.generation):
                try:
                    summary = replica.engine.stream_close(sid)
                except Exception:
                    summary = None
            if summary is None:
                summary = {"session": sid, "frames": rst.frames + 1,
                           "pairs": rst.frames, "warm_pairs": None}
            summary["restarts"] = rst.restarts
            return summary

    def _restart_stream(self, rst: _RoutedStream, reason: str,
                        exclude: Set[str]):
        """Re-open ``rst`` cold on an eligible replica, replaying its
        last frame as the new frame 0.  Called with ``rst.lock`` held.
        The old engine's copy (if any survives) is left to its TTL
        eviction — closing it could block on a dead replica."""
        target = self._pick(rst.bucket, exclude)
        if target is None:
            states = {r.name: r.state for r in self.fleet.replicas}
            raise RuntimeError(
                f"stream {rst.sid!r}: no eligible replica to restart "
                f"on (fleet states: {states})")
        target.engine.stream_open(rst.sid, rst.last_image,
                                  iters=rst.iters, ttl_s=rst.ttl_s)
        prev = rst.replica
        rst.replica = target.name
        rst.generation = target.generation
        rst.weights_version = getattr(self.fleet, "weights_version", 0)
        rst.restarts += 1
        self._stream_restarts.inc()
        self._sink.emit("stream_restart", sid=rst.sid,
                        bucket=f"{rst.bucket[0]}x{rst.bucket[1]}",
                        from_replica=prev, to_replica=target.name,
                        reason=reason)
        return target

    def _sweep_streams_locked(self, now: float) -> None:
        for sid, rst in list(self._streams.items()):
            if now - rst.t_last > rst.ttl_s and not rst.lock.locked():
                del self._streams[sid]

    def evacuate(self, replica_name: str,
                 reason: str = "scale_down") -> List[str]:
        """Migrate every streaming session owned by ``replica_name``
        onto a sibling via the cold-restart replay path (the fleet
        autoscaler calls this before draining a scale-down victim).
        Sessions with no eligible target are left in place — the next
        frame's owner-loss check restarts them lazily instead of
        failing the evacuation.  Returns the migrated session ids."""
        with self._streams_lock:
            owned = [rst for rst in self._streams.values()
                     if rst.replica == replica_name]
        moved = []
        for rst in owned:
            with rst.lock:
                if rst.replica != replica_name:
                    continue  # a concurrent frame already moved it
                try:
                    self._restart_stream(rst, reason, {replica_name})
                except RuntimeError:
                    continue
                moved.append(rst.sid)
        return moved

    # ------------------------------------------------------------------
    # placement
    # ------------------------------------------------------------------

    def _eligible(self, exclude: Set[str]) -> List[object]:
        return [r for r in self.fleet.replicas
                if r.name not in exclude and r.eligible()]

    def _queue_capacity(self, replica) -> int:
        """PER-REPLICA queue depth bound for the spill math.  A remote
        replica's ``max_queue`` is its own (read through the facade);
        only replicas without the method — or whose capacity is still
        unknown, e.g. an unreachable remote — fall back to the shared
        ``ServeConfig``."""
        qc = getattr(replica, "queue_capacity", None)
        if qc is not None:
            try:
                cap = qc()
            except Exception:
                cap = None
            if cap:
                return int(cap)
        return self.fleet.serve_cfg.max_queue

    def _pick(self, bucket: tuple, exclude: Set[str]):
        """Affinity first, least-loaded fallback, health-gated."""
        candidates = self._eligible(exclude)
        if not candidates:
            return None
        n = len(self.fleet.replicas)
        affine_idx = zlib.crc32(repr(bucket).encode()) % n
        for r in candidates:
            if r.index == affine_idx and r.pending() < (
                    self.cfg.affinity_spill * self._queue_capacity(r)):
                return r
        return min(candidates, key=lambda r: (r.pending(), r.index))

    # ------------------------------------------------------------------
    # dispatch / failover / hedging
    # ------------------------------------------------------------------

    def _dispatch(self, req: _RoutedRequest, *, initial: bool) -> None:
        """Hand ``req`` to an eligible replica, walking the eligibility
        list until one accepts.  Terminal failures raise synchronously
        on the initial dispatch (the caller hasn't been handed a future
        yet) and settle the future afterwards — the request is never
        left pending."""
        saw_full = None
        while True:
            with req.lock:
                if req.future.done():
                    return
                replica = self._pick(req.bucket, req.tried)
                if replica is not None:
                    req.tried.add(replica.name)
            if replica is None:
                self._terminal(req, saw_full, initial)
                return
            # One "attempt" span per dispatch; the engine's submitting
            # thread captures it (use_context) and the device worker
            # records queue/pad/device under it — so the span crosses
            # the dispatcher and device threads with the request.
            att = (req.trace.child("attempt", replica=replica.name,
                                   hedge=False)
                   if req.trace is not None else None)
            try:
                if att is not None:
                    with trace.use_context(att):
                        inner = replica.engine.submit(req.image1,
                                                      req.image2)
                else:
                    inner = replica.engine.submit(req.image1, req.image2)
            except QueueFullError as e:
                if att is not None:  # recorded, but not keep-forcing
                    att.end(status="full", queue_depth=e.queue_depth)
                saw_full = e  # full ≠ dead: no breaker strike
                continue
            except RuntimeError as e:
                # Lost the race with a crash/stop between the health
                # check and submit — treat exactly like a failed
                # attempt on that replica.
                if att is not None:
                    att.end(status="error", error=type(e).__name__)
                if not is_failover_error(e):
                    self._settle_or_raise(req, e, initial)
                    return
                req.last_exc = e
                self._strike(replica)
                continue
            self._requests.inc(replica=replica.name)
            if initial:
                self._maybe_arm_hedge(req)
            gen = replica.generation
            inner.add_done_callback(
                lambda f, r=replica, g=gen, a=att:
                    self._on_done(req, r, g, f, span=a))
            return

    def _strike(self, replica) -> None:
        """One failover-class breaker strike; emits
        ``fleet_breaker_open`` exactly on the closed->open transition."""
        if replica.note_failure(self.cfg.breaker_threshold,
                                self.cfg.breaker_cooldown_s):
            self._sink.emit("fleet_breaker_open", replica=replica.name,
                            cooldown_s=self.cfg.breaker_cooldown_s)

    def _slo_done(self, ok: bool,
                  latency_s: Optional[float] = None,
                  exc: Optional[BaseException] = None) -> None:
        """Feed the CLIENT-visible outcome of one settled request.
        Load-shed rejections (429-class QueueFullError) spend no
        availability budget — shedding under overload is the mechanism
        PROTECTING the SLO, not a violation of it."""
        if self._slo is None:
            return
        if exc is not None and isinstance(exc, QueueFullError):
            return
        self._slo.record("fleet_availability", ok)
        if ok and latency_s is not None:
            self._slo.record(
                "fleet_latency",
                latency_s * 1000.0
                <= self.fleet.serve_cfg.slo_latency_target_ms)

    def _terminal(self, req: _RoutedRequest, saw_full, initial: bool):
        """No replica left to try: fail the request loudly."""
        if saw_full is not None:
            depth = sum(r.pending() for r in self.fleet.replicas)
            exc: BaseException = QueueFullError(
                f"all eligible replicas at max_queue "
                f"({depth} requests in flight fleet-wide); retry after "
                f"{self.fleet.serve_cfg.retry_after_s:g}s",
                queue_depth=depth,
                retry_after_s=self.fleet.serve_cfg.retry_after_s)
            self._rejected.inc()
        elif req.last_exc is not None:
            exc = RuntimeError(
                f"request failed on {len(req.tried)} replica(s); "
                f"last error: {type(req.last_exc).__name__}: "
                f"{req.last_exc}")
            exc.__cause__ = req.last_exc
        else:
            states = {r.name: r.state for r in self.fleet.replicas}
            exc = RuntimeError(
                f"no eligible replica (fleet states: {states})")
            self._rejected.inc()
        self._settle_or_raise(req, exc, initial)

    def _settle_or_raise(self, req: _RoutedRequest, exc: BaseException,
                         initial: bool) -> None:
        if initial:
            req._cancel_timer()
            self._slo_done(False, exc=exc)
            raise exc
        if req.settle_exception(exc):
            self._slo_done(False, exc=exc)
        elif not req.future.done():
            # Unreachable by construction; the tripwire exists so a
            # future regression shows up as a nonzero counter in the
            # drill instead of a hung client.
            self._dropped.inc()

    def _maybe_arm_hedge(self, req: _RoutedRequest) -> None:
        if self.cfg.hedge_timeout_s <= 0 or len(self.fleet.replicas) < 2:
            return
        timer = threading.Timer(self.cfg.hedge_timeout_s,
                                self._hedge, args=(req,))
        timer.daemon = True
        req.timer = timer
        timer.start()

    def _hedge(self, req: _RoutedRequest) -> None:
        with req.lock:
            if req.future.done() or req.hedged:
                return
            req.hedged = True
            replica = self._pick(req.bucket, req.tried)
            if replica is None:
                return  # nowhere to hedge; primary still owns the request
            req.tried.add(replica.name)
        att = (req.trace.child("attempt", replica=replica.name,
                               hedge=True)
               if req.trace is not None else None)
        try:
            if att is not None:
                with trace.use_context(att):
                    inner = replica.engine.submit(req.image1, req.image2)
            else:
                inner = replica.engine.submit(req.image1, req.image2)
        except Exception as e:
            if att is not None:
                att.end(status="full"
                        if isinstance(e, QueueFullError) else "error",
                        error=type(e).__name__)
            return  # hedge is best-effort; the primary attempt stands
        if req.trace is not None:
            # Tail-keep: a fired hedge means a straggler — this trace
            # is exactly the kind worth keeping regardless of sampling.
            req.trace.mark_keep()
        self._hedges.inc()
        self._requests.inc(replica=replica.name)
        self._sink.emit("serve_hedge", replica=replica.name,
                        bucket=f"{req.bucket[0]}x{req.bucket[1]}")
        gen = replica.generation
        inner.add_done_callback(
            lambda f, r=replica, g=gen, a=att:
                self._on_done(req, r, g, f, hedge=True, span=a))

    def _on_done(self, req: _RoutedRequest, replica, generation: int,
                 inner: Future, *, hedge: bool = False,
                 span=None) -> None:
        exc = inner.exception()
        if exc is None:
            # End the attempt BEFORE settling so the root-span flush
            # carries it; a hedge loser finishing after settlement
            # still lands in the (kept) tree via the late-span path.
            if span is not None:
                span.end(status="ok", won=not req.future.done())
            replica.note_success()
            if req.settle_result(inner.result()):
                lat = time.perf_counter() - req.t_submit
                self._latency.record(lat)
                self._slo_done(True, lat)
                if hedge:
                    self._hedge_wins.inc()
            return
        if span is not None:  # error status tail-keeps the trace
            span.end(status="error", error=type(exc).__name__)
        if is_failover_error(exc):
            # Strike the replica only if this failure came from the
            # engine generation we dispatched to (a restarted engine
            # must not inherit its predecessor's strikes).
            if replica.generation == generation:
                self._strike(replica)
            req.last_exc = exc
            if not req.future.done():
                self._failovers.inc(replica=replica.name)
                self._sink.emit(
                    "serve_failover", replica=replica.name,
                    bucket=f"{req.bucket[0]}x{req.bucket[1]}",
                    tried=len(req.tried),
                    error=f"{type(exc).__name__}: {str(exc)[:200]}")
                self._dispatch(req, initial=False)
            return
        if req.settle_exception(exc):
            self._slo_done(False, exc=exc)

    # ------------------------------------------------------------------
    # introspection (the HTTP edge serves a router exactly like a bare
    # engine: same health/stats/metrics_text facade)
    # ------------------------------------------------------------------

    def health(self) -> dict:
        return self.fleet.health()

    def metrics_text(self) -> str:
        return self.fleet.metrics_text()

    def router_stats(self) -> dict:
        def total(counter):  # sum across label sets (per-replica lines)
            return sum(v for _, v in counter.items())

        return {
            "requests_total": total(self._requests),
            "requests_by_replica": {
                dict(k).get("replica", ""): v
                for k, v in self._requests.items()},
            "failovers_total": total(self._failovers),
            "hedges_total": self._hedges.value(),
            "hedge_wins_total": self._hedge_wins.value(),
            "rejected_total": self._rejected.value(),
            "dropped_total": self._dropped.value(),
            "latency_ms": self._latency.snapshot(),
            "streams_open": len(self._streams),
            "stream_restarts_total": int(
                self._stream_restarts.value()),
            "slo": (self._slo.snapshot() if self._slo is not None
                    else {"enabled": False}),
        }

    def stats(self) -> dict:
        return dict(self.fleet.stats(), router=self.router_stats())
