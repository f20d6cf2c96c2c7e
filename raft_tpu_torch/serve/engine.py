"""Inference serving engine: shape buckets, dynamic batching, continuous
batching and streaming sessions (the port of ``raft_tpu/serve/
engine.py``).

A server sees concurrent requests of unknown resolution.  The engine:

1. **Buckets shapes.**  Every request's ``(H, W)`` rounds to a
   /8-aligned bucket (``ops.pad.bucket_hw``, optionally snapped to a
   configured ladder), and the engine keeps one program set per
   ``(bucket, lanes)``: the slot programs of ``serve/slots.py`` (``enc``,
   ``iter``, ``up``, and for streaming ``stash`` and ``wenc``) with the
   resident slot state they update in place.  On the card each program
   is a captured CUDA graph: the first call of a key runs eagerly, the
   second captures, and every later call replays.  A capture is an
   explicit, counted event (``capture_counter``, mirrored into
   ``raft_serve_compiles_total``): steady traffic never captures.
   Request mode keeps a state and its graphs for each batch size a
   bucket has run; past the resident budget it frees the least recently
   used ones (see :class:`InferenceEngine`).

2. **Micro-batches requests** (``batching="request"``, the default).
   Requests landing in one bucket are coalesced by a per-bucket
   dispatcher into one device batch that closes at ``max_batch`` items or
   ``max_wait_ms`` after its first item; a partial batch is padded with
   its last item up to the nearest configured batch size.  The batch runs
   the slot programs in lockstep: admit every lane, ``iters`` iterations
   with the threshold off, one upsample, with no read back to the host
   in between.

3. **Batches at iteration granularity** (``batching="slot"``).  The unit
   of device work is one GRU iteration over a persistent ``slots``-lane
   batch: the dispatcher admits waiting requests into free lanes (``enc``
   for those lanes), runs one ``iter`` over every lane, reads the lanes'
   status, and retires lanes whose budget is spent or whose convergence
   predicate fired (``early_exit_threshold``), upsampling them (``up``).
   Both modes drive the same programs, so with early exit off their
   outputs agree bit for bit.

4. **Streams video** (``stream_open`` / ``stream_submit`` /
   ``stream_close``; slot mode).  A session pins one lane of its bucket's
   slot pool across frames: frame N+1 sends only the new image; the
   previous frame's features are reused as frame 1's, and its flow is
   forward-warped into the new pair's ``coords1`` init.  A session's
   first pair runs the unmodified ``enc`` (bit for bit the stateless
   path).  Idle sessions are evicted after ``stream_ttl_s``.

Threads: callers ``submit()`` (bucket lookup, backpressure, handoff to
the engine's asyncio loop); the loop thread's per-bucket dispatchers
coalesce batches and never touch the device; the engine's own host
thread runs each batch or slot cycle (the chaos seam, padding and
stacking, waiting, unpadding, quality scoring) and hands every CUDA call
(launches, copies, captures, replays, allocations) to the device-worker
thread.  The device worker is one per device for all engines of the
process (the JAX engine has one per engine): cuDNN's convolution plans
are chosen per thread, under the memory free when a shape is first run,
so engines on threads of their own could replay different kernels, and
give different bits, for the same model; and while the worker captures
a graph, a CUDA call from any other thread would fail ("operation not
permitted when stream is capturing").  A straggling or wedged engine
holds only its own host thread, so its siblings keep serving (the
fleet's hedges and failovers depend on it).
Backpressure: at most ``max_queue`` requests in flight; beyond it
``submit()`` raises :class:`QueueFullError` (HTTP 429).

Warm start (``ServeConfig.aot_dir``, ``serve/aot.py``): an engine built
with a manifest directory captures every ``(bucket, lanes, program)``
the manifest lists during :meth:`InferenceEngine.start`, before it
reports ready, so its first request captures nothing.  Flow quality
(``quality_*``, ``obs/quality.py``) and SLOs (``slo_*``, ``obs/slo.py``)
are built only when their knobs are set.

The engine runs on the card unless it is given ``device="cpu"``; without
CUDA it raises.  The JAX engine's request spans (ROADMAP A8b′), its
MFU-floor SLO and incident knobs (A8c′) are not ported yet (the
modules they use, ``obs/trace.py``, ``obs/cost.py`` and
``obs/incident.py``, are): their ``ServeConfig`` knobs raise at any value
but the default.
"""

from __future__ import annotations

import asyncio
import dataclasses
import gc
import threading
import time
from collections import OrderedDict
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from raft_tpu_torch import chaos
from raft_tpu_torch.chaos import (InjectedDeviceError, InjectedReplicaKill,
                                  ReplicaWedgedInterrupt, is_transient_error)
from raft_tpu_torch.config import RAFTConfig
from raft_tpu_torch.obs import EventSink, MetricRegistry
from raft_tpu_torch.ops.pad import InputPadder, bucket_hw
from raft_tpu_torch.serve.stats import Counters, LatencyRecorder
from raft_tpu_torch.utils.profiling import CaptureCounter

# ServeConfig knobs of parts the port does not have yet -> the ROADMAP
# item that brings them.  Each raises at any value but its default.
UNPORTED_KNOBS = {
    "slo_mfu_floor": "A8c′ (the serving MFU floor; obs/cost.py is "
                     "ported)",
    "incidents": "A8c′ (the engine's incident knobs; obs/incident.py "
                 "is ported)",
    "incident_window_s": "A8c′ (the engine's incident knobs)",
    "incident_quiet_s": "A8c′ (the engine's incident knobs)",
    "incident_cooldown_s": "A8c′ (the engine's incident knobs)",
}

# the default resident budget on the card: this share of its memory
# (a fleet splits it among its engines)
RESIDENT_FRACTION = 0.75


def _device_unusable(exc: BaseException) -> bool:
    """True for an error after which the device must not be touched again:
    a replica-fatal fault, or a CUDA error (sticky: the context is
    unusable), as torch or a kernel launch reports it.  An out-of-memory
    error leaves the context usable."""
    if getattr(exc, "replica_fatal", False):
        return True
    msg = str(exc)
    return "CUDA error" in msg or "cudaError" in msg


# One device-worker thread per device, shared by every engine of the
# process: device work serializes there, and cuDNN's convolution plans
# (PyTorch caches them per thread, and picks them under the memory free at
# that moment) are picked once for all engines, so two engines of one
# model replay the same kernels.
_DEVICE_WORKERS: Dict[str, ThreadPoolExecutor] = {}
_DEVICE_WORKERS_LOCK = threading.Lock()


def _device_worker(device) -> ThreadPoolExecutor:
    import torch

    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    with _DEVICE_WORKERS_LOCK:
        pool = _DEVICE_WORKERS.get(str(dev))
        if pool is None:
            pool = _DEVICE_WORKERS[str(dev)] = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="raft-serve-device")
        return pool


def on_device(device, fn):
    """Run ``fn()`` on ``device``'s device worker and return its result:
    how code outside an engine (the fleet dropping a replaced engine's
    memory) makes a CUDA call without racing an engine's capture."""
    return _device_worker(device).submit(fn).result()


class QueueFullError(RuntimeError):
    """Backpressure rejection: ``max_queue`` requests already in flight
    (or ``max_sessions`` sessions open).  Carries the structured overload
    detail the HTTP layer returns (429 JSON body and ``Retry-After``):
    ``queue_depth`` at rejection and the suggested ``retry_after_s``."""

    def __init__(self, msg: str, *, queue_depth: int = 0,
                 retry_after_s: float = 1.0):
        super().__init__(msg)
        self.queue_depth = int(queue_depth)
        self.retry_after_s = float(retry_after_s)


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Engine knobs (model hyperparameters stay in ``RAFTConfig``); the
    JAX package's, with the same defaults and checks.

    ``max_wait_ms`` trades tail latency for batch fill.  ``buckets`` is an
    optional explicit ``(H, W)`` ladder; ``batch_sizes`` the request-mode
    batch shapes (default: powers of two up to ``max_batch``).
    ``stall_timeout_s``: with requests pending and no device batch done
    for this long, ``health()`` reports not ready (0 disables).
    ``device_retries``: re-runs of a device call after an error
    :func:`~raft_tpu_torch.chaos.is_transient_error` accepts; retry k
    sleeps ``min(retry_backoff_s * 2^(k-1), retry_backoff_max_s)``
    scaled by ``1 +- retry_jitter`` (seeded per engine), and the retries
    stop at ``retry_deadline_s`` after the first failure.
    ``retry_after_s``: the hint a 429 carries.  ``chaos_slow_s`` /
    ``chaos_hang_max_s`` size the injected ``replica_slow`` sleep and the
    ``replica_hang`` wedge.  ``batching``: ``"request"`` or ``"slot"``
    (``slots`` lanes a bucket).  ``early_exit_threshold``: a slot retires
    once its largest flow update (1/8-resolution units) falls below it; 0
    disables.  Slot mode honors a per-request ``iters`` budget (capped at
    ``iters``); request mode runs every lane to ``iters``.  Streaming
    (slot mode): ``stream_ttl_s`` evicts a quiet session,
    ``stream_warm_iters`` budgets warm frames (None: the session's
    budget), ``max_sessions`` bounds open sessions.  ``aot_dir``: a
    warm-start manifest directory (``serve/aot.py``) whose keys
    :meth:`InferenceEngine.start` captures; a missing, torn or
    mismatched manifest is a warm-start miss (``aot_import_error``) and
    the engine captures lazily.  ``quality_sample_rate``: the fraction of
    retiring slot-mode requests scored with the photometric proxy
    (``obs/quality.py``; 0 builds no monitor), ``quality_cycle`` adds a
    backward pass per scored request, ``quality_drift_*`` size the drift
    detector.  ``slo_availability_target`` / ``slo_latency_target_ms``
    (99% of requests under it) / ``slo_quality_bound`` (needs
    ``quality_sample_rate``), 0 each disabling it, and ``slo_window_s``
    (the burn policy's 1 h window rescaled) build an
    :class:`~raft_tpu_torch.obs.slo.SLOTracker`.  The MFU-floor SLO and
    the incident knobs (:data:`UNPORTED_KNOBS`) raise at any value but
    the default.

    Memory: each ``(bucket, lanes)`` holds a resident slot state and its
    graphs (``allpairs`` in bf16 at 440x1024: 131 MB of state a lane).
    Slot mode keeps one for each bucket it has seen, for the engine's
    life.  Request mode keeps one for each batch size a bucket has run,
    and when the card's reserved memory passes the engine's
    ``resident_budget_bytes`` (default :data:`RESIDENT_FRACTION` = 0.75
    of the card) before a new one is made, it frees the least recently
    used ones first; a freed key captures again when traffic returns to
    it.  A ``buckets`` ladder bounds both."""

    iters: int = 32
    max_batch: int = 8
    max_wait_ms: float = 5.0
    max_queue: int = 256
    bucket_multiple: int = 8
    buckets: Optional[Tuple[Tuple[int, int], ...]] = None
    batch_sizes: Optional[Tuple[int, ...]] = None
    pad_mode: str = "sintel"
    latency_window: int = 4096
    stall_timeout_s: float = 120.0
    device_retries: int = 1
    retry_backoff_s: float = 0.05
    retry_backoff_max_s: float = 2.0
    retry_jitter: float = 0.25
    retry_deadline_s: float = 10.0
    retry_after_s: float = 1.0
    aot_dir: Optional[str] = None
    chaos_slow_s: float = 0.5
    chaos_hang_max_s: float = 30.0
    batching: str = "request"
    slots: int = 8
    early_exit_threshold: float = 0.0
    quality_sample_rate: float = 0.0
    quality_cycle: bool = False
    quality_drift_reference: int = 256
    quality_drift_window: int = 64
    quality_drift_threshold: float = 0.5
    stream_ttl_s: float = 60.0
    stream_warm_iters: Optional[int] = None
    max_sessions: int = 64
    slo_availability_target: float = 0.0
    slo_latency_target_ms: float = 0.0
    slo_quality_bound: float = 0.0
    slo_mfu_floor: float = 0.0
    slo_window_s: float = 3600.0
    incidents: bool = False
    incident_window_s: float = 10.0
    incident_quiet_s: float = 30.0
    incident_cooldown_s: float = 60.0

    def __post_init__(self):
        for name, item in UNPORTED_KNOBS.items():
            default = type(self).__dataclass_fields__[name].default
            if getattr(self, name) != default:
                raise ValueError(
                    f"ServeConfig.{name}={getattr(self, name)!r}: not "
                    f"ported yet (ROADMAP {item}); leave it at {default!r}")
        if self.stream_ttl_s <= 0:
            raise ValueError("stream_ttl_s must be > 0")
        if self.stream_warm_iters is not None \
                and self.stream_warm_iters < 1:
            raise ValueError("stream_warm_iters must be >= 1 (None "
                             "keeps the session budget)")
        if self.max_sessions < 1:
            raise ValueError("max_sessions must be >= 1")
        if self.max_batch < 1 or self.max_queue < 1:
            raise ValueError("max_batch and max_queue must be >= 1")
        if self.batching not in ("request", "slot"):
            raise ValueError(f"batching must be 'request' or 'slot', "
                             f"got {self.batching!r}")
        if self.slots < 1:
            raise ValueError("slots must be >= 1")
        if self.iters < 1:
            raise ValueError("iters must be >= 1")
        if self.early_exit_threshold < 0:
            raise ValueError("early_exit_threshold must be >= 0 "
                             "(0 disables early exit)")
        if not 0.0 <= self.quality_sample_rate <= 1.0:
            raise ValueError(
                f"quality_sample_rate must be in [0, 1] (0 disables "
                f"quality scoring), got {self.quality_sample_rate}")
        if (self.quality_drift_reference < 4
                or self.quality_drift_window < 2
                or self.quality_drift_threshold <= 0):
            raise ValueError(
                "need quality_drift_reference >= 4, "
                "quality_drift_window >= 2 and "
                "quality_drift_threshold > 0")
        if self.max_wait_ms < 0:
            raise ValueError("max_wait_ms must be >= 0")
        if self.stall_timeout_s < 0:
            raise ValueError("stall_timeout_s must be >= 0")
        if self.device_retries < 0 or self.retry_backoff_s < 0:
            raise ValueError(
                "device_retries and retry_backoff_s must be >= 0")
        if (self.retry_backoff_max_s < self.retry_backoff_s
                or self.retry_deadline_s <= 0
                or not 0 <= self.retry_jitter < 1):
            raise ValueError(
                "need retry_backoff_max_s >= retry_backoff_s, "
                "retry_deadline_s > 0 and 0 <= retry_jitter < 1")
        if not 0.0 <= self.slo_availability_target < 1.0:
            raise ValueError(
                "slo_availability_target must be in [0, 1) — 0 "
                f"disables, 1.0 leaves no error budget; got "
                f"{self.slo_availability_target}")
        if (self.slo_latency_target_ms < 0 or self.slo_quality_bound < 0
                or self.slo_window_s <= 0):
            raise ValueError(
                "need slo_latency_target_ms >= 0, slo_quality_bound "
                ">= 0 and slo_window_s > 0")
        m = self.bucket_multiple
        for hw in self.buckets or ():
            if hw[0] % m or hw[1] % m:
                raise ValueError(
                    f"bucket {hw} not /{m}-aligned (the model "
                    f"downsamples by {m})")

    def resolved_batch_sizes(self) -> Tuple[int, ...]:
        if self.batch_sizes:
            sizes = tuple(sorted({int(b) for b in self.batch_sizes}))
            if sizes[0] < 1:
                raise ValueError(f"batch_sizes must be >= 1: {sizes}")
            return sizes
        sizes, b = set(), 1
        while b < self.max_batch:
            sizes.add(b)
            b *= 2
        sizes.add(self.max_batch)
        return tuple(sorted(sizes))


class _Request:
    __slots__ = ("image1", "image2", "bucket", "padder", "future",
                 "t_submit", "iters", "session", "warm")

    def __init__(self, image1, image2, bucket, padder, iters=None,
                 session=None, warm=False):
        self.image1 = image1
        self.image2 = image2
        self.bucket = bucket
        self.padder = padder
        # per-request budget (slot mode, capped at cfg.iters)
        self.iters = iters
        # a streamed frame: ``session`` pins it to the session's lane,
        # ``warm`` picks the warm encode over the cold one
        self.session = session
        self.warm = warm
        self.future: Future = Future()
        self.t_submit = time.perf_counter()


class _StreamSession:
    """One streaming session's host record; its device state (coords,
    carry) lives in the pinned lane.  ``lane`` is written only by the
    device worker; ``inflight`` / ``t_last`` under the engine's sessions
    lock; ``carry_ok`` flips on the device worker."""

    __slots__ = ("sid", "bucket", "padder", "shape", "iters", "ttl_s",
                 "lane", "frames", "pairs", "warm_pairs", "last_image",
                 "inflight", "t_last", "t_open", "carry_ok", "closed")

    def __init__(self, sid, bucket, padder, shape, iters, ttl_s,
                 first_image):
        self.sid = sid
        self.bucket = bucket
        self.padder = padder
        self.shape = shape
        self.iters = iters
        self.ttl_s = ttl_s
        self.lane: Optional[int] = None
        self.frames = 1          # the opening frame
        self.pairs = 0           # pairs retired successfully
        self.warm_pairs = 0
        self.last_image = first_image
        self.inflight: Optional[Future] = None
        self.t_last = time.time()
        self.t_open = self.t_last
        self.carry_ok = False    # the lane's carry (fmap, ctx) is valid
        self.closed = False


class _SlotPool:
    """One bucket's continuous-batching bookkeeping: its
    :class:`~raft_tpu_torch.serve.slots.SlotSet` (the resident device
    state) and host mirrors of the lane assignments.  Touched only by the
    bucket's dispatcher and the device call it awaits."""

    __slots__ = ("progs", "reqs", "budgets", "active_np", "t_admit",
                 "pins")

    def __init__(self, slots: int):
        self.progs = None
        self.reqs: List[Optional[_Request]] = [None] * slots
        self.budgets = np.zeros((slots,), np.int32)
        self.active_np = np.zeros((slots,), bool)
        self.t_admit = [0.0] * slots
        # lane -> session: a pinned lane is not given to another request
        # even while idle (its coords and carry are the warm start)
        self.pins: Dict[int, _StreamSession] = {}

    def live(self) -> List[_Request]:
        return [r for r in self.reqs if r is not None]

    def clear(self) -> None:
        """Free every lane on the host; pinned sessions stay pinned but go
        cold (their next frame re-seeds)."""
        slots = len(self.reqs)
        self.reqs = [None] * slots
        self.budgets = np.zeros((slots,), np.int32)
        self.active_np = np.zeros((slots,), bool)
        for s in self.pins.values():
            s.carry_ok = False

    def reset(self) -> None:
        """:meth:`clear`, and zero the device state (after a failed
        cycle)."""
        self.clear()
        if self.progs is not None:
            self.progs.reset()


class InferenceEngine:
    """See the module docstring.  Lifecycle::

        engine = InferenceEngine(state_dict, model_cfg, ServeConfig(...))
        engine.start()                       # or: with engine: ...
        engine.warmup([(436, 1024)])         # optional: capture up front
        flow = engine.infer(image1, image2)  # or .submit() -> Future
        print(engine.stats())
        engine.stop()

    ``state_dict`` is the port's (``convert.py`` makes one from JAX
    variables).  ``device`` defaults to the card.
    ``resident_budget_bytes``: request mode's memory budget (see
    :class:`ServeConfig`), held against :meth:`resident_bytes` (what this
    engine's sets hold); None is :data:`RESIDENT_FRACTION` of the card
    (a :class:`~raft_tpu_torch.serve.fleet.ReplicaFleet` passes each
    engine its share), and no budget on the CPU."""

    def __init__(self, state_dict: Mapping, model_cfg: RAFTConfig,
                 cfg: ServeConfig = ServeConfig(), *,
                 registry: Optional[MetricRegistry] = None,
                 sink: Optional[EventSink] = None, device="cuda",
                 resident_budget_bytes: Optional[int] = None):
        import torch

        from raft_tpu_torch.evaluate import make_inference_model
        from raft_tpu_torch.serve.slots import SlotPrograms

        self.cfg = cfg

        def build():
            return make_inference_model(model_cfg, state_dict, device=device)

        # weights resident on the device (copied there on the device
        # worker, so no copy races another engine's capture); every
        # program reads them in place
        if torch.device(device).type == "cuda" and torch.cuda.is_available():
            model = on_device(device, build)
        else:
            model = build()
        self.device = next(model.parameters()).device
        self._model_cfg = model.config
        self._batch_sizes = cfg.resolved_batch_sizes()
        self._max_group = min(cfg.max_batch, self._batch_sizes[-1])
        self.crashed: Optional[str] = None
        self._stopped = False
        self._stop_lock = threading.Lock()
        self._retry_rng = np.random.default_rng(0)
        self.registry = registry or MetricRegistry()
        self._sink = sink if sink is not None else EventSink.from_env()
        # one event per (bucket, lanes, program): its capture on the card
        # (its first run on the CPU)
        self.capture_counter = CaptureCounter(
            registry=self.registry, metric="raft_serve_compiles_total",
            labeler=lambda key: {"bucket": f"{key[0][0]}x{key[0][1]}",
                                 "batch": str(key[1]), "program": key[2]})
        self._programs = SlotPrograms(model, self.capture_counter)
        # (bucket, lanes) -> SlotSet, least recently used first
        self._sets: "OrderedDict[tuple, object]" = OrderedDict()
        self._sets_lock = threading.Lock()
        # (bucket, lanes) -> bytes the card's reserved memory grew by
        # during this engine's device calls for it (the state, the
        # graphs' private pools): what the resident budget is held
        # against on the card
        self._held: Dict[tuple, int] = {}
        if resident_budget_bytes is None and self.device.type == "cuda":
            resident_budget_bytes = int(
                RESIDENT_FRACTION
                * torch.cuda.get_device_properties(self.device).total_memory)
        self.resident_budget_bytes = resident_budget_bytes

        self._latency = LatencyRecorder(cfg.latency_window,
                                        registry=self.registry)
        self._iters_used = LatencyRecorder(
            cfg.latency_window, registry=self.registry,
            metric="raft_serve_iters_used",
            help="refinement iterations a request consumed before "
                 "retiring (early exit / per-request budget)",
            scale=1.0, suffix="")
        self._iters_used_warm = LatencyRecorder(
            cfg.latency_window, registry=self.registry,
            metric="raft_serve_iters_used_warm",
            help="iterations consumed by warm-started streamed frames",
            scale=1.0, suffix="")
        self._iters_used_cold = LatencyRecorder(
            cfg.latency_window, registry=self.registry,
            metric="raft_serve_iters_used_cold",
            help="iterations consumed by cold-started requests "
                 "(stateless pairs and session first pairs)",
            scale=1.0, suffix="")
        self._counters = Counters(registry=self.registry)
        # flow quality (obs/quality.py): built only when sampled, so the
        # default hot path carries no monitor
        self._quality = None
        if cfg.quality_sample_rate > 0:
            from raft_tpu_torch.obs import quality as quality_mod

            self._quality = quality_mod.QualityMonitor(
                registry=self.registry, sink=self._sink,
                sample_rate=cfg.quality_sample_rate,
                cycle=cfg.quality_cycle,
                drift_reference=cfg.quality_drift_reference,
                drift_window=cfg.quality_drift_window,
                drift_threshold=cfg.quality_drift_threshold,
                reservoir=cfg.latency_window)
        # SLOs (obs/slo.py): a tracker only for the objectives set
        self._slo = None
        slo_specs = []
        if (cfg.slo_availability_target > 0 or cfg.slo_latency_target_ms
                > 0 or cfg.slo_quality_bound > 0):
            from raft_tpu_torch.obs import slo as slo_mod

            policy = slo_mod.scaled_policy(cfg.slo_window_s)
            if cfg.slo_availability_target > 0:
                slo_specs.append(slo_mod.SLOSpec(
                    "availability", cfg.slo_availability_target,
                    "non-error request fraction", windows=policy))
            if cfg.slo_latency_target_ms > 0:
                slo_specs.append(slo_mod.SLOSpec(
                    "latency", 0.99,
                    f"requests under {cfg.slo_latency_target_ms}ms",
                    windows=policy))
            if cfg.slo_quality_bound > 0 and cfg.quality_sample_rate > 0:
                slo_specs.append(slo_mod.SLOSpec(
                    "quality", 0.99,
                    f"sampled photometric proxy <= "
                    f"{cfg.slo_quality_bound}", windows=policy))
            if slo_specs:
                self._slo = slo_mod.SLOTracker(
                    slo_specs, registry=self.registry, sink=self._sink)
        self._sessions: Dict[str, _StreamSession] = {}
        self._sessions_lock = threading.Lock()
        self._sessions_gauge = self.registry.gauge(
            "raft_serve_sessions_open", "streaming sessions currently open")
        self._stream_frames = self.registry.counter(
            "raft_serve_stream_frames_total",
            "streamed frames received (session mode)")
        self._stream_evicted = self.registry.counter(
            "raft_serve_stream_evictions_total",
            "streaming sessions evicted by the idle TTL")
        self._pending_gauge = self.registry.gauge(
            "raft_serve_pending_requests", "requests in flight")
        self._state_evictions = self.registry.counter(
            "raft_serve_state_evictions_total",
            "request-mode (bucket, lanes) states and graphs freed to stay "
            "within the resident budget")
        self.registry.add_collect_hook(self._collect_pending)

        self._pending = 0
        self._pending_lock = threading.Lock()
        # the stall signal: when the last device batch completed, when the
        # pending backlog started (0 -> nonzero), and start(); and the
        # shared device worker: device calls of this engine waiting in
        # line behind other engines' work (not a stall), and when its
        # running device call reached the worker
        self._last_batch_done: Optional[float] = None
        self._pending_since: Optional[float] = None
        self._t_started: Optional[float] = None
        self._in_line = 0
        self._device_since: Optional[float] = None
        self._stale_gauge = self.registry.gauge(
            "raft_serve_seconds_since_last_batch",
            "seconds since the last completed device batch (refreshed "
            "at scrape; absent before the first batch)")
        # device-batch ordinal: the chaos trigger context
        self._batch_seq = 0

        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None
        self._queues: Dict[tuple, asyncio.Queue] = {}
        self._dispatchers: Dict[tuple, asyncio.Task] = {}
        self._device_pool = _device_worker(self.device)
        # this engine's own host thread: batches and slot cycles run
        # here, their device calls on the shared worker
        self._host_pool = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="raft-serve-host")
        self._accepting = False

        # warm start (serve/aot.py): the manifest's fingerprint of this
        # engine, and what start() replayed
        from raft_tpu_torch.serve import aot as aot_mod

        self._aot_fingerprint = aot_mod.model_fingerprint(
            self._model_cfg, state_dict, cfg.iters, self.device)
        self.aot_info: dict = {"dir": cfg.aot_dir, "replayed": 0,
                               "ok": None}

    # ------------------------------------------------------------------
    # warm-start manifests
    # ------------------------------------------------------------------

    def _replay_manifest(self, directory: str) -> None:
        """Capture every key of the manifest in ``directory`` (on the
        device worker, before the engine reports ready).  Any refusal is
        a warm-start miss: the event, then lazy capture."""
        from raft_tpu_torch.serve import aot as aot_mod

        t0 = time.perf_counter()
        try:
            keys = aot_mod.read_manifest(directory,
                                         fingerprint=self._aot_fingerprint)
        except aot_mod.AOTImportError as e:
            self.aot_info.update(ok=False, error=str(e))
            self._sink.emit("aot_import_error", dir=directory,
                            error=str(e)[:300])
            return
        by_set: Dict[tuple, list] = {}
        for bucket, lanes, prog in keys:
            by_set.setdefault((bucket, lanes), []).append(prog)
        for (bucket, lanes), progs in by_set.items():
            self._device(lambda b=bucket, n=lanes, p=tuple(progs):
                         self._get_programs(b, n).warm(p), (bucket, lanes))
        secs = time.perf_counter() - t0
        self.aot_info.update(ok=True, replayed=len(keys),
                             seconds=round(secs, 3))
        self._sink.emit("aot_import", dir=directory, keys=len(keys),
                        seconds=round(secs, 3))

    def compiled_keys(self) -> List[tuple]:
        """``(bucket, lanes, program)`` keys this engine has captured (on
        the CPU: run) and still holds: what :meth:`export_aot` lists."""
        with self._sets_lock:
            held = set(self._sets)
        return sorted(k for k in self.capture_counter.counts()
                      if (k[0], k[1]) in held)

    def export_aot(self, directory: str) -> dict:
        """Write the warm-start manifest of :meth:`compiled_keys` into
        ``directory`` (atomically); returns it.  Raises when nothing was
        captured (warm up first)."""
        from raft_tpu_torch.serve import aot as aot_mod

        manifest = aot_mod.write_manifest(
            directory, self.compiled_keys(),
            fingerprint=self._aot_fingerprint)
        self._sink.emit("aot_export", dir=directory,
                        keys=len(manifest["keys"]))
        return manifest

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    def start(self) -> "InferenceEngine":
        if self._thread is not None:
            raise RuntimeError("engine already started")
        if self._stopped:
            raise RuntimeError(
                "engine stopped: engines are single-use; build a new "
                "InferenceEngine")
        self._loop = asyncio.new_event_loop()
        started = threading.Event()

        def run():
            asyncio.set_event_loop(self._loop)
            self._loop.call_soon(started.set)
            self._loop.run_forever()

        self._thread = threading.Thread(target=run, name="raft-serve-loop",
                                        daemon=True)
        self._thread.start()
        started.wait()
        if self.cfg.aot_dir:
            self._replay_manifest(self.cfg.aot_dir)
        self._counters.mark_started()
        self._t_started = time.perf_counter()
        self._accepting = True
        return self

    def stop(self, drain: bool = True, timeout: float = 60.0) -> None:
        """Stop accepting, optionally drain in-flight work, shut down.
        Queued requests that cannot complete fail with
        ``RuntimeError('engine stopped')``."""
        with self._stop_lock:
            self._stop_locked(drain, timeout)

    def _stop_locked(self, drain: bool, timeout: float) -> None:
        if self._thread is None:
            self._stopped = True
            return
        self._accepting = False
        self._stopped = True
        if drain:
            deadline = time.perf_counter() + timeout
            while time.perf_counter() < deadline:
                with self._pending_lock:
                    if self._pending == 0:
                        break
                time.sleep(0.005)

        async def _cancel_all():
            tasks = list(self._dispatchers.values())
            for t in tasks:
                t.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)

        asyncio.run_coroutine_threadsafe(
            _cancel_all(), self._loop).result(timeout=10)
        # this engine's batches end (a wedge ends once it stops
        # accepting); then its states and graphs go, on the device worker
        self._host_pool.shutdown(wait=True)
        try:
            self._device(self._release_device_state)
        except Exception as e:   # an unusable device: nothing to give back
            self._sink.emit("serve_release_error",
                            error=f"{type(e).__name__}: {e}"[:300])
        self._loop.call_soon_threadsafe(self._loop.stop)
        self._thread.join(timeout=10)
        self._loop.close()
        self._thread = None
        self._dispatchers.clear()
        self._queues.clear()

    def _release_device_state(self) -> None:
        """Drop every set and graph of this engine (device worker): a
        stopped engine holds no card memory but its weights, whatever
        still refers to it."""
        with self._sets_lock:
            for bucket, lanes in list(self._sets):
                self._programs.forget(bucket, lanes)
            self._sets.clear()
            self._held.clear()
        if self.device.type == "cuda":
            import torch

            gc.collect()
            torch.cuda.empty_cache()

    def __enter__(self) -> "InferenceEngine":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ------------------------------------------------------------------
    # client API (any thread)
    # ------------------------------------------------------------------

    def _check_accepting(self) -> None:
        if self._accepting:
            return
        if self.crashed:
            raise RuntimeError(f"engine crashed: {self.crashed}")
        if self._stopped:
            raise RuntimeError(
                "engine stopped: engines are single-use; build a new "
                "InferenceEngine")
        raise RuntimeError("engine not started (or stopping)")

    def _admit_pending_locked(self) -> None:
        """Count one more request in flight; caller holds
        ``_pending_lock``.  Raises :class:`QueueFullError` at
        ``max_queue``."""
        if self._pending >= self.cfg.max_queue:
            self._counters.add_rejected()
            raise QueueFullError(
                f"{self._pending} requests in flight >= max_queue="
                f"{self.cfg.max_queue}; retry after "
                f"{self.cfg.retry_after_s:g}s",
                queue_depth=self._pending,
                retry_after_s=self.cfg.retry_after_s)
        if self._pending == 0:
            self._pending_since = time.perf_counter()
        self._pending += 1

    def _hand_off(self, req: _Request) -> Future:
        try:
            self._loop.call_soon_threadsafe(self._enqueue, req)
        except RuntimeError:  # loop closed under our feet (stop race)
            with self._pending_lock:
                self._pending -= 1
            raise RuntimeError("engine stopped")
        return req.future

    def _bucket_of(self, h: int, w: int):
        bucket = bucket_hw(h, w, self.cfg.bucket_multiple, self.cfg.buckets)
        return bucket, InputPadder((h, w), mode=self.cfg.pad_mode,
                                   target=bucket)

    def submit(self, image1, image2,
               iters: Optional[int] = None) -> Future:
        """Enqueue one frame pair; returns a Future resolving to the
        ``(H, W, 2)`` float32 flow at the original resolution.  ``iters``
        is an optional budget (slot mode; capped at ``cfg.iters``).
        Raises :class:`QueueFullError` at once (never blocks) when
        ``max_queue`` requests are in flight."""
        if iters is not None and int(iters) < 1:
            raise ValueError(f"iters must be >= 1, got {iters}")
        self._check_accepting()
        im1 = np.asarray(image1, dtype=np.float32)
        im2 = np.asarray(image2, dtype=np.float32)
        if im1.ndim != 3 or im1.shape[-1] != 3 or im1.shape != im2.shape:
            raise ValueError(
                f"expected two matching (H, W, 3) images, got "
                f"{im1.shape} and {im2.shape}")
        bucket, padder = self._bucket_of(*im1.shape[:2])
        with self._pending_lock:
            self._admit_pending_locked()
        return self._hand_off(_Request(
            im1, im2, bucket, padder, None if iters is None else int(iters)))

    def infer(self, image1, image2, timeout: Optional[float] = None,
              iters: Optional[int] = None) -> np.ndarray:
        """Blocking wrapper around :meth:`submit`."""
        return self.submit(image1, image2,
                           iters=iters).result(timeout=timeout)

    # ------------------------------------------------------------------
    # client API: streaming sessions (any thread)
    # ------------------------------------------------------------------

    def stream_open(self, session_id: str, image, *,
                    iters: Optional[int] = None,
                    ttl_s: Optional[float] = None) -> dict:
        """Open a streaming session seeded with its first frame (held on
        the host; the first :meth:`stream_submit` forms the cold pair and
        pins a lane).  ``iters`` is the session's budget (capped at
        ``cfg.iters``), ``ttl_s`` overrides ``cfg.stream_ttl_s``.  Raises
        :class:`QueueFullError` at ``max_sessions`` open sessions (after
        sweeping expired ones)."""
        self._check_accepting()
        if self.cfg.batching != "slot":
            raise ValueError(
                "streaming sessions require batching='slot' (a session "
                "is a pinned lane in the slot pool)")
        if iters is not None and int(iters) < 1:
            raise ValueError(f"iters must be >= 1, got {iters}")
        if ttl_s is not None and float(ttl_s) <= 0:
            raise ValueError(f"ttl_s must be > 0, got {ttl_s}")
        im = np.asarray(image, dtype=np.float32)
        if im.ndim != 3 or im.shape[-1] != 3:
            raise ValueError(f"expected an (H, W, 3) image, got "
                             f"{im.shape}")
        h, w = im.shape[:2]
        bucket, padder = self._bucket_of(h, w)
        sess = _StreamSession(
            str(session_id), bucket, padder, (h, w),
            None if iters is None else int(iters),
            float(ttl_s) if ttl_s is not None else self.cfg.stream_ttl_s,
            im)
        with self._sessions_lock:
            evicted = self._sweep_unpinned_locked(time.time())
            if sess.sid in self._sessions:
                raise ValueError(f"session {sess.sid!r} already open")
            if len(self._sessions) >= self.cfg.max_sessions:
                self._counters.add_rejected()
                raise QueueFullError(
                    f"{len(self._sessions)} sessions open >= "
                    f"max_sessions={self.cfg.max_sessions}",
                    queue_depth=len(self._sessions),
                    retry_after_s=self.cfg.retry_after_s)
            self._sessions[sess.sid] = sess
            self._sessions_gauge.set(len(self._sessions))
        self._emit_evictions(evicted)
        self._sink.emit("stream_open", sid=sess.sid,
                        bucket=f"{bucket[0]}x{bucket[1]}",
                        iters=sess.iters, ttl_s=sess.ttl_s)
        return {"session": sess.sid, "frame": 0, "bucket": list(bucket)}

    def stream_submit(self, session_id: str, image) -> Future:
        """Stream the next frame into an open session; returns a Future
        resolving to the flow from the previous frame to this one.  One
        frame may be in flight per session."""
        self._check_accepting()
        im = np.asarray(image, dtype=np.float32)
        with self._sessions_lock:
            sess = self._sessions.get(str(session_id))
            if sess is None:
                raise ValueError(f"unknown session {session_id!r} "
                                 "(expired, closed, or never opened)")
            if im.shape != sess.last_image.shape:
                raise ValueError(
                    f"frame shape {im.shape} != session shape "
                    f"{sess.last_image.shape} (a session is fixed to "
                    "one resolution)")
            if sess.inflight is not None and not sess.inflight.done():
                raise ValueError(
                    f"session {sess.sid!r} already has a frame in "
                    "flight (stream frames sequentially)")
            warm = sess.carry_ok
            budget = sess.iters
            if warm and self.cfg.stream_warm_iters is not None:
                budget = self.cfg.stream_warm_iters
            with self._pending_lock:
                self._admit_pending_locked()
            req = _Request(sess.last_image, im, sess.bucket, sess.padder,
                           None if budget is None else int(budget),
                           session=sess, warm=warm)
            sess.last_image = im
            sess.frames += 1
            sess.t_last = time.time()
            sess.inflight = req.future
            # for the blocking facades: which pair this Future resolves
            # and whether it took the warm path, decided here
            req.future.stream_frame = sess.frames - 1
            req.future.stream_warm = warm
            self._stream_frames.inc()

        def _clear_inflight(_fut, sess=sess):
            with self._sessions_lock:
                if sess.inflight is _fut:
                    sess.inflight = None
                sess.t_last = time.time()

        req.future.add_done_callback(_clear_inflight)
        return self._hand_off(req)

    def stream_frame(self, session_id: str, image,
                     timeout: Optional[float] = None) -> np.ndarray:
        """Blocking wrapper around :meth:`stream_submit`."""
        return self.stream_submit(session_id, image).result(timeout=timeout)

    def stream_ingest(self, session_id: str, image, *,
                      iters: Optional[int] = None,
                      ttl_s: Optional[float] = None,
                      timeout: Optional[float] = None) -> dict:
        """Open on first use (``POST /v1/stream/{id}``): an unknown id
        opens the session with ``image`` as frame 0 (``flow`` None); a
        known one streams the frame and blocks for its flow.  Returns
        ``{"session", "frame", "warm", "flow"}``."""
        sid = str(session_id)
        with self._sessions_lock:
            known = sid in self._sessions
        if not known:
            ack = self.stream_open(sid, image, iters=iters, ttl_s=ttl_s)
            return {"session": sid, "frame": ack["frame"], "warm": False,
                    "flow": None}
        fut = self.stream_submit(sid, image)
        flow = fut.result(timeout=timeout)
        return {"session": sid, "frame": fut.stream_frame,
                "warm": fut.stream_warm, "flow": flow}

    def stream_close(self, session_id: str) -> dict:
        """Close a session; its pinned lane returns to the free pool at
        the dispatcher's next sweep.  Returns the session summary."""
        with self._sessions_lock:
            sess = self._sessions.get(str(session_id))
            if sess is None:
                raise ValueError(f"unknown session {session_id!r} "
                                 "(expired, closed, or never opened)")
            if sess.inflight is not None and not sess.inflight.done():
                raise ValueError(
                    f"session {sess.sid!r} has a frame in flight: "
                    "wait for it before closing")
            del self._sessions[sess.sid]
            sess.closed = True
            self._sessions_gauge.set(len(self._sessions))
        summary = {"session": sess.sid, "frames": sess.frames,
                   "pairs": sess.pairs, "warm_pairs": sess.warm_pairs}
        self._sink.emit("stream_close", sid=sess.sid, frames=sess.frames,
                        pairs=sess.pairs, warm_pairs=sess.warm_pairs)
        return summary

    def _sweep_unpinned_locked(self, now: float) -> list:
        """Evict expired sessions that never pinned a lane (pinned ones
        are swept by their bucket's dispatcher, which owns the lane).
        Caller holds ``_sessions_lock``."""
        out = []
        for sid, s in list(self._sessions.items()):
            if s.lane is not None:
                continue
            if s.inflight is not None and not s.inflight.done():
                continue
            if now - s.t_last > s.ttl_s:
                del self._sessions[sid]
                s.closed = True
                out.append(s)
        if out:
            self._sessions_gauge.set(len(self._sessions))
        return out

    def _emit_evictions(self, evicted: list) -> None:
        for s in evicted:
            self._stream_evicted.inc()
            self._sink.emit(
                "stream_evict", sid=s.sid,
                bucket=f"{s.bucket[0]}x{s.bucket[1]}",
                lane=-1 if s.lane is None else int(s.lane),
                idle_s=round(time.time() - s.t_last, 3), ttl_s=s.ttl_s)

    def warmup(self, image_shapes: Sequence[Tuple[int, int]],
               batch_sizes: Optional[Sequence[int]] = None) -> List[tuple]:
        """Capture the programs of the ``(bucket, lanes)`` keys of the
        given raw image ``(H, W)`` shapes (rounded as live traffic is),
        so that first requests do not pay for it: slot mode one key a
        bucket at ``cfg.slots`` lanes, request mode one per ``(bucket,
        batch_size)``.  Runs on the device worker; returns the keys."""
        keys = []
        for (h, w) in image_shapes:
            bucket, _ = self._bucket_of(h, w)
            sizes = ([self.cfg.slots] if self.cfg.batching == "slot"
                     else (batch_sizes or self._batch_sizes))
            keys += [(bucket, int(bs)) for bs in sizes]

        for bucket, bs in keys:
            self._device(lambda b=bucket, n=bs: self._get_programs(b, n)
                         .warm(), (bucket, bs))
        return keys

    def _collect_pending(self, _reg) -> None:
        with self._pending_lock:
            pending = self._pending
            last = self._last_batch_done
        self._pending_gauge.set(pending)
        if last is not None:
            self._stale_gauge.set(time.perf_counter() - last)

    def health(self) -> dict:
        """Readiness (``GET /v1/healthz``): not ready when not accepting,
        crashed, or when requests are pending and no device batch has
        completed within ``stall_timeout_s`` of the newest of {last
        completed batch, start of the pending backlog, start(), the
        moment its running device call reached the shared device
        worker}.  An engine whose device call waits in line behind
        another engine's work is not stalled."""
        now = time.perf_counter()
        with self._pending_lock:
            pending = self._pending
            last = self._last_batch_done
            pending_since = self._pending_since
            in_line = self._in_line
            device_since = self._device_since
        since = None if last is None else now - last
        stalled = False
        if self.cfg.stall_timeout_s and pending > 0 and not in_line:
            refs = [t for t in (last, pending_since, self._t_started,
                                device_since) if t is not None]
            stalled = (bool(refs)
                       and now - max(refs) > self.cfg.stall_timeout_s)
        return {
            "ready": bool(self._accepting and not stalled
                          and not self.crashed),
            "accepting": bool(self._accepting),
            "stalled": stalled,
            "crashed": self.crashed,
            "pending": pending,
            "seconds_since_last_batch":
                None if since is None else round(since, 3),
            "stall_timeout_s": self.cfg.stall_timeout_s,
        }

    def metrics_text(self) -> str:
        """Prometheus text of the engine registry (what ``stats()``
        reads)."""
        return self.registry.render_prometheus()

    def queue_capacity(self) -> int:
        """This engine's admission bound (the router's spill math and
        the autoscaler read it through the replica)."""
        return self.cfg.max_queue

    def load_signals(self) -> dict:
        """The autoscaler's inputs, from host counters only: ``pending``
        / ``max_queue`` / ``queue_frac``, ``occupancy`` (slot lanes or
        batch fill), ``burn_rate`` (the worst SLO burn, 0 without SLOs),
        ``mfu`` (None: the cost model is not ported yet) and
        ``latency_p95_ms`` over the recent window."""
        with self._pending_lock:
            pending = self._pending
        cap = max(int(self.cfg.max_queue), 1)
        burn = 0.0
        if self._slo is not None:
            for snap in self._slo.snapshot().values():
                if isinstance(snap, dict):
                    burn = max(burn, float(snap.get("burn_rate") or 0.0))
        counters = self._counters.snapshot(1)
        lat = self._latency.snapshot()
        return {
            "pending": pending,
            "max_queue": self.cfg.max_queue,
            "queue_frac": round(pending / cap, 4),
            "occupancy": float(counters.get("occupancy") or 0.0),
            "burn_rate": round(burn, 4),
            "mfu": None,
            "latency_p95_ms": float(lat.get("p95_ms") or 0.0),
        }

    def quality_drift(self) -> Optional[dict]:
        """Per-proxy drift-detector state (None when quality scoring is
        off): the fleet's supervisor forwards new firings."""
        if self._quality is None:
            return None
        return self._quality.drift_snapshot()

    def stats(self) -> dict:
        """One JSON-able snapshot: counters, latency percentiles over the
        recent window, captures per ``(bucket, lanes, program)``."""
        out = self._counters.snapshot(1)
        with self._pending_lock:
            out["pending"] = self._pending
        out["max_queue"] = self.cfg.max_queue
        out["latency_ms"] = self._latency.snapshot()
        out["batching"] = self.cfg.batching
        out["device"] = str(self.device)
        out["iters_used"] = self._iters_used.snapshot()
        out["iters_used_warm"] = self._iters_used_warm.snapshot()
        out["iters_used_cold"] = self._iters_used_cold.snapshot()
        with self._sessions_lock:
            expired = self._sweep_unpinned_locked(time.time())
        self._emit_evictions(expired)
        with self._sessions_lock:
            out["sessions"] = {
                "open": len(self._sessions),
                "pinned": sum(1 for s in self._sessions.values()
                              if s.lane is not None),
                "frames_total": int(self._stream_frames.value()),
                "evicted_total": int(self._stream_evicted.value()),
            }
        counts = self.capture_counter.counts()
        out["compiles"] = {f"{hw[0]}x{hw[1]}/b{bs}/{prog}": n
                           for (hw, bs, prog), n in sorted(counts.items())}
        out["num_buckets"] = len({k[0] for k in counts})
        out["aot"] = dict(self.aot_info)
        out["quality"] = (self._quality.snapshot()
                          if self._quality is not None
                          else {"enabled": False})
        out["slo"] = (self._slo.snapshot() if self._slo is not None
                      else {"enabled": False})
        return out

    # ------------------------------------------------------------------
    # internals: event-loop thread
    # ------------------------------------------------------------------

    def _enqueue(self, req: _Request) -> None:
        q = self._queues.get(req.bucket)
        if q is None:
            q = self._queues[req.bucket] = asyncio.Queue()
            runner = (self._slot_dispatcher if self.cfg.batching == "slot"
                      else self._dispatcher)
            self._dispatchers[req.bucket] = self._loop.create_task(
                runner(req.bucket, q))
        q.put_nowait(req)

    def _fail_leftovers(self, leftovers: List[_Request]) -> None:
        for r in leftovers:
            if not r.future.done():
                r.future.set_exception(RuntimeError("engine stopped"))
        if leftovers:
            with self._pending_lock:
                self._pending -= len(leftovers)

    async def _dispatcher(self, bucket: tuple, q: asyncio.Queue) -> None:
        """Coalesce one bucket's requests into micro-batches.  The batch
        is not awaited: the engine's host thread serializes its batches,
        and the next batch fills while the previous one runs."""
        batch: List[_Request] = []
        try:
            while True:
                batch = [await q.get()]
                deadline = self._loop.time() + self.cfg.max_wait_ms / 1e3
                while len(batch) < self._max_group:
                    wait = deadline - self._loop.time()
                    if wait <= 0:
                        break
                    try:
                        batch.append(
                            await asyncio.wait_for(q.get(), timeout=wait))
                    except asyncio.TimeoutError:
                        break
                fut = self._loop.run_in_executor(
                    self._host_pool, self._run_batch, bucket, batch)
                batch = []
                fut.add_done_callback(lambda f: f.exception())
        except asyncio.CancelledError:
            leftovers = batch
            while not q.empty():
                leftovers.append(q.get_nowait())
            self._fail_leftovers(leftovers)
            raise

    async def _slot_dispatcher(self, bucket: tuple,
                               q: asyncio.Queue) -> None:
        """Continuous batching: one persistent ``cfg.slots``-lane batch a
        bucket; each cycle admits waiting requests into free lanes and
        runs one iteration.  The device work is awaited (the next cycle's
        admissions depend on which lanes retired), so the pool has one
        owner.  The loop blocks on the queue only when no lane is live
        and nothing waits."""
        pool = _SlotPool(self.cfg.slots)
        waiting: List[_Request] = []
        try:
            while True:
                if not waiting and not pool.live():
                    if pool.pins:
                        # idle with pinned lanes: wake at the earliest TTL
                        # expiry so the sweep can free them
                        try:
                            waiting.append(await asyncio.wait_for(
                                q.get(), timeout=self._pin_poll_s(pool)))
                        except asyncio.TimeoutError:
                            pass
                    else:
                        waiting.append(await q.get())
                while True:
                    try:
                        waiting.append(q.get_nowait())
                    except asyncio.QueueEmpty:
                        break
                await self._loop.run_in_executor(
                    self._host_pool, self._slot_cycle, bucket, pool,
                    waiting)
        except asyncio.CancelledError:
            leftovers = list(waiting) + pool.live()
            waiting.clear()
            pool.reqs = [None] * len(pool.reqs)
            while not q.empty():
                leftovers.append(q.get_nowait())
            self._fail_leftovers(leftovers)
            raise

    def _pin_poll_s(self, pool: _SlotPool) -> float:
        """Idle poll while lanes are pinned: until the earliest session
        TTL could expire, clamped to [0.05, 1.0] s."""
        now = time.time()
        nxt = min((s.t_last + s.ttl_s for s in pool.pins.values()),
                  default=now + 1.0)
        return float(min(max(nxt - now, 0.05), 1.0))

    # ------------------------------------------------------------------
    # internals: the engine's host thread, and its device calls
    # ------------------------------------------------------------------

    def _device(self, fn, key: Optional[tuple] = None):
        """Run ``fn()`` on the shared device worker and wait for it (every
        CUDA call of the engine goes through here).  The time it waits in
        line is not a stall (:meth:`health`).  With ``key`` (a ``(bucket,
        lanes)``), the growth of the card's reserved memory during the
        call is charged to that set (:meth:`resident_bytes`)."""
        with self._pending_lock:
            self._in_line += 1

        def run():
            with self._pending_lock:
                self._in_line -= 1
                self._device_since = time.perf_counter()
            try:
                if key is None or self.device.type != "cuda":
                    return fn()
                import torch

                before = torch.cuda.memory_reserved(self.device)
                try:
                    return fn()
                finally:
                    grown = torch.cuda.memory_reserved(self.device) - before
                    if grown > 0 and key in self._sets:
                        self._held[key] = self._held.get(key, 0) + grown
            finally:
                with self._pending_lock:
                    self._device_since = None

        return self._device_pool.submit(run).result()

    def _get_programs(self, bucket: tuple, lanes: int):
        """The :class:`~raft_tpu_torch.serve.slots.SlotSet` of ``(bucket,
        lanes)``: one resident state and one program set per key; both
        batching modes run through here (on the device worker).  In
        request mode a new key first frees least recently used ones while
        the resident memory is past the budget (slot mode's pools hold
        their sets for good)."""
        from raft_tpu_torch.serve.slots import SlotSet

        key = (tuple(bucket), int(lanes))
        with self._sets_lock:
            progs = self._sets.get(key)
            if progs is None:
                if self.cfg.batching == "request":
                    self._evict_past_budget()
                progs = self._sets[key] = SlotSet(self._programs, bucket,
                                                  lanes)
            self._sets.move_to_end(key)
            return progs

    def resident_bytes(self) -> int:
        """What the resident budget is held against: on the card, the
        reserved memory this engine's sets grew it by (their states and
        their graphs' private pools; all device calls of the process run
        one at a time on the device worker, so a call's growth is its
        own), on the CPU the bytes of the sets' states."""
        if self.device.type == "cuda":
            return sum(self._held.values())
        return sum(s.nbytes() for s in self._sets.values())

    def _evict_past_budget(self) -> None:
        """While the resident memory is past the budget, free the least
        recently used set and its graphs (until none is left), then give
        the freed blocks back to the card; caller holds ``_sets_lock`` on
        the device worker, so no set is in use."""
        budget = self.resident_budget_bytes
        if budget is None:
            return
        evicted = False
        while self._sets and self.resident_bytes() > budget:
            (bucket, lanes), _ = self._sets.popitem(last=False)
            self._programs.forget(bucket, lanes)
            self._held.pop((bucket, lanes), None)
            evicted = True
            self._state_evictions.inc()
            self._sink.emit("serve_state_evict",
                            bucket=f"{bucket[0]}x{bucket[1]}", lanes=lanes,
                            resident_bytes=self.resident_bytes(),
                            budget_bytes=budget)
        if evicted and self.device.type == "cuda":
            import torch

            gc.collect()     # a graph's memory goes with its last ref
            torch.cuda.empty_cache()

    def _retry_call(self, bucket: tuple, seq: int, thunk,
                    key: Optional[tuple] = None):
        """Run one device call (``thunk``, on the device worker; ``key``
        as :meth:`_device`) with transient-error retry:
        up to ``cfg.device_retries`` re-runs with exponential, jittered
        backoff under ``retry_deadline_s``, each counted and logged
        (``serve_retry`` with the backoff slept).  The ``device_err``
        seam raises before ``thunk`` runs, so a retried call finds the
        resident state as the failed attempt found it; anything not
        transient raises at once."""
        attempt = 0
        t_first_try = time.perf_counter()
        while True:
            try:
                if chaos.should_inject("device_err", step=seq,
                                       point="serve.device"):
                    raise InjectedDeviceError(
                        f"chaos-injected transient device error "
                        f"(batch {seq})")
                return self._device(thunk, key)
            except Exception as e:
                if attempt >= self.cfg.device_retries \
                        or not is_transient_error(e):
                    raise
                attempt += 1
                base = min(self.cfg.retry_backoff_s * 2 ** (attempt - 1),
                           self.cfg.retry_backoff_max_s)
                backoff = base * (1.0 + self.cfg.retry_jitter
                                  * float(self._retry_rng.uniform(-1, 1)))
                elapsed = time.perf_counter() - t_first_try
                if elapsed + backoff > self.cfg.retry_deadline_s:
                    self._sink.emit(
                        "serve_retry_deadline",
                        bucket=f"{bucket[0]}x{bucket[1]}",
                        attempt=attempt, elapsed_s=round(elapsed, 4),
                        deadline_s=self.cfg.retry_deadline_s)
                    raise
                self._counters.add_retry()
                self._sink.emit("serve_retry",
                                bucket=f"{bucket[0]}x{bucket[1]}",
                                attempt=attempt,
                                backoff_s=round(backoff, 6),
                                elapsed_s=round(elapsed, 4),
                                error=f"{type(e).__name__}: {e}")
                time.sleep(backoff)

    def _crash(self, reason: str) -> None:
        """Mark the engine dead: stop accepting, stamp the reason."""
        self.crashed = reason
        self._accepting = False
        self._sink.emit("replica_crash", reason=reason[:300])

    def _chaos_replica_faults(self, seq: int) -> None:
        """The ``serve.replica`` seam (step context: the batch ordinal),
        on the engine's host thread: a straggler or a wedge holds this
        engine only."""
        if chaos.should_inject("replica_slow", step=seq,
                               point="serve.replica"):
            self._sink.emit("chaos_inject", fault="replica_slow", step=seq)
            time.sleep(self.cfg.chaos_slow_s)
        if chaos.should_inject("replica_hang", step=seq,
                               point="serve.replica"):
            self._sink.emit("chaos_inject", fault="replica_hang", step=seq)
            t0 = time.perf_counter()
            while (self._accepting
                   and time.perf_counter() - t0 < self.cfg.chaos_hang_max_s):
                time.sleep(0.02)
            raise ReplicaWedgedInterrupt(
                f"chaos-injected device wedge interrupted after "
                f"{time.perf_counter() - t0:.2f}s (batch {seq})")
        if chaos.should_inject("replica_kill", step=seq,
                               point="serve.replica"):
            self._sink.emit("chaos_inject", fault="replica_kill", step=seq)
            self._crash(f"chaos-injected replica kill (batch {seq})")
            raise InjectedReplicaKill(
                f"chaos-injected replica kill (batch {seq})")

    def _slo_request(self, ok: bool, latency_s: Optional[float] = None,
                     n: int = 1) -> None:
        """``n`` request outcomes into the SLO tracker (callers check
        ``self._slo``); the latency SLO observes successes only."""
        self._slo.record("availability", ok, n=n)
        if ok and latency_s is not None:
            self._slo.record(
                "latency",
                latency_s * 1000.0 <= self.cfg.slo_latency_target_ms, n=n)

    def _run_batch(self, bucket: tuple, reqs: List[_Request]) -> None:
        """Request mode: one micro-batch through the slot programs in
        lockstep (admit all, ``iters`` iterations, one upsample), read
        back once at the end; padding here, the programs on the device
        worker."""
        n = len(reqs)
        bs = next((s for s in self._batch_sizes if s >= n), n)
        t_start = time.perf_counter()
        self._batch_seq += 1
        if self.crashed:
            self._fail_waiting(list(reqs))
            return
        try:
            self._chaos_replica_faults(self._batch_seq)
            im1 = [r.padder.pad_np(r.image1) for r in reqs]
            im2 = [r.padder.pad_np(r.image2) for r in reqs]
            if bs > n:  # ballast lanes keep the batch shape
                im1 += [im1[-1]] * (bs - n)
                im2 += [im2[-1]] * (bs - n)
            a1, a2 = np.stack(im1), np.stack(im2)
            budgets = np.full((bs,), self.cfg.iters, np.int32)

            def thunk():
                progs = self._get_programs(bucket, bs)
                progs.encode(a1, a2, progs.admit_all, budgets)
                for _ in range(self.cfg.iters):
                    progs.iterate(0.0)
                return progs.upsample().cpu().numpy()

            flow_up = self._retry_call(bucket, self._batch_seq, thunk,
                                       (tuple(bucket), bs))
            t_done = time.perf_counter()
            for j, r in enumerate(reqs):
                r.future.set_result(
                    np.asarray(r.padder.unpad(flow_up[j:j + 1])[0]))
                self._latency.record(t_done - r.t_submit)
                if self._slo is not None:
                    self._slo_request(True, t_done - r.t_submit)
            self._counters.add_batch(real=n, padded=bs - n, failed=False)
            self._sink.emit("serve_batch",
                            bucket=f"{bucket[0]}x{bucket[1]}", real=n,
                            ballast=bs - n,
                            seconds=round(t_done - t_start, 6))
        except Exception as e:
            for r in reqs:
                if not r.future.done():
                    r.future.set_exception(e)
            self._counters.add_batch(real=n, padded=bs - n, failed=True)
            if self._slo is not None:
                self._slo_request(False, n=n)
            self._sink.emit("serve_batch_error",
                            bucket=f"{bucket[0]}x{bucket[1]}", real=n,
                            error=f"{type(e).__name__}: {e}")
            if _device_unusable(e) and not self.crashed:
                self._crash(f"{type(e).__name__}: {e}")
        finally:
            with self._pending_lock:
                self._pending -= len(reqs)
                self._last_batch_done = time.perf_counter()

    # ------------------------------------------------------------------
    # internals: the engine's host thread, slot mode
    # ------------------------------------------------------------------

    def _fail_lanes(self, reqs: List[_Request], e: Exception, event: str,
                    bucket: tuple, **fields) -> None:
        for r in reqs:
            if not r.future.done():
                r.future.set_exception(e)
        self._counters.add_failed_lanes(len(reqs))
        if self._slo is not None and reqs:
            self._slo_request(False, n=len(reqs))
        self._sink.emit(event, bucket=f"{bucket[0]}x{bucket[1]}",
                        error=f"{type(e).__name__}: {e}", **fields)
        with self._pending_lock:
            self._pending -= len(reqs)

    def _fail_waiting(self, waiting: List[_Request]) -> None:
        """Fail requests that never reached a lane because the engine
        crashed (and empty ``waiting``)."""
        for r in waiting:
            if not r.future.done():
                r.future.set_exception(
                    RuntimeError(f"engine crashed: {self.crashed}"))
        with self._pending_lock:
            self._pending -= len(waiting)
        waiting.clear()

    def _pool_failed(self, bucket: tuple, pool: _SlotPool,
                     waiting: List[_Request], e: Exception,
                     event: str) -> None:
        """A cycle's device work failed and every live lane's request
        dies.  The pool resets to zeros and the waiting requests stay
        queued for it, unless the device is unusable (a CUDA error is
        sticky) or the reset fails: then the device is not touched again,
        the engine crashes (``health()`` not ready, ``submit`` refuses)
        and the waiting requests fail with it."""
        live = pool.live()
        self._fail_lanes(live, e, event, bucket, lanes=len(live))
        if not _device_unusable(e):
            try:
                self._device(pool.reset)
                return
            except Exception as reset_err:   # the zeroing failed too
                e = reset_err
        pool.clear()
        if not self.crashed:
            self._crash(f"{type(e).__name__}: {e}")
        self._fail_waiting(waiting)

    def _slot_cycle(self, bucket: tuple, pool: _SlotPool,
                    waiting: List[_Request]) -> None:
        """One continuous-batching cycle: admit, then iterate.
        ``waiting`` is the dispatcher's FIFO (drained oldest first into
        the lowest free lanes)."""
        self._batch_seq += 1
        seq = self._batch_seq
        if self.crashed:
            self._fail_waiting(waiting)
            return
        try:
            self._chaos_replica_faults(seq)
            if pool.progs is None:
                key = (tuple(bucket), self.cfg.slots)
                pool.progs = self._device(
                    lambda: self._get_programs(*key), key)
            self._sweep_pins(bucket, pool)
            if waiting:
                self._admit_cycle(bucket, pool, waiting, seq)
            if pool.active_np.any():
                self._iter_slots(bucket, pool, waiting, seq)
        except Exception as e:
            # replica-fatal fault, a device error or a bug
            self._pool_failed(bucket, pool, waiting, e, "serve_slot_error")
        finally:
            with self._pending_lock:
                self._last_batch_done = time.perf_counter()

    def _sweep_pins(self, bucket: tuple, pool: _SlotPool) -> None:
        """Evict closed or expired pinned sessions and free their lanes
        (no device work: the next admit overwrites the lane)."""
        now = time.time()
        evicted = []
        for lane, s in list(pool.pins.items()):
            if pool.reqs[lane] is not None or (
                    s.inflight is not None and not s.inflight.done()):
                continue
            if s.closed:
                del pool.pins[lane]
                s.lane = None
            elif now - s.t_last > s.ttl_s:
                del pool.pins[lane]
                s.lane = None
                s.closed = True
                evicted.append((lane, s))
        if not evicted:
            return
        with self._sessions_lock:
            for _, s in evicted:
                self._sessions.pop(s.sid, None)
            self._sessions_gauge.set(len(self._sessions))
        for lane, s in evicted:
            self._stream_evicted.inc()
            self._sink.emit("stream_evict", sid=s.sid,
                            bucket=f"{bucket[0]}x{bucket[1]}", lane=lane,
                            idle_s=round(now - s.t_last, 3), ttl_s=s.ttl_s)

    def _admit_cycle(self, bucket: tuple, pool: _SlotPool,
                     waiting: List[_Request], seq: int) -> None:
        """Split the waiting FIFO into this cycle's admissions: stateless
        requests fill free unpinned lanes; a session frame goes to its
        pinned lane (pinning one on its first pair), warm when the lane's
        carry is valid, else cold plus a carry stash.  Requests that
        found no lane stay in ``waiting``, in order."""
        S = self.cfg.slots
        free = [i for i in range(S)
                if pool.reqs[i] is None and i not in pool.pins]
        cold: List[tuple] = []
        warm: List[tuple] = []
        stash: List[tuple] = []
        leftover: List[_Request] = []
        for r in waiting:
            sess = r.session
            if sess is None:
                if free:
                    cold.append((free.pop(0), r))
                else:
                    leftover.append(r)
                continue
            lane = sess.lane
            if lane is None or pool.pins.get(lane) is not sess:
                if not free:
                    leftover.append(r)
                    continue
                lane = free.pop(0)
                sess.lane = lane
                pool.pins[lane] = sess
            if pool.reqs[lane] is not None:
                leftover.append(r)
                continue
            if r.warm and sess.carry_ok:
                warm.append((lane, r))
            else:
                # cold: the unmodified encode (bit parity with the
                # stateless path) plus a stash so the next frame is warm
                r.warm = False
                cold.append((lane, r))
                stash.append((lane, r))
        waiting[:] = leftover
        try:
            if cold:
                if self._admit_slots(bucket, pool, cold, seq) and stash:
                    self._stash_carry(bucket, pool, stash, seq)
            if warm:
                self._admit_warm(bucket, pool, warm, seq)
        except Exception:
            # the device is unusable: this cycle's requests that neither
            # failed nor took a lane go back to ``waiting``, which the
            # crash fails
            waiting.extend(r for _, r in cold + warm
                           if not r.future.done() and r not in pool.reqs)
            raise

    def _lane_inputs(self, pool: _SlotPool, admits: List[tuple],
                     first: bool):
        """Host batch of the admitted lanes: the padded frames (frame 1
        only when ``first``), the admit mask and the lanes' budgets."""
        S = self.cfg.slots
        H, W = pool.progs.bucket
        a1 = np.zeros((S, H, W, 3), np.float32) if first else None
        a2 = np.zeros((S, H, W, 3), np.float32)
        admit = np.zeros((S,), bool)
        budgets = pool.budgets.copy()
        for i, r in admits:
            if first:
                a1[i] = r.padder.pad_np(r.image1)
            a2[i] = r.padder.pad_np(r.image2)
            admit[i] = True
            budgets[i] = min(int(r.iters or self.cfg.iters), self.cfg.iters)
        return a1, a2, admit, budgets

    def _commit_admits(self, pool: _SlotPool, admits: List[tuple],
                       admit: np.ndarray, budgets: np.ndarray) -> None:
        pool.active_np = pool.active_np | admit
        pool.budgets = budgets
        t_done = time.perf_counter()
        for i, r in admits:
            pool.reqs[i] = r
            pool.t_admit[i] = t_done

    def _admit_slots(self, bucket: tuple, pool: _SlotPool,
                     admits: List[tuple], seq: int) -> bool:
        """Encode ``admits`` (``(lane, request)`` pairs) into their lanes;
        the other lanes' state is kept, so a failed admit fails only the
        admitted requests."""
        t0 = time.perf_counter()
        a1, a2, admit, budgets = self._lane_inputs(pool, admits, True)
        try:
            self._retry_call(bucket, seq, lambda: pool.progs.encode(
                a1, a2, admit, budgets), self._set_key(pool))
        except Exception as e:
            self._fail_lanes([r for _, r in admits], e, "serve_admit_error",
                             bucket, admits=len(admits), warm=False)
            if _device_unusable(e):
                raise
            return False
        self._commit_admits(pool, admits, admit, budgets)
        self._sink.emit("serve_admit", bucket=f"{bucket[0]}x{bucket[1]}",
                        admits=len(admits), seq=seq, warm=False,
                        seconds=round(time.perf_counter() - t0, 6))
        return True

    def _stash_carry(self, bucket: tuple, pool: _SlotPool,
                     admits: List[tuple], seq: int) -> None:
        """Stash frame 2's features into freshly cold-admitted session
        lanes.  A separate program, so the cold pair runs the unmodified
        ``enc``; a failure never fails the pair (the session stays cold
        and re-seeds on its next frame)."""
        _, a2, admit, _ = self._lane_inputs(pool, admits, False)
        try:
            self._retry_call(bucket, seq,
                             lambda: pool.progs.stash(a2, admit),
                             self._set_key(pool))
        except Exception as e:
            for _, r in admits:
                r.session.carry_ok = False
            self._sink.emit("stream_stash_error",
                            bucket=f"{bucket[0]}x{bucket[1]}",
                            lanes=len(admits),
                            error=f"{type(e).__name__}: {e}")
            if _device_unusable(e):
                raise
            return
        for _, r in admits:
            r.session.carry_ok = True

    def _admit_warm(self, bucket: tuple, pool: _SlotPool,
                    admits: List[tuple], seq: int) -> None:
        """Warm-admit session frames into their pinned lanes: only the new
        image runs through the encoders, and ``coords1`` starts from the
        lane's previous flow warped forward.  A failure fails just these
        frames and marks their sessions cold."""
        t0 = time.perf_counter()
        _, a2, admit, budgets = self._lane_inputs(pool, admits, False)
        try:
            self._retry_call(bucket, seq, lambda: pool.progs.encode_warm(
                a2, admit, budgets), self._set_key(pool))
        except Exception as e:
            for _, r in admits:
                r.session.carry_ok = False
            self._fail_lanes([r for _, r in admits], e, "serve_admit_error",
                             bucket, admits=len(admits), warm=True)
            if _device_unusable(e):
                raise
            return
        self._commit_admits(pool, admits, admit, budgets)
        self._sink.emit("serve_admit", bucket=f"{bucket[0]}x{bucket[1]}",
                        admits=len(admits), seq=seq, warm=True,
                        seconds=round(time.perf_counter() - t0, 6))

    def _iter_slots(self, bucket: tuple, pool: _SlotPool,
                    waiting: List[_Request], seq: int) -> None:
        """One ``iter`` over the lanes, one read of their status, then
        ``up`` and retirement of the lanes that just retired.  On a
        failure every live request dies (:meth:`_pool_failed`)."""
        prev_active = pool.active_np.copy()
        n_active = int(prev_active.sum())
        thr = float(self.cfg.early_exit_threshold)

        def thunk():
            return pool.progs.iterate(thr).cpu().numpy()

        try:
            status = self._retry_call(bucket, seq, thunk,
                                      self._set_key(pool))
        except Exception as e:
            self._pool_failed(bucket, pool, waiting, e, "serve_iter_error")
            return
        t_done = time.perf_counter()
        active = status[0] > 0
        pool.active_np = active
        self._counters.add_slot_step(n_active, self.cfg.slots)
        newly = prev_active & ~active
        if not newly.any():
            return
        flow_np = self._device(lambda: pool.progs.upsample().cpu().numpy())
        bk = f"{bucket[0]}x{bucket[1]}"
        for i in np.nonzero(newly)[0]:
            i = int(i)
            r = pool.reqs[i]
            pool.reqs[i] = None
            if r is None:
                continue
            out = np.asarray(r.padder.unpad(flow_np[i:i + 1])[0])
            if not r.future.done():
                r.future.set_result(out)
            used = int(status[1][i])
            self._latency.record(t_done - r.t_submit)
            self._iters_used.record(used)
            (self._iters_used_warm if r.warm
             else self._iters_used_cold).record(used)
            self._counters.add_completed()
            if self._slo is not None:
                self._slo_request(True, t_done - r.t_submit)
            if r.session is not None:
                r.session.pairs += 1
                if r.warm:
                    r.session.warm_pairs += 1
            self._sink.emit("serve_retire", bucket=bk, slot=i, iters=used,
                            warm=bool(r.warm),
                            converged=bool(status[2][i] > 0),
                            seconds=round(t_done - r.t_submit, 6))
            if self._quality is not None:
                self._note_quality(r, out, bk, float(status[3][i]),
                                   bool(status[2][i] > 0), used)
            with self._pending_lock:
                self._pending -= 1

    def _set_key(self, pool: _SlotPool) -> tuple:
        return (pool.progs.bucket, pool.progs.lanes)

    def _note_quality(self, r: _Request, out: np.ndarray, bk: str,
                      residual: float, converged: bool, used: int) -> None:
        """One retirement into the quality monitor (and the quality SLO);
        a sampled request with ``quality_cycle`` submits its backward
        pass, best effort (backpressure or a stopping engine skips it)."""
        qattrs = self._quality.note_retirement(
            future=r.future, image1=r.image1, image2=r.image2, flow=out,
            bucket=bk, residual=residual, converged=converged, iters=used)
        if (self._slo is not None and qattrs is not None
                and "quality_photometric" in qattrs):
            self._slo.record("quality", qattrs["quality_photometric"]
                             <= self.cfg.slo_quality_bound)
        if qattrs is not None and self.cfg.quality_cycle:
            try:
                bfut = self.submit(r.image2, r.image1, iters=r.iters)
            except Exception:
                return
            self._quality.begin_cycle(bfut, out, bk)
