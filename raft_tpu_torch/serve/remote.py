"""Remote replica backend: the fleet facade over the npz wire protocol
(the port of ``raft_tpu/serve/remote.py``).

One serving host's ``FlowRouter`` fronts replicas on OTHER hosts by
speaking the same HTTP protocol the serve CLI exposes (the port's and
the JAX package's alike) —
``POST /v1/flow``, ``POST/DELETE /v1/stream/{id}``, ``GET /v1/healthz``,
``GET /v1/stats`` — through :class:`RemoteEngine`, which implements the
engine facade the router and fleet already duck-type (``submit`` /
``infer`` / ``stream_ingest`` / ``stream_close`` / ``health`` /
``stats`` / ``metrics_text``).  :class:`RemoteReplica` wraps it in the
:class:`~raft_tpu_torch.serve.fleet.Replica` state machine so the router's
placement, breaker, failover, and hedging code paths need no remote
special case at all.

Design points:

- **Network-error taxonomy** — every wire failure is classified into
  one of five :class:`RemoteNetworkError` subclasses (refused / reset /
  timeout / mid-response disconnect / HTTP 503).  All carry
  ``replica_fatal = True``, so
  :func:`raft_tpu_torch.serve.router.is_failover_error` re-dispatches the
  request on a sibling and the breaker accumulates strikes — a
  partitioned host is indistinguishable from a crashed replica to the
  router.  Only timeouts are additionally marked ``transient`` (a
  deadline flake is worth a same-path retry); refused/reset indict the
  host.  Malformed responses raise :class:`RemoteProtocolError`, which
  is deliberately NOT a failover signal — a server speaking garbage
  would speak the same garbage to the retry.
- **No trace header yet** — the JAX client sends the submitting
  thread's span as ``X-Raft-Trace``; the port's serving path opens no
  spans yet (ROADMAP A8b′), so it sends none (a JAX server then
  starts its own trace).
- **Connection pooling + per-request deadlines** — a small pool of
  keep-alive ``http.client`` connections; a connection that saw any
  network error is discarded, never reused.  Every request runs under
  ``RemoteConfig.request_timeout_s`` (health probes under the much
  tighter ``health_timeout_s``).
- **Client-side pending** — ``pending()`` counts in-flight requests on
  THIS side of the wire (no network round trip), so router placement
  (`_pick`'s least-loaded fallback) stays cheap during a partition.
- **Chaos seam** (``serve.remote``): ``net_refuse``
  (connect refused), ``net_slow`` (added latency), ``net_drop``
  (mid-response disconnect — the request reached the server, the
  response never arrived), and ``net_partition`` (every wire operation
  times out until the rule's ``heal=`` ordinal is reached).  All are
  deterministic under the :class:`~raft_tpu_torch.chaos.FaultPlan` grammar.

Telemetry: each REQUEST-path network failure emits one ``net_retry``
event and bumps ``raft_remote_net_errors_total{kind=...}`` in the
engine's local registry (health probes are deliberately unrecorded —
a 20 Hz supervisor poll during a partition would drown the stream).
"""

from __future__ import annotations

import dataclasses
import http.client
import io
import json
import socket
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import List, Optional, Tuple

import numpy as np

from raft_tpu_torch import chaos
from raft_tpu_torch.obs import EventSink, MetricRegistry
from raft_tpu_torch.obs.exposition import render as render_metrics
from raft_tpu_torch.serve.engine import QueueFullError

CHAOS_POINT = "serve.remote"


# ---------------------------------------------------------------------------
# network-error taxonomy
# ---------------------------------------------------------------------------


class RemoteNetworkError(RuntimeError):
    """Base of the wire-failure taxonomy.  ``replica_fatal`` makes every
    subclass a failover signal to the router (the remote HOST is
    suspect); ``transient`` stays False except for timeouts — retrying
    a refused/reset connection on the same path cannot help."""

    transient = False
    replica_fatal = True
    kind = "network"


class RemoteRefusedError(RemoteNetworkError):
    """TCP connect refused — nothing is listening (host down, process
    dead, or a ``net_refuse`` chaos fire)."""

    kind = "refused"


class RemoteResetError(RemoteNetworkError):
    """Connection reset / broken pipe mid-request."""

    kind = "reset"


class RemoteTimeoutError(RemoteNetworkError):
    """Per-request deadline exceeded (or a ``net_partition`` chaos
    fire — a partition and a very slow host are the same observable).
    Marked transient: a deadline flake is worth one same-path retry."""

    transient = True
    kind = "timeout"


class RemoteDisconnectedError(RemoteNetworkError):
    """The server closed the connection mid-response: the request may
    or may not have executed remotely.  Safe to fail over — flow
    inference is idempotent."""

    kind = "disconnect"


class RemoteUnavailableError(RemoteNetworkError):
    """HTTP 503 from the remote — its own health gate is draining it
    (stalled engine, shed load).  Carries ``http_status`` so
    classification survives message rewording."""

    kind = "unavailable"
    http_status = 503


class RemoteProtocolError(RuntimeError):
    """The remote answered, but not in the protocol (unexpected status,
    unparseable body).  NOT a failover signal: a server speaking the
    wrong protocol will speak it to every retry too."""


def classify_network_error(exc: BaseException,
                           address: str = "?") -> RemoteNetworkError:
    """Map a stdlib transport exception onto the taxonomy.  Order
    matters: ``http.client.RemoteDisconnected`` subclasses
    ``ConnectionResetError``, and ``socket.timeout`` IS
    ``TimeoutError`` on modern Pythons."""
    if isinstance(exc, RemoteNetworkError):
        return exc
    msg = f"{type(exc).__name__}: {exc}"
    if isinstance(exc, http.client.RemoteDisconnected):
        return RemoteDisconnectedError(
            f"remote {address} disconnected mid-response ({msg})")
    if isinstance(exc, ConnectionRefusedError):
        return RemoteRefusedError(
            f"remote {address} refused the connection ({msg})")
    if isinstance(exc, (ConnectionResetError, BrokenPipeError,
                        ConnectionAbortedError)):
        return RemoteResetError(
            f"connection to remote {address} reset ({msg})")
    if isinstance(exc, (TimeoutError, socket.timeout)):
        return RemoteTimeoutError(
            f"request to remote {address} timed out ({msg})")
    return RemoteNetworkError(
        f"network error talking to remote {address} ({msg})")


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RemoteConfig:
    """Wire knobs for one :class:`RemoteEngine`."""

    #: TCP connect deadline for a fresh pooled connection.
    connect_timeout_s: float = 2.0
    #: Per-request deadline (``/v1/flow``, ``/v1/stream``).
    request_timeout_s: float = 120.0
    #: Deadline for ``GET /v1/healthz`` probes — tight, so a partition
    #: flips the health gate fast.
    health_timeout_s: float = 1.0
    #: Health snapshots are cached this long: router eligibility checks
    #: per request must not each cost a network round trip.
    health_cache_s: float = 0.2
    #: Keep-alive connections retained for reuse.
    pool_size: int = 8
    #: Client threads running requests (bounds in-flight concurrency).
    workers: int = 8
    #: Client-side in-flight bound; ``None`` learns the remote's own
    #: ``max_queue`` from ``/v1/stats`` (router spill math reads it via
    #: ``queue_capacity()``).
    max_queue: Optional[int] = None
    #: Added latency per ``net_slow`` chaos fire.
    chaos_slow_s: float = 0.05

    def __post_init__(self):
        for f in ("connect_timeout_s", "request_timeout_s",
                  "health_timeout_s"):
            if getattr(self, f) <= 0:
                raise ValueError(f"{f} must be > 0")
        if self.pool_size < 1 or self.workers < 1:
            raise ValueError("pool_size and workers must be >= 1")
        if self.max_queue is not None and self.max_queue < 1:
            raise ValueError("max_queue must be >= 1 (or None)")


# ---------------------------------------------------------------------------
# the engine facade over the wire
# ---------------------------------------------------------------------------


class RemoteEngine:
    """``InferenceEngine``-shaped client of one remote serving host.

    The facade contract (what ``FlowRouter`` / ``ReplicaFleet`` call):
    ``submit`` returns a Future, raises :class:`QueueFullError` at the
    client-side bound and lifecycle ``RuntimeError`` after ``stop()``;
    ``health()``/``stats()``/``metrics_text()`` mirror the engine
    introspection surface; ``stream_open``/``stream_ingest``/
    ``stream_close`` speak the streaming-session protocol."""

    def __init__(self, address: str,
                 cfg: RemoteConfig = RemoteConfig(), *,
                 name: str = "remote",
                 registry: Optional[MetricRegistry] = None,
                 sink: Optional[EventSink] = None):
        host, sep, port = address.rpartition(":")
        if not sep or not host or not port.isdigit():
            raise ValueError(
                f"remote replica spec {address!r}: expected HOST:PORT")
        self.address = address
        self.name = name
        self.cfg = cfg
        self._host, self._port = host, int(port)
        self.registry = registry or MetricRegistry()
        self._sink = sink if sink is not None else EventSink.from_env()
        self._net_errors = self.registry.counter(
            "raft_remote_net_errors_total",
            "request-path network failures talking to this remote "
            "replica, by taxonomy kind")
        self._pool = ThreadPoolExecutor(
            max_workers=cfg.workers,
            thread_name_prefix=f"raft-remote-{name}")
        self._conns: List[http.client.HTTPConnection] = []
        self._conn_lock = threading.Lock()
        self._pending = 0
        self._pending_lock = threading.Lock()
        self._stopped = False
        self._health_cache: Optional[dict] = None
        self._health_t = 0.0
        self._health_lock = threading.Lock()
        self._learned_max_queue: Optional[int] = None
        self.crashed: Optional[str] = None  # facade parity; never set

    # -- lifecycle ------------------------------------------------------

    def start(self) -> "RemoteEngine":
        """Facade parity no-op: the remote host owns its own engine
        lifecycle (and its own warmup/AOT artifacts)."""
        return self

    def stop(self, drain: bool = True, timeout: float = 30.0) -> None:
        self._stopped = True
        self._pool.shutdown(wait=drain)
        with self._conn_lock:
            conns, self._conns = self._conns, []
        for c in conns:
            try:
                c.close()
            except Exception:
                pass

    def warmup(self, image_shapes, batch_sizes=None) -> list:
        return []  # the remote host warmed itself at ITS bring-up

    def compiled_keys(self) -> list:
        return []

    def quality_drift(self) -> Optional[dict]:
        return None

    # -- wire plumbing --------------------------------------------------

    def _get_conn(self) -> http.client.HTTPConnection:
        with self._conn_lock:
            if self._conns:
                return self._conns.pop()
        return http.client.HTTPConnection(
            self._host, self._port, timeout=self.cfg.connect_timeout_s)

    def _put_conn(self, conn: http.client.HTTPConnection) -> None:
        with self._conn_lock:
            if not self._stopped and len(self._conns) < self.cfg.pool_size:
                self._conns.append(conn)
                return
        try:
            conn.close()
        except Exception:
            pass

    @staticmethod
    def _discard(conn: http.client.HTTPConnection) -> None:
        # A connection that saw ANY network error is never reused: its
        # stream state is unknowable (half-read response, dead socket).
        try:
            conn.close()
        except Exception:
            pass

    def _chaos_pre(self) -> None:
        """Pre-dispatch chaos checks for the ``serve.remote`` seam.
        ``net_partition`` and ``net_refuse`` raise before any socket
        work — deterministic regardless of network timing."""
        if not chaos.enabled():
            return
        if chaos.should_inject("net_refuse", point=CHAOS_POINT):
            raise RemoteRefusedError(
                f"remote {self.address} refused the connection "
                "(chaos net_refuse)")
        if chaos.should_inject("net_partition", point=CHAOS_POINT):
            raise RemoteTimeoutError(
                f"request to remote {self.address} timed out "
                "(chaos net_partition)")
        if chaos.should_inject("net_slow", point=CHAOS_POINT):
            time.sleep(self.cfg.chaos_slow_s)

    def _request(self, method: str, path: str, body: bytes = b"",
                 headers: Tuple[Tuple[str, str], ...] = (),
                 timeout: Optional[float] = None,
                 record: bool = True,
                 raise_503: bool = True):
        """One wire round trip -> ``(status, body_bytes)``.  Network
        failures (and chaos fires at this seam) raise classified
        :class:`RemoteNetworkError`\\ s; with ``record`` the failure is
        counted + emitted as a ``net_retry`` event.  ``raise_503=False``
        returns 503 responses instead (health probes read the body)."""
        timeout = timeout if timeout is not None \
            else self.cfg.request_timeout_s
        try:
            self._chaos_pre()
            # net_drop fires mid-response: the request goes out and the
            # server executes it, but the response never arrives.
            drop = chaos.enabled() and chaos.should_inject(
                "net_drop", point=CHAOS_POINT)
            conn = self._get_conn()
            try:
                conn.timeout = timeout
                if conn.sock is not None:
                    conn.sock.settimeout(timeout)
                conn.request(method, path, body=body,
                             headers=dict(headers))
                if drop:
                    raise RemoteDisconnectedError(
                        f"remote {self.address} disconnected "
                        "mid-response (chaos net_drop)")
                resp = conn.getresponse()
                status, data = resp.status, resp.read()
            except (OSError, http.client.HTTPException,
                    RemoteNetworkError) as e:
                self._discard(conn)
                raise classify_network_error(e, self.address) from \
                    (None if isinstance(e, RemoteNetworkError) else e)
            self._put_conn(conn)
        except RemoteNetworkError as err:
            self._note_net_error(err, path, record)
            raise
        if status == 503 and raise_503:
            err = RemoteUnavailableError(
                f"remote {self.address} unavailable (HTTP 503): "
                f"{data[:200]!r}")
            self._note_net_error(err, path, record)
            raise err
        return status, data

    def _note_net_error(self, err: RemoteNetworkError, path: str,
                        record: bool) -> None:
        if not record:
            return
        self._net_errors.inc(kind=err.kind)
        self._sink.emit("net_retry", replica=self.name,
                        address=self.address, kind=err.kind, path=path,
                        error=str(err)[:200])

    # -- request path ---------------------------------------------------

    def pending_count(self) -> int:
        with self._pending_lock:
            return self._pending

    def queue_capacity(self) -> Optional[int]:
        """Queue depth bound the router's spill math should use for
        this replica: the configured client-side bound, else the
        remote's own ``max_queue`` learned (once) from ``/v1/stats``."""
        if self.cfg.max_queue is not None:
            return self.cfg.max_queue
        if self._learned_max_queue is None:
            try:
                status, data = self._request(
                    "GET", "/v1/stats",
                    timeout=self.cfg.health_timeout_s, record=False)
                if status == 200:
                    mq = json.loads(data).get("max_queue")
                    if isinstance(mq, (int, float)) and mq > 0:
                        self._learned_max_queue = int(mq)
            except (RemoteNetworkError, ValueError):
                return None
        return self._learned_max_queue

    def submit(self, image1, image2) -> Future:
        """Dispatch one frame pair to the remote; returns a Future
        resolving to the ``(H, W, 2)`` flow.  Shape validation and the
        lifecycle/queue-full contract mirror the in-process engine so
        the router cannot tell the difference."""
        if self._stopped:
            raise RuntimeError(
                "engine stopped — engines are single-use; build a new "
                f"RemoteEngine for {self.address}")
        im1 = np.asarray(image1, dtype=np.float32)
        im2 = np.asarray(image2, dtype=np.float32)
        if im1.ndim != 3 or im1.shape[-1] != 3 or im1.shape != im2.shape:
            raise ValueError(
                f"expected two matching (H, W, 3) images, got "
                f"{im1.shape} and {im2.shape}")
        with self._pending_lock:
            if (self.cfg.max_queue is not None
                    and self._pending >= self.cfg.max_queue):
                raise QueueFullError(
                    f"remote {self.address}: {self._pending} requests "
                    "already in flight client-side",
                    queue_depth=self._pending, retry_after_s=1.0)
            self._pending += 1
        fut = self._pool.submit(self._do_flow, im1, im2)

        def _dec(_f):
            with self._pending_lock:
                self._pending -= 1

        fut.add_done_callback(_dec)
        return fut

    def infer(self, image1, image2,
              timeout: Optional[float] = None) -> np.ndarray:
        return self.submit(image1, image2).result(timeout=timeout)

    def _do_flow(self, im1, im2) -> np.ndarray:
        buf = io.BytesIO()
        np.savez(buf, image1=im1, image2=im2)
        headers = [("Content-Type", "application/octet-stream")]
        status, data = self._request("POST", "/v1/flow",
                                     body=buf.getvalue(),
                                     headers=tuple(headers))
        if status == 200:
            with np.load(io.BytesIO(data)) as z:
                return np.asarray(z["flow"])
        self._raise_structured(status, data)

    def _raise_structured(self, status: int, data: bytes):
        """Map the wire protocol's structured error responses back onto
        the exceptions the in-process engine raises, so callers (and
        the router's failover policy) see identical behavior."""
        try:
            obj = json.loads(data)
        except ValueError:
            obj = {}
        if status == 429:
            raise QueueFullError(
                obj.get("error", f"remote {self.address} queue full"),
                queue_depth=int(obj.get("queue_depth", 0)),
                retry_after_s=float(obj.get("retry_after_s", 1.0)))
        if status in (400, 404, 409):
            raise ValueError(
                obj.get("error", f"remote {self.address} rejected the "
                                 f"request (HTTP {status})"))
        raise RemoteProtocolError(
            f"remote {self.address} returned HTTP {status}: "
            f"{obj.get('error', data[:200])}")

    # -- streaming sessions --------------------------------------------

    def _stream_post(self, session_id: str, image, query: str = "",
                     timeout: Optional[float] = None) -> dict:
        im = np.asarray(image, dtype=np.float32)
        buf = io.BytesIO()
        np.savez(buf, image=im)
        headers = [("Content-Type", "application/octet-stream")]
        status, data = self._request(
            "POST", f"/v1/stream/{session_id}{query}",
            body=buf.getvalue(), headers=tuple(headers),
            timeout=timeout)
        if status != 200:
            self._raise_structured(status, data)
        with np.load(io.BytesIO(data)) as z:
            return {"session": str(session_id),
                    "frame": int(z["frame"]),
                    "warm": bool(z["warm"]) if "warm" in z else False,
                    "flow": (np.asarray(z["flow"])
                             if "flow" in z.files else None)}

    def stream_open(self, session_id: str, image, *,
                    iters: Optional[int] = None,
                    ttl_s: Optional[float] = None) -> dict:
        parts = []
        if iters is not None:
            parts.append(f"iters={int(iters)}")
        if ttl_s is not None:
            parts.append(f"ttl_s={float(ttl_s):g}")
        query = ("?" + "&".join(parts)) if parts else ""
        return self._stream_post(session_id, image, query)

    def stream_ingest(self, session_id: str, image, *,
                      iters: Optional[int] = None,
                      ttl_s: Optional[float] = None,
                      timeout: Optional[float] = None) -> dict:
        # iters/ttl_s only apply at open on the wire protocol; the
        # router always opens via stream_open first.
        return self._stream_post(session_id, image, timeout=timeout)

    def stream_close(self, session_id: str) -> dict:
        status, data = self._request("DELETE",
                                     f"/v1/stream/{session_id}")
        if status != 200:
            self._raise_structured(status, data)
        return json.loads(data)

    # -- introspection --------------------------------------------------

    def health(self) -> dict:
        """Engine-shaped readiness snapshot, cached ``health_cache_s``
        (router eligibility checks are per request).  A wire failure
        reads as not-ready with the taxonomy kind attached — the health
        gate sidelines a partitioned host exactly like a crashed one."""
        now = time.monotonic()
        with self._health_lock:
            if (self._health_cache is not None
                    and now - self._health_t < self.cfg.health_cache_s):
                return dict(self._health_cache,
                            pending=self.pending_count())
        try:
            status, data = self._request(
                "GET", "/v1/healthz",
                timeout=self.cfg.health_timeout_s, record=False,
                raise_503=False)
        except RemoteNetworkError as e:
            h = {"ready": False, "accepting": False, "stalled": False,
                 "crashed": None, "seconds_since_last_batch": None,
                 "stall_timeout_s": 0.0, "remote": self.address,
                 "net_error": e.kind}
        else:
            if status == 200:
                h = {"ready": True, "accepting": True, "stalled": False,
                     "crashed": None, "seconds_since_last_batch": None,
                     "stall_timeout_s": 0.0, "remote": self.address}
            else:  # 503: the remote's own health gate said drain
                try:
                    detail = json.loads(data)
                except ValueError:
                    detail = {}
                h = dict(detail, ready=False, remote=self.address)
                h.setdefault("accepting", False)
                h.setdefault("stalled", False)
                h.setdefault("crashed", None)
        with self._health_lock:
            self._health_cache = h
            self._health_t = time.monotonic()
        return dict(h, pending=self.pending_count())

    def load_signals(self) -> dict:
        """Autoscaler inputs, client-side only (never a network call —
        the autoscaler ticks on the supervisor thread)."""
        pending = self.pending_count()
        cap = self.cfg.max_queue or self._learned_max_queue or 0
        return {"pending": pending, "max_queue": cap,
                "queue_frac": round(pending / cap, 4) if cap else 0.0,
                "occupancy": 0.0, "burn_rate": 0.0, "mfu": None,
                "latency_p95_ms": 0.0}

    def stats(self) -> dict:
        """The remote's ``/v1/stats`` snapshot overlaid with the
        client-side view (in-flight count, net-error taxonomy counts);
        degrades to the client-side view alone during a partition."""
        client = {
            "remote": self.address,
            "pending_client": self.pending_count(),
            "net_errors": {dict(k).get("kind", ""): v
                           for k, v in self._net_errors.items()},
        }
        try:
            status, data = self._request(
                "GET", "/v1/stats",
                timeout=self.cfg.health_timeout_s, record=False)
            remote = json.loads(data) if status == 200 else {}
        except (RemoteNetworkError, ValueError):
            remote = {"unreachable": True}
        return dict(remote, **client)

    def metrics_text(self) -> str:
        """The CLIENT-side registry only (net-error counters): the
        remote host's own ``/metrics`` is scraped at the remote host —
        proxying it here would double-count every sample."""
        return render_metrics(self.registry)


# ---------------------------------------------------------------------------
# the fleet-facing replica wrapper
# ---------------------------------------------------------------------------

# Imported here (not at module top) in spirit only — fleet.py imports
# THIS module lazily at its point of use, so this top-level import is
# the acyclic direction: remote -> fleet -> engine.
from raft_tpu_torch.serve.fleet import Replica  # noqa: E402


class RemoteReplica(Replica):
    """Fleet member backed by a :class:`RemoteEngine` — same state
    machine, breaker, and generation counter as a local
    :class:`~raft_tpu_torch.serve.fleet.Replica`, so the router needs no
    remote special case.

    Differences from a local replica, all supervisor-side:

    - ``is_remote`` gates the fleet paths that cannot apply across the
      wire: no engine rebuild on crash (the remote host supervises its
      OWN engine), no rolling weight flip (the remote host rolls its
      own weights), no AOT export.
    - :meth:`poll` replaces the crash/stall restart logic: it watches
      the health transition.  While the remote is unreachable the
      breaker + health gate sideline it (exactly like a crashed local
      replica); when it answers again the replica REJOINS — generation
      bumps and the breaker resets under the lock, so strikes earned
      against the partitioned generation cannot sideline the healed
      one (``fleet_remote_rejoin`` event)."""

    is_remote = True

    def __init__(self, index: int, address: str,
                 cfg: RemoteConfig = RemoteConfig()):
        super().__init__(index)
        self.address = address
        self.remote_cfg = cfg
        self._down_seen = False

    def start(self, sink: Optional[EventSink] = None) -> RemoteEngine:
        """Build + adopt the wire client (no device work, no warmup —
        the remote host warmed itself at its own bring-up)."""
        eng = RemoteEngine(self.address, self.remote_cfg,
                           name=self.name, sink=sink)
        self.adopt(eng)
        self.set_state("ready")
        return eng

    def pending(self) -> int:
        """Client-side in-flight count — the local replica's version of
        this costs a lock; a network round trip per placement decision
        would not fly."""
        eng = self.engine
        return 0 if eng is None else eng.pending_count()

    def poll(self, sink: Optional[EventSink] = None) -> None:
        """Supervisor hook (called at the fleet's health-poll cadence):
        track down -> up transitions and rejoin on heal."""
        eng = self.engine
        if eng is None:
            return
        ready = bool(eng.health().get("ready"))
        if not ready:
            self._down_seen = True
            return
        if not self._down_seen:
            return
        self._down_seen = False
        with self._lock:
            # Generation-guarded breaker reset: the router tags strikes
            # with the generation it struck, and a bumped generation
            # means those strikes belonged to the partition, not to the
            # healed host.
            self.generation += 1
            self._consec_failures = 0
            self._broken_until = 0.0
            gen = self.generation
        if sink is not None:
            sink.emit("fleet_remote_rejoin", replica=self.name,
                      address=self.address, generation=gen)
