"""Lightweight distributed tracing over the telemetry event stream (the
port's copy of ``raft_tpu/obs/trace.py``).

One serve request traverses router placement, hedging, failover,
replica engines, batch coalescing, and device retries; one train step
traverses the prefetch producer, the host, the device dispatch, and a
background checkpoint committer.  Flat per-component events cannot
answer "where did THIS request's 600 ms go" — a trace can.  This
module reconstructs causality with three ids carried on every span
record:

- ``trace_id``  — one per request / train step (the tree),
- ``span_id``   — one per timed operation (the node),
- ``parent_id`` — the edge (``None`` marks the root).

Spans are buffered per trace and emitted as ``trace_span`` events into
the ordinary :class:`~raft_tpu_torch.obs.events.EventSink` JSONL stream when
the root span ends — *if* the trace was head-sampled at
``sample_rate``, or if anything interesting happened along the way
(**tail-based keep**: an error status, a device retry, a hedge, a
failover, or an explicit :meth:`Span.mark_keep` force the whole tree
out regardless of the sampling coin).  Traces that were neither
sampled nor kept are parked in a small ring so a *later* verdict (the
non-finite step guard flags step N at the next logger flush) can still
recover them via :meth:`Tracer.emit_recent_dropped`.

Context crosses threads two ways: implicitly through a thread-local
stack (:func:`trace_span` / :func:`use_context`) and explicitly by
carrying the :class:`Span` object on the unit of work (serve requests
carry it from the submitting thread to the device worker; checkpoint
snapshots carry it to the committer thread).  Context crosses the wire
through the ``X-Raft-Trace: <trace_id>-<span_id>-<s|d>`` header
(:func:`format_header` / :func:`parse_header`).

Hot-path contract: ``sample_rate=0`` turns the layer OFF —
:meth:`Tracer.start_trace` and :func:`trace_span` return one shared
no-op singleton (no allocation, no clock read, no lock), pinned by
``tests/test_torch_trace.py``.
"""

from __future__ import annotations

import os
import random
import threading
import time
import uuid
from collections import deque
from typing import Optional, Tuple

from raft_tpu_torch.obs.events import EventSink, default_sink

#: Event kind under which every span record is emitted.
EVENT = "trace_span"
#: Wire-propagation header: ``<trace_id>-<span_id>-<s|d>``.
HEADER = "X-Raft-Trace"


def _new_id() -> str:
    return uuid.uuid4().hex[:16]


# ---------------------------------------------------------------------------
# no-op singleton (the sample_rate=0 hot path)
# ---------------------------------------------------------------------------


class _NoopSpan:
    """Shared stand-in when tracing is off or there is no current
    context: every method is a no-op, ``bool()`` is False, and it is
    its own (reusable) context manager so the disabled path allocates
    nothing."""

    __slots__ = ()
    trace_id = None
    span_id = None
    sampled = False

    def __bool__(self):
        return False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def child(self, name, **attrs):
        return self

    def end(self, status="ok", **attrs):
        pass

    def annotate(self, **attrs):
        pass

    def mark_keep(self):
        pass


NOOP_SPAN = _NoopSpan()


# ---------------------------------------------------------------------------
# thread-local context
# ---------------------------------------------------------------------------

_tls = threading.local()


def _stack():
    s = getattr(_tls, "stack", None)
    if s is None:
        s = _tls.stack = []
    return s


def current() -> Optional["Span"]:
    """The innermost span on THIS thread, or ``None``."""
    s = getattr(_tls, "stack", None)
    return s[-1] if s else None


class _ContextGuard:
    """``with use_context(span):`` — make ``span`` the current context
    on this thread without ending it on exit.  This is how a span
    created on one thread becomes the parent of spans recorded on
    another (router attempt → engine submit, HTTP handler → router)."""

    __slots__ = ("_span",)

    def __init__(self, span):
        self._span = span

    def __enter__(self):
        sp = self._span
        if sp is not None and sp:
            _stack().append(sp)
        return sp

    def __exit__(self, *exc):
        sp = self._span
        if sp is not None and sp:
            stack = _stack()
            if stack and stack[-1] is sp:
                stack.pop()
            elif sp in stack:  # unbalanced nesting — still recover
                stack.remove(sp)
        return False


def use_context(span) -> _ContextGuard:
    """Context manager installing ``span`` as this thread's current
    trace context (no-op for ``None`` / the no-op singleton)."""
    return _ContextGuard(span)


def trace_span(name: str, **attrs):
    """Open a child span under the current context, usable as a
    context manager::

        with trace_span("pad", bucket=str(bucket)):
            ...

    With no current context (tracing off, or an untraced request) this
    returns the shared no-op singleton — nothing is allocated.
    """
    parent = current()
    if parent is None or not parent:
        return NOOP_SPAN
    return parent.child(name, **attrs)


# ---------------------------------------------------------------------------
# trace state + spans
# ---------------------------------------------------------------------------


class _TraceState:
    """Shared per-trace bookkeeping: the sampling verdict, the keep
    flag, and the buffered span records awaiting the flush decision.
    ``emitted_n`` tracks how many buffered records already went out so
    late spans (a checkpoint commit finishing after its step's root
    span closed) flush incrementally without duplicates."""

    __slots__ = ("tracer", "trace_id", "sampled", "keep", "records",
                 "lock", "flushed", "emitted_n", "root_attrs")

    def __init__(self, tracer, trace_id, sampled, keep, root_attrs):
        self.tracer = tracer
        self.trace_id = trace_id
        self.sampled = sampled
        self.keep = keep
        self.records = []
        self.lock = threading.Lock()
        self.flushed = False
        self.emitted_n = 0
        self.root_attrs = root_attrs

    def _flush_locked(self) -> None:
        """Emit any unemitted records if the trace earned it.  Caller
        holds ``self.lock``."""
        if not self.flushed or not (self.sampled or self.keep):
            return
        pending = self.records[self.emitted_n:]
        self.emitted_n = len(self.records)
        if pending:
            self.tracer._emit_records(pending)


class Span:
    """One timed node of a trace tree.  Thread-safe: ``end()`` may be
    called from a different thread than the one that opened it, and is
    idempotent.  Usable directly as a context manager (enter pushes it
    onto this thread's context stack; exit pops and ends it, marking
    status ``error`` — which tail-keeps the trace — if an exception is
    in flight)."""

    __slots__ = ("_state", "name", "span_id", "parent_id", "attrs",
                 "t_start_wall", "t_start_mono", "_ended", "_root")

    def __init__(self, state: _TraceState, name: str,
                 parent_id: Optional[str], attrs: dict,
                 root: bool = False):
        self._state = state
        self.name = name
        self.span_id = _new_id()
        self.parent_id = parent_id
        self.attrs = dict(attrs) if attrs else {}
        self.t_start_wall = time.time()
        self.t_start_mono = time.perf_counter()
        self._ended = False
        self._root = root

    # -- identity ------------------------------------------------------

    @property
    def trace_id(self) -> str:
        return self._state.trace_id

    @property
    def sampled(self) -> bool:
        return self._state.sampled

    def __bool__(self):
        return True

    # -- lifecycle -----------------------------------------------------

    def child(self, name: str, **attrs) -> "Span":
        return Span(self._state, name, self.span_id, attrs)

    def annotate(self, **attrs) -> None:
        """Attach attributes to a still-open span."""
        self.attrs.update(attrs)

    def mark_keep(self) -> None:
        """Tail-based keep: force this whole trace out at flush time
        regardless of the head-sampling coin (and immediately, if the
        root already closed)."""
        st = self._state
        with st.lock:
            st.keep = True
            st._flush_locked()

    def end(self, status: str = "ok", **attrs) -> None:
        """Close the span.  Status ``error`` tail-keeps the trace
        (other non-ok statuses — e.g. ``full`` — record without
        forcing the keep).
        Ending the root span is the trace's flush point: buffered
        records are emitted (sampled/kept) or parked in the tracer's
        recently-dropped ring."""
        st = self._state
        t_end = time.perf_counter()
        with st.lock:
            if self._ended:
                return
            self._ended = True
            if attrs:
                self.attrs.update(attrs)
            rec = _record(st.trace_id, self.span_id, self.parent_id,
                          self.name, self.t_start_wall,
                          self.t_start_mono, t_end, status, self.attrs)
            st.records.append(rec)
            if status == "error":
                st.keep = True
            if self._root:
                st.flushed = True
            st._flush_locked()
            parked = (self._root and st.emitted_n == 0)
        if parked:
            st.tracer._park_dropped(st)

    # -- context-manager sugar ----------------------------------------

    def __enter__(self):
        _stack().append(self)
        return self

    def __exit__(self, exc_type, exc, tb):
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:
            stack.remove(self)
        if exc_type is not None:
            self.end(status="error", error=f"{exc_type.__name__}")
        else:
            self.end()
        return False


def _record(trace_id, span_id, parent_id, name, t_start_wall,
            t_start_mono, t_end_mono, status, attrs) -> dict:
    rec = {
        "trace_id": trace_id,
        "span_id": span_id,
        "parent_id": parent_id,
        "name": name,
        "t_start": round(t_start_wall, 6),
        "t_start_mono": round(t_start_mono, 6),
        "dur_s": round(max(t_end_mono - t_start_mono, 0.0), 6),
        "status": status,
    }
    prof = _active_profile
    if prof is not None:
        rec["xprof"] = prof
    if attrs:
        for k, v in attrs.items():
            rec.setdefault(k, v)
    return rec


def record_span(parent, name: str, t_start_mono: float,
                t_end_mono: float, status: str = "ok",
                **attrs) -> None:
    """Record an already-measured interval as a child of ``parent``.

    This is the cross-thread escape hatch for work timed where no
    trace context exists yet: the prefetch *producer* stamps its
    prep/h2d windows with ``time.perf_counter()`` and the *consumer*
    attaches them to its step trace here; the serve device worker
    attaches per-request queue/pad/device windows the same way.  The
    wall-clock start is derived from the monotonic offset so Perfetto
    export stays consistent with live spans."""
    if parent is None or not parent:
        return
    st = parent._state
    wall = time.time() - (time.perf_counter() - t_start_mono)
    rec = _record(st.trace_id, _new_id(), parent.span_id, name, wall,
                  t_start_mono, t_end_mono, status, attrs)
    with st.lock:
        st.records.append(rec)
        if status == "error":
            st.keep = True
        st._flush_locked()


# ---------------------------------------------------------------------------
# tracer
# ---------------------------------------------------------------------------


class Tracer:
    """Issues trace roots, holds the sampling RNG (seeded → the
    sampled/dropped sequence is deterministic, pinned by test), and
    owns the recently-dropped ring for late tail-keep."""

    def __init__(self, sink: Optional[EventSink] = None,
                 sample_rate: float = 0.0, seed: int = 0,
                 keep_dropped: int = 128):
        if not 0.0 <= float(sample_rate) <= 1.0:
            raise ValueError("sample_rate must be in [0, 1]")
        self.sample_rate = float(sample_rate)
        self._sink = sink
        self._rand = random.Random(seed)
        self._rand_lock = threading.Lock()
        # Dropped-trace ring: every read/write goes through
        # self._dropped_lock.  The deque's own maxlen bound is not a
        # substitute for the lock: emit_recent_dropped snapshots under
        # the lock, then flushes each state under ITS state.lock (never
        # both at once, so no lock-order edge).
        self._dropped = deque(maxlen=max(int(keep_dropped), 1))
        self._dropped_lock = threading.Lock()

    @property
    def enabled(self) -> bool:
        return self.sample_rate > 0.0

    def _sink_now(self):
        return self._sink if self._sink is not None else default_sink()

    def _emit_records(self, records) -> None:
        sink = self._sink_now()
        for rec in records:
            try:
                sink.emit(EVENT, **rec)
            except Exception:  # telemetry must never fail the workload
                pass

    def _park_dropped(self, state: _TraceState) -> None:
        with self._dropped_lock:
            self._dropped.append(state)

    # -- roots ---------------------------------------------------------

    def start_trace(self, name: str, trace_id: Optional[str] = None,
                    parent_id: Optional[str] = None,
                    sampled: Optional[bool] = None,
                    keep: bool = False, **attrs):
        """Open a root span.  ``trace_id``/``parent_id``/``sampled``
        continue a trace arriving over the wire (:func:`parse_header`);
        locally-originated roots draw the sampling coin from the
        seeded RNG.  Returns the no-op singleton when the tracer is
        disabled and no upstream decision forces recording."""
        if not self.enabled and sampled is None:
            return NOOP_SPAN
        if sampled is None:
            with self._rand_lock:
                sampled = self._rand.random() < self.sample_rate
        st = _TraceState(self, trace_id or _new_id(), bool(sampled),
                         bool(keep), dict(attrs))
        return Span(st, name, parent_id, attrs, root=True)

    def begin(self, name: str, **attrs):
        """Child of the current context if one exists (the HTTP handler
        already opened the root), else a fresh root (in-process callers
        like the smoke drills hit the router directly)."""
        parent = current()
        if parent is not None and parent:
            return parent.child(name, **attrs)
        return self.start_trace(name, **attrs)

    # -- late tail-keep ------------------------------------------------

    def emit_recent_dropped(self, steps=None, pred=None) -> int:
        """Recover recently-dropped traces after a late verdict (the
        non-finite guard only learns step N was bad at the next logger
        flush).  ``steps``: emit traces whose root carried
        ``step=<n in steps>``; ``pred``: arbitrary predicate over the
        root attrs; neither: emit everything still in the ring.
        Returns the number of traces emitted."""
        if steps is not None:
            steps = set(int(s) for s in steps)
        with self._dropped_lock:
            states = list(self._dropped)
        n = 0
        for st in states:
            root = st.root_attrs
            if steps is not None and root.get("step") not in steps:
                continue
            if pred is not None and not pred(root):
                continue
            with st.lock:
                already = st.emitted_n
                st.keep = True
                st._flush_locked()
                if st.emitted_n > already:
                    n += 1
        return n


# ---------------------------------------------------------------------------
# wire propagation
# ---------------------------------------------------------------------------


def format_header(span) -> Optional[str]:
    """``X-Raft-Trace`` value for ``span``: ``<trace>-<span>-<s|d>``
    (``s`` = sampled upstream, ``d`` = recorded only on tail-keep)."""
    if span is None or not span:
        return None
    flag = "s" if span.sampled else "d"
    return f"{span.trace_id}-{span.span_id}-{flag}"


def parse_header(value) -> Optional[Tuple[str, str, bool]]:
    """Parse an ``X-Raft-Trace`` value into
    ``(trace_id, parent_span_id, sampled)``; ``None`` on anything
    malformed (a bad header must never fail a request)."""
    if not value:
        return None
    parts = str(value).strip().split("-")
    if len(parts) != 3:
        return None
    trace_id, span_id, flag = parts
    if flag not in ("s", "d") or not trace_id or not span_id:
        return None
    try:
        int(trace_id, 16), int(span_id, 16)
    except ValueError:
        return None
    return trace_id, span_id, flag == "s"


# ---------------------------------------------------------------------------
# profiler linkage
# ---------------------------------------------------------------------------

_active_profile: Optional[str] = None


def set_active_profile(directory: Optional[str]) -> None:
    """While a ``torch.profiler`` window is running
    (``utils/profiling.StepProfiler``), stamp its artifact directory onto
    every span recorded, under the key ``xprof`` that the JAX package's
    readers know — the trace waterfall links straight to the device
    profile that covers it."""
    global _active_profile
    _active_profile = directory


def active_profile() -> Optional[str]:
    return _active_profile


# ---------------------------------------------------------------------------
# process-default tracer
# ---------------------------------------------------------------------------

# Double-checked singleton: the unlocked fast-path read is safe because
# CPython guarantees atomic reference loads and a Tracer is fully
# constructed before being published; all WRITES go through
# _default_lock (same discipline as obs/events.py's default sink).
_default: Optional[Tracer] = None
_default_lock = threading.Lock()


def default_tracer() -> Tracer:
    """The process-wide tracer.  Lazily built from
    ``RAFT_TRACE_SAMPLE_RATE`` / ``RAFT_TRACE_SEED`` (disabled when
    unset), emitting into the default event sink."""
    global _default
    if _default is None:
        with _default_lock:
            if _default is None:
                rate = float(os.environ.get("RAFT_TRACE_SAMPLE_RATE",
                                            "0") or 0)
                seed = int(os.environ.get("RAFT_TRACE_SEED", "0") or 0)
                _default = Tracer(sample_rate=rate, seed=seed)
    return _default


def configure(sample_rate: Optional[float] = None,
              seed: Optional[int] = None,
              sink: Optional[EventSink] = None,
              keep_dropped: Optional[int] = None) -> Tracer:
    """Replace the process-default tracer (CLIs call this once at
    startup; omitted arguments fall back to env/previous values)."""
    global _default
    with _default_lock:
        prev = _default
        if sample_rate is None:
            sample_rate = (prev.sample_rate if prev is not None else
                           float(os.environ.get(
                               "RAFT_TRACE_SAMPLE_RATE", "0") or 0))
        if seed is None:
            seed = int(os.environ.get("RAFT_TRACE_SEED", "0") or 0)
        if sink is None and prev is not None:
            sink = prev._sink
        kw = {}
        if keep_dropped is not None:
            kw["keep_dropped"] = keep_dropped
        _default = Tracer(sink=sink, sample_rate=sample_rate,
                          seed=seed, **kw)
        return _default


def reset_default_tracer() -> None:
    """Drop the process-default tracer (tests)."""
    global _default
    with _default_lock:
        _default = None
