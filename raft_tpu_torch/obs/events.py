"""Structured JSONL event log (the telemetry stream spans fold into; the
port's copy of ``raft_tpu/obs/events.py``).

One record per event, one line per record, append-only::

    {"event": "train_step", "t_wall": 1722777600.123,
     "t_mono": 123.456, "process": 0, "step": 42,
     "step_time_s": 0.51, "queue_wait_s": 0.002, ...}

- ``t_wall`` is ``time.time()`` (correlate across hosts / with XProf
  traces); ``t_mono`` is ``time.perf_counter()`` (durations within one
  process — wall clocks step, monotonic ones don't).
- ``process`` is the ``torch.distributed`` rank (0 when no process
  group is initialized), and each process writes its own
  ``telemetry-p<index>.jsonl`` so pod runs never interleave writers.
- Disabled (no directory, and ``RAFT_TELEMETRY_DIR`` unset) the sink is
  a no-op: ``emit`` returns before building the record.

The file is opened line-buffered, so every record is one ``write``
syscall and a crashed run keeps everything up to its last event —
microseconds per event, never a device sync.

Size-capped rotation (``RAFT_TELEMETRY_MAX_MB``, default off): a long
serve run must not grow its JSONL files unbounded.  With a cap, the
live file rotates at a quarter of the budget to ``telemetry-p<i>-r<seq>.jsonl`` and the three newest
rotated segments are kept (older ones deleted), bounding total disk at
~the cap.  ``-`` sorts before ``.``, so a sorted ``*.jsonl`` glob still
yields segments in chronological order.

Observers (:meth:`EventSink.add_observer`) see every record emitted.
They are invoked AFTER the write lock is released, so an observer may
itself emit through the same sink without deadlocking.
"""

from __future__ import annotations

import glob
import json
import os
import threading
import time
from typing import Callable, Optional

# Rotation granularity: the live segment caps at budget/4 and the 3
# newest rotated segments are kept, so live + rotated stay ~under the
# configured total budget.
_ROTATE_SEGMENTS = 4


def _process_index() -> int:
    try:
        import torch.distributed as dist

        return dist.get_rank() if dist.is_initialized() else 0
    except Exception:
        return 0


class EventSink:
    """Append-only JSONL writer; thread-safe; no-op when ``directory``
    is None."""

    def __init__(self, directory: Optional[str] = None, *,
                 filename: Optional[str] = None,
                 max_bytes: Optional[int] = None):
        self._dir = directory or None
        self._filename = filename
        self._lock = threading.Lock()
        self._fh = None
        self._process: Optional[int] = None
        self.path: Optional[str] = None
        if max_bytes is None:
            mb = os.environ.get("RAFT_TELEMETRY_MAX_MB")
            if mb:
                try:
                    max_bytes = int(float(mb) * 1024 * 1024)
                except ValueError:
                    max_bytes = None
        self._max_bytes = max_bytes if max_bytes and max_bytes > 0 \
            else None
        self._bytes = 0
        self._rot_seq = 0
        self._observers: tuple = ()

    @classmethod
    def from_env(cls) -> "EventSink":
        return cls(os.environ.get("RAFT_TELEMETRY_DIR") or None)

    def add_observer(self, fn: Callable[[dict], None]) -> None:
        """Register ``fn(record)`` to see every emitted record.  Called
        OUTSIDE the write lock (an observer may emit through this same
        sink); observer errors are swallowed — telemetry consumers must
        never take down the producer."""
        with self._lock:
            self._observers = self._observers + (fn,)

    @property
    def enabled(self) -> bool:
        return self._dir is not None

    @property
    def directory(self) -> Optional[str]:
        """The sink's directory (None when disabled) — sibling artifacts
        (forensic bundles, stack dumps) land next to the JSONL."""
        return self._dir

    def _ensure_open_locked(self):
        # Caller holds self._lock (the *_locked suffix is the repo's
        # lock-discipline convention).
        if self._fh is None:
            os.makedirs(self._dir, exist_ok=True)
            self._process = _process_index()
            name = self._filename or f"telemetry-p{self._process}.jsonl"
            self.path = os.path.join(self._dir, name)
            self._fh = open(self.path, "a", buffering=1)
            try:
                self._bytes = os.path.getsize(self.path)
            except OSError:
                self._bytes = 0
            if self._max_bytes is not None and self._rot_seq == 0:
                # Continue segment numbering across reopens/restarts.
                existing = sorted(glob.glob(
                    self._rotated_glob_locked()))
                if existing:
                    tail = existing[-1].rsplit("-r", 1)[-1]
                    try:
                        self._rot_seq = int(tail.split(".")[0]) + 1
                    except ValueError:
                        self._rot_seq = len(existing)
        return self._fh

    def _rotated_glob_locked(self) -> str:
        base = self.path[:-len(".jsonl")] if self.path else ""
        return base + "-r*.jsonl"

    def _maybe_rotate_locked(self) -> None:
        """Rotate the live segment once it exceeds its share of the
        budget; keep the newest rotated segments, delete the rest.
        Rotated names (``-r<seq>``) sort BEFORE the live file (``-`` <
        ``.``), so sorted-glob readers still see chronological order."""
        if self._max_bytes is None or self.path is None:
            return
        seg_bytes = max(self._max_bytes // _ROTATE_SEGMENTS, 4096)
        if self._bytes < seg_bytes:
            return
        self._fh.close()
        self._fh = None
        base = self.path[:-len(".jsonl")]
        dest = f"{base}-r{self._rot_seq:06d}.jsonl"
        self._rot_seq += 1
        try:
            os.replace(self.path, dest)
        except OSError:
            pass
        for old in sorted(glob.glob(
                self._rotated_glob_locked()))[:-(_ROTATE_SEGMENTS - 1)]:
            try:
                os.remove(old)
            except OSError:
                pass
        self._fh = open(self.path, "a", buffering=1)
        self._bytes = 0

    def emit(self, event: str, step: Optional[int] = None,
             **fields) -> None:
        """Write one event record.  ``fields`` must be JSON-able (or
        str()-able — ``default=str`` keeps a stray numpy scalar from
        killing the run that merely wanted telemetry)."""
        if self._dir is None:
            return
        with self._lock:
            fh = self._ensure_open_locked()
            rec = {"event": event, "t_wall": time.time(),
                   "t_mono": time.perf_counter(),
                   "process": self._process}
            if step is not None:
                rec["step"] = int(step)
            rec.update(fields)
            line = json.dumps(rec, default=str) + "\n"
            fh.write(line)
            self._bytes += len(line)
            self._maybe_rotate_locked()
            observers = self._observers
        for fn in observers:
            try:
                fn(rec)
            except Exception:
                pass

    def flush(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.flush()

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None


_default_sink: Optional[EventSink] = None
_default_lock = threading.Lock()


def default_sink() -> EventSink:
    """Process-wide sink bound to ``RAFT_TELEMETRY_DIR`` at first use
    (no-op when unset).  CLIs that take ``--telemetry-dir`` export the
    env var before anything touches telemetry, so this picks it up."""
    global _default_sink
    if _default_sink is None:
        with _default_lock:
            if _default_sink is None:
                _default_sink = EventSink.from_env()
    return _default_sink


def reset_default_sink() -> None:
    """Close and forget the default sink (tests; env changes)."""
    global _default_sink
    with _default_lock:
        if _default_sink is not None:
            _default_sink.close()
        _default_sink = None
