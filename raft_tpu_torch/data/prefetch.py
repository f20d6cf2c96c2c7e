"""Device prefetch: the overlapped training input pipeline (the port's copy
of ``raft_tpu/data/prefetch.py``).

:class:`DevicePipeline` moves host prep (the image noise) and the copy to
the device onto one background producer thread feeding a bounded buffer,
so while the card runs step N the producer prepares and copies batches
N+1..N+depth.  Exactly one producer pulls the host iterator and applies
``prep_fn`` in stream order, as the serial path does, so a stateful prep
(the noise generator keyed on the resume step) sees the same calls whether
the pipeline is buffered (``depth > 0``) or serial (``depth == 0``: prep
and put inline in ``next()``, no thread).  A semaphore of ``depth`` slots
is taken before the producer touches the source, so the pipeline never
holds more than ``depth`` batches beyond the one the consumer steps on.

On the card, :class:`CudaBatchPut` copies each batch into one of
``depth + 1`` reused pinned host buffers and from there to the device
with ``non_blocking`` copies on a side stream, and records an event.  The
consumer's ``next()`` makes its current stream wait on that event and
``record_stream``-s each tensor on it, so the allocator does not hand the
memory to the side stream again while the step may still read it.

After each ``next()``, ``last_stamps`` holds the producer's
``perf_counter`` stamps ``(t0, t1, t2)`` of that batch (pulled, prepared,
put), which the train loop turns into ``prep`` / ``h2d`` trace spans,
and, with ``keep_host``, ``last_host_batch`` holds the host batch after
``prep_fn`` (after the noise and after ``shard_rows``: the rank's own
rows), which the forensics ring keeps.  ``keep_host`` is off by default:
the references keep up to ``depth`` more host batches alive.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Dict, Iterable, Iterator, Optional

import numpy as np
import torch

from raft_tpu_torch import chaos

# Producer -> consumer message kinds.
_ITEM, _END, _ERROR = "item", "end", "error"

BATCH_KEYS = ("image1", "image2", "flow", "valid")


class PipelineInterrupted(Exception):
    """Raised out of ``next(pipeline)`` when the ``interrupt`` predicate
    turns true while the buffer is empty: the preemption path out of an
    input wait.  The pipeline stays usable."""


def _chaos_producer_point(ordinal: int) -> None:
    """The ``producer_err`` seam, before batch ``ordinal`` is pulled."""
    if chaos.should_inject("producer_err", step=ordinal,
                           point="pipeline.producer"):
        raise chaos.InjectedProducerCrash(
            f"chaos-injected producer crash before batch {ordinal}")


class CudaBatchPut:
    """Host batch -> device tensors through a ring of pinned buffers and a
    side stream.  ``put`` runs on the producer, ``ready`` on the consumer
    (see the module docstring).  A ring slot is rewritten only after the
    event of its previous copy has completed."""

    def __init__(self, device: torch.device, slots: int):
        self.device = torch.device(device)
        if self.device.type != "cuda":
            raise ValueError(f"CudaBatchPut needs a CUDA device, got "
                             f"{self.device}")
        self.stream = torch.cuda.Stream(self.device)
        self._ring = [None] * max(int(slots), 1)
        self._events = [None] * len(self._ring)
        self._next = 0

    def _slot(self, batch: Dict[str, np.ndarray]):
        """The next ring slot's index and pinned buffers, holding
        ``batch``."""
        i = self._next
        self._next = (i + 1) % len(self._ring)
        if self._events[i] is not None:
            # the slot's last copy must have left before it is refilled
            self._events[i].synchronize()  # raftlint: disable=JIT103
        bufs = self._ring[i]
        if bufs is None or any(bufs[k].shape != np.shape(batch[k])
                               for k in BATCH_KEYS):
            bufs = {k: torch.empty(np.shape(batch[k]), dtype=torch.float32,
                                   pin_memory=True) for k in BATCH_KEYS}
            self._ring[i] = bufs
        for k in BATCH_KEYS:
            np.copyto(bufs[k].numpy(), batch[k], casting="same_kind")
        return i, bufs

    def put(self, batch: Dict[str, np.ndarray]):
        i, bufs = self._slot(batch)
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            out = {k: torch.empty(bufs[k].shape, dtype=torch.float32,
                                  device=self.device) for k in BATCH_KEYS}
            for k in BATCH_KEYS:
                out[k].copy_(bufs[k], non_blocking=True)
            event = torch.cuda.Event()
            event.record(self.stream)
        self._events[i] = event
        return out, event

    def ready(self, item) -> Dict[str, torch.Tensor]:
        out, event = item
        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(event)
        for t in out.values():
            t.record_stream(stream)
        return out


def host_put(batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Host batch -> float32 CPU tensors (the pipeline's put on the CPU)."""
    return {k: torch.from_numpy(np.asarray(batch[k], np.float32))
            for k in BATCH_KEYS}


class DevicePipeline:
    """Iterator of device batches with bounded background prefetch.

    ``batches``: the host batch iterator (``ShardedLoader.batches`` or
    ``batches_from_step``).  ``put_fn``: host batch -> device batch (None:
    identity, host-only pipelining); ``ready_fn``: what the consumer's
    ``next()`` applies to ``put_fn``'s result (``CudaBatchPut.ready``;
    None: identity).  ``prep_fn``: host prep before ``put_fn``, called in
    stream order by one thread.  ``depth``: buffered batches beyond the one
    handed to the consumer; 0 = the serial path.  ``interrupt``: a
    predicate polled every ``interrupt_poll_s`` while the consumer waits on
    an empty buffer; when true, ``next()`` raises
    :class:`PipelineInterrupted`.

    A producer-side exception re-raises, as the same object, in the
    consumer's ``next()``; after it the pipeline is closed.  ``close()``
    (also on leaving a ``with`` block) stops the producer, joins it and
    drops buffered batches so their device memory frees.
    ``last_prep_s`` / ``last_h2d_s``: the producer's prep and put time of
    the batch ``next()`` returned last (``last_stamps``, ``keep_host``
    and ``last_host_batch``: see the module docstring).
    """

    def __init__(self, batches: Iterable, *,
                 put_fn: Optional[Callable] = None,
                 ready_fn: Optional[Callable] = None,
                 prep_fn: Optional[Callable] = None,
                 depth: int = 2, keep_host: bool = False,
                 interrupt: Optional[Callable[[], bool]] = None,
                 interrupt_poll_s: float = 0.1):
        if depth < 0:
            raise ValueError(f"device-prefetch depth must be >= 0, "
                             f"got {depth}")
        self._src: Iterator = iter(batches)
        self._put = put_fn if put_fn is not None else (lambda b: b)
        self._ready = ready_fn if ready_fn is not None else (lambda b: b)
        self._prep = prep_fn
        self.depth = int(depth)
        self.keep_host = bool(keep_host)
        self._interrupt = interrupt
        self._interrupt_poll_s = max(float(interrupt_poll_s), 1e-3)
        self.last_prep_s = 0.0
        self.last_h2d_s = 0.0
        self.last_stamps: Optional[tuple] = None
        self.last_host_batch = None
        self.batches_out = 0
        self._closed = False
        if self.depth > 0:
            # the queue is unbounded; _slots bounds what is in flight
            self._q: queue.Queue = queue.Queue()
            self._slots = threading.Semaphore(self.depth)
            self._stop = threading.Event()
            self._thread = threading.Thread(
                target=self._produce, name="raft-device-prefetch",
                daemon=True)
            self._thread.start()

    # -- producer (depth > 0) -------------------------------------------
    def _produce(self) -> None:
        produced = 0
        try:
            while True:
                # a slot first: never pull a batch there is no room for
                while not self._slots.acquire(timeout=0.05):
                    if self._stop.is_set():
                        return
                if self._stop.is_set():
                    return
                _chaos_producer_point(produced)
                produced += 1
                try:
                    batch = next(self._src)
                except StopIteration:
                    self._q.put((_END, None, None, None))
                    return
                t0 = time.perf_counter()
                if self._prep is not None:
                    batch = self._prep(batch)
                t1 = time.perf_counter()
                host = batch if self.keep_host else None
                batch = self._put(batch)
                t2 = time.perf_counter()
                self._q.put((_ITEM, batch, host, (t0, t1, t2)))
        except BaseException as e:  # re-raised in the consumer
            self._q.put((_ERROR, e, None, None))

    # -- consumer --------------------------------------------------------
    def __iter__(self) -> "DevicePipeline":
        return self

    def _account(self, host, stamps: tuple) -> None:
        t0, t1, t2 = stamps
        self.last_prep_s = t1 - t0
        self.last_h2d_s = t2 - t1
        self.last_stamps = stamps
        self.last_host_batch = host
        self.batches_out += 1

    def __next__(self):
        if self._closed:
            raise StopIteration
        if self.depth == 0:
            _chaos_producer_point(self.batches_out)
            batch = next(self._src)  # StopIteration propagates
            t0 = time.perf_counter()
            if self._prep is not None:
                batch = self._prep(batch)
            t1 = time.perf_counter()
            host = batch if self.keep_host else None
            batch = self._put(batch)
            t2 = time.perf_counter()
            self._account(host, (t0, t1, t2))
            return self._ready(batch)
        if self._interrupt is None:
            kind, payload, host, stamps = self._q.get()
        else:
            # a preemption request cannot interrupt queue.get: poll
            while True:
                try:
                    kind, payload, host, stamps = self._q.get(
                        timeout=self._interrupt_poll_s)
                    break
                except queue.Empty:
                    if self._interrupt():
                        raise PipelineInterrupted(
                            "preemption requested while waiting on the "
                            "input pipeline")
        if kind == _END:
            self._closed = True
            raise StopIteration
        if kind == _ERROR:
            self._closed = True
            raise payload
        self._slots.release()
        self._account(host, stamps)
        return self._ready(payload)

    def buffered(self) -> int:
        """Batches in the buffer now (0 on the serial path); at most
        ``depth``."""
        return 0 if self.depth == 0 else self._q.qsize()

    def close(self) -> None:
        """Stop the producer, join it and drop buffered batches.
        Idempotent.  A producer blocked inside the source (host IO) sees
        the stop at its next batch boundary; the thread is a daemon, so a
        wedged loader cannot hang interpreter exit."""
        self._closed = True
        if self.depth == 0:
            return
        self._stop.set()
        self._thread.join(timeout=5.0)
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass

    def __enter__(self) -> "DevicePipeline":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False
