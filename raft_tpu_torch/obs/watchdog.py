"""Stall watchdog: notice when the training loop stops making steps (the
port's copy of ``raft_tpu/obs/watchdog.py``).

A hung multi-GPU job is the most expensive failure mode of a long
unattended run — one wedged rank (deadlocked collective, stuck storage
read, livelocked loader) leaves every card idle while every surface
looks "running".  :class:`StallWatchdog` is a daemon thread fed
a per-iteration heartbeat by ``train()``: when no heartbeat lands
within ``timeout_s`` it

1. dumps **all thread stacks** via :mod:`faulthandler` (to the shared
   dump file under the telemetry dir, else stderr) — the "where is it
   stuck" answer, captured at the moment of the stall;
2. emits a ``stall`` JSONL event carrying the last telemetry records
   (so the post-mortem sees what the run looked like right before);
3. optionally (``hard_exit=True``) hard-exits the process (code 42) so
   the job scheduler restarts the job instead of letting it idle.

Default off (``TrainConfig.watchdog_timeout = 0``).  Pick a timeout of
roughly N× your rolling median step time (N≈20 is comfortable).  The
loop pauses the watchdog across the first call of a batch shape (eager:
the kernels' build, cuDNN's plan search) and the second (the graph's
capture), and around the save+validate block, whose minutes-long
runtime is legitimate.

The same stack-dump file (``stacks-p<rank>.txt``) serves the on-demand
path: ``cli/train.py`` registers SIGQUIT (``kill -QUIT <pid>``) to append an all-thread dump
via :func:`install_sigquit_dump` without killing the run.
"""

from __future__ import annotations

import faulthandler
import os
import threading
import time
from typing import Callable, Optional


def _process_index() -> int:
    """The ``torch.distributed`` rank (0 without a process group)."""
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def stack_dump_path(directory: Optional[str]) -> Optional[str]:
    """The shared all-thread stack-dump file for this process (used by
    both the watchdog and the SIGQUIT handler); None = dump to stderr."""
    if not directory:
        return None
    return os.path.join(directory, f"stacks-p{_process_index()}.txt")


_sigquit_file = None  # keep the fd alive: faulthandler holds a borrow


def install_sigquit_dump(dump_path: Optional[str] = None) -> Optional[str]:
    """Register SIGQUIT -> faulthandler all-thread stack dump (appended
    to ``dump_path``, else stderr).  On-demand "where is it stuck"
    without killing the run; no-op on platforms without SIGQUIT."""
    import signal

    if not hasattr(signal, "SIGQUIT"):
        return None
    global _sigquit_file
    try:
        if dump_path:
            os.makedirs(os.path.dirname(dump_path) or ".", exist_ok=True)
            _sigquit_file = open(dump_path, "a")
            faulthandler.register(signal.SIGQUIT, file=_sigquit_file,
                                  all_threads=True)
        else:
            faulthandler.register(signal.SIGQUIT, all_threads=True)
    except Exception:
        # faulthandler needs a real fileno; a captured/redirected stderr
        # (pytest, some launchers) has none — the dump is a debugging
        # aid, never worth failing the run over.
        return None
    return dump_path


class StallWatchdog:
    """Daemon thread that fires when heartbeats stop arriving.

    ``beat(step)`` is the only hot-path call: a lock-guarded tuple
    store, nanoseconds, never a device access.  After firing once the
    watchdog re-arms only when a new heartbeat arrives (one stall = one
    dump + one event, not a dump per poll)."""

    def __init__(self, timeout_s: float, *, sink=None,
                 dump_path: Optional[str] = None,
                 hard_exit: bool = False, exit_code: int = 42,
                 recent_records: Optional[Callable[[], list]] = None,
                 poll_s: Optional[float] = None):
        if timeout_s <= 0:
            raise ValueError(f"watchdog timeout must be > 0, got "
                             f"{timeout_s}")
        self.timeout_s = float(timeout_s)
        self.dump_path = dump_path
        self.hard_exit = bool(hard_exit)
        self.exit_code = int(exit_code)
        self._sink = sink
        self._recent = recent_records
        self._poll = poll_s or max(min(self.timeout_s / 4.0, 1.0), 0.01)
        self._lock = threading.Lock()
        self._last = (time.perf_counter(), -1)
        self._armed = False
        self._paused = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.stall_count = 0
        self.last_stall: Optional[dict] = None

    # -- producer side (the train loop) --------------------------------

    def beat(self, step: int) -> None:
        with self._lock:
            self._last = (time.perf_counter(), int(step))
            self._armed = True

    def pause(self) -> None:
        """Suspend stall detection (save/validate blocks are legitimately
        minutes-long)."""
        with self._lock:
            self._paused = True

    def resume(self) -> None:
        with self._lock:
            self._paused = False
            self._last = (time.perf_counter(), self._last[1])

    # -- lifecycle ------------------------------------------------------

    def start(self) -> "StallWatchdog":
        if self._thread is not None:
            raise RuntimeError("watchdog already started")
        with self._lock:
            self._last = (time.perf_counter(), self._last[1])
        self._thread = threading.Thread(
            target=self._run, name="raft-stall-watchdog", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    # -- watcher thread -------------------------------------------------

    def _run(self) -> None:
        while not self._stop.wait(self._poll):
            with self._lock:
                t, step = self._last
                armed, paused = self._armed, self._paused
            if not armed or paused:
                continue
            dt = time.perf_counter() - t
            if dt >= self.timeout_s:
                with self._lock:
                    self._armed = False  # one stall -> one fire
                self._fire(step, dt)

    def _fire(self, step: int, dt: float) -> None:
        self.stall_count += 1
        stacks = None
        try:
            if self.dump_path:
                os.makedirs(os.path.dirname(self.dump_path) or ".",
                            exist_ok=True)
                with open(self.dump_path, "a") as f:
                    f.write(f"=== stall watchdog: no heartbeat for "
                            f"{dt:.1f}s (last step {step}) ===\n")
                    faulthandler.dump_traceback(file=f, all_threads=True)
                stacks = self.dump_path
            else:
                faulthandler.dump_traceback(all_threads=True)
        except Exception:
            pass  # the event below still fires
        recent = []
        if self._recent is not None:
            try:
                recent = list(self._recent())
            except Exception:
                pass
        info = {"step": step,
                "seconds_since_heartbeat": round(dt, 3),
                "timeout_s": self.timeout_s,
                "stacks": stacks, "recent": recent}
        self.last_stall = info
        if self._sink is not None:
            self._sink.emit("stall", **info)
            self._sink.flush()
        print(f"WATCHDOG: no training heartbeat for {dt:.1f}s "
              f"(timeout {self.timeout_s}s, last step {step}); thread "
              f"stacks -> {stacks or 'stderr'}"
              + ("; hard-exiting" if self.hard_exit else ""), flush=True)
        if self.hard_exit:
            if self._sink is not None:
                try:
                    self._sink.flush()
                except Exception:
                    pass
            os._exit(self.exit_code)
