"""Profiling hooks (the port of ``raft_tpu/utils/profiling.py``): capture
accounting, the profiler window over training steps, step annotations and
the step's device memory.

The JAX package counts one compile event per program it builds; the
port's counterpart of a compiled program is a captured CUDA graph
(``utils/graphs.py``), so callers record one event per graph they
capture.  Tests then assert the invariant directly: steady traffic
captures once per key, never per call.  :func:`device_sync` is the one
wait on the card that a timer outside this module takes.  As the JAX counter does, it
mirrors each event into a metric registry (``raft_tpu_torch.obs``)
when given one: the serving engine's ``raft_serve_compiles_total``.

The JAX package's ``enable_persistent_compile_cache`` has no
counterpart: a CUDA graph cannot be saved to disk, and the kernels
already build once into ``build/`` under a hash of their sources.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Dict, Hashable, Optional


class CaptureCounter:
    """Per-key capture events, thread-safe.

    With a ``registry`` (a :class:`raft_tpu_torch.obs.MetricRegistry`,
    duck-typed), each event also increments the ``metric`` counter,
    labeled by ``labeler(key) -> {label: value}`` (default: one
    ``key=str(key)`` label)."""

    def __init__(self, registry=None,
                 metric: str = "raft_captures_total",
                 labeler: Optional[Callable[[Hashable], dict]] = None
                 ) -> None:
        self._lock = threading.Lock()
        self._counts: Dict[Hashable, int] = {}
        self._metric = (registry.counter(metric,
                                         "program captures (CUDA graphs)")
                        if registry is not None else None)
        self._labeler = labeler

    def record(self, key: Hashable) -> None:
        with self._lock:
            self._counts[key] = self._counts.get(key, 0) + 1
        if self._metric is not None:
            labels = (self._labeler(key) if self._labeler
                      else {"key": str(key)})
            self._metric.inc(1, **labels)

    def count(self, key: Hashable) -> int:
        with self._lock:
            return self._counts.get(key, 0)

    def counts(self) -> Dict[Hashable, int]:
        with self._lock:
            return dict(self._counts)

    def total(self) -> int:
        with self._lock:
            return sum(self._counts.values())


# ---------------------------------------------------------------------------
# the profiler window, step annotations, device memory
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class StepProfiler:
    """A ``torch.profiler`` window over steps ``[start, start + num_steps)``
    (the port of the JAX package's ``jax.profiler`` window), written as a
    Chrome trace ``trace-<A>-<B>[-rank<r>].json`` under ``trace_dir``.

    Inactive (two int compares a step) when ``trace_dir`` is None.  The
    CPU and, when a card is visible, CUDA activities are recorded: the
    kernels of a captured graph's replay show on the timeline.
    ``absolute``: ``start_step`` is a global step number (the
    ``--profile_steps A:B`` window of a possibly resumed run) instead of
    an offset from the first observed step.  While the window runs, its
    directory is stamped onto concurrently recorded trace spans
    (``obs.trace.set_active_profile``).
    """

    trace_dir: Optional[str] = None
    start_step: int = 10          # relative to the first observed step
    num_steps: int = 5
    absolute: bool = False
    rank: Optional[int] = None
    _first_step: Optional[int] = None
    _prof: object = None
    _done: bool = False
    path: Optional[str] = None    # the trace file, once written

    @staticmethod
    def _link_trace(directory) -> None:
        from raft_tpu_torch.obs import trace

        trace.set_active_profile(directory)

    def maybe_start(self, step: int) -> None:
        if self.trace_dir is None or self._prof is not None or self._done:
            return
        if self._first_step is None:
            self._first_step = 0 if self.absolute else step
        if step - self._first_step < self.start_step:
            return
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()
        self._link_trace(self.trace_dir)

    def maybe_stop(self, step: int, sync_on=None) -> None:
        """``sync_on``: a device tensor of the window's last step (the
        loss); the window waits for the card once, before it stops, so
        the trace holds the device work of every step it covers."""
        if self._prof is None:
            return
        if step - self._first_step + 1 >= self.start_step + self.num_steps:
            import torch

            if sync_on is not None and getattr(sync_on, "is_cuda", False):
                torch.cuda.synchronize(sync_on.device)
            self._finish()

    def _finish(self) -> None:
        import os

        prof, self._prof = self._prof, None
        prof.__exit__(None, None, None)
        self._done = True
        self._link_trace(None)
        a = self.start_step + (self._first_step or 0)
        name = f"trace-{a}-{a + self.num_steps}" + (
            f"-rank{self.rank}" if self.rank is not None else "") + ".json"
        os.makedirs(self.trace_dir, exist_ok=True)
        self.path = os.path.join(self.trace_dir, name)
        prof.export_chrome_trace(self.path)
        print(f"profiler trace written to {self.path}", flush=True)

    def close(self) -> None:
        if self._prof is not None:
            self._finish()


def device_sync(device) -> None:
    """Wait for the work queued on ``device`` (a CUDA device): what closes
    a timed region on the host clock (the autotuner's points).  Nothing on
    the CPU, whose work is done when the call returns."""
    import torch

    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def annotate_step(step: int):
    """A named range ``train_step#<step>`` on the profiler's timeline."""
    import torch

    return torch.profiler.record_function(f"train_step#{int(step)}")


def _gib(nbytes: float) -> float:
    return round(nbytes / float(2 ** 30), 3)


def state_bytes(state) -> int:
    """Bytes of a train state on its device: the model's parameters and
    buffers and the optimizer's state tensors."""
    import torch

    seen, total = set(), 0

    def add(t):
        nonlocal total
        if isinstance(t, torch.Tensor) and t.data_ptr() not in seen:
            seen.add(t.data_ptr())
            total += t.numel() * t.element_size()

    for t in list(state.model.parameters()) + list(state.model.buffers()):
        add(t)
    for per_param in state.optimizer.state.values():
        for t in per_param.values():
            add(t)
    return total


def hbm_usage(device, args_bytes: int = 0) -> dict:
    """Device memory of the train step, the JAX package's record with the
    CUDA caching allocator as its source: ``peak_hbm_gb`` is
    ``max_memory_allocated`` since the caller's
    ``reset_peak_memory_stats`` (the caller resets before the first step
    and reads after the capture, so the figure covers the graph's private
    pool), ``reserved_gb`` what the allocator holds from the card,
    ``args_gb`` the state's bytes (model, optimizer state, buffers),
    ``temp_gb`` the rest of the peak; ``output_gb`` is 0 (the step's
    outputs are its metrics, a few hundred bytes).  On a device without
    an allocator to ask (the CPU): ``{"peak_hbm": "unavailable"}``."""
    import torch

    device = torch.device(device)
    if device.type != "cuda":
        return {"peak_hbm": "unavailable"}
    try:
        peak = torch.cuda.max_memory_allocated(device)
        reserved = torch.cuda.memory_reserved(device)
    except RuntimeError as e:  # pragma: no cover - allocator specific
        return {"peak_hbm": f"unavailable ({type(e).__name__})"}
    return {
        "peak_hbm_gb": _gib(peak),
        "args_gb": _gib(args_bytes),
        "output_gb": 0.0,
        "temp_gb": _gib(max(peak - args_bytes, 0)),
        "reserved_gb": _gib(reserved),
        "source": "torch.cuda.max_memory_allocated",
    }


def probe_error_is_oom(exc: BaseException) -> bool:
    """Whether an allocation failure is an out-of-memory verdict
    (``torch.cuda.OutOfMemoryError``, or a message that says so) rather
    than a broken probe."""
    import torch

    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return True
    msg = f"{type(exc).__name__}: {exc}".lower()
    return "out of memory" in msg or "resource_exhausted" in msg


def measure_hbm_limit(device="cuda") -> dict:
    """The device memory this process can use: what ``cudaMemGetInfo``
    says is free plus what the caching allocator already holds.  Returns
    ``{"hbm_limit_gb": float, "source": str}``, or
    ``{"hbm_limit_gb": "unavailable", "source": ...}`` without a card."""
    import torch

    if not torch.cuda.is_available():
        return {"hbm_limit_gb": "unavailable", "source": "no CUDA device"}
    device = torch.device(device)
    try:
        free, _total = torch.cuda.mem_get_info(device)
    except RuntimeError as e:
        if probe_error_is_oom(e):
            free = 0
        else:
            return {"hbm_limit_gb": "unavailable",
                    "source": f"cudaMemGetInfo failed: {type(e).__name__}"}
    usable = free + torch.cuda.memory_reserved(device)
    return {"hbm_limit_gb": round(usable / 2 ** 30, 2),
            "source": "cudaMemGetInfo free + this process's reserved"}


#: The measured limit's file at the repository root.  Not the JAX
#: package's ``HBM_LIMIT.json``, which holds a TPU's figure.
HBM_LIMIT_FILE = "HBM_LIMIT_CUDA.json"


def load_hbm_limit(default_gb=None, path=None):
    """``(limit_gb, source)`` from :data:`HBM_LIMIT_FILE` at the repository
    root (a :func:`measure_hbm_limit` record), else ``(default_gb,
    reason)``; ``path`` overrides the location."""
    import json
    import os.path as osp

    if path is None:
        root = osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__))))
        path = osp.join(root, HBM_LIMIT_FILE)
    if not osp.exists(path):
        return default_gb, f"no (valid) {osp.basename(path)}"
    try:
        with open(path) as f:
            rec = json.load(f)
    except (OSError, ValueError):
        return default_gb, f"corrupt {osp.basename(path)}"
    v = rec.get("hbm_limit_gb") if isinstance(rec, dict) else None
    if isinstance(v, (int, float)) and v >= 1.0:
        return float(v), rec.get("source", osp.basename(path))
    return default_gb, f"no (valid) {osp.basename(path)}"
