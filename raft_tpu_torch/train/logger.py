"""Training metrics logger (the port of ``raft_tpu/train/logger.py``).

Means over a window of ``log_freq`` steps, printed with the step and the
learning rate, and mirrored to TensorBoard when it is asked for and can
be imported (a warning once, else; printing goes on).  The step's metrics
stay device tensors until the window's flush, which reads them back to
the host in one go: no per-step sync for logging.

The ``on_flush`` hook gets ``(first_step, means, per_step)`` from that
same single transfer (``per_step[i]`` belongs to step
``first_step + i``): the training-health layer (``obs/health.py``) feeds
on it, so it adds no transfer of its own.  A failure inside the hook is
printed as a warning and training goes on.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch


def _host(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().float().cpu().numpy()
    return np.asarray(v)


class Logger:
    def __init__(self, log_freq: int = 100,
                 lr_fn: Optional[Callable] = None,
                 tensorboard_dir: Optional[str] = None,
                 log: Optional[Callable[[str], None]] = None,
                 on_flush: Optional[Callable[[int, Dict, List[Dict]],
                                             None]] = None):
        self.log_freq = log_freq
        self.lr_fn = lr_fn
        self.log = log or (lambda line: print(line, flush=True))
        self.on_flush = on_flush
        self._pending: List[Dict] = []
        self._last_step = 0
        self._writer = None
        self._tb_dir = tensorboard_dir

    def _ensure_writer(self):
        if self._writer is None and self._tb_dir is not None:
            tb_dir = self._tb_dir
            try:
                from torch.utils.tensorboard import SummaryWriter
                self._writer = SummaryWriter(tb_dir)
            except Exception as e:  # tensorboard missing or unwritable
                self._tb_dir = None
                print(f"WARNING: tensorboard logging to {tb_dir!r} "
                      f"disabled ({type(e).__name__}: {e}); stdout "
                      "metrics continue", flush=True)
        return self._writer

    def push(self, step: int, metrics: Dict) -> None:
        """Keep step ``step``'s metrics; flush every ``log_freq`` steps."""
        self._pending.append(metrics)
        self._last_step = step
        if len(self._pending) >= self.log_freq:
            self._flush()

    def _flush(self) -> None:
        if not self._pending:
            return
        step = self._last_step
        count = len(self._pending)
        per_step = [{k: _host(v) for k, v in m.items()}
                    for m in self._pending]
        sums: Dict[str, np.ndarray] = {}
        for m in per_step:
            for k, v in m.items():
                sums[k] = sums.get(k, 0.0) + np.asarray(v, np.float64)
        means = {k: s / count for k, s in sums.items()}
        lr = float(self.lr_fn(step)) if self.lr_fn else float("nan")
        body = ", ".join(f"{k} {float(v):10.4f}"
                         for k, v in sorted(means.items())
                         if np.ndim(v) == 0)
        self.log(f"[{step + 1:6d}, {lr:10.7f}] {body}")
        w = self._ensure_writer()
        if w is not None:
            for k, v in means.items():
                if np.ndim(v) == 0:
                    w.add_scalar(k, float(v), step + 1)
                else:  # per-iteration curves: one series per element
                    for i, vi in enumerate(np.ravel(v)):
                        w.add_scalar(f"{k}/{i:02d}", float(vi), step + 1)
        if self.on_flush is not None:
            try:
                self.on_flush(step - count + 1, means, per_step)
            except Exception as e:  # health/forensics must never kill
                print(f"WARNING: logger flush hook failed "
                      f"({type(e).__name__}: {e})", flush=True)
        self._pending = []

    def write_dict(self, step: int, results: Dict[str, float]) -> None:
        """Validation results: one printed line, and TensorBoard."""
        self.log(" ".join(f"{k}={v:.4f}" for k, v in results.items()))
        w = self._ensure_writer()
        if w is not None:
            for k, v in results.items():
                w.add_scalar(k, v, step)

    def close(self) -> None:
        self._flush()  # the trailing partial window
        if self._writer is not None:
            self._writer.close()
