"""Training health, the host half (the port of ``raft_tpu/obs/health.py``;
the in-graph guard is ``train/step.py``'s).

:class:`HealthMonitor` is fed by the training ``Logger``'s once-per-
interval flush (the ONLY device-to-host metric transfer the loop makes):
it mirrors the numerics metrics into the registry
(``raft_train_param_norm`` / ``raft_train_update_ratio`` /
``raft_train_epe_iter{iter}`` / ``raft_train_nonfinite_steps_total``),
emits a ``train_health`` record per flush, and, when a flushed interval
holds a step the guard flagged, writes a **forensic bundle** (the step's
host batch, its step, the dropout generator's state before it, its
metrics and the run's configurations) under ``telemetry_dir/forensics/``
and re-keeps that step's trace (late tail-keep).

The bundle is the JAX package's format, one ``.npz`` with the batch's
arrays and a ``__meta__`` JSON string, so ``raft_tpu.obs.health.
load_forensic_bundle`` reads the port's bundles and
:func:`load_forensic_bundle` reads JAX's.  ``meta["rng"]`` says what
replays the port's dropout draw: the seed, the step, the state of the
step's ``torch.Generator`` (``TrainState.generator``) before the step,
as hex bytes of ``Generator.get_state()``, and the generator's device
type (a CUDA generator's state does not fit a CPU one's):
``python -m raft_tpu_torch replay-step`` (``cli/replay_step.py``)
re-runs the step from it.

The monitor keeps a bounded ring of the most recent host batches
(``TrainConfig.forensic_keep``); a flagged step older than the ring at
flush time still gets a bundle (step, rng, metrics) with
``batch_captured: false``: set ``log_freq <= forensic_keep`` for
guaranteed capture.  Across ranks each rank's monitor writes a bundle of
its own rows (the flag agrees: the loss is reduced over the ranks), with
the rank in the file name.
"""

from __future__ import annotations

import collections
import json
import os
from typing import Dict, List, Optional

import numpy as np

_BATCH_KEYS = ("image1", "image2", "flow", "valid")


def forensic_bundle_path(directory: str, step: int,
                         rank: Optional[int] = None) -> str:
    """``step%08d.npz`` (the JAX package's name), or
    ``step%08d-rank<r>.npz`` for a rank of a world larger than one."""
    suffix = "" if rank is None else f"-rank{int(rank)}"
    return os.path.join(directory, f"step{int(step):08d}{suffix}.npz")


def write_forensic_bundle(directory: str, step: int,
                          batch: Optional[Dict[str, np.ndarray]],
                          meta: Dict, rank: Optional[int] = None) -> str:
    """One self-contained ``.npz``: the (post-noise) host batch arrays plus
    a ``__meta__`` JSON blob (step, seed, per-step metrics, model + train
    config dicts).  ``batch=None`` still writes the record with
    ``batch_captured: false`` so the event is never silently lost."""
    os.makedirs(directory, exist_ok=True)
    path = forensic_bundle_path(directory, step, rank)
    meta = dict(meta, step=int(step), batch_captured=batch is not None)
    arrays = {}
    if batch is not None:
        arrays = {k: np.asarray(v) for k, v in batch.items()}
    np.savez(path, __meta__=np.asarray(json.dumps(meta, default=str)),
             **arrays)
    return path


def load_forensic_bundle(path: str):
    """``(batch_or_None, meta)`` from a bundle written above."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["__meta__"]))
        batch = None
        if meta.get("batch_captured"):
            batch = {k: z[k] for k in z.files if k != "__meta__"}
    return batch, meta


def _scalar(metrics: Dict, key: str) -> Optional[float]:
    v = metrics.get(key)
    if v is None:
        return None
    v = np.asarray(v)
    return float(v) if v.ndim == 0 else None


def _vector(metrics: Dict, key: str) -> Optional[List[float]]:
    v = metrics.get(key)
    if v is None:
        return None
    v = np.asarray(v, np.float64)
    return [float(x) for x in np.ravel(v)]


class HealthMonitor:
    """Observes the Logger's per-interval flush; writes forensics.

    Everything it receives is host numpy already (the Logger's single
    per-interval transfer), so it adds no device sync, as
    :class:`raft_tpu_torch.obs.train.TrainTelemetry`, which it drives.
    ``rank``: this process's rank at a world larger than one (the bundle
    name carries it), else None."""

    def __init__(self, telemetry, *, forensics_dir: Optional[str] = None,
                 seed: int = 0, keep: int = 8,
                 initial_nonfinite: int = 0,
                 run_meta: Optional[Dict] = None,
                 rank: Optional[int] = None,
                 generator_device: Optional[str] = None):
        self.telemetry = telemetry
        self.forensics_dir = forensics_dir
        self.seed = int(seed)
        self.rank = rank
        self.generator_device = generator_device
        self._ring: collections.deque = collections.deque(
            maxlen=max(int(keep), 1))
        self.nonfinite_total = int(initial_nonfinite)
        self.run_meta = run_meta or {}
        self.bundles: List[str] = []   # paths written this run

    def note_batch(self, step: int, host_batch,
                   rng_state: Optional[bytes] = None) -> None:
        """Remember the host batch about to be consumed by ``step`` and the
        dropout generator's state before it (a reference append: no
        copies, no device access)."""
        if self.forensics_dir is not None and host_batch is not None:
            self._ring.append((int(step), host_batch, rng_state))

    def observe_flush(self, first_step: int, means: Dict,
                      per_step: List[Dict]) -> None:
        """Logger flush hook: per-step metrics (host numpy) for steps
        ``first_step .. first_step+len(per_step)-1``."""
        if not per_step:
            return
        flagged = [first_step + i for i, m in enumerate(per_step)
                   if float(np.asarray(m.get("nonfinite", 0.0))) > 0.5]
        self.nonfinite_total += len(flagged)
        if flagged:
            # Late tail-keep: the guard's verdict arrives a log interval
            # after the step ran, so the step's trace, if it lost the
            # sampling coin, sits in the tracer's dropped ring.
            try:
                from raft_tpu_torch.obs import trace

                trace.default_tracer().emit_recent_dropped(steps=flagged)
            except Exception:
                pass  # telemetry must never fail the monitor
        last = per_step[-1]
        self.telemetry.record_health(
            first_step + len(per_step) - 1,
            param_norm=_scalar(last, "param_norm"),
            update_ratio=_scalar(last, "update_ratio"),
            epe_iter=_vector(last, "epe_iter"),
            loss_iter=_vector(last, "loss_iter"),
            nonfinite_new=len(flagged),
            nonfinite_total=self.nonfinite_total)
        for step in flagged:
            self._capture(step, per_step[step - first_step])

    def _capture(self, step: int, metrics: Dict) -> None:
        if self.forensics_dir is None:
            return
        found = next((e for e in self._ring if e[0] == step), None)
        batch = None if found is None else found[1]
        rng_state = None if found is None else found[2]
        meta = {
            "seed": self.seed,
            # the dropout draws come from TrainState.generator: restoring
            # this state before the step replays them
            "rng": {"kind": "torch.Generator state before the step",
                    "seed": self.seed, "step": int(step),
                    "generator_state": (None if rng_state is None
                                        else bytes(rng_state).hex()),
                    "device": self.generator_device},
            "metrics": {k: np.asarray(v).tolist()
                        for k, v in metrics.items()},
        }
        if self.rank is not None:
            meta["rank"] = int(self.rank)
        meta.update(self.run_meta)
        try:
            path = write_forensic_bundle(self.forensics_dir, step, batch,
                                         meta, rank=self.rank)
        except Exception as e:  # forensics must never kill the run
            print(f"WARNING: forensic bundle for step {step} failed "
                  f"({type(e).__name__}: {e})", flush=True)
            return
        self.bundles.append(path)
        self.telemetry.sink.emit(
            "nonfinite_step", step=step, bundle=path,
            batch_captured=batch is not None,
            nonfinite_steps_total=self.nonfinite_total)
        print(f"WARNING: non-finite loss/grads at step {step}; update "
              f"skipped by the guard; forensic bundle: {path}"
              + ("" if batch is not None else
                 " (batch already evicted — raise forensic_keep or "
                 "lower log_freq to capture it)"), flush=True)
