"""Training-loop telemetry recorder (the port of ``raft_tpu/obs/train.py``,
driven by ``raft_tpu_torch/train/loop.py``).

Everything this class receives is a host-side float the loop measured
with ``perf_counter``: it never sees the step's device tensors, so it
cannot add a device sync to the step path (the ``Logger`` keeps its
once-per-interval transfer).

Per step it records/emits (``train_step``):

- ``step_time_s``: wall time of the loop iteration (queue wait + the
  step's enqueue + the wait for the previous step on the card: the loop
  keeps one step in flight, so once the pipeline fills this is the
  device step time);
- ``queue_wait_s``: time blocked in ``next()`` on the input pipeline,
  the input-bound detector;
- ``h2d_s`` / ``prep_s``: the producer-side copy and host prep of the
  batch the step consumed (off the critical path with prefetch on);
- ``pairs_per_sec_per_chip``: ``batch / step_time / num_devices``.

One-time events: ``run_config``; ``compile`` (the first call of the step
key, which runs eagerly); ``hbm_usage`` (the CUDA allocator's peak after
the capture, ``utils/profiling.hbm_usage``; ``RAFT_TELEMETRY_HBM=0``
skips it); ``cost_report`` (the counted first step, ``obs/cost.py``;
``RAFT_TELEMETRY_COST=0`` skips it — per-step MFU then stays unset).
``close()`` emits ``metrics_summary`` with the registry's snapshot.  The
event names, fields, metric names and environment knobs are the JAX
package's, so its readers fold either package's stream.
"""

from __future__ import annotations

import collections
import os
from typing import List, Optional, Sequence, Tuple

from raft_tpu_torch.obs import cost as cost_mod
from raft_tpu_torch.obs.events import EventSink
from raft_tpu_torch.obs.registry import MetricRegistry
from raft_tpu_torch.utils.profiling import CaptureCounter


def _env_float(name: str, default: float = 0.0) -> float:
    """A float env knob; unset/empty/garbage -> ``default``."""
    raw = os.environ.get(name)
    if not raw:
        return default
    try:
        return float(raw)
    except ValueError:
        return default


class TrainTelemetry:
    def __init__(self, directory: Optional[str] = None, *,
                 batch_size: int, num_devices: int,
                 image_size: Tuple[int, int],
                 registry: Optional[MetricRegistry] = None,
                 hbm: Optional[bool] = None,
                 tuning_stamp: Optional[dict] = None):
        directory = directory or os.environ.get("RAFT_TELEMETRY_DIR") or None
        self.sink = EventSink(directory)
        self.enabled = self.sink.enabled
        self.registry = registry or MetricRegistry(enabled=self.enabled)
        self.batch_size = int(batch_size)
        self.num_devices = max(int(num_devices), 1)
        self.image_size = tuple(int(x) for x in image_size)
        # Tuning provenance: rides the run_config event so a reader can
        # say whether the run's knobs were autotuned or hand-set (the
        # port has no tuning registry yet: {"tuned": False}).
        self.tuning_stamp = dict(tuning_stamp or {"tuned": False})
        if hbm is None:
            hbm = os.environ.get("RAFT_TELEMETRY_HBM", "1") == "1"
        self.hbm_enabled = self.enabled and hbm
        # Cost-model capture (obs/cost.py): the first step runs under
        # the counting modes — disable with RAFT_TELEMETRY_COST=0.
        self.cost_enabled = self.enabled and (
            os.environ.get("RAFT_TELEMETRY_COST", "1") == "1")
        self._cost_book = cost_mod.CostBook(registry=self.registry,
                                            sink=self.sink)
        self.compile_counter = CaptureCounter(
            registry=self.registry, metric="raft_train_compiles_total")
        self._step_hist = self.registry.histogram(
            "raft_train_step_seconds", "wall time per training step")
        self._wait_hist = self.registry.histogram(
            "raft_train_queue_wait_seconds",
            "consumer time blocked on the input pipeline per step "
            "(the input-bound signal; serial fetch cost at depth 0)")
        self._h2d_hist = self.registry.histogram(
            "raft_train_h2d_seconds",
            "producer-side device_put dispatch span per batch")
        self._prep_hist = self.registry.histogram(
            "raft_train_host_prep_seconds",
            "producer-side host prep (noise) span per batch")
        self._pps = self.registry.gauge(
            "raft_train_pairs_per_sec_per_chip",
            "batch / step_time / num_devices, last step")
        # Training-health metrics: fed by HealthMonitor from the
        # Logger's once-per-interval flush — host floats only, never a
        # device sync.
        self._param_norm = self.registry.gauge(
            "raft_train_param_norm",
            "global L2 norm of all parameters, last logged step")
        self._update_ratio = self.registry.gauge(
            "raft_train_update_ratio",
            "global update-norm / param-norm of the optimizer step, "
            "last logged step (a spike = one step rewriting the net)")
        self._nonfinite = self.registry.counter(
            "raft_train_nonfinite_steps_total",
            "steps whose loss/grads were non-finite (update skipped by "
            "the in-graph guard)")
        self._epe_iter = self.registry.gauge(
            "raft_train_epe_iter",
            "per-refinement-iteration EPE of the last logged step "
            "(iter label; the refinement-convergence curve)")
        # Recent per-step records for the stall watchdog's post-mortem.
        self._recent: collections.deque = collections.deque(maxlen=16)
        # Train-side SLOs + incident engine (obs/slo.py,
        # obs/incident.py), env-driven so every train entrypoint gets
        # them without CLI plumbing: RAFT_SLO_GOODPUT=<objective>
        # tracks the non-quarantined non-nonfinite step fraction
        # (fed by record_health; quarantines counted via a sink
        # observer), RAFT_SLO_MFU_FLOOR=<floor> the per-step MFU floor
        # (known device peaks only), RAFT_SLO_WINDOW_S rescales the
        # burn policy, RAFT_INCIDENTS=1 builds the incident manager
        # (RAFT_INCIDENT_WINDOW_S / _QUIET_S / _COOLDOWN_S size it).
        # All disabled by default: nothing is constructed, the step
        # path is untouched.
        self._slo = None
        self._quarantined_new = 0
        self._last_health_step: Optional[int] = None
        goodput = _env_float("RAFT_SLO_GOODPUT")
        mfu_floor = _env_float("RAFT_SLO_MFU_FLOOR")
        self._mfu_floor = None
        if self.enabled and (goodput or mfu_floor):
            from raft_tpu_torch.obs import slo as slo_mod

            window = _env_float("RAFT_SLO_WINDOW_S") or 3600.0
            policy = slo_mod.scaled_policy(window)
            specs = []
            if goodput:
                specs.append(slo_mod.SLOSpec(
                    "train_goodput", goodput,
                    "non-quarantined non-nonfinite step fraction",
                    windows=policy))
            if mfu_floor and (cost_mod.peak_spec().tflops or 0):
                self._mfu_floor = mfu_floor
                specs.append(slo_mod.SLOSpec(
                    "train_mfu", 0.9,
                    f"step MFU >= {mfu_floor}", windows=policy))
            if specs:
                self._slo = slo_mod.SLOTracker(
                    specs, registry=self.registry, sink=self.sink)
                self.sink.add_observer(self._count_quarantine)
        self._incidents = None
        if self.enabled and os.environ.get("RAFT_INCIDENTS") == "1":
            from raft_tpu_torch.obs import incident as incident_mod

            self._incidents = incident_mod.IncidentManager(
                registry=self.registry,
                window_s=_env_float("RAFT_INCIDENT_WINDOW_S") or 10.0,
                quiet_close_s=_env_float("RAFT_INCIDENT_QUIET_S")
                or 30.0,
                cooldown_s=_env_float("RAFT_INCIDENT_COOLDOWN_S",
                                      60.0))
            self._incidents.attach(self.sink)
            self._incidents.recorder.add_provider(
                "recent_steps", self.recent_records)

    def _count_quarantine(self, rec: dict) -> None:
        """Sink observer (SLO-enabled runs only): count quarantined
        samples between health flushes so the goodput SLO debits them
        alongside nonfinite steps."""
        if rec.get("event") == "sample_quarantine":
            self._quarantined_new += 1

    @property
    def directory(self) -> Optional[str]:
        """The resolved telemetry directory (None = disabled)."""
        return self.sink.directory

    def recent_records(self) -> List[dict]:
        """The last few train_step records (stall-event payload)."""
        return list(self._recent)

    def start(self, start_step: int, num_steps: int) -> None:
        if not self.enabled:
            return
        self.sink.emit("run_config", step=start_step,
                       batch_size=self.batch_size,
                       num_devices=self.num_devices,
                       image_size=list(self.image_size),
                       num_steps=int(num_steps),
                       **self.tuning_stamp)

    def record_step(self, step: int, step_time_s: float,
                    queue_wait_s: float, h2d_s: float = 0.0,
                    prep_s: float = 0.0) -> None:
        if not self.enabled:
            return
        pps = (self.batch_size / step_time_s / self.num_devices
               if step_time_s > 0 else 0.0)
        self._step_hist.observe(step_time_s)
        self._wait_hist.observe(queue_wait_s)
        self._h2d_hist.observe(h2d_s)
        self._prep_hist.observe(prep_s)
        self._pps.set(pps)
        # MFU from the device-time proxy (step minus input wait; once
        # the pipeline fills this converges to device step time) — a
        # no-op {} until record_cost stamped the counted step.
        cost_attrs = self._cost_book.observe(
            "train_step", max(step_time_s - queue_wait_s, 1e-9))
        if (self._slo is not None and self._mfu_floor
                and "mfu" in cost_attrs):
            self._slo.record("train_mfu",
                             cost_attrs["mfu"] >= self._mfu_floor)
        rec = dict(step=step,
                   step_time_s=round(step_time_s, 6),
                   queue_wait_s=round(queue_wait_s, 6),
                   h2d_s=round(h2d_s, 6),
                   prep_s=round(prep_s, 6),
                   pairs_per_sec_per_chip=round(pps, 3))
        self._recent.append(rec)
        self.sink.emit("train_step", **rec)

    def record_health(self, step: int, *,
                      param_norm: Optional[float] = None,
                      update_ratio: Optional[float] = None,
                      epe_iter: Optional[Sequence[float]] = None,
                      loss_iter: Optional[Sequence[float]] = None,
                      nonfinite_new: int = 0,
                      nonfinite_total: int = 0) -> None:
        """One per-Logger-flush health record: numerics gauges + the
        refinement-convergence curve + the non-finite counter.  All
        inputs are host floats already pulled by the Logger's single
        interval transfer (HealthMonitor is the only caller)."""
        if not self.enabled:
            return
        if param_norm is not None:
            self._param_norm.set(param_norm)
        if update_ratio is not None:
            self._update_ratio.set(update_ratio)
        if epe_iter is not None:
            for i, v in enumerate(epe_iter):
                self._epe_iter.set(float(v), iter=f"{i:02d}")
        if nonfinite_new:
            self._nonfinite.inc(nonfinite_new)
        if self._slo is not None:
            # Goodput accounting per flush interval: bad = nonfinite
            # steps + samples quarantined since the last flush; good =
            # the rest of the interval's steps.
            q, self._quarantined_new = self._quarantined_new, 0
            prev, self._last_health_step = self._last_health_step, step
            bad = int(nonfinite_new) + q
            if bad:
                self._slo.record("train_goodput", False, n=bad)
            if prev is not None and step - prev - bad > 0:
                self._slo.record("train_goodput", True,
                                 n=step - prev - bad)
        fields = {"nonfinite_steps_total": int(nonfinite_total),
                  "nonfinite_in_interval": int(nonfinite_new)}
        if param_norm is not None:
            fields["param_norm"] = round(float(param_norm), 6)
        if update_ratio is not None:
            fields["update_ratio"] = round(float(update_ratio), 8)
        if epe_iter is not None:
            fields["epe_iter"] = [round(float(v), 5) for v in epe_iter]
        if loss_iter is not None:
            fields["loss_iter"] = [round(float(v), 6) for v in loss_iter]
        self.sink.emit("train_health", step=step, **fields)

    def record_compile(self, step: int, seconds: float, key) -> None:
        """First call of a step key: its eager warm-up (the kernels' build
        and load, cuDNN's plan search, the cost count) dominates its wall
        time, so that is the recorded figure."""
        if not self.enabled:
            return
        self.compile_counter.record(key)
        self.sink.emit("compile", step=step, key=str(key),
                       seconds=round(seconds, 6))

    def record_hbm(self, info: dict) -> None:
        if not self.enabled:
            return
        peak = info.get("peak_hbm_gb")
        if isinstance(peak, (int, float)):
            self.registry.gauge(
                "raft_train_peak_hbm_gb",
                "train step's peak device allocation (CUDA caching "
                "allocator, the captured graph's pool included)").set(peak)
        self.sink.emit("hbm_usage", **info)

    def record_cost(self, cost) -> None:
        """Stamp the train step's counted :class:`obs.cost.ProgramCost`
        — one ``cost_report`` event + the ``raft_cost_*`` gauges; from
        then on every ``record_step`` refreshes MFU/BW utilization from
        the step's measured wall time (host floats only)."""
        if not self.enabled:
            return
        self._cost_book.stamp("train_step", cost)

    def close(self) -> None:
        if self._incidents is not None:
            # Finalize before the summary so incident_close (and its
            # bundle) precede the run's last record.
            self._incidents.close()
        if self.enabled:
            self.sink.emit("metrics_summary",
                           metrics=self.registry.snapshot())
        self.sink.close()
