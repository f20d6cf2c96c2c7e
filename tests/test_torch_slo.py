"""The port's SLO tracker (``raft_tpu_torch/obs/slo.py``) against the JAX
package's on one recorded sequence under a fake clock (identical
snapshots, alerts, events and gauges), the burn-window checks, and the
serving engine's and the router's SLO knobs on the CPU.
"""

import numpy as np
import pytest
import torch

from raft_tpu.obs import slo as jslo
from raft_tpu.obs.registry import MetricRegistry as JaxRegistry
from raft_tpu_torch.config import RAFTConfig
from raft_tpu_torch.models.raft import RAFT
from raft_tpu_torch.obs import MetricRegistry
from raft_tpu_torch.obs import slo
from raft_tpu_torch.serve import InferenceEngine, ServeConfig


class _RecordingSink:
    def __init__(self):
        self.events = []

    def emit(self, event, step=None, **fields):
        self.events.append((event, fields))


class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def _sequence(seed=0):
    """(dt, slo name, ok, n): a healthy stretch, a burst of failures and
    slow requests, a recovery, an unknown name."""
    rng = np.random.default_rng(seed)
    seq = []
    for i in range(400):
        bad = 150 <= i < 230
        seq.append((float(rng.uniform(0.05, 0.4)), "availability",
                    not (bad and rng.random() < 0.6), 1))
        seq.append((0.0, "latency", not (bad and rng.random() < 0.8),
                    int(rng.integers(1, 3))))
        if i % 50 == 0:
            seq.append((0.0, "unknown", False, 1))
    return seq


def test_slo_tracker_matches_jax_under_a_fake_clock():
    """Both trackers fed the same observations at the same fake times:
    every alert list, snapshot, event and gauge value is identical."""
    trackers, sinks, regs, clocks = [], [], [], []
    for mod, reg in ((slo, MetricRegistry()), (jslo, JaxRegistry())):
        clock = _Clock()
        sink = _RecordingSink()
        policy = mod.scaled_policy(60.0)
        specs = [mod.SLOSpec("availability", 0.99, "non-error",
                             windows=policy),
                 mod.SLOSpec("latency", 0.95, "fast", windows=policy)]
        trackers.append(mod.SLOTracker(specs, registry=reg, sink=sink,
                                       check_interval_s=1.0, clock=clock))
        sinks.append(sink)
        regs.append(reg)
        clocks.append(clock)
    for dt, name, ok, n in _sequence():
        for tr, clock in zip(trackers, clocks):
            clock.t += dt
            tr.record(name, ok, n=n)
        if dt:
            assert trackers[0].snapshot() == trackers[1].snapshot()
    alerts = [tr.check() for tr in trackers]
    assert alerts[0] == alerts[1]
    assert sinks[0].events == sinks[1].events
    assert any(e == "slo_burn" for e, _ in sinks[0].events)
    for reg in regs:
        reg.collect()
    for name in ("raft_slo_burn_rate", "raft_slo_budget_remaining",
                 "raft_slo_burns_total"):
        ours = dict(regs[0]._metrics[name].items())
        theirs = dict(regs[1]._metrics[name].items())
        assert ours == theirs, name
    assert [s.name for s in trackers[0].specs] == ["availability",
                                                   "latency"]


def test_policy_and_validation_match_jax():
    assert [vars(w) for w in slo.scaled_policy(120.0)] == \
        [vars(w) for w in jslo.scaled_policy(120.0)]
    for kw in (dict(long_s=0, short_s=1, threshold=1),
               dict(long_s=1, short_s=2, threshold=1),
               dict(long_s=2, short_s=1, threshold=0),
               dict(long_s=2, short_s=1, threshold=1, severity="x")):
        with pytest.raises(ValueError):
            slo.BurnWindow(**kw)
    for objective in (0.0, 1.0):
        with pytest.raises(ValueError):
            slo.SLOSpec("a", objective)
    with pytest.raises(ValueError):
        slo.SLOSpec("a", 0.9, windows=())
    with pytest.raises(ValueError):
        slo.SLOTracker([slo.SLOSpec("a", 0.9), slo.SLOSpec("a", 0.9)])


def test_engine_slo_knobs(tmp_path):
    """The engine builds a tracker for the objectives set (availability,
    latency), feeds it every outcome, and exposes the worst burn in
    ``load_signals``; the MFU floor still refuses (the cost model)."""
    torch.set_num_threads(1)
    cfg = RAFTConfig.small_model()
    sd = RAFT(cfg, seed=0).state_dict()
    eng = InferenceEngine(sd, cfg, ServeConfig(
        iters=2, max_batch=2, batch_sizes=(2,), max_wait_ms=5,
        slo_availability_target=0.99, slo_latency_target_ms=1e-3,
        slo_window_s=60.0), device="cpu")
    rng = np.random.default_rng(0)
    with eng:
        for _ in range(2):
            eng.infer(*(rng.uniform(0, 255, (36, 52, 3)).astype(np.float32)
                        for _ in range(2)), timeout=60)
        snap = eng.stats()["slo"]
        sig = eng.load_signals()
    assert snap["availability"]["good"] == 2
    assert snap["latency"] == {**snap["latency"], "good": 0, "bad": 2}
    assert sig["burn_rate"] > 0 and sig["mfu"] is None
    assert sig["max_queue"] == 256 and sig["pending"] == 0
    assert "raft_slo_burn_rate" in eng.metrics_text()
    with pytest.raises(ValueError, match="slo_mfu_floor.*ROADMAP A8"):
        ServeConfig(slo_mfu_floor=0.5)
    for kw in (dict(slo_availability_target=1.0),
               dict(slo_latency_target_ms=-1), dict(slo_window_s=0)):
        with pytest.raises(ValueError):
            ServeConfig(**kw)
