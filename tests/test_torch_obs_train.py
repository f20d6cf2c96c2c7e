"""The port's training telemetry on the CPU, against the JAX package's.

- ``TrainTelemetry`` of both packages fed the same host floats (steps,
  compile, memory, cost, health, the SLO and incident knobs) write the
  same JSONL records, apart from the timestamps (``t_wall``, ``t_mono``),
  the ``process`` field and the metrics' help texts in the summary (each
  package describes its own source: XLA's analyses or the CUDA
  allocator and the counted first call);
- the port's loop with a stubbed step (the port's form of
  ``tests/test_obs.py::test_loop_data_wait_and_no_per_step_sync``): the
  metrics are transfer-counting spies, and telemetry, health, tracing and
  the cost count on add no host read and keep the Logger's flush cadence;
  the stream carries the JAX loop's events and span tree, and
  ``scripts/telemetry_summary.py`` folds it as it folds JAX's;
- the loader's ``sample_quarantine`` and the checkpoint manager's
  ``ckpt_fallback`` / ``ckpt_commit`` events reach the run's stream;
- no telemetry directory: no files.
"""

import importlib.util
import json
import os.path as osp
import time

import numpy as np
import pytest
import torch

from raft_tpu.obs import cost as jcost
from raft_tpu.obs.train import TrainTelemetry as JaxTrainTelemetry
from raft_tpu_torch import chaos
from raft_tpu_torch.config import RAFTConfig, TrainConfig
from raft_tpu_torch.obs import cost
from raft_tpu_torch.obs import trace
from raft_tpu_torch.obs.train import TrainTelemetry
from raft_tpu_torch.train import loop as loop_mod
from raft_tpu_torch.train.state import TrainState

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
DROP = ("t_wall", "t_mono", "process")


def _records(directory):
    (f,) = directory.glob("telemetry-p*.jsonl")
    return [json.loads(line) for line in f.read_text().splitlines()]


def _strip(rec):
    out = {k: v for k, v in rec.items() if k not in DROP}
    if out.get("event") == "metrics_summary":
        out["metrics"] = {k: {kk: vv for kk, vv in m.items() if kk != "help"}
                          for k, m in out["metrics"].items()}
    return out


def _drive(cls, directory, cost_mod, peaks_kind):
    t = cls(str(directory), batch_size=8, num_devices=2,
            image_size=(32, 48))
    t.start(start_step=3, num_steps=10)
    t.record_compile(3, 1.25, key=("train_step", (32, 48), 8))
    t.record_hbm({"peak_hbm_gb": 1.5, "args_gb": 0.1, "output_gb": 0.0,
                  "temp_gb": 1.4})
    t.record_cost(cost_mod.ProgramCost(
        program="train_step", flops=4.0e12, bytes=2.0e11,
        pairs_per_call=4.0, source="xla", device_kind=peaks_kind))
    for i, (st, qw) in enumerate([(0.5, 0.01), (0.25, 0.125),
                                  (0.3, 0.0)]):
        t.record_step(3 + i, st, qw, h2d_s=0.002 * i, prep_s=0.001)
    t.record_health(5, param_norm=12.5, update_ratio=1e-3,
                    epe_iter=[2.0, 1.5, 1.25], loss_iter=[1.0, 0.5, 0.25],
                    nonfinite_new=1, nonfinite_total=3)
    t.sink.emit("sample_quarantine", index=4)
    t.record_health(6, param_norm=12.6, update_ratio=2e-3)
    t.close()
    return _records(directory)


@pytest.mark.parametrize("knobs", [
    {},
    {"RAFT_SLO_GOODPUT": "0.99", "RAFT_SLO_MFU_FLOOR": "0.1",
     "RAFT_SLO_WINDOW_S": "60", "RAFT_INCIDENTS": "1",
     "RAFT_TELEMETRY_HBM": "1"}], ids=["plain", "slo_incidents"])
def test_train_telemetry_records_match_jax(tmp_path, monkeypatch, knobs):
    """The same calls on both classes give the same records (the TPU kind
    on both, whose peak both tables hold, so MFU and the MFU floor are
    live)."""
    for k in ("RAFT_TELEMETRY_DIR", "RAFT_SLO_GOODPUT", "RAFT_SLO_MFU_FLOOR",
              "RAFT_INCIDENTS", "RAFT_TELEMETRY_COST"):
        monkeypatch.delenv(k, raising=False)
    for k, v in knobs.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(jcost, "peak_spec",
                        lambda kind=None: jcost.PEAK_SPECS["v5e"])
    monkeypatch.setattr(cost, "peak_spec",
                        lambda kind=None: cost.PEAK_SPECS["v5e"])
    got = _drive(TrainTelemetry, tmp_path / "port", cost, "TPU v5e")
    want = _drive(JaxTrainTelemetry, tmp_path / "jax", jcost, "TPU v5e")
    assert [r["event"] for r in got] == [r["event"] for r in want]
    for g, w in zip(got, want):
        if g["event"].startswith("incident_"):
            g, w = dict(g), dict(w)
            g.pop("incident_id"), w.pop("incident_id")
        assert _strip(g) == _strip(w), g["event"]
    events = {r["event"] for r in got}
    assert {"run_config", "compile", "hbm_usage", "cost_report",
            "train_step", "train_health", "metrics_summary"} <= events
    summary = got[-1]["metrics"]
    assert "raft_cost_mfu" in summary and "raft_train_peak_hbm_gb" in summary
    if knobs:
        assert "incident_open" in events
        assert "raft_slo_budget_remaining" in summary


class _SyncSpy:
    """A device-tensor stand-in that counts host reads."""

    calls = 0

    def __init__(self, v):
        self._v = v

    def __array__(self, dtype=None, copy=None):
        _SyncSpy.calls += 1
        return np.asarray(self._v, dtype or np.float32)


_STUB_METRIC_KEYS = ("loss", "param_norm", "update_ratio", "nonfinite",
                     "epe_iter")


def _stub_loop(monkeypatch, seen_cfgs=None):
    """A step that bumps the counter, sleeps a little and returns spies;
    ``seen_cfgs`` collects the model configurations the state is built
    from."""

    def fake_init_state(model_cfg, cfg, device="cpu", state_dict=None):
        if seen_cfgs is not None:
            seen_cfgs.append(model_cfg)
        model = torch.nn.Linear(2, 2)
        return TrainState(
            model=model, optimizer=torch.optim.SGD(model.parameters(), 0.1),
            schedule=lambda count: torch.tensor(1e-4, dtype=torch.float64),
            generator=torch.Generator().manual_seed(cfg.seed),
            nonfinite_steps=torch.zeros((), dtype=torch.int64))

    def fake_make_train_step(cfg, device="cpu", mesh=None):
        def step_fn(state, batch):
            time.sleep(0.002)
            metrics = {k: _SyncSpy([0.5, 0.25] if k == "epe_iter" else 1.0)
                       for k in _STUB_METRIC_KEYS}
            metrics["nonfinite"] = _SyncSpy(0.0)
            state.step += 1
            return state, metrics

        step_fn.graphs = False
        return step_fn

    monkeypatch.setattr(loop_mod, "init_state", fake_init_state)
    monkeypatch.setattr(loop_mod, "make_train_step", fake_make_train_step)


def _slow_batches(n, batch_size, hw, slow_steps=(), delay=0.06):
    H, W = hw
    rng = np.random.default_rng(0)
    for i in range(n):
        if i in slow_steps:
            time.sleep(delay)  # an input-bound step
        yield {"image1": rng.uniform(0, 255, (batch_size, H, W, 3)
                                     ).astype(np.float32),
               "image2": rng.uniform(0, 255, (batch_size, H, W, 3)
                                     ).astype(np.float32),
               "flow": np.zeros((batch_size, H, W, 2), np.float32),
               "valid": np.ones((batch_size, H, W), np.float32)}


def _load_summary_script():
    spec = importlib.util.spec_from_file_location(
        "telemetry_summary", osp.join(REPO, "scripts",
                                      "telemetry_summary.py"))
    ts = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ts)
    return ts


def test_loop_no_added_host_reads_and_stream(tmp_path, monkeypatch,
                                            capsys):
    """Telemetry (with health, tracing at rate 1, the cost count, the
    watchdog and the profiler window) adds no host read; the flush
    cadence is the same; the stream carries the JAX loop's events; the
    slow fetch before step 2 shows in its ``queue_wait_s``; and the JAX
    package's summary script folds it.  Serial pipeline, so the slow
    fetch lands on a known step.  A tuning registry written by the JAX
    package's ``save_entry`` for the run's key moves the knob and is
    stamped on ``run_config``, as the JAX loop stamps it."""
    from raft_tpu import tuning as jtuning

    seen_cfgs = []
    _stub_loop(monkeypatch, seen_cfgs)
    monkeypatch.delenv("RAFT_TELEMETRY_DIR", raising=False)
    monkeypatch.delenv("RAFT_TUNING", raising=False)
    reg = str(tmp_path / "tuning.json")
    key = jtuning.save_entry("train", (32, 32), 8, {"corr_block_size": 128},
                             path=reg, device="cpu")
    monkeypatch.setenv("RAFT_TUNING_REGISTRY", reg)
    tdir = tmp_path / "telemetry"

    def run(name, telemetry_dir, **kw):
        cfg = TrainConfig(name=name, num_steps=4, batch_size=8,
                          image_size=(32, 32), iters=2, val_freq=2,
                          log_freq=2, ckpt_dir=str(tmp_path / name),
                          device_prefetch=0, **kw)
        _SyncSpy.calls = 0
        try:
            loop_mod.train(RAFTConfig.small_model(), cfg,
                           _slow_batches(10, 8, (32, 32), slow_steps=(2,)),
                           device="cpu", telemetry_dir=telemetry_dir)
        finally:
            trace.reset_default_tracer()
        flushes = sum(1 for line in capsys.readouterr().out.splitlines()
                      if line.startswith("["))
        return _SyncSpy.calls, flushes

    off = run("off", None)
    on = run("on", str(tdir), trace_sample_rate=1.0, watchdog_timeout=60.0,
             profile_steps=(1, 2), forensic_keep=4)
    assert on == off == (4 * len(_STUB_METRIC_KEYS), 2)

    recs = _records(tdir)
    events = [r["event"] for r in recs]
    assert events[0] == "run_config" and events[-1] == "metrics_summary"
    assert recs[0]["tuned"] is True and recs[0]["tuning_key"] == key
    assert recs[0]["tuning_registry_hash"] == \
        jtuning.registry_file_hash(reg)
    assert [c.corr_block_size for c in seen_cfgs] == [128, 128]
    for ev in ("compile", "hbm_usage", "cost_report", "ckpt_commit"):
        assert ev in events, ev
    hbm = next(r for r in recs if r["event"] == "hbm_usage")
    assert hbm["peak_hbm"] == "unavailable"     # no allocator on the CPU
    steps = {r["step"]: r for r in recs if r["event"] == "train_step"}
    assert sorted(steps) == [0, 1, 2, 3]
    for r in steps.values():
        assert r["step_time_s"] >= r["queue_wait_s"] >= 0
        assert r["h2d_s"] >= 0 and r["prep_s"] >= 0
        assert r["pairs_per_sec_per_chip"] > 0
    assert steps[2]["queue_wait_s"] >= 0.04
    assert steps[3]["queue_wait_s"] < 0.04
    health = [r for r in recs if r["event"] == "train_health"]
    assert [r["step"] for r in health] == [1, 3]
    assert health[0]["param_norm"] == 1.0 and health[0]["epe_iter"] == [
        0.5, 0.25]
    spans = [r for r in recs if r["event"] == "trace_span"]
    roots = {r["trace_id"]: r for r in spans if r["parent_id"] is None}
    assert sorted(r["step"] for r in roots.values()) == [0, 1, 2, 3]
    kids = {}
    for r in spans:
        if r["parent_id"] is not None:
            kids.setdefault(r["trace_id"], set()).add(r["name"])
    assert all({"queue_wait", "prep", "h2d", "step_dispatch"} <= kids[t]
               for t in roots)
    step1 = next(t for t, r in roots.items() if r["step"] == 1)
    assert "ckpt_commit" in kids[step1]          # the save after step 1
    assert any("xprof" in r for r in spans)      # the profiler window
    assert list((tdir / "profile").glob("trace-1-2.json"))
    assert "stall" not in events

    ts = _load_summary_script()
    out = ts.summarize(*ts.last_run(ts.iter_records(str(tdir))), skip=2)
    assert out["metric"] == "train_throughput_custom_32x32_bf16_iters12"
    assert out["unit"] == "image-pairs/sec/chip" and out["value"] > 0
    assert out["config"]["steps_measured"] == 2
    assert 0 <= out["config"]["queue_wait_frac"] <= 1


def test_loop_telemetry_disabled_by_default(tmp_path, monkeypatch):
    _stub_loop(monkeypatch)
    monkeypatch.delenv("RAFT_TELEMETRY_DIR", raising=False)
    cfg = TrainConfig(name="t", num_steps=2, batch_size=8,
                      image_size=(32, 32), iters=2, val_freq=100,
                      log_freq=2, ckpt_dir=str(tmp_path / "ck"))
    state = loop_mod.train(RAFTConfig.small_model(), cfg,
                           _slow_batches(4, 8, (32, 32)), device="cpu")
    assert state.step == 2
    assert not list(tmp_path.glob("**/telemetry-*.jsonl"))


def test_loader_quarantine_and_checkpoint_fallback_events(tmp_path,
                                                          monkeypatch):
    """A sample that fails to read is quarantined into the run's stream
    (event + counter), and a resume past a torn step emits
    ``ckpt_fallback`` before the run's first step."""
    from raft_tpu_torch.data.datasets import ShardedLoader

    class _DS:
        name = "toy"

        def __len__(self):
            return 6

        def load(self, idx, rng):
            if idx == 2:
                raise OSError("truncated")
            return {"image1": np.full((8, 8, 3), idx, np.float32),
                    "image2": np.full((8, 8, 3), idx, np.float32),
                    "flow": np.zeros((8, 8, 2), np.float32),
                    "valid": np.ones((8, 8), np.float32)}

    _stub_loop(monkeypatch)
    monkeypatch.delenv("RAFT_TELEMETRY_DIR", raising=False)
    cfg = TrainConfig(name="q", num_steps=2, batch_size=2,
                      image_size=(8, 8), iters=2, val_freq=1, log_freq=2,
                      ckpt_dir=str(tmp_path / "ck"), device_prefetch=0)
    tdir = tmp_path / "tel"
    loop_mod.train(RAFTConfig.small_model(), cfg,
                   loader=ShardedLoader(_DS(), 2, seed=0, num_workers=1),
                   device="cpu", telemetry_dir=str(tdir))
    chaos.tear_files(str(tmp_path / "ck" / "q" / "2"))
    cfg3 = TrainConfig(**{**cfg.__dict__, "num_steps": 3})
    loop_mod.train(RAFTConfig.small_model(), cfg3,
                   loader=ShardedLoader(_DS(), 2, seed=0, num_workers=1),
                   device="cpu", telemetry_dir=str(tdir))
    recs = _records(tdir)
    events = [r["event"] for r in recs]
    q = [r for r in recs if r["event"] == "sample_quarantine"]
    assert q and q[0]["dataset"] == "toy" and "truncated" in q[0]["error"]
    second = len(events) - 1 - events[::-1].index("run_config")
    fb = events.index("ckpt_fallback")
    assert fb < second and recs[fb]["step"] == 2
    summary = [r for r in recs if r["event"] == "metrics_summary"][0]
    assert "raft_data_quarantined_total" in summary["metrics"]
