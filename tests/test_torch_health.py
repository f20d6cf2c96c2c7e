"""The port's training-health layer on the CPU, against the JAX package's.

- the step's health taps: ``param_norm`` and ``update_ratio`` of one
  small-model step (64x64, batch 2, 2 iterations, fp32; 64x64 because of
  XLA:CPU's gradient at 48x64, ROADMAP C) against JAX's jitted
  ``make_train_step`` from the same weights, on a finite step: JAX's tap
  on a guarded non-finite step reports the norm of the rejected update
  (not finite), which the port's optimizer never forms, so there the
  port reports ``update_ratio`` 0 and leaves the parameters as they were;
- forensic bundles: a bundle the port writes is read by JAX's
  ``load_forensic_bundle`` and the other way round; the monitor's ring
  evicts the oldest batch; a flagged step's bundle, event and trace;
- the port's loop on a NaN batch writes a bundle with the rank's rows and
  the dropout generator's state, and leaves the parameters bit for bit;
- the stall watchdog fires, dumps, re-arms, pauses and resumes; a SIGQUIT
  dump lands in the stack file.
"""

import json
import os
import signal
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.config import RAFTConfig as JaxRAFTConfig
from raft_tpu.config import TrainConfig as JaxTrainConfig
from raft_tpu.models.raft import RAFT as JaxRAFT
from raft_tpu.obs import health as jhealth
from raft_tpu.train import optim as joptim
from raft_tpu.train.state import TrainState as JaxTrainState
from raft_tpu.train.step import make_train_step as jax_make_train_step
from raft_tpu_torch.config import RAFTConfig, TrainConfig
from raft_tpu_torch.obs import health, trace, watchdog
from raft_tpu_torch.obs.train import TrainTelemetry
from raft_tpu_torch.train import loop
from raft_tpu_torch.train.step import init_state, make_train_step

from test_torch_fixtures import small_raft_variables

STEP_KW = dict(lr=2e-4, num_steps=100, batch_size=2, image_size=(64, 64),
               iters=2)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the runner's workers share the cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _batch(seed=14, b=2, h=64, w=64):
    rng = np.random.default_rng(seed)
    return {"image1": rng.uniform(0, 255, (b, h, w, 3)).astype(np.float32),
            "image2": rng.uniform(0, 255, (b, h, w, 3)).astype(np.float32),
            "flow": (3 * rng.standard_normal((b, h, w, 2))).astype(
                np.float32),
            "valid": (rng.random((b, h, w)) > 0.1).astype(np.float32)}


def test_health_taps_match_jax_step():
    """``param_norm`` (rtol 1e-6: the same fp32 parameters, another
    summation order) and ``update_ratio`` against JAX's step.  The update
    ratio's bound, rtol 1e-3: Adam's first step moves every entry by about
    ``lr`` whatever its gradient's size, so entries whose gradient is
    within the gradient bound of ``test_torch_small.py`` of zero (about a
    fifth of them here) may move either way in either package; here the
    ratio is 2.4e-5 relative off JAX's."""
    variables, sd = small_raft_variables(0)
    jcfg = JaxTrainConfig(**STEP_KW)
    jmodel = JaxRAFT(JaxRAFTConfig.small_model(corr_impl="allpairs"))
    tx = joptim.make_optimizer(jcfg.lr, jcfg.num_steps, jcfg.wdecay,
                               jcfg.epsilon, jcfg.clip)
    jstate = JaxTrainState(step=jnp.asarray(0, jnp.int32),
                           params=variables["params"],
                           batch_stats=variables["batch_stats"],
                           opt_state=tx.init(variables["params"]),
                           nonfinite_steps=jnp.asarray(0, jnp.int32))
    jstep = jax_make_train_step(jmodel, tx, jcfg, donate=False)
    batch = _batch()
    _, jmet = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                    jax.random.PRNGKey(0))
    want_pn = float(jmet["param_norm"])
    want_ur = float(jmet["update_ratio"])
    assert np.isfinite(want_ur) and want_ur > 0

    cfg = TrainConfig(**STEP_KW)
    state = init_state(RAFTConfig.small_model(), cfg, device="cpu",
                       state_dict=sd)
    before = [p.detach().clone() for p in state.model.parameters()]
    pn = float(torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(p) for p in before])))
    state, met = make_train_step(cfg, device="cpu")(state, batch)
    np.testing.assert_allclose(float(met["param_norm"]), want_pn, rtol=1e-6)
    np.testing.assert_allclose(float(met["param_norm"]), pn, rtol=1e-6)
    delta = torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(p.detach() - b) for p, b in
         zip(state.model.parameters(), before)]))
    np.testing.assert_allclose(float(met["update_ratio"]),
                               float(delta) / (pn + 1e-12), rtol=1e-6)
    np.testing.assert_allclose(float(met["update_ratio"]), want_ur,
                               rtol=1e-3)

    # a guarded non-finite step: no update, so the ratio is 0
    bad = dict(batch, flow=np.full_like(batch["flow"], np.nan))
    kept = [p.detach().clone() for p in state.model.parameters()]
    state, met = make_train_step(cfg, device="cpu")(state, bad)
    assert float(met["nonfinite"]) == 1.0
    assert float(met["update_ratio"]) == 0.0
    assert np.isfinite(float(met["param_norm"]))
    assert all(torch.equal(a, b) for a, b in
               zip(kept, state.model.parameters()))


@pytest.mark.parametrize("captured", [True, False])
def test_bundles_cross_packages(tmp_path, captured):
    """Each package's writer, the other's reader: the same batch arrays
    and meta."""
    rng = np.random.default_rng(3)
    batch = ({k: rng.standard_normal((1, 4, 6, c)).astype(np.float32)
              for k, c in (("image1", 3), ("image2", 3), ("flow", 2))}
             if captured else None)
    meta = {"seed": 5, "metrics": {"loss": float("nan")}, "x": [1, 2]}
    p = health.write_forensic_bundle(str(tmp_path / "port"), 12, batch,
                                     meta)
    assert os.path.basename(p) == "step00000012.npz"
    q = jhealth.write_forensic_bundle(str(tmp_path / "jax"), 12, batch,
                                      meta)
    for path in (p, q):
        for load in (jhealth.load_forensic_bundle,
                     health.load_forensic_bundle):
            got, m = load(path)
            assert m["batch_captured"] is captured and m["step"] == 12
            assert m["seed"] == 5 and m["x"] == [1, 2]
            if captured:
                assert sorted(got) == sorted(batch)
                for k in batch:
                    np.testing.assert_array_equal(got[k], batch[k])
            else:
                assert got is None
    assert health.forensic_bundle_path("d", 3, rank=1) == os.path.join(
        "d", "step00000003-rank1.npz")


def test_monitor_ring_bundle_event_and_late_trace(tmp_path):
    """A flagged step in the ring gets a bundle with its batch and
    generator state, a ``nonfinite_step`` event and its dropped trace
    back; a step evicted from the ring gets ``batch_captured: false``."""
    telem = TrainTelemetry(str(tmp_path / "tel"), batch_size=2,
                           num_devices=1, image_size=(4, 6))
    tracer = trace.configure(sample_rate=1e-9, seed=0, sink=telem.sink)
    try:
        mon = health.HealthMonitor(telem, forensics_dir=str(
            tmp_path / "tel" / "forensics"), seed=9, keep=2, rank=None)
        for s in range(4):
            sp = tracer.start_trace("train_step", step=s)
            sp.end()
            mon.note_batch(s, {"image1": np.full((1, 2), s, np.float32)},
                           bytes([s, 255]))
        assert [e[0] for e in mon._ring] == [2, 3]
        per_step = [{"loss": np.float32(1.0), "nonfinite": np.float32(
            1.0 if s in (1, 3) else 0.0), "param_norm": np.float32(2.0),
            "update_ratio": np.float32(0.0),
            "epe_iter": np.asarray([1.0, 0.5], np.float32)}
            for s in range(4)]
        mon.observe_flush(0, {}, per_step)
        telem.close()
    finally:
        trace.reset_default_tracer()
    assert mon.nonfinite_total == 2
    b3, m3 = health.load_forensic_bundle(mon.bundles[1])
    assert m3["batch_captured"] and b3["image1"][0, 0] == 3
    assert m3["rng"]["generator_state"] == bytes([3, 255]).hex()
    assert m3["rng"]["seed"] == 9 and m3["rng"]["step"] == 3
    b1, m1 = health.load_forensic_bundle(mon.bundles[0])
    assert b1 is None and not m1["batch_captured"]
    (f,) = (tmp_path / "tel").glob("telemetry-p*.jsonl")
    recs = [json.loads(line) for line in f.read_text().splitlines()]
    events = [r["event"] for r in recs]
    assert events.count("nonfinite_step") == 2
    hrec = next(r for r in recs if r["event"] == "train_health")
    assert hrec["nonfinite_in_interval"] == 2 and hrec["step"] == 3
    roots = {r["step"] for r in recs if r["event"] == "trace_span"
             and r["name"] == "train_step"}
    assert roots == {1, 3}   # the flagged steps' traces, kept late


def test_loop_nan_batch_bundle_and_bit_identical_params(tmp_path,
                                                        monkeypatch):
    """The port's loop (small model, 32x48, fp32) with step 1's flow NaN:
    one bundle of the batch that step consumed, a ``nonfinite_step``
    event, and the parameters after step 1 those after step 0."""
    monkeypatch.delenv("RAFT_TELEMETRY_DIR", raising=False)
    batches = [_batch(s, 2, 32, 48) for s in range(3)]
    batches[1]["flow"][0, 0, 0, 0] = np.nan
    seen = []

    def grab(sd):
        seen.append({k: v.clone() for k, v in sd.items()})
        return {}

    cfg = TrainConfig(name="nan", lr=2e-4, num_steps=3, batch_size=2,
                      image_size=(32, 48), iters=2, val_freq=1, log_freq=3,
                      ckpt_dir=str(tmp_path / "ck"), device_prefetch=1,
                      forensic_keep=4)
    tdir = tmp_path / "tel"
    loop.train(RAFTConfig.small_model(), cfg, iter(batches),
               validators={"grab": grab}, device="cpu",
               telemetry_dir=str(tdir))
    assert all(torch.equal(seen[0][k], seen[1][k]) for k in seen[0])
    assert not all(torch.equal(seen[1][k], seen[2][k]) for k in seen[1])
    (path,) = (tdir / "forensics").glob("*.npz")
    assert path.name == "step00000001.npz"
    got, meta = jhealth.load_forensic_bundle(str(path))
    np.testing.assert_array_equal(got["flow"], batches[1]["flow"])
    assert meta["rng"]["generator_state"] is not None
    gen = torch.Generator().manual_seed(cfg.seed)
    assert bytes.fromhex(meta["rng"]["generator_state"]) == \
        gen.get_state().numpy().tobytes()   # no dropout draw yet
    assert meta["train_cfg"]["forensic_keep"] == 4
    (f,) = tdir.glob("telemetry-p*.jsonl")
    recs = [json.loads(line) for line in f.read_text().splitlines()]
    ev = [r for r in recs if r["event"] == "nonfinite_step"]
    assert len(ev) == 1 and ev[0]["step"] == 1 and ev[0]["batch_captured"]
    hrec = [r for r in recs if r["event"] == "train_health"]
    assert hrec[-1]["nonfinite_steps_total"] == 1
    assert len(hrec[-1]["epe_iter"]) == 2


class _Sink:
    def __init__(self):
        self.recs = []

    def emit(self, event, **fields):
        self.recs.append(dict(fields, event=event))

    def flush(self):
        pass


def test_watchdog_fires_dumps_rearms_and_pauses(tmp_path):
    sink = _Sink()
    dump = str(tmp_path / "stacks-p0.txt")
    wd = watchdog.StallWatchdog(0.15, sink=sink, dump_path=dump,
                                recent_records=lambda: [{"step": 4}],
                                poll_s=0.01)
    wd.start()
    try:
        wd.beat(4)
        deadline = time.monotonic() + 5
        while wd.stall_count < 1 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert wd.stall_count == 1
        time.sleep(0.3)
        assert wd.stall_count == 1         # one stall, one fire
        (rec,) = sink.recs
        assert rec["event"] == "stall" and rec["step"] == 4
        assert rec["recent"] == [{"step": 4}] and rec["stacks"] == dump
        text = open(dump).read()
        assert "no heartbeat" in text and "_run" in text
        wd.beat(5)                         # re-armed by a new heartbeat
        wd.pause()
        time.sleep(0.4)
        assert wd.stall_count == 1         # paused: no fire
        wd.resume()
        deadline = time.monotonic() + 5
        while wd.stall_count < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert wd.stall_count == 2 and sink.recs[-1]["step"] == 5
    finally:
        wd.stop()
    with pytest.raises(ValueError):
        watchdog.StallWatchdog(0.0)


def test_stack_dump_path_and_sigquit(tmp_path):
    assert watchdog.stack_dump_path(None) is None
    path = watchdog.stack_dump_path(str(tmp_path))
    assert path == str(tmp_path / "stacks-p0.txt")
    assert watchdog.install_sigquit_dump(path) == path
    try:
        os.kill(os.getpid(), signal.SIGQUIT)
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline and not (
                os.path.exists(path) and os.path.getsize(path) > 0):
            time.sleep(0.01)
        assert "test_stack_dump_path_and_sigquit" in open(path).read()
    finally:
        import faulthandler

        faulthandler.unregister(signal.SIGQUIT)
    assert threading.main_thread().is_alive()
