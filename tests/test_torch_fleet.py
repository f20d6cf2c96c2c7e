"""The port's serving fleet on the CPU (twins of tests/test_fleet.py), small
model, fp32, ``device="cpu"``:

- the warm-start manifest (``serve/aot.py``): its fingerprint, its gates
  (a wrong fingerprint, a missing directory, a torn file), an engine that
  replays it capturing nothing on its request path, and a miss falling
  back to lazy capture;
- the repair of the shared device worker: two engines in one process,
  one under ``replica_slow``, the other's requests finishing well inside
  the slow time with its ``health()`` ready throughout;
- the router: failover classification, bucket affinity, the breaker,
  failover after ``replica_kill`` with no dropped request, hedging a
  straggler;
- the fleet: a wedged replica (``replica_hang``) restarted alone, rolling
  weight updates (an in-memory ``state_dict`` and a port checkpoint)
  behind the verify, canary and proxy gates, ``stop()`` racing an
  update's warm-up, and the end-to-end drill of the JAX package's
  ``scripts/serve_fleet_smoke.py``.

One module fixture warms one engine and writes the manifest every fleet
here replays; backoffs and polls are in milliseconds.
"""

import os
import shutil
import threading
import time

import numpy as np
import pytest
import torch

from raft_tpu_torch import chaos
from raft_tpu_torch.config import RAFTConfig, TrainConfig
from raft_tpu_torch.models.raft import RAFT
from raft_tpu_torch.serve import (FleetConfig, FlowRouter, InferenceEngine,
                                  QueueFullError, ReplicaFleet, RouterConfig,
                                  ServeConfig, WeightUpdateError)
from raft_tpu_torch.serve import aot as aot_mod
from raft_tpu_torch.serve.router import is_failover_error

CFG = RAFTConfig.small_model()      # fp32 on the CPU
ITERS = 2
SHAPE = (36, 52)                    # -> bucket (40, 56)
BUCKET = (40, 56)
KEYS = {(BUCKET, 2, p) for p in ("enc", "iter", "up")}


@pytest.fixture(autouse=True)
def _isolated():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    chaos.uninstall()
    yield
    chaos.uninstall()
    torch.set_num_threads(saved)


def _serve_cfg(**kw):
    base = dict(iters=ITERS, max_batch=2, batch_sizes=(2,), max_wait_ms=5,
                max_queue=64)
    base.update(kw)
    return ServeConfig(**base)


def _images(rng, h=SHAPE[0], w=SHAPE[1]):
    return (rng.uniform(0, 255, (h, w, 3)).astype(np.float32),
            rng.uniform(0, 255, (h, w, 3)).astype(np.float32))


def _wait_for(pred, timeout_s, what):
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        if pred():
            return
        time.sleep(0.01)
    raise AssertionError(f"timed out waiting for {what}")


def _seeded(seed):
    return {k: v.clone() for k, v in RAFT(CFG, seed=seed).state_dict()
            .items()}


@pytest.fixture(scope="module")
def state_dict():
    return _seeded(0)


@pytest.fixture(scope="module")
def aot_dir(state_dict, tmp_path_factory):
    """The file's one warm-up: an engine captures the (40, 56) x b2
    programs and writes the manifest."""
    d = str(tmp_path_factory.mktemp("aot"))
    eng = InferenceEngine(state_dict, CFG, _serve_cfg(), device="cpu")
    eng.start()
    try:
        eng.warmup([SHAPE])
        eng.export_aot(d)
    finally:
        eng.stop()
    return d


def _mk_fleet(state_dict, aot_dir, *, replicas=2, scfg=None, **fcfg_kw):
    kw = dict(replicas=replicas, aot_dir=aot_dir, warmup_shapes=(SHAPE,),
              auto_export_aot=False, restart_backoff_s=0.01,
              restart_backoff_max_s=0.05, health_poll_s=0.02)
    kw.update(fcfg_kw)
    return ReplicaFleet(state_dict, CFG, scfg or _serve_cfg(),
                        FleetConfig(**kw), device="cpu")


# ---------------------------------------------------------------------------
# the warm-start manifest
# ---------------------------------------------------------------------------


def test_model_fingerprint_sensitivity(state_dict):
    """The fingerprint moves with what changes the captured programs:
    iters, a leaf's shape or dtype, an added entry, the precision; not
    with the weights' values."""
    fp = aot_mod.model_fingerprint(CFG, state_dict, ITERS)
    assert fp == aot_mod.model_fingerprint(CFG, _seeded(3), ITERS)
    assert fp != aot_mod.model_fingerprint(CFG, state_dict, ITERS + 1)
    k = next(iter(state_dict))
    for changed in (dict(state_dict, **{k: state_dict[k][:1]}),
                    dict(state_dict, **{k: state_dict[k].double()}),
                    dict(state_dict, extra=torch.zeros(1))):
        assert fp != aot_mod.model_fingerprint(CFG, changed, ITERS)
    bf16 = RAFTConfig.small_model(compute_dtype="bfloat16")
    assert fp != aot_mod.model_fingerprint(bf16, state_dict, ITERS)


def test_manifest_gates_and_corruption(state_dict, aot_dir, tmp_path):
    """A good manifest round-trips; a wrong fingerprint, a missing
    directory and a torn file are each refused whole."""
    fp = aot_mod.model_fingerprint(CFG, state_dict, ITERS)
    assert set(aot_mod.read_manifest(aot_dir, fingerprint=fp)) == KEYS
    with pytest.raises(aot_mod.AOTImportError, match="fingerprint"):
        aot_mod.read_manifest(aot_dir, fingerprint="deadbeef")
    with pytest.raises(aot_mod.AOTImportError, match="no warm-start"):
        aot_mod.read_manifest(str(tmp_path / "nope"), fingerprint=fp)
    torn = tmp_path / "torn"
    shutil.copytree(aot_dir, torn)
    m = torn / aot_mod.MANIFEST
    m.write_bytes(m.read_bytes()[:60])
    with pytest.raises(aot_mod.AOTImportError, match="torn"):
        aot_mod.read_manifest(str(torn), fingerprint=fp)
    # a complete file whose keys were edited fails the checksum
    with open(os.path.join(aot_dir, aot_mod.MANIFEST), "rb") as f:
        m.write_bytes(f.read().replace(b'"lanes": 2', b'"lanes": 4'))
    with pytest.raises(aot_mod.AOTImportError, match="checksum"):
        aot_mod.read_manifest(str(torn), fingerprint=fp)


def test_engine_manifest_replay_zero_captures(state_dict, aot_dir):
    """An engine built with ``aot_dir`` captures the manifest's keys in
    ``start()``: its first request captures nothing."""
    eng = InferenceEngine(state_dict, CFG, _serve_cfg(aot_dir=aot_dir),
                          device="cpu")
    eng.start()
    try:
        assert eng.aot_info["ok"] is True and eng.aot_info["replayed"] == 3
        at_start = eng.capture_counter.counts()
        assert set(at_start) == KEYS
        flow = eng.infer(*_images(np.random.default_rng(1)), timeout=60)
        assert flow.shape == SHAPE + (2,) and np.isfinite(flow).all()
        assert eng.capture_counter.counts() == at_start
        assert eng.stats()["aot"]["replayed"] == 3
    finally:
        eng.stop()


def test_engine_manifest_miss_falls_back_to_lazy_capture(state_dict,
                                                         tmp_path):
    """A missing manifest is a warm-start miss, not a serve failure."""
    events = []

    class Sink:
        def emit(self, event, step=None, **fields):
            events.append(event)

    eng = InferenceEngine(state_dict, CFG,
                          _serve_cfg(aot_dir=str(tmp_path / "empty")),
                          sink=Sink(), device="cpu")
    eng.start()
    try:
        assert eng.aot_info["ok"] is False and "aot_import_error" in events
        assert eng.capture_counter.counts() == {}
        assert eng.infer(*_images(np.random.default_rng(1)),
                         timeout=60).shape == SHAPE + (2,)
        assert eng.capture_counter.counts() == {k: 1 for k in KEYS}
    finally:
        eng.stop()


# ---------------------------------------------------------------------------
# the repair: one straggling engine does not stall its siblings
# ---------------------------------------------------------------------------


def test_slow_engine_does_not_stall_its_sibling(state_dict, aot_dir):
    """Two engines share the device worker; ``replica_slow`` sleeps on the
    slow engine's own host thread, so the other's requests finish well
    inside the slow time and its ``health()`` stays ready throughout."""
    slow_s = 2.0
    cfg = _serve_cfg(aot_dir=aot_dir, chaos_slow_s=slow_s,
                     stall_timeout_s=0.3)
    slow = InferenceEngine(state_dict, CFG, cfg, device="cpu").start()
    fast = InferenceEngine(state_dict, CFG, cfg, device="cpu").start()
    try:
        rng = np.random.default_rng(2)
        chaos.install(chaos.FaultPlan.parse("replica_slow@batch=1"))
        t0 = time.perf_counter()
        held = slow.submit(*_images(rng))
        time.sleep(0.1)                  # the slow engine is asleep
        futs = [fast.submit(*_images(rng)) for _ in range(4)]
        ready = []
        while not all(f.done() for f in futs):
            ready.append(fast.health()["ready"])
            time.sleep(0.01)
        dt = time.perf_counter() - t0
        assert all(f.result().shape == SHAPE + (2,) for f in futs)
        assert dt < slow_s / 2, f"the sibling took {dt:.2f} s"
        assert all(ready) and not held.done()
        assert held.result(timeout=30).shape == SHAPE + (2,)
        assert time.perf_counter() - t0 >= slow_s
    finally:
        slow.stop()
        fast.stop()


# ---------------------------------------------------------------------------
# router
# ---------------------------------------------------------------------------


def test_failover_error_classification():
    from raft_tpu_torch.chaos import (InjectedReplicaKill,
                                      ReplicaWedgedInterrupt)

    assert is_failover_error(InjectedReplicaKill("kill"))
    assert is_failover_error(ReplicaWedgedInterrupt("wedge"))
    assert is_failover_error(RuntimeError("engine stopped: ..."))
    assert is_failover_error(RuntimeError("engine crashed: reason"))
    assert not is_failover_error(ValueError("bad shapes"))
    assert not is_failover_error(QueueFullError("full"))


def test_router_affinity_fallback_and_breaker(state_dict, aot_dir):
    """The bucket's affine replica gets the traffic; exclusion or an open
    breaker reroutes; the breaker closes after its cooldown."""
    fleet = _mk_fleet(state_dict, aot_dir).start()
    try:
        router = FlowRouter(fleet, RouterConfig(breaker_threshold=1,
                                                breaker_cooldown_s=0.2))
        affine = router._pick(BUCKET, set())
        other = next(r for r in fleet.replicas if r is not affine)
        assert router._pick(BUCKET, set()) is affine
        assert router._pick(BUCKET, {affine.name}) is other
        affine.note_failure(1, 0.2)
        assert affine.breaker_open()
        assert router._pick(BUCKET, set()) is other
        time.sleep(0.25)
        assert router._pick(BUCKET, set()) is affine
        assert router._pick(BUCKET, {affine.name, other.name}) is None
        rng = np.random.default_rng(3)
        for _ in range(3):
            router.infer(*_images(rng), timeout=60)
        assert router.router_stats()["requests_by_replica"] == {
            affine.name: 3}
    finally:
        fleet.stop()


def test_kill_failover_no_dropped_requests(state_dict, aot_dir):
    """``replica_kill`` mid-load fails the victim's batch over to the
    sibling; every accepted future resolves, none is dropped, and the
    restarted victim captures nothing on its first request."""
    fleet = _mk_fleet(state_dict, aot_dir).start()
    try:
        router = FlowRouter(fleet, RouterConfig())
        chaos.install(chaos.FaultPlan.parse("replica_kill@batch=2"))
        rng = np.random.default_rng(4)
        futs = []
        for _ in range(8):
            futs.append(router.submit(*_images(rng)))
            time.sleep(0.01)
        assert all(f.result(timeout=60).shape == SHAPE + (2,)
                   for f in futs)
        rstats = router.router_stats()
        assert rstats["dropped_total"] == 0
        assert rstats["failovers_total"] >= 1
        _wait_for(lambda: sum(r.restarts for r in fleet.replicas) == 1
                  and all(r.state == "ready" for r in fleet.replicas),
                  30, "the supervised restart")
        victim = next(r for r in fleet.replicas if r.restarts)
        assert victim.generation == 2 and victim.engine.aot_info["ok"]
        before = victim.engine.capture_counter.counts()
        flow = victim.engine.infer(*_images(rng), timeout=60)
        assert flow.shape == SHAPE + (2,)
        assert victim.engine.capture_counter.counts() == before
        assert 'reason="crash"' in fleet.metrics_text()
    finally:
        fleet.stop()


def test_hang_restarts_only_the_wedged_replica(state_dict, aot_dir):
    """A wedge (``replica_hang``) never raises on its own: the stall
    turns the wedged replica not ready, the supervisor restarts it and
    only it, the interrupted batch fails over, and the sibling serves
    throughout."""
    scfg = _serve_cfg(stall_timeout_s=0.3, chaos_hang_max_s=20.0)
    fleet = _mk_fleet(state_dict, aot_dir, scfg=scfg).start()
    try:
        router = FlowRouter(fleet, RouterConfig())
        chaos.install(chaos.FaultPlan.parse("replica_hang@batch=1"))
        rng = np.random.default_rng(5)
        futs = [router.submit(*_images(rng)) for _ in range(2)]
        assert all(f.result(timeout=30).shape == SHAPE + (2,)
                   for f in futs)
        _wait_for(lambda: sum(r.restarts for r in fleet.replicas) == 1
                  and all(r.state == "ready" for r in fleet.replicas),
                  30, "the stall-triggered restart")
        assert sorted(r.restarts for r in fleet.replicas) == [0, 1]
        assert 'reason="stall"' in fleet.metrics_text()
        assert router.router_stats()["dropped_total"] == 0
    finally:
        fleet.stop()


def test_restart_stop_error_names_the_replica(state_dict, aot_dir,
                                              tmp_path):
    """An old engine whose ``stop`` raises during the supervised restart
    gives JAX's ``fleet_restart_stop_error`` with the replica and the
    error, and the restart goes on to a fresh engine."""
    from raft_tpu_torch.obs import EventSink

    events = []
    sink = EventSink(str(tmp_path))
    sink.add_observer(events.append)
    kw = dict(replicas=1, aot_dir=aot_dir, warmup_shapes=(SHAPE,),
              auto_export_aot=False, restart_backoff_s=0.01,
              restart_backoff_max_s=0.05, health_poll_s=0.02)
    fleet = ReplicaFleet(state_dict, CFG, _serve_cfg(), FleetConfig(**kw),
                         sink=sink, device="cpu").start()
    try:
        [victim] = fleet.replicas
        eng = victim.engine
        real_stop = eng.stop

        def stop(*a, **k):
            real_stop(*a, **k)
            raise RuntimeError("teardown refused")

        eng.stop = stop
        chaos.install(chaos.FaultPlan.parse("replica_kill@batch=1"))
        with pytest.raises(Exception):
            eng.infer(*_images(np.random.default_rng(6)), timeout=30)
        _wait_for(lambda: victim.restarts == 1 and victim.state == "ready",
                  30, "the supervised restart")
        assert victim.engine is not eng
    finally:
        fleet.stop()
    errs = [e for e in events if e["event"].endswith("stop_error")]
    assert [(e["event"], e["replica"], e["error"]) for e in errs] == [
        ("fleet_restart_stop_error", victim.name, "teardown refused")]


def test_hedge_covers_straggler(state_dict, aot_dir):
    """``replica_slow`` makes the primary a straggler; the hedge to the
    sibling answers long before it."""
    slow_s = 1.5
    fleet = _mk_fleet(state_dict, aot_dir,
                      scfg=_serve_cfg(chaos_slow_s=slow_s)).start()
    try:
        router = FlowRouter(fleet, RouterConfig(hedge_timeout_s=0.1))
        chaos.install(chaos.FaultPlan.parse("replica_slow@batch=1"))
        t0 = time.perf_counter()
        flow = router.infer(*_images(np.random.default_rng(6)), timeout=30)
        dt = time.perf_counter() - t0
        assert flow.shape == SHAPE + (2,)
        assert dt < slow_s / 2, f"the hedge did not cover the straggler"
        rstats = router.router_stats()
        assert rstats["hedges_total"] == 1
        assert rstats["hedge_wins_total"] == 1
        assert rstats["dropped_total"] == 0
    finally:
        fleet.stop(drain=False)


# ---------------------------------------------------------------------------
# rolling weight updates, fleet lifecycle
# ---------------------------------------------------------------------------


def _checkpoint(sd, path):
    """A port training-run directory holding ``sd`` as its step 1."""
    from raft_tpu_torch.train.checkpoint import CheckpointManager
    from raft_tpu_torch.train.step import init_state

    state = init_state(CFG, TrainConfig(), device="cpu", state_dict=sd)
    mgr = CheckpointManager(str(path))
    mgr.save(1, state)
    mgr.close()
    return str(path)


def test_rolling_update_flips_and_gates(state_dict, aot_dir, tmp_path):
    """A verified checkpoint flips every replica, each new engine
    capturing nothing on its request path, and the fleet then serves a
    fresh engine's bits; a torn copy, NaN weights and a missing
    directory are refused with the version unchanged."""
    fleet = _mk_fleet(state_dict, aot_dir).start()
    try:
        router = FlowRouter(fleet, RouterConfig())
        im1, im2 = _images(np.random.default_rng(7))
        before = router.infer(im1, im2, timeout=60)
        new_sd = _seeded(9)
        run = _checkpoint(new_sd, tmp_path / "run")
        torn = tmp_path / "torn"
        shutil.copytree(run, torn)
        chaos.tear_files(str(torn / "1"))
        with pytest.raises(WeightUpdateError, match="verify-ckpt"):
            fleet.update_weights(str(torn))
        assert fleet.weights_version == 1

        report = fleet.update_weights(run)
        assert report["ok"] and sorted(report["flipped"]) == ["r0", "r1"]
        assert report["provenance"]["verified"]
        assert fleet.weights_version == 2
        counts = {r.name: r.engine.capture_counter.counts()
                  for r in fleet.replicas}
        after = router.infer(im1, im2, timeout=60)
        assert {r.name: r.engine.capture_counter.counts()
                for r in fleet.replicas} == counts
        fresh = InferenceEngine(new_sd, CFG, _serve_cfg(),
                                device="cpu").start()
        try:
            assert np.array_equal(after, fresh.infer(im1, im2, timeout=60))
        finally:
            fresh.stop()
        assert not np.allclose(after, before)

        poisoned = {k: torch.full_like(v, float("nan"))
                    for k, v in new_sd.items()}
        with pytest.raises(WeightUpdateError, match="canary"):
            fleet.update_weights(poisoned)
        with pytest.raises(WeightUpdateError, match="not found"):
            fleet.update_weights(str(tmp_path / "nonexistent"))
        assert fleet.weights_version == 2 and fleet.health()["ready"]
    finally:
        fleet.stop()


def test_update_weights_from_weight_file(state_dict, aot_dir, tmp_path):
    """A ``.pth`` the port wrote (``torch.save`` of a ``state_dict``, the
    file ``serve --model`` serves) flips every replica, and the fleet
    then serves the bits of an engine built from that file; a torn copy
    of it is refused before any flip, the version and the flows
    unchanged."""
    from raft_tpu_torch.convert import load_state_dict_file

    new_sd = _seeded(11)
    weights = tmp_path / "weights.pth"
    torch.save(new_sd, weights)
    torn = tmp_path / "torn.pth"
    shutil.copy(weights, torn)
    with open(torn, "r+b") as f:
        f.truncate(os.path.getsize(torn) // 2)
    fleet = _mk_fleet(state_dict, aot_dir).start()
    try:
        router = FlowRouter(fleet, RouterConfig())
        im1, im2 = _images(np.random.default_rng(8))
        before = router.infer(im1, im2, timeout=60)
        with pytest.raises(WeightUpdateError, match="failed to load"):
            fleet.update_weights(str(torn))
        assert fleet.weights_version == 1
        assert np.array_equal(router.infer(im1, im2, timeout=60), before)

        report = fleet.update_weights(str(weights))
        assert report["ok"] and sorted(report["flipped"]) == ["r0", "r1"]
        assert report["provenance"] == {"kind": "file",
                                        "path": str(weights)}
        assert fleet.weights_version == 2
        after = router.infer(im1, im2, timeout=60)
        fresh = InferenceEngine(load_state_dict_file(str(weights), CFG),
                                CFG, _serve_cfg(), device="cpu").start()
        try:
            assert np.array_equal(after, fresh.infer(im1, im2, timeout=60))
        finally:
            fresh.stop()
        assert not np.allclose(after, before)
    finally:
        fleet.stop()


def test_rolling_update_under_load_fails_nothing(state_dict, aot_dir):
    """Clients keep a closed loop running until ``update_weights``
    returns; least-loaded placement keeps both replicas busy, so each
    flip finds requests in flight on the old engine.  Those drain, the
    loop's requests that span each flip all answer, and none fails."""
    flips = []

    class Sink:
        def emit(self, event, step=None, **fields):
            if event == "fleet_replica_flip":
                flips.append((time.perf_counter(), fields))

    fleet = ReplicaFleet(state_dict, CFG, _serve_cfg(), FleetConfig(
        replicas=2, aot_dir=aot_dir, warmup_shapes=(SHAPE,),
        auto_export_aot=False, health_poll_s=0.02), sink=Sink(),
        device="cpu").start()
    try:
        router = FlowRouter(fleet, RouterConfig(affinity_spill=0.0))
        done, recs, errs = threading.Event(), [], []

        def client(seed):
            rng = np.random.default_rng(seed)
            while not done.is_set():
                t = time.perf_counter()
                try:
                    router.infer(*_images(rng), timeout=60)
                except Exception as e:   # noqa: BLE001 (asserted below)
                    errs.append(repr(e))
                recs.append((t, time.perf_counter()))

        threads = [threading.Thread(target=client, args=(s,))
                   for s in range(4)]
        for t in threads:
            t.start()
        _wait_for(lambda: len(recs) >= 4, 30, "the loop")
        try:
            report = fleet.update_weights(_seeded(9))
        finally:
            done.set()
            for t in threads:
                t.join()
        assert sorted(report["flipped"]) == ["r0", "r1"] and not errs
        assert sorted(f["replica"] for _, f in flips) == ["r0", "r1"]
        for t_flip, f in flips:
            assert f["in_flight"] >= 1, f
            assert any(s < t_flip < e for s, e in recs), f
        rstats = router.router_stats()
        assert rstats["dropped_total"] == 0
        assert rstats["failovers_total"] == 0    # the old engines drained
    finally:
        fleet.stop()


def test_scrambled_weights_refused_by_proxy_canary(state_dict, aot_dir):
    """Finite but wild weights (every parameter x25) pass the shape and
    finiteness canary and are refused at the golden-batch proxy gate; the
    fleet keeps serving the old weights."""
    scrambled = {k: v * 25.0 for k, v in state_dict.items()}
    fleet = _mk_fleet(state_dict, aot_dir).start()
    try:
        router = FlowRouter(fleet, RouterConfig())
        im1, im2 = _images(np.random.default_rng(8))
        before = router.infer(im1, im2, timeout=60)
        with pytest.raises(WeightUpdateError, match="proxy"):
            fleet.update_weights(scrambled)
        assert fleet.weights_version == 1
        assert np.array_equal(router.infer(im1, im2, timeout=60), before)
        assert fleet.health()["ready"]
    finally:
        fleet.stop()


def test_fleet_stop_during_update_warmup_joins_cleanly(state_dict,
                                                      aot_dir):
    """``stop()`` racing an update's canary joins: the warming engine is
    stopped, the update fails with ``WeightUpdateError``, no flip."""
    fleet = _mk_fleet(state_dict, aot_dir).start()
    gate, entered = threading.Event(), threading.Event()
    real_canary = fleet._canary

    def blocking_canary(warming):
        entered.set()
        gate.wait(timeout=30)
        return real_canary(warming)

    fleet._canary = blocking_canary
    outcome = {}

    def update():
        try:
            outcome["report"] = fleet.update_weights(dict(state_dict))
        except BaseException as e:  # noqa: BLE001 (asserted below)
            outcome["error"] = e

    t = threading.Thread(target=update)
    t.start()
    assert entered.wait(timeout=30)
    warming = fleet._warming
    assert warming is not None
    t0 = time.perf_counter()
    fleet.stop(drain=True)
    assert time.perf_counter() - t0 < 30
    gate.set()
    t.join(timeout=30)
    assert not t.is_alive()
    assert isinstance(outcome.get("error"), WeightUpdateError), outcome
    assert warming._stopped and fleet.weights_version == 1
    assert all(r.state == "stopped" for r in fleet.replicas)


def test_serve_fleet_drill(state_dict, tmp_path):
    """The JAX package's fleet drill, in one process: replica 0 writes
    the manifest and replica 1 replays it; an open loop under
    ``replica_kill`` loses no request; the victim restarts capturing
    nothing; a checkpoint rolls out; ``/metrics`` is labelled by
    replica."""
    fleet = ReplicaFleet(state_dict, CFG, _serve_cfg(), FleetConfig(
        replicas=2, aot_dir=str(tmp_path / "aot"), warmup_shapes=(SHAPE,),
        restart_backoff_s=0.01, restart_backoff_max_s=0.05,
        health_poll_s=0.02), device="cpu").start()
    try:
        r0, r1 = fleet.replicas
        assert r0.engine.aot_info["ok"] is False   # nothing to replay yet
        assert r1.engine.aot_info["ok"] is True
        assert set(r1.engine.capture_counter.counts()) == KEYS
        router = FlowRouter(fleet, RouterConfig())
        chaos.install(chaos.FaultPlan.parse("replica_kill@batch=3"))
        rng = np.random.default_rng(10)
        futs = [router.submit(*_images(rng)) for _ in range(10)]
        assert all(f.result(timeout=60).shape == SHAPE + (2,)
                   for f in futs)
        chaos.uninstall()
        _wait_for(lambda: sum(r.restarts for r in fleet.replicas) == 1
                  and all(r.state == "ready" for r in fleet.replicas),
                  30, "the restart")
        rstats = router.router_stats()
        assert rstats["dropped_total"] == 0 and rstats["failovers_total"]
        report = fleet.update_weights(_checkpoint(_seeded(5),
                                                  tmp_path / "run"))
        assert report["version"] == 2
        text = fleet.metrics_text()
        assert 'replica="r0"' in text and 'replica="r1"' in text
        assert "raft_fleet_weight_updates_total" in text
        assert fleet.stats()["fleet"]["restarts_total"] == 1
    finally:
        fleet.stop()
