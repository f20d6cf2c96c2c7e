"""The port's multi-host fabric on the CPU (twins of tests/test_remote.py):
the ``RemoteEngine`` facade over the npz wire protocol (loopback bit for
bit), the network-error taxonomy and its retry-or-failover
classification, the ``serve.remote`` chaos seam, the partition -> heal
-> rejoin state machine, per-replica spill capacity in the router, the
``heal=`` grammar, and the fabric drill (partition, rejoin, one
autoscaler grow and one scale-down migrating a session).  Across the
packages, the port's client against the JAX package's HTTP server and
the JAX client against the port's, each returning that server's
engine's flow.

One port engine behind one loopback server serves the wire tests.
"""

import http.client
import socket
import threading
import time
import zlib

import numpy as np
import pytest
import torch

from raft_tpu_torch import chaos
from raft_tpu_torch.chaos import is_transient_error
from raft_tpu_torch.cli.serve import make_server
from raft_tpu_torch.config import RAFTConfig
from raft_tpu_torch.obs import MetricRegistry
from raft_tpu_torch.serve import (FleetConfig, FlowRouter, InferenceEngine,
                                  QueueFullError, RemoteConfig, RemoteEngine,
                                  RemoteNetworkError, RemoteProtocolError,
                                  RemoteReplica, ReplicaFleet, RouterConfig,
                                  ServeConfig, classify_network_error)
from raft_tpu_torch.serve.remote import (RemoteDisconnectedError,
                                         RemoteRefusedError,
                                         RemoteResetError,
                                         RemoteTimeoutError,
                                         RemoteUnavailableError)
from raft_tpu_torch.serve.router import is_failover_error

from test_torch_fixtures import small_raft_variables

CFG = RAFTConfig.small_model()
ITERS = 2
SHAPE = (36, 52)                # -> bucket (40, 56)


def _images(rng, h=SHAPE[0], w=SHAPE[1]):
    return (rng.uniform(0, 255, (h, w, 3)).astype(np.float32),
            rng.uniform(0, 255, (h, w, 3)).astype(np.float32))


class _ListSink:
    def __init__(self):
        self.records = []

    def emit(self, event, step=None, **fields):
        self.records.append(dict(event=event, **fields))

    def of(self, name):
        return [r for r in self.records if r["event"] == name]


@pytest.fixture(autouse=True)
def _isolated():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    chaos.uninstall()
    yield
    chaos.uninstall()
    torch.set_num_threads(saved)


def _serve(engine):
    server = make_server(engine, "127.0.0.1", 0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, f"127.0.0.1:{server.server_address[1]}"


@pytest.fixture(scope="module")
def served():
    """A port engine behind a loopback server (``max_queue`` 8)."""
    _, sd = small_raft_variables(0)
    eng = InferenceEngine(sd, CFG, ServeConfig(
        iters=ITERS, max_batch=2, batch_sizes=(2,), max_wait_ms=5,
        max_queue=8), device="cpu").start()
    eng.warmup([SHAPE])
    server, addr = _serve(eng)
    yield eng, addr
    server.shutdown()
    eng.stop(drain=False)


def _remote(addr, **kw):
    base = dict(connect_timeout_s=1.0, request_timeout_s=60.0,
                health_timeout_s=1.0)
    base.update(kw)
    return RemoteEngine(addr, RemoteConfig(**base))


def _wait_for(pred, timeout_s, what):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.01)
    raise AssertionError(f"timed out waiting for {what}")


# ---------------------------------------------------------------------------
# the facade over the wire, and across the packages
# ---------------------------------------------------------------------------


def test_loopback_bitwise_parity(served):
    eng, addr = served
    im1, im2 = _images(np.random.default_rng(0))
    remote = _remote(addr)
    try:
        got = remote.infer(im1, im2, timeout=60)
        want = eng.infer(im1, im2, timeout=60)
        assert got.dtype == np.float32 and got.shape == SHAPE + (2,)
        assert np.array_equal(got, want)
        h = remote.health()
        assert h["ready"] and h["remote"] == addr
        assert remote.queue_capacity() == 8
        st = remote.stats()
        assert st["remote"] == addr and st["pending_client"] == 0
        assert st["max_queue"] == 8
    finally:
        remote.stop()


def test_port_client_against_jax_server(served):
    """The port's ``RemoteEngine`` against the JAX package's HTTP server
    fronting a JAX engine on the same weights: the JAX engine's flow, bit
    for bit, and the structured errors of its protocol."""
    from raft_tpu.cli.serve import make_server as jax_make_server
    from raft_tpu.config import RAFTConfig as JaxRAFTConfig
    from raft_tpu.serve import InferenceEngine as JaxEngine
    from raft_tpu.serve import ServeConfig as JaxServeConfig

    variables, _ = small_raft_variables(0)
    jeng = JaxEngine(variables, JaxRAFTConfig.small_model(), JaxServeConfig(
        iters=ITERS, max_batch=1, batch_sizes=(1,), max_wait_ms=1,
        max_queue=5)).start()
    server = jax_make_server(jeng, "127.0.0.1", 0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    remote = _remote(f"127.0.0.1:{server.server_address[1]}")
    try:
        im1, im2 = _images(np.random.default_rng(11))
        got = remote.infer(im1, im2, timeout=120)
        assert np.array_equal(got, jeng.infer(im1, im2, timeout=120))
        assert remote.health()["ready"] and remote.queue_capacity() == 5
        with pytest.raises(ValueError, match="unknown session"):
            remote.stream_close("never-opened")
    finally:
        remote.stop()
        server.shutdown()
        jeng.stop(drain=False)


def test_jax_client_against_port_server(served):
    """The JAX package's ``RemoteEngine`` against the port's server: the
    port engine's flow, bit for bit, and its health and capacity."""
    from raft_tpu.serve import RemoteConfig as JaxRemoteConfig
    from raft_tpu.serve import RemoteEngine as JaxRemoteEngine

    eng, addr = served
    remote = JaxRemoteEngine(addr, JaxRemoteConfig(
        connect_timeout_s=1.0, request_timeout_s=60.0))
    try:
        im1, im2 = _images(np.random.default_rng(12))
        got = remote.infer(im1, im2, timeout=60)
        assert np.array_equal(got, eng.infer(im1, im2, timeout=60))
        assert remote.health()["ready"] and remote.queue_capacity() == 8
    finally:
        remote.stop()


def test_submit_contract_mirrors_engine(served):
    _, addr = served
    im1, im2 = _images(np.random.default_rng(1))
    remote = _remote(addr, max_queue=2)
    try:
        with pytest.raises(ValueError, match="matching"):
            remote.submit(im1, im2[:-4])
        with remote._pending_lock:
            remote._pending = 2
        with pytest.raises(QueueFullError):
            remote.submit(im1, im2)
        with remote._pending_lock:
            remote._pending = 0
        with pytest.raises(ValueError, match="unknown session"):
            remote.stream_close("never-opened")
    finally:
        remote.stop()
    with pytest.raises(RuntimeError, match="engine stopped"):
        remote.submit(im1, im2)


# ---------------------------------------------------------------------------
# the taxonomy
# ---------------------------------------------------------------------------


def test_network_taxonomy_failover_classification():
    for exc in (ConnectionRefusedError("refused"),
                ConnectionResetError("reset"), socket.timeout("deadline"),
                http.client.RemoteDisconnected("gone"),
                RemoteRefusedError("x"), RemoteResetError("x"),
                RemoteTimeoutError("x"), RemoteDisconnectedError("x"),
                RemoteUnavailableError("503"), RemoteNetworkError("x")):
        assert is_failover_error(exc), exc
    for exc in (QueueFullError("full"), ValueError("bad shape"),
                RemoteProtocolError("garbage")):
        assert not is_failover_error(exc), exc
    for exc in (socket.timeout("t"), TimeoutError("t"),
                RemoteTimeoutError("t")):
        assert is_transient_error(exc), exc
    for exc in (ConnectionRefusedError("r"),
                http.client.RemoteDisconnected("d"), RemoteRefusedError("x"),
                RemoteResetError("x"), RemoteDisconnectedError("x"),
                RemoteUnavailableError("x")):
        assert not is_transient_error(exc), exc


def test_classify_network_error_mapping():
    cases = [(http.client.RemoteDisconnected("x"), RemoteDisconnectedError),
             (ConnectionRefusedError("x"), RemoteRefusedError),
             (ConnectionResetError("x"), RemoteResetError),
             (BrokenPipeError("x"), RemoteResetError),
             (ConnectionAbortedError("x"), RemoteResetError),
             (socket.timeout("x"), RemoteTimeoutError),
             (TimeoutError("x"), RemoteTimeoutError),
             (OSError("x"), RemoteNetworkError)]
    for raw, want in cases:
        got = classify_network_error(raw, "h:1")
        assert type(got) is want and "h:1" in str(got), (raw, got)
    err = RemoteTimeoutError("already")
    assert classify_network_error(err, "h:1") is err


# ---------------------------------------------------------------------------
# the serve.remote chaos seam
# ---------------------------------------------------------------------------


def test_net_chaos_deterministic_and_replayable(served):
    """``net_refuse@step=1``: exactly the second wire operation fails,
    classified and counted; an identical plan replays it."""
    _, addr = served
    im1, im2 = _images(np.random.default_rng(3))
    for _ in range(2):
        sink = _ListSink()
        remote = RemoteEngine(addr, RemoteConfig(), sink=sink)
        chaos.install(chaos.FaultPlan.parse("net_refuse@step=1", seed=7))
        try:
            assert remote.infer(im1, im2, timeout=60).shape == SHAPE + (2,)
            with pytest.raises(RemoteRefusedError):
                remote.infer(im1, im2, timeout=60)
            assert remote.infer(im1, im2, timeout=60).shape == SHAPE + (2,)
        finally:
            chaos.uninstall()
            remote.stop()
        retries = sink.of("net_retry")
        assert len(retries) == 1 and retries[0]["kind"] == "refused"
        assert retries[0]["path"] == "/v1/flow"
        assert {dict(k).get("kind"): v
                for k, v in remote._net_errors.items()} == {"refused": 1}


def test_net_drop_is_mid_response_disconnect(served):
    """``net_drop``: the request reaches the server and runs there; the
    response never arrives (a failover-class disconnect)."""
    eng, addr = served
    im1, im2 = _images(np.random.default_rng(4))
    before = eng.stats()["completed"]
    remote = _remote(addr)
    chaos.install(chaos.FaultPlan.parse("net_drop@step=0", seed=0))
    try:
        with pytest.raises(RemoteDisconnectedError):
            remote.infer(im1, im2, timeout=60)
    finally:
        chaos.uninstall()
        remote.stop()
    _wait_for(lambda: eng.stats()["completed"] == before + 1, 30,
              "the dropped request to finish on the server")


def test_partition_heal_rejoin_generation_guard(served):
    _, addr = served
    sink = _ListSink()
    r = RemoteReplica(1, addr, RemoteConfig(
        connect_timeout_s=1.0, health_timeout_s=1.0, health_cache_s=0.0))
    r.start(sink=sink)
    try:
        assert r.eligible()
        gen0 = r.generation
        assert r.note_failure(threshold=1, cooldown_s=60.0)
        assert r.breaker_open() and not r.eligible()
        chaos.install(chaos.FaultPlan.parse(
            "net_partition@step=0,heal=3", seed=0))
        for _ in range(3):
            r.poll(sink)
            assert r.generation == gen0
        r.poll(sink)
        assert r.generation == gen0 + 1 and not r.breaker_open()
        chaos.uninstall()
        assert r.eligible()
        rejoins = sink.of("fleet_remote_rejoin")
        assert len(rejoins) == 1 and rejoins[0]["replica"] == "r1"
        assert rejoins[0]["generation"] == gen0 + 1
        r.poll(sink)
        assert len(sink.of("fleet_remote_rejoin")) == 1
    finally:
        chaos.uninstall()
        r.engine.stop()


def test_heal_grammar():
    plan = chaos.FaultPlan.parse("net_partition@step=2,heal=5", seed=0)
    assert [plan.fires("net_partition") for _ in range(8)] == \
        [False, False, True, True, True, False, False, False]
    assert plan.counts() == {"net_partition": 3}
    with pytest.raises(chaos.ChaosSpecError, match="heal= needs"):
        chaos.FaultPlan.parse("net_partition@p=0.5,heal=5")
    with pytest.raises(chaos.ChaosSpecError, match="must be >"):
        chaos.FaultPlan.parse("net_partition@step=5,heal=5")


# ---------------------------------------------------------------------------
# the router's spill math with per-replica capacity
# ---------------------------------------------------------------------------


class _StubReplica:
    def __init__(self, index, pending, cap):
        self.index = index
        self.name = f"r{index}"
        self.state = "ready"
        self.generation = 1
        self._pending = pending
        self._cap = cap

    def eligible(self):
        return True

    def pending(self):
        return self._pending

    def queue_capacity(self):
        if isinstance(self._cap, Exception):
            raise self._cap
        return self._cap


class _StubFleet:
    def __init__(self, replicas, max_queue=64):
        self.replicas = replicas
        self.serve_cfg = ServeConfig(max_queue=max_queue)
        self.registry = MetricRegistry()


def test_spill_uses_per_replica_capacity():
    bucket = (40, 56)
    affine = zlib.crc32(repr(bucket).encode()) % 2
    small = _StubReplica(affine, pending=3, cap=4)
    other = _StubReplica(1 - affine, pending=2, cap=64)
    router = FlowRouter(_StubFleet(sorted([small, other],
                                          key=lambda r: r.index)),
                        RouterConfig())
    assert router._pick(bucket, set()) is other
    small._cap = None
    assert router._pick(bucket, set()) is small
    small._cap = RemoteTimeoutError("probe timed out")
    assert router._pick(bucket, set()) is small


# ---------------------------------------------------------------------------
# the fabric drill (the JAX package's scripts/fabric_smoke.py --tiny)
# ---------------------------------------------------------------------------


def test_fabric_drill(tmp_path):
    """One local replica and one remote host behind the router, the
    autoscaler on 1..2 locals.  A partition fails traffic over with no
    drop; the healed remote rejoins and takes its traffic back; queue
    pressure grows one replica; a stream on it survives the idle
    scale-down by replay onto a sibling."""
    shape, bucket = (52, 36), (56, 40)
    assert zlib.crc32(repr(bucket).encode()) % 2 == 1   # -> the remote
    assert zlib.crc32(repr(bucket).encode()) % 3 == 2   # -> the grown one
    _, sd = small_raft_variables(0)
    server_eng = InferenceEngine(sd, CFG, ServeConfig(
        iters=ITERS, batching="slot", slots=2, max_wait_ms=5, max_queue=8,
        stall_timeout_s=30.0), device="cpu").start()
    server_eng.warmup([shape])
    server, addr = _serve(server_eng)
    sink = _ListSink()
    fleet = ReplicaFleet(sd, CFG, ServeConfig(
        iters=ITERS, batching="slot", slots=2, max_wait_ms=5, max_queue=32,
        stall_timeout_s=30.0), FleetConfig(
        replicas=1, remote=(addr,), remote_cfg=RemoteConfig(
            connect_timeout_s=0.5, request_timeout_s=30.0,
            health_timeout_s=0.5, health_cache_s=0.25, max_queue=8),
        warmup_shapes=(shape,), restart_backoff_s=0.01,
        restart_backoff_max_s=0.05, health_poll_s=0.05, autoscale_min=1,
        autoscale_max=2, autoscale_interval_s=0.1,
        autoscale_up_queue_frac=0.25, autoscale_down_queue_frac=0.02,
        autoscale_up_consecutive=2, autoscale_down_consecutive=3,
        autoscale_cooldown_s=0.5, aot_dir=str(tmp_path / "aot")),
        sink=sink, device="cpu").start()
    router = FlowRouter(fleet, RouterConfig(breaker_threshold=2,
                                            breaker_cooldown_s=0.5),
                        sink=sink)
    rng = np.random.default_rng(0)

    def frame():
        return rng.uniform(0, 255, shape + (3,)).astype(np.float32)

    def autoscale():
        return fleet.stats()["fleet"]["autoscale"]

    try:
        r0, r1 = fleet.replicas
        assert r1.is_remote and r1.queue_capacity() == 8
        for _ in range(2):
            router.infer(frame(), frame(), timeout=60)
        assert router.router_stats()["requests_by_replica"]["r1"] >= 1
        gen0 = r1.generation
        # a fresh probe: for health_cache_s the placements below find the
        # remote ready, so requests (not a probe) meet the partition first
        r1.engine._health_cache = None
        assert r1.engine.health()["ready"]
        chaos.install(chaos.FaultPlan.parse(
            "net_partition@step=0,heal=16", seed=0))
        futs = [router.submit(frame(), frame()) for _ in range(6)]
        assert all(f.result(timeout=60).shape == shape + (2,)
                   for f in futs)
        rstats = router.router_stats()
        assert rstats["dropped_total"] == 0 and rstats["failovers_total"]
        assert sink.of("net_retry")
        _wait_for(lambda: r1.generation > gen0, 30, "the rejoin")
        chaos.uninstall()
        _wait_for(r1.eligible, 10, "the rejoined remote")
        before = router.router_stats()["requests_by_replica"]["r1"]
        router.infer(frame(), frame(), timeout=60)
        assert router.router_stats()["requests_by_replica"]["r1"] > before

        futs, deadline = [], time.time() + 30
        while autoscale()["ups"] < 1:
            assert time.time() < deadline, autoscale()
            for _ in range(4):
                try:
                    futs.append(router.submit(frame(), frame()))
                except QueueFullError:
                    time.sleep(0.01)
            if sum(not f.done() for f in futs) > 24:
                time.sleep(0.005)
        assert all(f.result(timeout=60).shape == shape + (2,)
                   for f in futs)
        assert [e["direction"] for e in sink.of("fleet_scale")] == ["up"]
        r2 = fleet.replicas[-1]
        assert r2.name == "r2" and r2.state == "ready"
        assert r2.engine.aot_info["ok"]

        assert router.stream_ingest("cam0", frame(), timeout=60)[
            "frame"] == 0
        assert router._streams["cam0"].replica == "r2"
        assert router.stream_ingest("cam0", frame(), timeout=60)[
            "flow"] is not None
        _wait_for(lambda: autoscale()["downs"] >= 1, 30, "the scale-down")
        down = sink.of("fleet_scale")[-1]
        assert down["replica"] == "r2" and down["moved"] == 1
        restart = sink.of("stream_restart")[-1]
        assert restart["reason"] == "scale_down"
        assert restart["from_replica"] == "r2"
        out = router.stream_ingest("cam0", frame(), timeout=60)
        assert out["frame"] == 2 and out["flow"] is not None
        assert router.stream_close("cam0")["restarts"] >= 1
        auto = autoscale()
        assert auto["ups"] == 1 and auto["downs"] == 1 and auto["flaps"] <= 1
        assert router.router_stats()["dropped_total"] == 0
        text = fleet.metrics_text()
        assert "raft_fleet_scale_events_total" in text
        assert "raft_remote_net_errors_total" in text
    finally:
        chaos.uninstall()
        fleet.stop(drain=False)
        server.shutdown()
        server_eng.stop(drain=False)
