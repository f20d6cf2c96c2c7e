"""The port's serving engine on the CPU (twins of tests/test_serve_slots.py's
engine cases and of the JAX engine's contracts), small model, fp32, on
weights converted with ``convert.py``, ``device="cpu"``:

- request mode against ``make_eval_fn`` (rtol 1e-4, atol 1e-3; on the
  CPU the two run the same operations);
- slot mode bit for bit against request mode, one event a ``(bucket,
  lanes, program)`` in the ledger, and staggered arrivals (join and
  leave) bit for bit and run to run;
- per-request budgets and convergence retirement, with their events;
- ``device_err`` retried bit for bit; retries exhausted fail the active
  lanes, not the waiting ones;
- backpressure and ``QueueFullError``'s hints; the retry schedule (the
  exponential ladder, its jitter band, its deadline);
- ``Counters``, ``LatencyRecorder``, the metric registry and its
  Prometheus text against the JAX package's on the same events;
- ``ServeConfig``'s checks as JAX's, and each knob of a part not ported
  refused by name; the serve CLI's flags;
- an HTTP round trip, the structured 429, and ``/metrics`` /
  ``/v1/healthz`` / ``/v1/stats`` on an engine on the CPU;
- a CUDA error (or a pool reset that fails) crashing the engine instead
  of touching the device again, any other failure resetting the pool;
- request mode's resident budget: the least recently used ``(bucket,
  lanes)`` freed, captured anew when traffic returns, the same bits;
- ``GraphCache``'s key with resident arguments, and dropping by key.
"""

import dataclasses
import io
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from raft_tpu_torch import chaos
from raft_tpu_torch.chaos import (FaultPlan, InjectedDeviceError,
                                  is_transient_error)
from raft_tpu_torch.cli import serve as serve_cli
from raft_tpu_torch.config import RAFTConfig
from raft_tpu_torch.evaluate import make_eval_fn
from raft_tpu_torch.obs import MetricRegistry
from raft_tpu_torch.serve import (Counters, InferenceEngine, LatencyRecorder,
                                  QueueFullError, ServeConfig)
from raft_tpu_torch.serve.engine import UNPORTED_KNOBS
from raft_tpu_torch.utils.graphs import cache_key
from raft_tpu_torch.utils.profiling import CaptureCounter

from test_torch_fixtures import small_raft_variables

CFG = RAFTConfig.small_model()      # fp32: bit-comparable
ITERS = 3
SHAPE = (36, 52)                    # -> bucket (40, 56)
BUCKET = (40, 56)


@pytest.fixture(autouse=True)
def _isolated():
    """One torch thread, and no chaos plan leaks across tests."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    chaos.uninstall()
    yield
    chaos.uninstall()
    torch.set_num_threads(saved)


class _RecordingSink:
    def __init__(self):
        self.events = []

    def emit(self, event, step=None, **fields):
        self.events.append((event, fields))

    def of(self, event):
        return [f for e, f in self.events if e == event]


def _images(rng, hw=SHAPE):
    return tuple(rng.uniform(0, 255, hw + (3,)).astype(np.float32)
                 for _ in range(2))


@pytest.fixture(scope="module")
def sd():
    return small_raft_variables(0)[1]


def _engine(sd, **kw):
    sink = kw.pop("sink", None)
    budget = kw.pop("resident_budget_bytes", None)
    return InferenceEngine(sd, CFG, ServeConfig(iters=ITERS, **kw),
                           sink=sink, device="cpu",
                           resident_budget_bytes=budget)


@pytest.fixture(scope="module")
def request_flows(sd):
    """The oracle: four seeded pairs through the request-mode engine at
    batch 4."""
    torch.set_num_threads(1)
    rng = np.random.default_rng(11)
    pairs = [_images(rng) for _ in range(4)]
    eng = _engine(sd, max_batch=4, batch_sizes=(4,), max_wait_ms=50)
    with eng:
        flows = [f.result(timeout=120)
                 for f in [eng.submit(a, b) for a, b in pairs]]
    return pairs, flows, eng


def test_request_mode_matches_make_eval_fn(sd, request_flows):
    """The lockstep pipeline (enc, 3 x iter, up) against the test-mode
    forward of ``make_eval_fn`` on the same padded batch; the ledger
    holds one event for each of the three programs."""
    pairs, flows, eng = request_flows
    from raft_tpu_torch.ops.pad import InputPadder

    pad = InputPadder(SHAPE, target=BUCKET)
    im1 = np.stack([pad.pad_np(a) for a, _ in pairs])
    im2 = np.stack([pad.pad_np(b) for _, b in pairs])
    _, up = make_eval_fn(CFG, ITERS, device="cpu")(sd, im1, im2)
    for j, flow in enumerate(flows):
        assert flow.shape == SHAPE + (2,)
        np.testing.assert_allclose(flow, pad.unpad(up[j].numpy()),
                                   rtol=1e-4, atol=1e-3)
    assert eng.capture_counter.counts() == {
        (BUCKET, 4, p): 1 for p in ("enc", "iter", "up")}
    stats = eng.stats()
    assert stats["completed"] == 4 and stats["batching"] == "request"
    assert stats["device"] == "cpu"


def test_slot_parity_bitwise_and_ledger(sd, request_flows):
    """Early exit off, a full slot batch: every flow bit for bit the
    request-mode engine's; one event a program."""
    pairs, ref, _ = request_flows
    eng = _engine(sd, batching="slot", slots=4, max_wait_ms=50)
    with eng:
        got = [f.result(timeout=120)
               for f in [eng.submit(a, b) for a, b in pairs]]
        stats = eng.stats()
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(r, g)
    assert eng.capture_counter.counts() == {
        (BUCKET, 4, p): 1 for p in ("enc", "iter", "up")}
    assert stats["completed"] == 4
    assert stats["iters_used"]["p50"] == float(ITERS)
    assert stats["iters_used"]["count_total"] == 4
    assert stats["slot_steps"] >= ITERS and 0 < stats["occupancy"] <= 1


def test_slot_join_leave_determinism(sd, request_flows):
    """A request admitted into a fresh pool, then three joining while one
    is in flight: the request-mode bits, and the same bits on a rerun."""
    pairs, ref, _ = request_flows

    def staggered():
        eng = _engine(sd, batching="slot", slots=4)
        with eng:
            r0 = eng.submit(*pairs[0]).result(timeout=120)
            futs = [eng.submit(*p) for p in pairs[1:]]
            return [r0] + [f.result(timeout=120) for f in futs]

    a, b = staggered(), staggered()
    for got_a, got_b, r in zip(a, b, ref):
        np.testing.assert_array_equal(got_a, got_b)
        np.testing.assert_array_equal(got_a, r)


def test_slot_budget_and_convergence_retire(sd):
    """Per-request budgets (capped at ``iters``) and the convergence
    predicate retire lanes; ``serve_retire`` carries the iterations and
    ``converged``."""
    im1, im2 = _images(np.random.default_rng(5))
    sink = _RecordingSink()
    eng = _engine(sd, batching="slot", slots=2, sink=sink)
    with eng:
        with pytest.raises(ValueError, match="iters"):
            eng.submit(im1, im2, iters=0)
        assert eng.infer(im1, im2, iters=1, timeout=120).shape == \
            SHAPE + (2,)
        assert eng.infer(im1, im2, iters=99, timeout=120).shape == \
            SHAPE + (2,)
    retired = sink.of("serve_retire")
    assert [r["iters"] for r in retired] == [1, ITERS]
    assert all(r["converged"] is False for r in retired)
    sink2 = _RecordingSink()
    eng2 = _engine(sd, batching="slot", slots=2, early_exit_threshold=1e9,
                   sink=sink2)
    with eng2:
        flow = eng2.infer(im1, im2, timeout=120)
    assert np.isfinite(flow).all()
    (ev,) = sink2.of("serve_retire")
    assert ev["iters"] == 1 and ev["converged"] is True
    assert eng2.stats()["iters_used"]["p50"] == 1.0


def test_device_err_retried_bit_identically(sd):
    """An injected transient error on the second request's second
    iteration is retried; the result is bit for bit the clean one (the
    fault fires before the program runs, so the state is untouched)."""
    im1, im2 = _images(np.random.default_rng(6))
    sink = _RecordingSink()
    eng = _engine(sd, batching="slot", slots=1, device_retries=1,
                  retry_backoff_s=0.0, retry_jitter=0.0, sink=sink)
    with eng:
        clean = eng.infer(im1, im2, timeout=120)       # cycles 1..3
        chaos.install(FaultPlan.parse("device_err@batch=5"))
        faulted = eng.infer(im1, im2, timeout=120)     # cycles 4..6
        chaos.uninstall()
        stats = eng.stats()
    np.testing.assert_array_equal(clean, faulted)
    assert stats["retries"] == 1 and stats["completed"] == 2
    assert stats["failed_lanes"] == 0
    (ev,) = sink.of("serve_retry")
    assert ev["attempt"] == 1


def test_device_err_exhausted_fails_actives_not_waiters(sd):
    """Retries off: the fault fails the active lane; the waiting request
    is served from the reset pool, bit for bit an undisturbed run."""
    im1, im2 = _images(np.random.default_rng(7))
    sink = _RecordingSink()
    eng = _engine(sd, batching="slot", slots=1, device_retries=0, sink=sink)
    with eng:
        clean = eng.infer(im1, im2, timeout=120)
        chaos.install(FaultPlan.parse("device_err@batch=5"))
        doomed = eng.submit(im1, im2)
        survivor = eng.submit(im1, im2)
        with pytest.raises(InjectedDeviceError):
            doomed.result(timeout=120)
        out = survivor.result(timeout=120)
        chaos.uninstall()
        stats = eng.stats()
    np.testing.assert_array_equal(clean, out)
    assert stats["failed_lanes"] == 1 and stats["errors"] == 1
    assert stats["completed"] == 2
    assert len(sink.of("serve_iter_error")) == 1


CUDA_ERROR = "CUDA error: an illegal memory access was encountered"


@pytest.mark.parametrize("fault", ["cuda_error", "reset_fails", "other"])
def test_device_failure_resets_pool_or_crashes_engine(sd, fault):
    """An ``iter`` that fails fails the live lane.  A CUDA error (sticky:
    the device is unusable), or a pool reset that raises after another
    error, crashes the engine without touching the device again: the
    waiting request fails with it, ``health()`` is not ready, ``submit``
    refuses, and nothing stays pending.  Any other error resets the pool
    and the waiting request is served."""
    im1, im2 = _images(np.random.default_rng(12))
    eng = _engine(sd, batching="slot", slots=1, device_retries=0)
    err = (RuntimeError(CUDA_ERROR) if fault == "cuda_error"
           else InjectedDeviceError("flake") if fault == "reset_fails"
           else ValueError("a bug"))
    resets = []
    gate = threading.Event()
    with eng:
        clean = eng.infer(im1, im2, timeout=120)   # the programs exist
        progs = eng._sets[(BUCKET, 1)]
        iterate, reset = progs.iterate, progs.reset

        def failing_iterate(threshold):
            progs.iterate = iterate                # fails once
            raise err

        def watched_reset():
            resets.append(1)
            if fault == "reset_fails":
                raise RuntimeError(CUDA_ERROR)
            reset()

        progs.iterate, progs.reset = failing_iterate, watched_reset
        eng._device_pool.submit(gate.wait)   # both queue before a cycle
        try:
            live, waiting = eng.submit(im1, im2), eng.submit(im1, im2)
        finally:
            gate.set()
        with pytest.raises(type(err)):
            live.result(timeout=120)
        health = eng.health()
        if fault == "other":
            np.testing.assert_array_equal(waiting.result(timeout=120),
                                          clean)
            assert health["ready"] and not health["crashed"]
        else:
            with pytest.raises(RuntimeError, match="engine crashed"):
                waiting.result(timeout=120)
            health = eng.health()
            assert not health["ready"] and health["crashed"]
            assert health["pending"] == 0
            with pytest.raises(RuntimeError, match="engine crashed"):
                eng.submit(im1, im2)
    assert resets == ([] if fault == "cuda_error" else [1])
    assert eng.stats()["failed_lanes"] == 1


def test_request_mode_cuda_error_crashes_engine(sd):
    """Request mode: a CUDA error fails its batch and crashes the engine;
    the engine refuses after it."""
    im1, im2 = _images(np.random.default_rng(14))
    eng = _engine(sd, max_batch=1)

    def broken(*a):
        raise RuntimeError(CUDA_ERROR)

    with eng:
        eng._get_programs = broken
        with pytest.raises(RuntimeError, match="CUDA error"):
            eng.infer(im1, im2, timeout=120)
        assert eng.health()["crashed"]
        with pytest.raises(RuntimeError, match="engine crashed"):
            eng.submit(im1, im2)


def test_request_mode_device_err_retried(sd, request_flows):
    """Request mode retries the whole lockstep pipeline: the same bits."""
    pairs, ref, _ = request_flows
    eng = _engine(sd, max_batch=4, batch_sizes=(4,), max_wait_ms=50,
                  retry_backoff_s=0.0, retry_jitter=0.0)
    chaos.install(FaultPlan.parse("device_err@batch=1"))
    with eng:
        got = [f.result(timeout=120)
               for f in [eng.submit(a, b) for a, b in pairs]]
        assert eng.stats()["retries"] == 1
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(r, g)


def test_backpressure_and_queue_full_hints(sd):
    """Beyond ``max_queue`` in flight, ``submit`` raises at once with the
    depth and the retry hint, counted as a rejection; the queue drains
    and accepts again."""
    im1, im2 = _images(np.random.default_rng(8))
    eng = _engine(sd, max_queue=2, max_batch=1, retry_after_s=2.5)
    gate = threading.Event()
    with eng:
        eng._device_pool.submit(gate.wait)          # hold the device worker
        try:
            futs = [eng.submit(im1, im2), eng.submit(im1, im2)]
            with pytest.raises(QueueFullError) as ei:
                eng.submit(im1, im2)
            assert ei.value.queue_depth == 2
            assert ei.value.retry_after_s == 2.5
            assert "max_queue=2" in str(ei.value)
            assert eng.stats()["rejected"] == 1
            assert eng.health()["pending"] == 2
        finally:
            gate.set()
        for f in futs:
            assert f.result(timeout=120).shape == SHAPE + (2,)
        assert eng.infer(im1, im2, timeout=120).shape == SHAPE + (2,)
    with pytest.raises(RuntimeError, match="engine stopped"):
        eng.submit(im1, im2)


def test_retry_schedule_jitter_and_deadline(sd, monkeypatch):
    """``_retry_call``: attempt k sleeps ``min(base * 2^(k-1), max)`` times
    a factor in ``1 +- jitter``; not transient raises at once; the
    deadline stops the ladder."""
    sleeps, main = [], threading.main_thread()
    # record this thread's sleeps only (other threads may sleep meanwhile)
    monkeypatch.setattr(time, "sleep", lambda t: sleeps.append(t)
                        if threading.current_thread() is main else None)
    sink = _RecordingSink()
    eng = _engine(sd, device_retries=4, retry_backoff_s=0.1,
                  retry_backoff_max_s=0.3, retry_jitter=0.25,
                  retry_deadline_s=100.0, sink=sink)
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) <= 4:
            raise InjectedDeviceError("flake")
        return "ok"

    assert eng._retry_call((8, 8), 1, flaky) == "ok"
    bases = [0.1, 0.2, 0.3, 0.3]
    assert len(sleeps) == 4
    for s, b in zip(sleeps, bases):
        assert 0.75 * b <= s <= 1.25 * b, (s, b)
    assert [e["backoff_s"] for e in sink.of("serve_retry")] == \
        [round(s, 6) for s in sleeps]
    assert eng.stats()["retries"] == 4

    def bug():
        raise ValueError("deterministic")

    with pytest.raises(ValueError):
        eng._retry_call((8, 8), 2, bug)
    eng2 = _engine(sd, device_retries=10, retry_backoff_s=1.0,
                   retry_backoff_max_s=2.0, retry_deadline_s=1.5,
                   sink=sink)
    sleeps.clear()

    def down():
        raise InjectedDeviceError("down")

    # attempt 1 sleeps 1.0 +- 25% <= 1.5; attempt 2's 2.0 +- 25% would end
    # past the deadline (sleep is patched, so no time passes)
    with pytest.raises(InjectedDeviceError):
        eng2._retry_call((8, 8), 3, down)
    assert len(sleeps) == 1
    (ev,) = sink.of("serve_retry_deadline")
    assert ev["attempt"] == 2


def test_is_transient_error():
    """Only an error that says so, or a timeout: a CUDA error is never
    transient in the port."""
    assert is_transient_error(InjectedDeviceError("x"))
    assert is_transient_error(TimeoutError())
    assert not is_transient_error(chaos.InjectedReplicaKill("x"))
    assert not is_transient_error(ConnectionResetError())
    assert not is_transient_error(
        RuntimeError("CUDA error: an illegal memory access UNAVAILABLE"))


def test_counters_and_latency_match_jax():
    """``Counters`` and ``LatencyRecorder`` on the same events as the JAX
    package's: the same snapshots (uptime aside), the same registry text
    (the port's exposition is a copy)."""
    from raft_tpu.obs import MetricRegistry as JaxRegistry
    from raft_tpu.serve import stats as jstats

    regs = MetricRegistry(), JaxRegistry()
    pairs = [(Counters(registry=regs[0]),
              LatencyRecorder(64, registry=regs[0])),
             (jstats.Counters(registry=regs[1]),
              jstats.LatencyRecorder(64, registry=regs[1]))]
    for c, lat in pairs:
        c.mark_started()
        c.add_batch(real=3, padded=1, failed=False)
        c.add_batch(real=2, padded=0, failed=True)
        c.add_rejected(2)
        c.add_retry()
        c.add_slot_step(3, 4)
        c.add_completed(3)
        c.add_failed_lanes(1)
        for v in (0.01, 0.02, 0.5):
            lat.record(v)
    (c, lat), (jc, jlat) = pairs
    got, want = c.snapshot(1), jc.snapshot(1)
    for snap in (got, want):
        for k in ("uptime_s", "pairs_per_sec", "pairs_per_sec_per_chip"):
            snap.pop(k)
    assert got == want
    assert lat.snapshot() == jlat.snapshot()
    strip = lambda t: "\n".join(  # noqa: E731
        ln for ln in t.splitlines()
        if "uptime" not in ln and not ln.startswith("# HELP"))
    assert strip(regs[0].render_prometheus()) == \
        strip(regs[1].render_prometheus())


def test_capture_counter_registry_mirror():
    """As JAX's ``CompileCounter``: each event also counts in the
    registry, labeled by ``labeler``."""
    reg = MetricRegistry()
    cc = CaptureCounter(registry=reg, metric="raft_serve_compiles_total",
                        labeler=lambda k: {"program": k[2]})
    cc.record(((8, 8), 2, "enc"))
    cc.record(((8, 8), 2, "enc"))
    assert cc.counts() == {((8, 8), 2, "enc"): 2}
    assert 'raft_serve_compiles_total{program="enc"} 2' in \
        reg.render_prometheus()


def test_serve_config_checks_match_jax():
    """Each bad value JAX's ``ServeConfig`` refuses, the port's refuses;
    each knob of a part not ported raises by name at any value but its
    default, naming its ROADMAP item."""
    from raft_tpu.serve import ServeConfig as JaxServeConfig

    assert {f.name for f in dataclasses.fields(ServeConfig)} == \
        {f.name for f in dataclasses.fields(JaxServeConfig)}
    bad = [dict(stream_ttl_s=0), dict(stream_warm_iters=0),
           dict(max_sessions=0), dict(max_batch=0), dict(max_queue=0),
           dict(batching="x"), dict(slots=0),
           dict(early_exit_threshold=-1), dict(max_wait_ms=-1),
           dict(stall_timeout_s=-1), dict(device_retries=-1),
           dict(retry_backoff_max_s=0.01), dict(retry_deadline_s=0),
           dict(retry_jitter=1.0), dict(buckets=((44, 50),)),
           dict(quality_sample_rate=1.5), dict(quality_drift_window=1),
           dict(slo_availability_target=1.0), dict(slo_window_s=0)]
    for kw in bad:
        with pytest.raises(ValueError):
            JaxServeConfig(**kw)
        with pytest.raises(ValueError):
            ServeConfig(**kw)
    assert ServeConfig(max_batch=6).resolved_batch_sizes() == \
        JaxServeConfig(max_batch=6).resolved_batch_sizes() == (1, 2, 4, 6)
    values = {"aot_dir": "d", "quality_cycle": True, "incidents": True}
    for knob, item in UNPORTED_KNOBS.items():
        default = ServeConfig.__dataclass_fields__[knob].default
        value = values.get(knob, (default or 0) + 1)
        with pytest.raises(ValueError, match=f"{knob}.*ROADMAP "
                                             f"{item.split()[0]}"):
            ServeConfig(**{knob: value})


def test_serve_cli_flags(tmp_path):
    """Every flag of the JAX serve CLI parses; each of a part not ported
    stops the CLI with its ROADMAP item; the rest build a ServeConfig,
    and the fleet flags (``--replicas``, ``--remote``, ``--autoscale``,
    ``--aot-dir``, ``--hedge-timeout-s``) a fleet and its router that
    serve on the CPU."""
    from raft_tpu.cli import serve as jcli
    from raft_tpu_torch.serve import FlowRouter, RemoteReplica

    jax_dests = set(vars(jcli.parse_args([])))
    assert jax_dests <= set(vars(serve_cli.parse_args([])))
    values = {"trace_sample_rate": ["0.5"]}
    assert set(values) == set(serve_cli.UNPORTED)
    for flag, rest in values.items():
        item = serve_cli.UNPORTED[flag][1].split()[0]
        with pytest.raises(SystemExit, match=f"ROADMAP {item}"):
            serve_cli.main([f"--{flag.replace('_', '-')}", *rest,
                            "--random-init", "--device", "cpu"])
    with pytest.raises(SystemExit, match="exactly one"):
        serve_cli.main(["--device", "cpu"])
    args = serve_cli.parse_args(
        ["--random-init", "--small", "--device", "cpu", "--precision",
         "fp32", "--batching", "slot", "--slots", "2", "--buckets",
         "40x56", "--max-queue", "3", "--telemetry-dir", str(tmp_path)])
    eng = serve_cli.build_engine(args)
    assert eng.cfg.slots == 2 and eng.cfg.buckets == ((40, 56),)
    assert eng.cfg.max_queue == 3 and eng.device.type == "cpu"
    args = serve_cli.parse_args(
        ["--random-init", "--small", "--device", "cpu", "--precision",
         "fp32", "--iters", "2", "--quality-sample-rate", "0.5",
         "--quality-cycle"])
    eng = serve_cli.build_engine(args)
    assert eng.cfg.quality_sample_rate == 0.5 and eng.cfg.quality_cycle
    args = serve_cli.parse_args(
        ["--random-init", "--small", "--device", "cpu", "--precision",
         "fp32", "--iters", "2", "--batch-sizes", "1", "--max-batch", "1",
         "--replicas", "2", "--remote", "127.0.0.1:1", "--autoscale",
         "2:3", "--aot-dir", str(tmp_path / "aot"), "--hedge-timeout-s",
         "0.5", "--warmup", "36x52"])
    assert serve_cli.fleet_mode(args)
    router, fleet = serve_cli.start_service(args)
    try:
        assert isinstance(router, FlowRouter)
        assert router.cfg.hedge_timeout_s == 0.5
        local = [r for r in fleet.replicas
                 if not isinstance(r, RemoteReplica)]
        assert [r.name for r in local] == ["r0", "r1"]
        assert isinstance(fleet.replicas[-1], RemoteReplica)
        assert fleet.replicas[-1].address == "127.0.0.1:1"
        assert (fleet.fleet_cfg.autoscale_min,
                fleet.fleet_cfg.autoscale_max) == (2, 3)
        assert fleet.aot_dir == str(tmp_path / "aot")
        assert local[1].engine.aot_info["ok"]
        flow = local[0].engine.infer(*(np.zeros((36, 52, 3), np.float32)
                                       for _ in range(2)), timeout=60)
        assert flow.shape == (36, 52, 2)
    finally:
        fleet.stop()
    with pytest.raises(SystemExit, match="MIN:MAX"):
        serve_cli.build_fleet(serve_cli.parse_args(
            ["--random-init", "--device", "cpu", "--autoscale", "2"]))


def _post(url, body):
    return urllib.request.urlopen(urllib.request.Request(
        url, data=body, method="POST"), timeout=120)


def _npz(**arrays):
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def test_http_round_trip_and_structured_429(sd, request_flows):
    """The HTTP front end on an engine on the CPU: ``/v1/flow`` returns
    the engine's flow bit for bit, a full queue answers 429 with its
    ``Retry-After`` and JSON hints, bad bodies 400, ``/metrics``,
    ``/v1/healthz`` and ``/v1/stats`` answer, ``/debug/profile`` names its
    ROADMAP item."""
    pairs, ref, _ = request_flows
    eng = _engine(sd, max_batch=4, batch_sizes=(4,), max_queue=1,
                  max_wait_ms=0)
    server = serve_cli.make_server(eng, "127.0.0.1", 0)
    url = "http://127.0.0.1:%d" % server.server_address[1]
    t = threading.Thread(target=server.serve_forever, daemon=True)
    gate = threading.Event()
    with eng:
        t.start()
        try:
            r = _post(url + "/v1/flow", _npz(image1=pairs[0][0],
                                             image2=pairs[0][1]))
            flow = np.load(io.BytesIO(r.read()))["flow"]
            np.testing.assert_array_equal(flow, ref[0])
            while eng.health()["pending"]:      # the batch's bookkeeping
                time.sleep(0.01)
            eng._device_pool.submit(gate.wait)
            held = eng.submit(*pairs[1])
            with pytest.raises(urllib.error.HTTPError) as ei:
                _post(url + "/v1/flow", _npz(image1=pairs[2][0],
                                             image2=pairs[2][1]))
            assert ei.value.code == 429
            assert ei.value.headers["Retry-After"] == "1"
            body = json.loads(ei.value.read())
            assert body["queue_depth"] == 1 and body["retry_after_s"] == 1.0
            gate.set()
            held.result(timeout=120)
            with pytest.raises(urllib.error.HTTPError) as ei:
                _post(url + "/v1/flow", b"not an npz")
            assert ei.value.code == 400
            with pytest.raises(urllib.error.HTTPError) as ei:
                _post(url + "/debug/profile", b"")
            assert ei.value.code == 501 and b"ROADMAP A8" in ei.value.read()
            text = urllib.request.urlopen(url + "/metrics").read().decode()
            assert "raft_serve_requests_rejected_total 1" in text
            assert 'raft_serve_compiles_total{batch="4"' in text
            assert urllib.request.urlopen(url + "/v1/healthz").read() == b"ok"
            stats = json.loads(urllib.request.urlopen(url + "/v1/stats")
                               .read())
            assert stats["completed"] == 2 and stats["rejected"] == 1
        finally:
            gate.set()
            server.shutdown()
            server.server_close()


def test_request_mode_frees_least_recent_state_past_budget(sd):
    """With a budget of one set's state, a fourth bucket frees the least
    recently used one (not the one served since); traffic back at the
    freed bucket captures its programs again (two events on its keys)
    and gets the same bits."""
    from raft_tpu_torch.serve.slots import STATE_KEYS, _leaves, state_template

    a, b, c = (40, 56), (48, 64), (40, 64)     # buckets of these shapes
    budget = sum(t.numel() * t.element_size() for t in
                 _leaves(state_template(CFG, 1, a), STATE_KEYS))
    rng = np.random.default_rng(13)
    im = {hw: _images(rng, hw) for hw in (a, b, c)}
    sink = _RecordingSink()
    eng = _engine(sd, max_batch=1, resident_budget_bytes=budget, sink=sink)
    with eng:
        first_b = None
        for hw in (a, b, a, c):
            out = eng.infer(*im[hw], timeout=120)
            first_b = out if hw == b and first_b is None else first_b
        assert list(eng._sets) == [(a, 1), (c, 1)]
        (ev,) = sink.of("serve_state_evict")
        assert (ev["bucket"], ev["lanes"]) == ("48x64", 1)
        assert ev["budget_bytes"] == budget
        again = eng.infer(*im[b], timeout=120)
        counts = eng.capture_counter.counts()
    np.testing.assert_array_equal(again, first_b)
    assert counts[(b, 1, "enc")] == 2 and counts[(a, 1, "enc")] == 1
    assert eng.registry.counter(
        "raft_serve_state_evictions_total").value() == len(
        sink.of("serve_state_evict")) >= 2


def test_graph_cache_drop_by_caller_key():
    """``GraphCache.drop`` forgets the programs and eager counts whose
    caller key matches, and only those."""
    from raft_tpu_torch.utils.graphs import GraphCache

    cache = GraphCache()
    keys = [cache_key(("iter", (b, 8, "iter")), [torch.zeros(2)])
            for b in ((40, 56), (48, 64))]
    for k in keys:
        cache._programs[k] = object()
        cache._eager[k] = 1
    assert cache.drop(lambda k: k[1][:2] == ((40, 56), 8)) == 1
    assert list(cache._programs) == list(cache._eager) == keys[1:]


def test_graph_cache_keys_resident_by_address():
    """A graph's key holds the arguments' shapes and dtypes (not their
    addresses: they are copied in) and the resident tensors' addresses
    (the graph reads and writes them there)."""
    a, b = torch.zeros(2, 3), torch.ones(2, 3)
    r1, r2 = torch.zeros(4), torch.zeros(4)
    assert cache_key("k", [a]) == cache_key("k", [b])
    assert cache_key("k", [a], [r1]) == cache_key("k", [b], [r1])
    assert cache_key("k", [a], [r1]) != cache_key("k", [a], [r2])
    assert cache_key("k", [a]) != cache_key("k", [a.double()])
    assert cache_key("k", [a]) != cache_key("j", [a])
    r1.zero_()                                   # in place: same key
    assert cache_key("k", [a], [r1]) == cache_key("k", [b], [r1])
