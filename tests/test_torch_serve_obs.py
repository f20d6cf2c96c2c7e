"""The serving half of the port's observability on the CPU, held to the JAX
package's ``obs/trace.py`` span schema and the JAX engine's contracts
(the twins of ``tests/test_trace.py``, whose JAX engine drills need
XLA:CPU's executable loader): small model, fp32, ``device="cpu"``.

- Span trees: an engine in each batching mode records JAX's span names
  with JAX's attributes (``queue`` / ``pad`` / ``device``; slot mode's
  ``iter_step`` a cycle and the quality scores on ``device``) under the
  submitting thread's span, in one trace; a retried batch and a failed
  one tail-keep a trace the head coin dropped; rate 0 records nothing.
- The router: a failover and a hedge each make ONE tree (``route``, one
  ``attempt`` a dispatch, each attempt holding its replica's spans); a
  request through the router to a ``RemoteReplica`` in front of the
  port's HTTP server makes one tree across the wire, and the port's
  client continues its trace on the JAX package's server;
  ``scripts/trace_report.py`` (which imports neither package) reads the
  port's JSONL.
- ``POST /debug/profile``: 400 on a non-number, the clamp, 409 while a
  window runs, a Chrome trace under the sink's directory, and the
  ``xprof`` link on spans recorded meanwhile.
- The cost book: one counted entry a ``(bucket, lanes, program)`` with
  JAX's program names, ``stats()["cost"]``, and ``load_signals()["mfu"]``
  None on the CPU, whose peak is unknown.
- Incidents: an engine's ``incidents`` knob, and a fleet's kill cascade
  folding into ONE incident, whose bundle the port's ``incidents`` CLI
  prints as the JAX package's CLI does.
"""

import io
import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from raft_tpu_torch import chaos
from raft_tpu_torch.cli import serve as serve_cli
from raft_tpu_torch.config import RAFTConfig
from raft_tpu_torch.models.raft import RAFT
from raft_tpu_torch.obs import EventSink, trace
from raft_tpu_torch.serve import (FleetConfig, FlowRouter, InferenceEngine,
                                  ReplicaFleet, RouterConfig, ServeConfig)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = RAFTConfig.small_model()      # fp32 on the CPU
ITERS = 2
SHAPE = (36, 52)                    # -> bucket (40, 56)
BUCKET = (40, 56)

# The attributes the JAX engine records on each span
# (raft_tpu/serve/engine.py:1762-1770, 1987-1989, 2169, 2236-2241),
# besides the cost attrs ("flops", "bytes", "mfu" on a known peak).
JAX_ATTRS = {
    "request": {"queue": {"batch"}, "pad": {"real", "ballast"},
                "device": {"bucket", "batch", "retries"}},
    "slot": {"queue": {"batch", "slot"}, "pad": {"slot"},
             "iter_step": {"batch", "slot", "active"},
             "device": {"bucket", "iters", "warm", "retries"}},
}
SPAN_KEYS = {"event", "trace_id", "span_id", "parent_id", "name",
             "t_start", "t_start_mono", "dur_s", "status"}


class _ListSink:
    """EventSink-shaped sink capturing records in-process."""

    def __init__(self):
        self.records = []
        self.lock = threading.Lock()

    def emit(self, event, **fields):
        with self.lock:
            self.records.append(dict(event=event, **fields))

    def spans(self, name=None):
        with self.lock:
            return [r for r in self.records if r["event"] == trace.EVENT
                    and (name is None or r["name"] == name)]


@pytest.fixture(autouse=True)
def _isolated():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    chaos.uninstall()
    trace.reset_default_tracer()
    yield
    chaos.uninstall()
    trace.reset_default_tracer()
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def sd():
    return RAFT(CFG, seed=0).state_dict()


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


def _serve(service):
    server = serve_cli.make_server(service, "127.0.0.1", 0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, f"127.0.0.1:{server.server_address[1]}"


def _post(url, body=b"", headers=None):
    return urllib.request.urlopen(urllib.request.Request(
        url, data=body, method="POST", headers=headers or {}), timeout=120)


def _npz(**arrays):
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


# ---------------------------------------------------------------------------
# the engine's spans and cost book
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["request", "slot"])
def test_engine_span_tree_and_cost_book(sd, mode):
    """One traced request: the JAX span names and attributes under the
    submitting span, one trace id across the engine's threads, the cost
    attrs from the counted book, no MFU on the CPU; slot mode hangs the
    sampled quality scores on ``device``."""
    sink = _ListSink()
    tracer = trace.Tracer(sink=sink, sample_rate=1.0)
    eng = InferenceEngine(sd, CFG, _serve_cfg(
        batching=mode, slots=2, quality_sample_rate=1.0 if mode == "slot"
        else 0.0), device="cpu").start()
    try:
        root = tracer.start_trace("req")
        with trace.use_context(root):
            fut = eng.submit(*_images(np.random.default_rng(1)))
        assert trace.current() is None
        assert fut.result(timeout=60).shape == SHAPE + (2,)
        root.end()
        _wait_for(lambda: sink.spans("device"), 10, "the device span")
        stats, signals = eng.stats(), eng.load_signals()
    finally:
        eng.stop()
    spans = [r for r in sink.spans() if r["name"] != "req"]
    assert {r["trace_id"] for r in sink.spans()} == {root.trace_id}
    assert all(r["parent_id"] == root.span_id for r in spans)
    want = JAX_ATTRS[mode]
    counts = {}
    for r in spans:
        counts[r["name"]] = counts.get(r["name"], 0) + 1
        extra = set(r) - SPAN_KEYS
        cost = {"flops", "bytes"} if r["name"] in ("device", "iter_step") \
            and (mode == "request") == (r["name"] == "device") else set()
        quality = ({k for k in extra if k.startswith("quality_")}
                   if mode == "slot" and r["name"] == "device" else set())
        assert extra == want[r["name"]] | cost | quality, r
        assert r["status"] == "ok" and r["dur_s"] >= 0
    assert counts == ({"queue": 1, "pad": 1, "device": 1} if mode ==
                      "request" else {"queue": 1, "pad": 1, "device": 1,
                                      "iter_step": ITERS})
    dev = sink.spans("device")[0]
    assert dev["retries"] == 0 and dev["bucket"] == "40x56"
    if mode == "slot":
        assert "quality_photometric" in dev and dev["iters"] == ITERS
        assert all(s["flops"] > 0 and "mfu" not in s
                   for s in sink.spans("iter_step"))
    else:
        assert dev["flops"] > 0 and dev["bytes"] > 0 and "mfu" not in dev
    # the cost book: JAX's keys and program names, counted on the CPU
    assert set(stats["cost"]) == {f"40x56/b2/{p}"
                                  for p in ("enc", "iter", "up")}
    rec = stats["cost"]["40x56/b2/iter"]
    assert rec["program"] == "serve_iter_40x56_b2"
    assert rec["source"] == "counted" and rec["device_kind"] == "cpu"
    assert rec["flops_per_pair"] * 2 == rec["flops"] > 0
    assert rec["peak_tflops"] is None and rec["bound_by"] == "unknown"
    assert signals["mfu"] is None
    assert stats["incidents"] == {"enabled": False}


def test_retried_and_failed_batches_tail_keep(sd):
    """A transient ``device_err`` is retried and tail-keeps a trace the
    head coin dropped (``retries`` on ``device``); a batch that fails
    records an error ``device`` span, which keeps its trace too."""
    sink = _ListSink()
    tracer = trace.Tracer(sink=sink, sample_rate=0.001, seed=0)
    eng = InferenceEngine(sd, CFG, _serve_cfg(device_retries=1,
                                              retry_backoff_s=0.001),
                          device="cpu").start()
    try:
        chaos.install(chaos.FaultPlan.parse("device_err@batch=1", seed=0))
        root = tracer.start_trace("req")
        assert not root.sampled
        with trace.use_context(root):
            fut = eng.submit(*_images(np.random.default_rng(2)))
        assert fut.result(timeout=60).shape == SHAPE + (2,)
        root.end()
        _wait_for(lambda: sink.spans("device"), 10, "the kept device span")
        assert sink.spans("device")[0]["retries"] >= 1
        assert sink.spans("req"), "tail-keep flushes the whole tree"
        chaos.install(chaos.FaultPlan.parse("device_err@batch=2,times=2", seed=0))
        root = tracer.start_trace("req2")
        assert not root.sampled
        with trace.use_context(root):
            fut = eng.submit(*_images(np.random.default_rng(3)))
        with pytest.raises(Exception):
            fut.result(timeout=60)
        root.end(status="error")
        _wait_for(lambda: len(sink.spans("device")) == 2, 10,
                  "the error span")
        err = sink.spans("device")[1]
        assert err["status"] == "error" and err["error"]
        assert err["trace_id"] == root.trace_id
    finally:
        eng.stop()


def test_rate_zero_records_nothing(sd):
    """``sample_rate=0``: the default tracer hands out the no-op
    singleton, a request carries no trace, no span reaches the sink."""
    sink = _ListSink()
    trace.configure(sample_rate=0.0, sink=sink)
    assert trace.default_tracer().begin("route") is trace.NOOP_SPAN
    eng = InferenceEngine(sd, CFG, _serve_cfg(batching="slot", slots=2),
                          device="cpu").start()
    seen = []
    real_iter = eng._iter_slots

    def spy(bucket, pool, waiting, seq):
        seen.extend(r.trace for r in pool.live())
        return real_iter(bucket, pool, waiting, seq)

    eng._iter_slots = spy
    try:
        with trace.use_context(trace.NOOP_SPAN):
            fut = eng.submit(*_images(np.random.default_rng(4)))
        assert fut.result(timeout=60).shape == SHAPE + (2,)
        assert seen and all(t is None for t in seen)
        assert not sink.spans() and trace.current() is None
    finally:
        eng.stop()


# ---------------------------------------------------------------------------
# the router and the wire
# ---------------------------------------------------------------------------


def _fleet(sd, tmp_path, scfg=None, **kw):
    base = dict(replicas=2, warmup_shapes=(SHAPE,), restart_backoff_s=0.01,
                restart_backoff_max_s=0.05, health_poll_s=0.02,
                aot_dir=str(tmp_path / "aot"))
    base.update(kw)
    return ReplicaFleet(sd, CFG, scfg or _serve_cfg(), FleetConfig(**base),
                        device="cpu")


def test_router_failover_and_hedge_one_tree(sd, tmp_path):
    """A ``replica_kill`` failover: ONE tree, a ``route`` root holding
    an error attempt and an ok one on the two replicas, kept past the
    dropped coin.  A hedge (``replica_slow``): ONE tree, the winner
    ``hedge=True`` / ``won=True``, the straggler stitched in late, each
    attempt holding its replica's ``device`` span."""
    sink = _ListSink()
    trace.configure(sample_rate=0.001, seed=0, sink=sink)
    fleet = _fleet(sd, tmp_path, scfg=_serve_cfg(chaos_slow_s=1.5)).start()
    try:
        router = FlowRouter(fleet, RouterConfig())
        chaos.install(chaos.FaultPlan.parse("replica_kill@batch=1",
                                            seed=0))
        flow = router.infer(*_images(np.random.default_rng(5)), timeout=60)
        assert flow.shape == SHAPE + (2,)
        _wait_for(lambda: len(sink.spans("attempt")) >= 2, 10,
                  "both attempt spans")
        (root,) = [r for r in sink.spans("route") if r["parent_id"] is None]
        attempts = sink.spans("attempt")
        assert {a["trace_id"] for a in attempts} == {root["trace_id"]}
        assert {a["parent_id"] for a in attempts} == {root["span_id"]}
        assert sorted(a["status"] for a in attempts) == ["error", "ok"]
        assert {a["replica"] for a in attempts} == {"r0", "r1"}
        assert root["replicas_tried"] == 2
        chaos.uninstall()
        _wait_for(lambda: all(r.state == "ready" for r in fleet.replicas)
                  and sum(r.restarts for r in fleet.replicas) == 1, 30,
                  "the restart")

        sink.records.clear()
        trace.configure(sample_rate=1.0, sink=sink)
        hedger = FlowRouter(fleet, RouterConfig(hedge_timeout_s=0.1))
        chaos.install(chaos.FaultPlan.parse("replica_slow@batch=1",
                                            seed=0))
        flow = hedger.infer(*_images(np.random.default_rng(6)), timeout=60)
        assert flow.shape == SHAPE + (2,)
        _wait_for(lambda: len(sink.spans("device")) >= 2, 30,
                  "the straggler's late spans")
        (root,) = [r for r in sink.spans("route") if r["parent_id"] is None]
        assert root["hedged"] is True
        attempts = sink.spans("attempt")
        assert len(attempts) == 2
        assert {a["trace_id"] for a in attempts} == {root["trace_id"]}
        winner = next(a for a in attempts if a["won"])
        loser = next(a for a in attempts if not a["won"])
        assert winner["hedge"] is True and loser["hedge"] is False
        assert loser["dur_s"] > winner["dur_s"]
        assert {d["parent_id"] for d in sink.spans("device")} == \
            {a["span_id"] for a in attempts}
    finally:
        fleet.stop(drain=False)


def test_remote_hop_keeps_one_tree(sd, tmp_path):
    """Router -> ``RemoteReplica`` -> the port's HTTP server -> its
    engine: one trace, the server's ``serve_http`` a child of the
    client's ``attempt``, the engine's spans under ``serve_http``, and
    the reply's ``X-Raft-Trace``.  ``scripts/trace_report.py`` rebuilds
    the tree from the JSONL without importing either package."""
    tdir = tmp_path / "tel"
    sink = EventSink(str(tdir))
    trace.configure(sample_rate=1.0, sink=sink)
    server_eng = InferenceEngine(sd, CFG, _serve_cfg(), device="cpu").start()
    server, addr = _serve(server_eng)
    shape = (52, 36)        # bucket (56, 40): the router's affinity -> r1
    fleet = _fleet(sd, tmp_path, replicas=1, remote=(addr,),
                   warmup_shapes=(shape,)).start()
    try:
        assert fleet.replicas[1].is_remote
        router = FlowRouter(fleet, RouterConfig())
        flow = router.infer(*_images(np.random.default_rng(7), *shape),
                            timeout=60)
        assert flow.shape == shape + (2,)
        r = _post(f"http://{addr}/v1/flow",
                  _npz(image1=np.zeros(shape + (3,), np.float32),
                       image2=np.zeros(shape + (3,), np.float32)),
                  headers={trace.HEADER: "0123456789abcdef-"
                                         "fedcba9876543210-s"})
        assert r.headers[trace.HEADER].startswith("0123456789abcdef-")
        r.read()
        time.sleep(0.3)
    finally:
        fleet.stop(drain=False)
        server.shutdown()
        server.server_close()
        server_eng.stop()
        sink.close()
    recs = [json.loads(line) for f in tdir.glob("*.jsonl")
            for line in f.read_text().splitlines()]
    spans = [r for r in recs if r["event"] == trace.EVENT]
    (root,) = [s for s in spans if s["name"] == "route"]
    tree = [s for s in spans if s["trace_id"] == root["trace_id"]]
    by_id = {s["span_id"]: s for s in tree}
    (att,) = [s for s in tree if s["name"] == "attempt"]
    (http,) = [s for s in tree if s["name"] == "serve_http"]
    assert att["replica"] == "r1" and http["parent_id"] == att["span_id"]
    assert {s["name"] for s in tree} == {"route", "attempt", "serve_http",
                                         "queue", "pad", "device"}
    for s in tree:
        if s["name"] in ("queue", "pad", "device"):
            assert by_id[s["parent_id"]]["name"] == "serve_http"
    upstream = [s for s in spans if s["trace_id"] == "0123456789abcdef"]
    assert {s["name"] for s in upstream} == {"serve_http", "queue", "pad",
                                             "device"}
    code = (f"import runpy, sys; sys.argv = ['trace_report', "
            f"{str(tdir)!r}, '--json']\n"
            "try:\n"
            f"    runpy.run_path({os.path.join(REPO, 'scripts', 'trace_report.py')!r}, "
            "run_name='__main__')\n"
            "except SystemExit:\n"
            "    pass\n"
            "assert not [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'raft_tpu', 'raft_tpu_torch')], 'imported a package'\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=60, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["config"]["traces_total"] == 2
    assert {"route", "attempt", "serve_http", "queue", "pad",
            "device"} <= set(rec["config"]["serve_span_names"])


def test_port_client_continues_trace_on_jax_server(sd):
    """The port's ``RemoteEngine`` under a port span sends
    ``X-Raft-Trace``; the JAX package's server continues the trace: its
    ``serve_http`` carries the port's trace id and parent span."""
    from raft_tpu.cli.serve import make_server as jax_make_server
    from raft_tpu.config import RAFTConfig as JaxRAFTConfig
    from raft_tpu.obs import trace as jtrace
    from raft_tpu.serve import InferenceEngine as JaxEngine
    from raft_tpu.serve import ServeConfig as JaxServeConfig
    from raft_tpu_torch.serve import RemoteConfig, RemoteEngine

    from test_torch_fixtures import small_raft_variables

    variables, _ = small_raft_variables(0)
    jsink = _ListSink()
    jtrace.configure(sample_rate=1.0, sink=jsink)
    jeng = JaxEngine(variables, JaxRAFTConfig.small_model(), JaxServeConfig(
        iters=ITERS, max_batch=1, batch_sizes=(1,), max_wait_ms=1)).start()
    server = jax_make_server(jeng, "127.0.0.1", 0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    remote = RemoteEngine(f"127.0.0.1:{server.server_address[1]}",
                          RemoteConfig(connect_timeout_s=1.0,
                                       request_timeout_s=120.0))
    tracer = trace.Tracer(sink=_ListSink(), sample_rate=1.0)
    try:
        root = tracer.start_trace("client")
        with trace.use_context(root):
            fut = remote.submit(*_images(np.random.default_rng(8)))
        assert fut.result(timeout=120).shape == SHAPE + (2,)
        root.end()
        _wait_for(lambda: [r for r in jsink.records
                           if r.get("name") == "serve_http"], 10,
                  "the JAX server's span")
        (http,) = [r for r in jsink.records if r.get("name") == "serve_http"]
        assert http["trace_id"] == root.trace_id
        assert http["parent_id"] == root.span_id
    finally:
        remote.stop()
        server.shutdown()
        jeng.stop(drain=False)
        jtrace.reset_default_tracer()


# ---------------------------------------------------------------------------
# POST /debug/profile
# ---------------------------------------------------------------------------


def test_debug_profile_endpoint(sd, tmp_path, monkeypatch):
    """400 on a non-number; a clamped window writes a Chrome trace under
    the sink's directory; a second request while one runs gets 409; a
    span recorded during the window links it (``xprof``)."""
    from raft_tpu_torch.obs import reset_default_sink

    monkeypatch.setenv("RAFT_TELEMETRY_DIR", str(tmp_path / "tel"))
    reset_default_sink()
    sink = _ListSink()
    trace.configure(sample_rate=1.0, sink=sink)
    eng = InferenceEngine(sd, CFG, _serve_cfg(), device="cpu").start()
    server, addr = _serve(eng)
    url = f"http://{addr}/debug/profile"
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(url + "?seconds=soon")
        assert ei.value.code == 400
        out = json.loads(_post(url + "?seconds=0.001").read())
        assert out["seconds"] == 0.05
        assert out["dir"].startswith(str(tmp_path / "tel" / "xprof"))
        with open(out["file"]) as f:
            assert "traceEvents" in json.load(f)
        held = {}

        def long_window():
            held["out"] = json.loads(_post(url + "?seconds=1.5").read())

        t = threading.Thread(target=long_window)
        t.start()
        _wait_for(server.RequestHandlerClass._profile_lock.locked, 10,
                  "the window")
        time.sleep(0.1)
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(url + "?seconds=1")
        assert ei.value.code == 409
        flow = _post(f"http://{addr}/v1/flow", _npz(
            image1=np.zeros(SHAPE + (3,), np.float32),
            image2=np.zeros(SHAPE + (3,), np.float32)))
        assert flow.headers[trace.HEADER]
        flow.read()
        t.join(timeout=30)
        assert held["out"]["seconds"] == 1.5
        linked = [s for s in sink.spans() if s.get("xprof")]
        assert linked and {s["xprof"] for s in linked} == \
            {held["out"]["dir"]}
        assert {"serve_http", "queue", "pad", "device"} <= \
            {s["name"] for s in linked}
        assert trace.active_profile() is None
    finally:
        server.shutdown()
        server.server_close()
        eng.stop()
        reset_default_sink()


# ---------------------------------------------------------------------------
# incidents
# ---------------------------------------------------------------------------


def test_engine_incident_knobs(sd, tmp_path):
    """``incidents=True``: the engine's own manager on its sink, with the
    ``engine_stats`` and ``serve_config`` providers; a crash opens one
    incident, reported in ``stats()``, and ``stop()`` finalizes it."""
    eng = InferenceEngine(sd, CFG, _serve_cfg(incidents=True,
                                              incident_window_s=5.0),
                          sink=EventSink(str(tmp_path)), device="cpu")
    assert set(eng._incidents.recorder.snapshots()) == {"engine_stats",
                                                        "serve_config"}
    eng.start()
    chaos.install(chaos.FaultPlan.parse("replica_kill@batch=1", seed=0))
    with pytest.raises(Exception):
        eng.infer(*_images(np.random.default_rng(9)), timeout=60)
    snap = eng.stats()["incidents"]
    assert snap["opened"] == 1 and "replica_crash" in snap["open"]["signals"]
    eng.stop()
    (bundle,) = (tmp_path / "incidents").iterdir()
    inc = json.loads((bundle / "incident.json").read_text())
    assert inc["status"] == "closed" and inc["trigger"] == "replica_crash"


def test_fleet_cascade_is_one_incident_and_cli_matches_jax(sd, tmp_path,
                                                           capsys):
    """The fleet's one manager folds a kill cascade (the crash, the
    failover, the restart) into ONE incident; the port's ``incidents``
    CLI prints its bundle as the JAX package's does, in every mode."""
    from raft_tpu.cli import incidents as jcli
    from raft_tpu_torch.cli import incidents as cli

    tdir = str(tmp_path / "tel")
    sink = EventSink(tdir)
    fleet = ReplicaFleet(sd, CFG, _serve_cfg(incidents=True,
                                             incident_window_s=10.0),
                         FleetConfig(replicas=2, warmup_shapes=(SHAPE,),
                                     restart_backoff_s=0.01,
                                     restart_backoff_max_s=0.05,
                                     health_poll_s=0.02,
                                     aot_dir=str(tmp_path / "aot")),
                         sink=sink, device="cpu").start()
    try:
        assert all(r.engine._incidents is None for r in fleet.replicas)
        router = FlowRouter(fleet, RouterConfig(), sink=sink)
        chaos.install(chaos.FaultPlan.parse("replica_kill@batch=1",
                                            seed=0))
        assert router.infer(*_images(np.random.default_rng(10)),
                            timeout=60).shape == SHAPE + (2,)
        _wait_for(lambda: sum(r.restarts for r in fleet.replicas) == 1,
                  30, "the restart")
        snap = fleet.stats()["fleet"]["incidents"]
        assert snap["opened"] == 1
        assert {"replica_crash", "serve_failover"} <= \
            set(snap["open"]["signals"])
    finally:
        fleet.stop(drain=False)
    capsys.readouterr()
    for argv in (["list"], ["list", "--json"], ["show", "inc"],
                 ["show", "inc", "--json"], ["timeline", "inc"],
                 ["timeline", "inc", "--json"]):
        outs = []
        for mod in (jcli, cli):
            assert mod.main(argv + ["--telemetry-dir", tdir]) == 0
            outs.append(capsys.readouterr().out)
        assert outs[0] == outs[1], argv
        if argv == ["list", "--json"]:
            (inc,) = json.loads(outs[1])
            assert inc["status"] == "closed"
