"""Streaming sessions on the port's engine (twins of the engine cases of
tests/test_serve_stream.py), small model, fp32, weights from
``convert.py``, ``device="cpu"``:

- an 8-frame clip with known motion: the first pair bit for bit a
  stateless slot request, the later six warm and finite, the summary 8
  frames / 7 pairs / 6 warm pairs, one ledger event for each of ``enc``,
  ``iter``, ``up``, ``stash`` and ``wenc``, warm frames spending fewer
  iterations than cold ones under a warm budget, the events' warm split;
- the session's warm flows against the JAX engine's on the same clip;
- the idle TTL evicting a session (event, counter, freed lane) and a
  later post re-seeding it;
- ``max_sessions`` answered with ``QueueFullError``; the errors of an
  unknown session, a resized frame, a frame in flight, request mode;
- the HTTP stream routes (``POST`` / ``DELETE /v1/stream/{id}``).
"""

import importlib.util
import io
import os.path as osp
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
from raft_tpu_torch.serve import InferenceEngine, QueueFullError, ServeConfig

from test_torch_fixtures import small_raft_variables

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
CFG = RAFTConfig.small_model()
ITERS = 3
SHAPE = (36, 52)                # -> bucket (40, 56)
BUCKET = (40, 56)


@pytest.fixture(autouse=True)
def _isolated():
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


def _make_clip(n_frames=8, seed=3):
    spec = importlib.util.spec_from_file_location(
        "make_demo_frames", osp.join(REPO, "scripts", "make_demo_frames.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.make_clip(n_frames, SHAPE, shift=(2, 1), seed=seed)


@pytest.fixture(scope="module")
def weights():
    return small_raft_variables(0)


def _engine(sd, sink=None, **kw):
    return InferenceEngine(sd, CFG, ServeConfig(iters=ITERS, **kw),
                           sink=sink, device="cpu")


@pytest.fixture(scope="module")
def session_run(weights):
    """One engine, one 8-frame clip through a session, after a stateless
    request for the first pair."""
    torch.set_num_threads(1)
    frames, _ = _make_clip(8)
    sink = _RecordingSink()
    eng = _engine(weights[1], sink, batching="slot", slots=4,
                  stream_warm_iters=ITERS - 1)
    with eng:
        ref = eng.infer(frames[0], frames[1], timeout=120)
        eng.stream_open("cam0", frames[0])
        outs = [eng.stream_ingest("cam0", f, timeout=120)
                for f in frames[1:]]
        summary = eng.stream_close("cam0")
        stats = eng.stats()
    return dict(frames=frames, ref=ref, outs=outs, summary=summary,
                stats=stats, sink=sink, eng=eng)


def test_stream_session_counts_parity_and_ledger(session_run):
    r = session_run
    outs = r["outs"]
    assert outs[0]["warm"] is False and outs[0]["frame"] == 1
    np.testing.assert_array_equal(outs[0]["flow"], r["ref"])
    assert all(o["warm"] for o in outs[1:])
    assert [o["frame"] for o in outs] == list(range(1, 8))
    assert all(o["flow"].shape == SHAPE + (2,) and np.isfinite(
        o["flow"]).all() for o in outs)
    assert r["summary"] == {"session": "cam0", "frames": 8, "pairs": 7,
                            "warm_pairs": 6}
    assert r["eng"].capture_counter.counts() == {
        (BUCKET, 4, p): 1 for p in ("enc", "iter", "up", "stash", "wenc")}
    warm, cold = r["stats"]["iters_used_warm"], r["stats"]["iters_used_cold"]
    assert warm["count_total"] == 6 and cold["count_total"] == 2
    assert warm["p50"] == ITERS - 1 < cold["p50"] == ITERS
    assert r["stats"]["sessions"]["frames_total"] == 7
    sink = r["sink"]
    assert [f["warm"] for f in sink.of("serve_retire")].count(True) == 6
    assert {a["warm"] for a in sink.of("serve_admit")} == {True, False}
    assert sink.of("stream_open")[0]["sid"] == "cam0"
    assert sink.of("stream_close")[0]["warm_pairs"] == 6


def test_stream_flows_match_jax_engine(weights, session_run):
    """The JAX engine streams the same clip on the same weights: every
    frame's flow (cold and warm) within the fp32 bounds."""
    from raft_tpu.config import RAFTConfig as JaxRAFTConfig
    from raft_tpu.serve import InferenceEngine as JaxEngine
    from raft_tpu.serve import ServeConfig as JaxServeConfig

    frames = session_run["frames"]
    eng = JaxEngine(weights[0], JaxRAFTConfig.small_model(), JaxServeConfig(
        iters=ITERS, batching="slot", slots=4, stream_warm_iters=ITERS - 1))
    with eng:
        eng.stream_open("cam0", frames[0])
        want = [eng.stream_ingest("cam0", f, timeout=300)
                for f in frames[1:]]
    for got, ref in zip(session_run["outs"], want):
        assert got["warm"] == ref["warm"] and got["frame"] == ref["frame"]
        np.testing.assert_allclose(got["flow"], ref["flow"], rtol=1e-4,
                                   atol=1e-3)


def test_stream_ttl_eviction_and_reseed(weights):
    frames, _ = _make_clip(3, seed=5)
    sink = _RecordingSink()
    eng = _engine(weights[1], sink, batching="slot", slots=2,
                  stream_ttl_s=0.3)
    with eng:
        out = eng.stream_ingest("cam0", frames[0], timeout=120)
        assert out["frame"] == 0 and out["flow"] is None
        out = eng.stream_ingest("cam0", frames[1], timeout=120)
        assert out["frame"] == 1 and out["flow"] is not None
        deadline = time.time() + 10
        while time.time() < deadline and eng.stats()["sessions"]["open"]:
            time.sleep(0.05)
        stats = eng.stats()
        assert stats["sessions"]["open"] == 0
        assert stats["sessions"]["evicted_total"] == 1
        (ev,) = sink.of("stream_evict")
        assert ev["sid"] == "cam0" and ev["idle_s"] >= 0.3
        assert ev["lane"] >= 0
        out = eng.stream_ingest("cam0", frames[1], timeout=120)
        assert out["frame"] == 0 and out["flow"] is None
        out = eng.stream_ingest("cam0", frames[2], timeout=120)
        assert out["frame"] == 1 and out["flow"] is not None
        eng.stream_close("cam0")


def test_stream_limits_and_errors(weights):
    frames, _ = _make_clip(2, seed=6)
    eng = _engine(weights[1], batching="slot", slots=2, max_sessions=1,
                  retry_after_s=3.0)
    with eng:
        eng.stream_open("a", frames[0])
        with pytest.raises(QueueFullError) as ei:
            eng.stream_open("b", frames[0])
        assert ei.value.queue_depth == 1 and ei.value.retry_after_s == 3.0
        with pytest.raises(ValueError, match="already open"):
            eng.stream_open("a", frames[0])
        with pytest.raises(ValueError, match="unknown session"):
            eng.stream_submit("zz", frames[1])
        with pytest.raises(ValueError, match="session shape"):
            eng.stream_submit("a", frames[1][:-8])
        gate = threading.Event()
        eng._device_pool.submit(gate.wait)
        try:
            fut = eng.stream_submit("a", frames[1])
            with pytest.raises(ValueError, match="in flight"):
                eng.stream_submit("a", frames[1])
            with pytest.raises(ValueError, match="in flight"):
                eng.stream_close("a")
        finally:
            gate.set()
        assert fut.result(timeout=120).shape == SHAPE + (2,)
        assert eng.stream_close("a")["pairs"] == 1
        with pytest.raises(ValueError, match="unknown session"):
            eng.stream_close("a")
    req = _engine(weights[1])
    with req:
        with pytest.raises(ValueError, match="batching='slot'"):
            req.stream_open("a", frames[0])


def test_http_stream_routes(weights, session_run):
    """``POST /v1/stream/{id}`` opens, then returns each frame's flow
    (bit for bit the in-process session's), ``DELETE`` closes with the
    summary, an unknown id answers 404."""
    frames, outs = session_run["frames"], session_run["outs"]
    eng = _engine(weights[1], batching="slot", slots=4,
                  stream_warm_iters=ITERS - 1)
    server = serve_cli.make_server(eng, "127.0.0.1", 0)
    url = "http://127.0.0.1:%d/v1/stream/cam0" % server.server_address[1]
    threading.Thread(target=server.serve_forever, daemon=True).start()

    def post(image, query=""):
        buf = io.BytesIO()
        np.savez(buf, image=image)
        r = urllib.request.urlopen(urllib.request.Request(
            url + query, data=buf.getvalue(), method="POST"), timeout=120)
        return np.load(io.BytesIO(r.read()))

    with eng:
        try:
            first = post(frames[0], "?ttl_s=30")
            assert int(first["frame"]) == 0 and "flow" not in first
            for k in range(1, 4):
                z = post(frames[k])
                assert int(z["frame"]) == k
                assert bool(z["warm"]) == (k > 1)
                np.testing.assert_array_equal(z["flow"], outs[k - 1]["flow"])
            r = urllib.request.urlopen(urllib.request.Request(
                url, method="DELETE"), timeout=60)
            assert r.read() == (b'{"session": "cam0", "frames": 4, '
                                b'"pairs": 3, "warm_pairs": 2}')
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(urllib.request.Request(
                    url, method="DELETE"), timeout=60)
            assert ei.value.code == 404
        finally:
            server.shutdown()
            server.server_close()
