"""The port's tracing layer on the CPU, against the JAX package's
(``raft_tpu/obs/trace.py``, of which ``raft_tpu_torch/obs/trace.py`` is a
copy): the sampling decisions at a fixed seed, the wire header both
ways, the no-op singleton of rate 0, the tail keep and the late keep of a
dropped trace, spans recorded on another thread, the profiler link, and
a checkpoint commit recorded under the step's trace."""

import json
import threading

import pytest
import torch

from raft_tpu.obs import trace as jtrace
from raft_tpu_torch.obs import trace
from raft_tpu_torch.obs.events import EventSink


class _Sink:
    def __init__(self):
        self.recs = []

    def emit(self, event, **fields):
        self.recs.append(dict(fields, event=event))


@pytest.fixture(autouse=True)
def fresh_tracer():
    trace.reset_default_tracer()
    trace.set_active_profile(None)
    yield
    trace.reset_default_tracer()
    trace.set_active_profile(None)


@pytest.mark.parametrize("rate,seed", [(0.5, 0), (0.1, 7), (0.9, 1234)])
def test_sampling_decisions_match_jax(rate, seed):
    got = trace.Tracer(sink=_Sink(), sample_rate=rate, seed=seed)
    want = jtrace.Tracer(sink=_Sink(), sample_rate=rate, seed=seed)
    a = [got.start_trace("train_step", step=i).sampled for i in range(200)]
    b = [want.start_trace("train_step", step=i).sampled for i in range(200)]
    assert a == b and 0 < sum(a) < 200


def test_headers_round_trip_both_packages():
    tr = trace.Tracer(sink=_Sink(), sample_rate=1.0)
    root = tr.start_trace("r")
    h = trace.format_header(root)
    assert jtrace.parse_header(h) == trace.parse_header(h) == (
        root.trace_id, root.span_id, True)
    jroot = jtrace.Tracer(sink=_Sink(), sample_rate=0.0).start_trace(
        "r", sampled=False)
    hj = jtrace.format_header(jroot)
    assert trace.parse_header(hj) == (jroot.trace_id, jroot.span_id, False)
    for bad in (None, "", "a-b", "xyz-12-s", "12-34-q", "12--s"):
        assert trace.parse_header(bad) is None
        assert jtrace.parse_header(bad) is None


def test_rate_zero_is_the_noop_singleton():
    tr = trace.Tracer(sink=_Sink(), sample_rate=0.0)
    assert tr.start_trace("x") is trace.NOOP_SPAN
    assert trace.trace_span("y") is trace.NOOP_SPAN
    with pytest.raises(ValueError):
        trace.Tracer(sample_rate=1.5)


def test_tail_keep_late_keep_threads_and_profile_link():
    sink = _Sink()
    tr = trace.Tracer(sink=sink, sample_rate=1e-12, seed=0, keep_dropped=4)
    # dropped, then recovered late (the guard's verdict at the flush)
    for step in range(6):
        root = tr.start_trace("train_step", step=step)
        trace.record_span(root, "queue_wait", root.t_start_mono,
                          root.t_start_mono + 1e-3)
        root.end()
    assert sink.recs == []
    assert tr.emit_recent_dropped(steps=[1]) == 0   # evicted: ring of 4
    assert tr.emit_recent_dropped(steps=[4]) == 1
    assert {(r["name"], r.get("step")) for r in sink.recs} == {
        ("train_step", 4), ("queue_wait", None)}
    # an error tail-keeps the whole tree; a child recorded on another
    # thread through use_context lands in it
    sink.recs.clear()
    root = tr.start_trace("train_step", step=9)

    def worker():
        with trace.use_context(root):
            with trace.trace_span("ckpt_commit"):
                pass

    t = threading.Thread(target=worker)
    t.start()
    t.join(timeout=10)
    assert not t.is_alive()
    trace.set_active_profile("prof/dir")
    trace.record_span(root, "step_dispatch", root.t_start_mono,
                      root.t_start_mono + 2e-3, status="error",
                      error="RuntimeError")
    trace.set_active_profile(None)
    root.end()
    names = {r["name"]: r for r in sink.recs}
    assert set(names) == {"train_step", "ckpt_commit", "step_dispatch"}
    assert names["ckpt_commit"]["parent_id"] == root.span_id
    assert names["step_dispatch"]["xprof"] == "prof/dir"
    assert "xprof" not in names["ckpt_commit"]


def test_checkpoint_commit_span_under_step_trace(tmp_path):
    """``save_async`` inside a step's context: the committer thread's
    ``ckpt_commit`` span is a child of that step's root, and the
    ``ckpt_commit`` event reports the probe's verdict."""
    from raft_tpu_torch.train.checkpoint import CheckpointManager
    from raft_tpu_torch.train.state import TrainState

    model = torch.nn.Linear(2, 2)
    state = TrainState(model=model,
                       optimizer=torch.optim.SGD(model.parameters(), 0.1),
                       schedule=lambda c: torch.tensor(0.0),
                       generator=torch.Generator(),
                       nonfinite_steps=torch.zeros((), dtype=torch.int64),
                       step=3)
    sink = EventSink(str(tmp_path / "tel"))
    tr = trace.configure(sample_rate=1.0, seed=0, sink=sink)
    mgr = CheckpointManager(str(tmp_path / "ck"), sink=sink)
    root = tr.start_trace("train_step", step=3)
    with trace.use_context(root):
        mgr.save_async(3, state)
    root.end()
    mgr.wait()
    mgr.close()
    sink.close()
    (f,) = (tmp_path / "tel").glob("*.jsonl")
    recs = [json.loads(line) for line in f.read_text().splitlines()]
    commit = [r for r in recs if r["event"] == "ckpt_commit"]
    assert len(commit) == 1 and commit[0]["ok"] and commit[0]["step"] == 3
    span = [r for r in recs if r["event"] == "trace_span"
            and r["name"] == "ckpt_commit"]
    assert len(span) == 1 and span[0]["parent_id"] == root.span_id
    assert span[0]["trace_id"] == root.trace_id
