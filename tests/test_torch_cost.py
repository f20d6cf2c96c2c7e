"""The port's cost model on the CPU, against the JAX package's
(``raft_tpu/obs/cost.py``): the record and roofline arithmetic of
``ProgramCost``, the ``CostBook`` gauges and event, and the two analytic
formulas equal JAX's; the H100 rows of the peak table; the counted work
of a tiny train step against a hand count (convolution FLOPs forward and
backward, an elementwise operator's bytes), the analytic tap of the
fused kernels, and the counted step's record; the memory record and the
limit file on the CPU."""

import json

import numpy as np
import pytest
import torch

from raft_tpu.obs import cost as jcost
from raft_tpu_torch.config import RAFTConfig, TrainConfig
from raft_tpu_torch.obs import cost
from raft_tpu_torch.obs.registry import MetricRegistry
from raft_tpu_torch.train.step import init_state, make_train_step, step_cost
from raft_tpu_torch.utils import profiling


class _Sink:
    def __init__(self):
        self.recs = []

    def emit(self, event, **fields):
        self.recs.append(dict(fields, event=event))


@pytest.mark.parametrize("kind", ["TPU v5e", "TPU v4", "cpu", "weird"])
@pytest.mark.parametrize("flops,nbytes,pairs", [
    (4.0e12, 2.0e11, 4.0), (1.0e9, 0.0, None), (3.0e10, 6.0e9, 2.0)])
def test_program_cost_matches_jax(kind, flops, nbytes, pairs):
    a = cost.ProgramCost("p", flops, nbytes, pairs_per_call=pairs,
                         source="xla", device_kind=kind)
    b = jcost.ProgramCost("p", flops, nbytes, pairs_per_call=pairs,
                          source="xla", device_kind=kind)
    for seconds in (None, 0.0, 0.05, 2.5):
        assert a.as_record(seconds) == b.as_record(seconds)
    assert a.bound_by == b.bound_by
    assert a.spec.ridge == b.spec.ridge


def test_cost_book_matches_jax():
    out = []
    for mod, reg_cls in ((cost, MetricRegistry),
                         (jcost, __import__(
                             "raft_tpu.obs.registry",
                             fromlist=["MetricRegistry"]).MetricRegistry)):
        reg, sink = reg_cls(), _Sink()
        book = mod.CostBook(registry=reg, sink=sink)
        c = mod.ProgramCost("train_step", 2e12, 1e11, pairs_per_call=8.0,
                            source="xla", device_kind="TPU v5e")
        book.stamp("train_step", c)
        attrs = book.observe("train_step", 0.125)
        assert book.observe("nope", 1.0) == {}
        snap = reg.snapshot()
        out.append((attrs, sink.recs,
                    {k: v["values"] for k, v in snap.items()}))
    assert out[0] == out[1]


@pytest.mark.parametrize("shape,kind,db", [
    ((8, 128, 46, 62), "rh", 4), ((8, 128, 46, 62), "blend", 2),
    ((1, 3, 5, 7), "rh", 4)])
def test_analytic_gru_gate_cost_matches_jax(shape, kind, db):
    assert cost.analytic_gru_gate_cost(shape, kind, db) == \
        jcost.analytic_gru_gate_cost(shape, kind, db)
    with pytest.raises(ValueError):
        cost.analytic_gru_gate_cost(shape, "nope")


@pytest.mark.parametrize("args", [
    (8, [(46, 62), (23, 31), (11, 15), (5, 7)], 46 * 62, 4, 256, 128, 4),
    (1, [(6, 8), (0, 0)], 48, 3, 40, 128, 1)])
def test_analytic_lookup_encode_cost_matches_jax(args):
    assert cost.analytic_lookup_encode_cost(*args) == \
        jcost.analytic_lookup_encode_cost(*args)


@pytest.mark.parametrize("name,want", [
    ("NVIDIA H100 80GB HBM3", "h100"), ("NVIDIA H100 PCIe", "h100-pcie"),
    ("NVIDIA H100 NVL", None), ("cpu", "cpu"), ("NVIDIA A100", None)])
def test_peak_table_h100_rows(name, want):
    spec = cost.peak_spec(name)
    if want is None:
        assert spec.tflops is None and spec.hbm_gbps is None
    else:
        assert spec == cost.PEAK_SPECS[want]
    assert cost.PEAK_SPECS["h100"].tflops == 989.4
    assert cost.PEAK_SPECS["h100"].hbm_gbps == 3350.0
    assert cost.PEAK_SPECS["h100-pcie"].tflops == 756.0
    assert cost.peak_spec().tflops is None        # this CPU: unknown
    c = cost.ProgramCost("p", 1e12, 1e9, device_kind="cpu")
    assert c.mfu(1.0) is None and c.bound_by == "unknown"


def test_counted_conv_step_matches_hand_count():
    """Two 3x3 convolutions (the input needs no gradient, so the first
    conv's backward is its weight gradient alone) plus an AdamW update:
    ``2 * N * Cout * Cin * 9 * H * W`` FLOPs per product, three products
    for the second conv, two for the first; an elementwise add of two
    fp32 tensors moves three tensors of bytes."""
    torch.manual_seed(0)
    net = torch.nn.Sequential(torch.nn.Conv2d(3, 8, 3, padding=1),
                              torch.nn.Conv2d(8, 4, 3, padding=1))
    opt = torch.optim.AdamW(net.parameters(), lr=1e-3)
    x = torch.randn(2, 3, 10, 12)
    with cost.counting() as c:
        net(x).square().mean().backward()
        opt.step()
    f1 = 2 * 2 * 8 * 3 * 9 * 10 * 12
    f2 = 2 * 2 * 4 * 8 * 9 * 10 * 12
    assert c.flops == 2 * f1 + 3 * f2
    assert c.bytes > 0 and c.analytic_flops == 0
    a, b = torch.ones(100), torch.ones(100)
    with cost.counting() as c2:
        torch.add(a, b)
        a.view(10, 10)                      # a view moves nothing
    assert c2.bytes == 3 * 400 and c2.flops == 0
    assert not cost.counting_active()


def test_analytic_tap_and_nesting():
    """A kernel wrapper's note reaches every open count, and none after
    the window closes."""
    cost.note_analytic("k", 1.0, 1.0)              # no window: dropped
    with cost.counting() as outer:
        with cost.counting() as inner:
            cost.note_analytic("gru_gate_rh", *cost.analytic_gru_gate_cost(
                (2, 4, 8, 8), "rh"))
        cost.note_analytic("lookup_encode", 10.0, 20.0)
    f, b = cost.analytic_gru_gate_cost((2, 4, 8, 8), "rh")
    assert inner.analytic_flops == f and inner.analytic_bytes == b
    assert outer.analytic_flops == f + 10.0
    assert outer.kernels == {"gru_gate_rh": 1, "lookup_encode": 1}
    assert outer.total_flops == outer.flops + f + 10.0


def test_counted_train_step_record():
    """The small model's step at 32x48 counted on its first call: a
    ``counted`` record whose call advances ``batch / world`` pairs (the
    same count read as one rank of two covers half the pairs), and MFU
    left unknown on the CPU."""
    cfg = TrainConfig(lr=2e-4, num_steps=10, batch_size=2,
                      image_size=(32, 48), iters=2)
    state = init_state(RAFTConfig.small_model(), cfg, device="cpu")
    rng = np.random.default_rng(0)
    batch = {"image1": rng.uniform(0, 255, (2, 32, 48, 3)),
             "image2": rng.uniform(0, 255, (2, 32, 48, 3)),
             "flow": rng.normal(size=(2, 32, 48, 2)),
             "valid": np.ones((2, 32, 48))}
    step = make_train_step(cfg, device="cpu")
    with cost.counting() as c:
        step(state, batch)
    one = step_cost(c, 2, 1)
    two = step_cost(c, 2, 2)
    assert one.source == "counted" and one.device_kind == "cpu"
    assert one.flops == c.flops > 1e8 and one.bytes > one.flops / 100
    assert two.pairs_per_call == 1.0
    assert two.flops_per_pair == 2 * one.flops_per_pair
    rec = one.as_record(0.5)
    assert rec["mfu"] is None and rec["pairs_per_call"] == 2.0
    empty = cost.counted_cost(cost.Count(), program="x", kind="cpu")
    assert empty.source == "unavailable"


def test_memory_record_and_limit_file(tmp_path):
    assert profiling.hbm_usage("cpu") == {"peak_hbm": "unavailable"}
    assert profiling.measure_hbm_limit()["hbm_limit_gb"] == "unavailable"
    assert profiling.probe_error_is_oom(torch.cuda.OutOfMemoryError("x"))
    assert profiling.probe_error_is_oom(RuntimeError("CUDA out of memory"))
    assert not profiling.probe_error_is_oom(RuntimeError("launch failed"))
    path = tmp_path / "lim.json"
    assert profiling.load_hbm_limit(7.0, str(path))[0] == 7.0
    path.write_text(json.dumps({"hbm_limit_gb": 79.1, "source": "probe"}))
    assert profiling.load_hbm_limit(None, str(path)) == (79.1, "probe")
    path.write_text("{bad")
    assert profiling.load_hbm_limit(3.0, str(path))[0] == 3.0
    model = torch.nn.Linear(4, 4)
    opt = torch.optim.AdamW(model.parameters())
    model(torch.ones(1, 4)).sum().backward()
    opt.step()
    state = type("S", (), {"model": model, "optimizer": opt})()
    # weights, two Adam moments, a step count per parameter
    assert profiling.state_bytes(state) == 3 * 20 * 4 + 2 * 4
