"""The port's compiled-execution slice on the CPU: what the captured CUDA
graphs rest on, where the CPU can check it.

- **No host read.** The train step (every correlation configuration, the
  guard, microbatches) and the test-mode forward run with
  ``Tensor.item``, ``__bool__``, ``__float__``, ``__int__``, ``tolist``,
  ``cpu`` and ``numpy`` patched to raise: a captured graph cannot read a
  value back, and an eager step on the card then makes no device sync.
- **CaptureCounter** against the JAX package's ``CompileCounter`` on the
  same events, from several threads.
- **corr_precision**: each of the four values against JAX on the CPU (the
  all-pairs pyramid, its lookup and the on-demand lookup, fp32 as
  XLA:CPU computes them), the ``'auto'`` rule, and a bad value's message.
- **Launch counters**: one function returns every kernel's live count,
  the 12 names.
- **Restore in place**: a checkpoint restore, past a torn newest step,
  copies into the tensors the state already holds (the ones a captured
  step reads), so no graph goes stale; a state saved by a plain AdamW
  loads into the fused one and trains on.
- **Graphs are the card's**: asking for them on the CPU raises.
- **No collection inside a capture**: a reference cycle that dies inside
  a capture, with the collector set to run at every allocation, is freed
  only after it (stand-ins for the CUDA graph and its capture).

The cases that need the card (capture, replay, launch counts per replay,
the guard under sync-debug mode) are in ``tests/test_torch_cuda.py``.
"""

import contextlib
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.config import RAFTConfig as JaxRAFTConfig
from raft_tpu.config import validate_corr_precision as jax_validate
from raft_tpu.ops import corr as jcorr
from raft_tpu.utils.profiling import CompileCounter
from raft_tpu_torch import chaos, ops
from raft_tpu_torch.config import RAFTConfig, TrainConfig
from raft_tpu_torch.evaluate import make_eval_fn
from raft_tpu_torch.ops import corr
from raft_tpu_torch.train import optim
from raft_tpu_torch.train.checkpoint import CheckpointManager
from raft_tpu_torch.train.step import init_state, make_train_step
from raft_tpu_torch.utils.profiling import CaptureCounter

B, H, W = 2, 32, 48
KW = dict(lr=2e-4, num_steps=100, batch_size=B, image_size=(H, W), iters=2)
LAUNCH_NAMES = {"corr_ondemand", "corr_ondemand_bwd", "gru_gate_rh",
                "gru_gate_blend", "gru_gate_rh_bwd", "gru_gate_blend_bwd",
                "pyramid_lookup_fwd", "pyramid_lookup_bwd",
                "pyramid_lookup_quantized", "upsample_loss_fwd",
                "upsample_loss_bwd", "lookup_encode"}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the test runner runs several workers at once."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _batch(seed, b=B):
    rng = np.random.default_rng(seed)
    return {"image1": torch.from_numpy(
                rng.uniform(0, 255, (b, H, W, 3)).astype(np.float32)),
            "image2": torch.from_numpy(
                rng.uniform(0, 255, (b, H, W, 3)).astype(np.float32)),
            "flow": torch.from_numpy(
                (3 * rng.standard_normal((b, H, W, 2))).astype(np.float32)),
            "valid": torch.ones(b, H, W)}


READS = ("item", "__bool__", "__float__", "__int__", "tolist", "cpu",
         "numpy")


@contextlib.contextmanager
def no_host_reads():
    """Every way a tensor's value reaches the host raises inside."""
    mp = pytest.MonkeyPatch()
    try:
        for name in READS:
            def refuse(self, *a, _name=name, **k):
                raise AssertionError(f"host read: Tensor.{_name}")
            mp.setattr(torch.Tensor, name, refuse)
        yield
    finally:
        mp.undo()


@pytest.mark.parametrize("small,model_kw,train_kw", [
    (False, {}, {}),
    (False, {"corr_impl": "allpairs_pallas", "upsample_loss_kernel": "pallas",
             "fused_lookup_encoder": True, "corr_dtype": "int8"}, {}),
    (False, {"corr_impl": "pallas", "fused_gru": True, "dropout": 0.1},
     {"accum_steps": 2, "fused_loss": False}),
    (True, {"remat": True, "remat_upsample": True}, {})],
    ids=["plain", "fused_int8", "ondemand_accum", "small_remat"])
def test_step_and_forward_read_nothing_back(small, model_kw, train_kw):
    """A good step, a poisoned one (the guard) and the test-mode forward
    with and without ``flow_init``, with every host read refused."""
    cfg = TrainConfig(**KW, **train_kw)
    mcfg = (RAFTConfig.small_model if small else RAFTConfig.full)(
        **model_kw)
    state = init_state(mcfg, cfg, device="cpu")
    step_fn = make_train_step(cfg, device="cpu")
    eval_fn = make_eval_fn(mcfg, 2, device="cpu")
    sd = state.model.state_dict()
    good, bad = _batch(0), _batch(1)
    bad["image2"][1, 5, 7, 2] = float("inf")
    flow_init = torch.zeros(B, H // 8, W // 8, 2)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}

    with no_host_reads():
        _, m_good = step_fn(state, good)
        _, m_bad = step_fn(state, bad)
        low, up = eval_fn(sd, good["image1"], good["image2"])
        low2, _ = eval_fn(sd, good["image1"], good["image2"], flow_init)

    assert state.step == 2
    assert torch.equal(m_good["nonfinite"], torch.tensor(0.0))
    assert torch.equal(m_bad["nonfinite"], torch.tensor(1.0))
    assert torch.equal(state.nonfinite_steps, torch.tensor(1))
    assert low.shape == (B, H // 8, W // 8, 2) and up.shape == (B, H, W, 2)
    assert low2.shape == low.shape
    moved = [k for k, v in state.model.state_dict().items()
             if not torch.equal(v, before[k])]
    assert moved


def test_capture_counter_matches_compile_counter():
    """The same events, recorded from four threads, give the same counts,
    per-key counts and total in both counters."""
    keys = [("fwd", 440, 1024), ("fwd", 376, 1248), ("step", 8), None]
    events = [keys[i % 4] for i in range(3 * 4 * 25)] + [keys[0]] * 7
    ours, theirs = CaptureCounter(), CompileCounter()

    def record(part):
        for k in part:
            ours.record(k)
            theirs.record(k)

    threads = [threading.Thread(target=record, args=(events[i::4],))
               for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert ours.counts() == theirs.counts()
    assert ours.total() == theirs.total() == len(events)
    for k in keys + [("never",)]:
        assert ours.count(k) == theirs.count(k)


@pytest.mark.parametrize("precision", ["auto", "default", "high",
                                       "highest"])
def test_corr_precision_matches_jax(precision):
    """Each value: the same resolution as JAX's config and, on the CPU,
    the same pyramid, lookup and on-demand lookup as JAX's at that
    precision (fp32 on both sides)."""
    jprec = JaxRAFTConfig.full(corr_precision=precision
                               ).resolved_corr_precision
    assert (RAFTConfig.full(corr_precision=precision).resolved_corr_precision
            == jprec)
    rng = np.random.default_rng(3)
    f1, f2 = (rng.standard_normal((1, 6, 8, 32)).astype(np.float32)
              for _ in range(2))
    coords = rng.uniform(-2, 9, (1, 6, 8, 2)).astype(np.float32)
    jp = jcorr.build_corr_pyramid(jnp.asarray(f1), jnp.asarray(f2), 3,
                                  jprec)
    want = np.asarray(jcorr.corr_lookup(jp, jnp.asarray(coords), 2, jprec))
    tp = corr.build_corr_pyramid(torch.from_numpy(f1), torch.from_numpy(f2),
                                 3, precision=precision)
    got = corr.corr_lookup(tp, torch.from_numpy(coords), 2, precision)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    jf2 = jcorr.pool_fmap_pyramid(jnp.asarray(f2), 3)
    want = np.asarray(jcorr.chunked_corr_lookup(
        jnp.asarray(f1), jf2, jnp.asarray(coords), 2, block_size=16,
        precision=jprec))
    got = corr.chunked_corr_lookup(
        torch.from_numpy(f1), corr.pool_fmap_pyramid(torch.from_numpy(f2),
                                                      3),
        torch.from_numpy(coords), 2, 16, precision)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_bad_corr_precision_fails_with_jax_message():
    with pytest.raises(ValueError) as want:
        jax_validate("fp32")
    with pytest.raises(ValueError) as got:
        RAFTConfig.full(corr_precision="fp32")
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="allowed: auto, default, high"):
        corr.matmul(torch.ones(1, 2, 2), torch.ones(1, 2, 2), "tf32")


def test_launch_counter_registry():
    """``ops.launch_counters`` returns the wrappers' live dicts: the 12
    kernel names, each counted once; ``add_launches`` adds into them."""
    from raft_tpu_torch.ops import (corr_kernels, gru_gates, lookup_encode,
                                    pyramid_kernels, upsample_loss)

    live = ops.launch_counters()
    assert {id(d) for d in live} == {id(m.LAUNCHES) for m in (
        corr_kernels, gru_gates, lookup_encode, pyramid_kernels,
        upsample_loss)}
    counts = ops.launch_counts()
    assert set(counts) == LAUNCH_NAMES and len(counts) == 12
    assert sum(len(d) for d in live) == 12
    before = ops.launch_counts()
    ops.add_launches({"lookup_encode": 3, "gru_gate_rh": 2})
    ops.add_launches({"lookup_encode": -3, "gru_gate_rh": -2})
    assert ops.launch_counts() == before


def test_restore_copies_into_the_live_tensors(tmp_path, capsys):
    """Resume past a torn newest step: every restored value lands in the
    tensor the state already held (parameters, optimizer moments and
    count, learning rate, non-finite counter), and equals the saved one."""
    cfg = TrainConfig(**KW, ckpt_dir=str(tmp_path))
    state = init_state(RAFTConfig.full(), cfg, device="cpu")
    step_fn = make_train_step(cfg, device="cpu")
    mgr = CheckpointManager(str(tmp_path / "run"))
    state, _ = step_fn(state, _batch(0))
    state.nonfinite_steps.fill_(3)
    mgr.save(1, state)
    saved = ({k: v.clone() for k, v in state.model.state_dict().items()},
             [{k: v.clone() for k, v in s.items()}
              for s in state.optimizer.state.values()])
    state, _ = step_fn(state, _batch(1))
    mgr.save(2, state)
    chaos.tear_files(str(tmp_path / "run" / "2"))

    params = dict(state.model.state_dict())
    opt = [dict(s) for s in state.optimizer.state.values()]
    lr = state.optimizer.param_groups[0]["lr"]
    count = state.nonfinite_steps
    mgr.restore_latest(state)
    assert "checkpoint fallback: step(s) [2]" in capsys.readouterr().out
    assert state.step == 1 and state.nonfinite_steps is count
    assert int(count) == 3
    assert state.optimizer.param_groups[0]["lr"] is lr
    for k, v in state.model.state_dict().items():
        assert v.data_ptr() == params[k].data_ptr()
        assert torch.equal(v, saved[0][k]), k
    for s_now, s_was, s_saved in zip(state.optimizer.state.values(), opt,
                                     saved[1]):
        for k in s_was:
            assert s_now[k] is s_was[k]
            assert torch.equal(s_now[k], s_saved[k]), k
    mgr.close()


def test_restore_takes_a_plain_adamw_state(tmp_path):
    """A run saved by a plain AdamW (not fused, not capturable, a float
    learning rate: the port's optimizer before its step was captured)
    restores into the fused one: its moments and count land in the live
    tensors, the live groups stay as they are (fused, the rate tensor),
    and the next step trains on from the restored count."""
    cfg = TrainConfig(**KW, ckpt_dir=str(tmp_path))
    old = init_state(RAFTConfig.full(), cfg, device="cpu")
    plain = torch.optim.AdamW(old.model.parameters(), lr=1e-4,
                              weight_decay=cfg.wdecay)
    gen = torch.Generator().manual_seed(0)
    for _ in range(2):
        for p in old.model.parameters():
            p.grad = torch.randn(p.shape, generator=gen)
        plain.step()
    old.optimizer, old.step = plain, 2
    mgr = CheckpointManager(str(tmp_path / "run"))
    mgr.save(2, old)

    state = init_state(RAFTConfig.full(), cfg, device="cpu")
    group = {k: v for k, v in state.optimizer.param_groups[0].items()
             if k != "params"}
    live = [dict(s) for s in state.optimizer.state.values()]
    mgr.restore_latest(state)
    assert state.step == 2
    now = state.optimizer.param_groups[0]
    assert all(now[k] is v for k, v in group.items()) and now["fused"]
    for s_now, s_was, s_plain in zip(state.optimizer.state.values(), live,
                                     plain.state.values()):
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert s_now[k] is s_was[k]
            assert torch.equal(s_now[k], s_plain[k]), k
    assert float(optim.update_count(state.optimizer)) == 2.0
    state, met = make_train_step(cfg, device="cpu")(state, _batch(1))
    assert np.isfinite(float(met["loss"])) and state.step == 3
    assert float(optim.update_count(state.optimizer)) == 3.0
    mgr.close()


def test_graphs_are_the_cards():
    with pytest.raises(ValueError, match="graphs=True needs a CUDA"):
        make_eval_fn(RAFTConfig.full(), 2, device="cpu", graphs=True)
    with pytest.raises(ValueError, match="graphs=True needs a CUDA"):
        make_train_step(TrainConfig(**KW), device="cpu", graphs=True)


def test_capture_keeps_the_collector_off(monkeypatch):
    """``CapturedProgram`` keeps the garbage collector off during the
    capture: a reference cycle that dies inside it, with the collector set
    to run at every allocation, is freed only after the capture ends; the
    collector is back on after, also when the captured function raises
    (the CUDA graph and its capture are stand-ins)."""
    import gc

    from raft_tpu_torch.utils import graphs

    events = []

    class Cycle:
        def __init__(self):
            self.me = self

        def __del__(self):
            events.append("cycle freed")

    class FakeGraph:
        def register_generator_state(self, gen):
            pass

    @contextlib.contextmanager
    def fake_capture(graph, stream=None, capture_error_mode=None):
        events.append(("capture", capture_error_mode))
        yield
        events.append("capture end")

    def fn(x, fail=False):
        keep.clear()                           # the cycle is dead now
        junk = [[i] for i in range(100)]       # tracked allocations
        events.append(("collector on", gc.isenabled(), len(junk)))
        if fail:
            raise RuntimeError("inside the capture")
        return x + 1

    monkeypatch.setattr(torch.cuda, "CUDAGraph", FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", fake_capture)
    keep = [Cycle()]
    threshold = gc.get_threshold()
    gc.set_threshold(1, 1, 1)
    try:
        prog = graphs.CapturedProgram(fn, [torch.zeros(3)], [], None)
        assert events[:3] == [("capture", "thread_local"),
                              ("collector on", False, 100), "capture end"]
        gc.collect()
        assert events[3:] == ["cycle freed"] and gc.isenabled()
        assert torch.equal(prog.static_out[0], torch.ones(3))
        with pytest.raises(RuntimeError, match="inside the capture"):
            graphs.CapturedProgram(lambda x: fn(x, fail=True),
                                   [torch.zeros(3)], [], None)
        assert gc.isenabled()
    finally:
        gc.set_threshold(*threshold)
