"""The port's training loop and checkpoints on the CPU (twins of
tests/test_loop.py, plus what the port's checkpoints must do): the loop
saves every ``val_freq`` steps and resumes from the newest step, a
preemption exits 143 with the last completed step saved, a resumed run
equals an uninterrupted one bit for bit (parameters, AdamW state, dropout
generator), a torn step falls back to the one before it, a structure
mismatch raises, and the image noise is JAX's: the same generator rule
(``SeedSequence([seed + 1, start_step])``) and the same draws.

The full model at 32x48, batch 2, 2 iterations (~0.15 s a step here)."""

import dataclasses

import numpy as np
import pytest
import torch

from raft_tpu.train.loop import add_image_noise as jax_add_image_noise
from raft_tpu_torch import chaos
from raft_tpu_torch.config import RAFTConfig, TrainConfig
from raft_tpu_torch.data.datasets import FlowDataset, ShardedLoader
from raft_tpu_torch.train import loop
from raft_tpu_torch.train.checkpoint import (CheckpointManager,
                                             CheckpointRestoreError)
from raft_tpu_torch.train.step import init_state, make_train_step

H, W = 32, 48


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the test runner runs several workers at once,
    and 8 threads a worker on the same cores spend most of their time
    waiting on each other (alone, one thread is as fast here)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _cfg(tmp_path, name, **kw):
    base = dict(name=name, lr=1e-4, num_steps=4, batch_size=2,
                image_size=(H, W), iters=2, val_freq=2, log_freq=2,
                ckpt_dir=str(tmp_path))
    return TrainConfig(**{**base, **kw})


def _batches(n, seed=0, b=2):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        img1 = rng.uniform(0, 255, size=(b, H, W, 3)).astype(np.float32)
        flow = np.zeros((b, H, W, 2), np.float32)
        flow[..., 0] = 1.0
        yield {"image1": img1, "image2": np.roll(img1, 1, axis=2),
               "flow": flow, "valid": np.ones((b, H, W), np.float32)}


class _Synth(FlowDataset):
    """A dataset of seeded frames: sample i is f(i) plus a draw of the
    loader's per-sample generator."""

    def __init__(self, n=7):
        super().__init__()
        self.image_list = [("a", "b")] * n

    def load(self, index, rng=None):
        base = np.random.default_rng(index).uniform(0, 255, (H, W, 3))
        img1 = np.clip(base + rng.normal(0, 4, base.shape), 0, 255)
        flow = np.full((H, W, 2), 0.5 * (index % 3), np.float32)
        return {"image1": img1.astype(np.float32),
                "image2": np.roll(img1, 1, axis=1).astype(np.float32),
                "flow": flow, "valid": np.ones((H, W), np.float32)}


def _state_tensors(state):
    opt = state.optimizer.state_dict()["state"]
    return ({k: v for k, v in state.model.state_dict().items()},
            {(i, k): v for i, s in opt.items() for k, v in s.items()},
            state.generator.get_state())


def _assert_same_state(a, b):
    (ma, oa, ga), (mb, ob, gb) = _state_tensors(a), _state_tensors(b)
    assert ma.keys() == mb.keys() and oa.keys() == ob.keys()
    for k in ma:
        assert torch.equal(ma[k], mb[k]), k
    for k in oa:
        assert torch.equal(oa[k], ob[k]), k
    assert torch.equal(ga, gb)
    assert (a.step, a.nonfinite_steps) == (b.step, b.nonfinite_steps)


def test_train_loop_checkpoint_and_resume(tmp_path):
    cfg = _cfg(tmp_path, "t")
    calls = []

    def fake_validator(state_dict):
        assert "fnet.conv1.weight" in state_dict
        calls.append(1)
        return {"val/metric": 1.0}

    timings, lines = [], []
    state = loop.train(RAFTConfig.full(), cfg, _batches(10), device="cpu",
                       validators={"fake": fake_validator},
                       timings=timings, log=lines.append)
    assert state.step == 4 and len(calls) == 2     # steps 2 and 4
    assert [t["step"] for t in timings] == [0, 1, 2, 3]
    assert all(t["step_s"] >= t["queue_wait_s"] >= 0 for t in timings)
    assert all(t["h2d_s"] >= 0 and t["prep_s"] >= 0 for t in timings)
    assert lines[0].startswith("[     2,") and "val/metric=1.0000" in lines
    mgr = CheckpointManager(str(tmp_path / "t"))
    assert mgr.all_steps() == [2, 4]
    assert mgr.saved_topology(4)["device"] == "cpu"

    state2 = loop.train(RAFTConfig.full(), dataclasses.replace(
        cfg, num_steps=6), _batches(10), device="cpu")
    assert state2.step == 6
    assert mgr.all_steps() == [2, 4, 6]


def test_checkpoint_manager_roundtrip(tmp_path):
    cfg = _cfg(tmp_path, "ck")
    state = init_state(RAFTConfig.full(), cfg, device="cpu")
    state, _ = make_train_step(cfg, device="cpu")(state, next(_batches(1)))
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save(3, state)
    mgr.save_async(5, state)
    mgr.wait()
    assert mgr.latest_step() == 5 and mgr.all_steps() == [3, 5]
    assert [r["ok"] for r in mgr.verify_all()] == [True, True]
    fresh = init_state(RAFTConfig.full(), dataclasses.replace(cfg, seed=9),
                       device="cpu")
    restored = mgr.restore_latest(fresh)
    assert restored is fresh
    _assert_same_state(restored, state)
    params = mgr.restore_params()
    assert params.keys() == state.model.state_dict().keys()
    mgr.close()
    mgr = CheckpointManager(str(tmp_path / "ck"), max_to_keep=2)
    for s in (6, 7):
        mgr.save(s, state)
    assert mgr.all_steps() == [6, 7]           # the newest max_to_keep
    assert set(mgr.saved_topology()) == {"3", "5", "6", "7"}


def test_single_host_request_preemption_saves_and_resumes(tmp_path):
    """``request_preemption()`` mid-stream exits 143 at the next step
    boundary with the last completed step saved; a fresh ``train()``
    resumes from it.  Serial pipeline, so the step that sees the flag is
    exact."""
    cfg = _cfg(tmp_path, "p", num_steps=6, val_freq=4, device_prefetch=0)

    def preempting_batches():
        for n, b in enumerate(_batches(10)):
            if n == 3:  # while fetching batch 3: seen at step 3's boundary
                loop.request_preemption()
            yield b

    with pytest.raises(SystemExit) as ex:
        loop.train(RAFTConfig.full(), cfg, preempting_batches(),
                   device="cpu")
    assert ex.value.code == 143
    assert CheckpointManager(str(tmp_path / "p")).latest_step() == 3

    state = loop.train(RAFTConfig.full(), cfg, _batches(10), device="cpu")
    assert state.step == 6


def test_resumed_run_equals_uninterrupted_bit_for_bit(tmp_path):
    """Through the loader, with dropout and device prefetch: a run
    preempted at step 2 (the ``preempt`` chaos fault) and resumed ends at
    step 4 with exactly the uninterrupted run's parameters, AdamW state
    and dropout generator."""
    model_cfg = RAFTConfig.full(dropout=0.2)
    loader = lambda: ShardedLoader(_Synth(), batch_size=2, seed=3,
                                   num_workers=2)
    full = loop.train(model_cfg, _cfg(tmp_path, "full"), loader=loader(),
                      device="cpu")
    cfg = _cfg(tmp_path, "cut", val_freq=3)
    chaos.install(chaos.FaultPlan.parse("preempt@step=2"))
    try:
        with pytest.raises(SystemExit) as ex:
            loop.train(model_cfg, cfg, loader=loader(), device="cpu")
    finally:
        chaos.uninstall()
    assert ex.value.code == 143
    assert CheckpointManager(str(tmp_path / "cut")).all_steps() == [2]
    resumed = loop.train(model_cfg, cfg, loader=loader(), device="cpu")
    _assert_same_state(resumed, full)


def test_torn_step_falls_back_and_verify_flags_it(tmp_path, capsys):
    cfg = _cfg(tmp_path, "torn")
    state = init_state(RAFTConfig.full(), cfg, device="cpu")
    mgr = CheckpointManager(str(tmp_path / "torn"))
    for s in (1, 2, 3):
        state.step = s
        mgr.save(s, state)
    chaos.tear_files(str(tmp_path / "torn" / "3"))
    reports = mgr.verify_all()
    assert [(r["step"], r["ok"]) for r in reports] == [
        (1, True), (2, True), (3, False)]
    assert reports[2]["error"].startswith("CheckpointCorruptError")
    restored = mgr.restore_latest(init_state(RAFTConfig.full(), cfg,
                                             device="cpu"))
    assert restored.step == 2
    out = capsys.readouterr().out
    assert "checkpoint fallback: step(s) [3] unrestorable" in out
    # the restore_err fault fails a whole step without touching its files
    chaos.install(chaos.FaultPlan.parse("restore_err@step=2"))
    try:
        assert mgr.restore_latest(init_state(
            RAFTConfig.full(), cfg, device="cpu")).step == 1
    finally:
        chaos.uninstall()
    for s in (1, 2):
        chaos.tear_files(str(tmp_path / "torn" / str(s)))
    with pytest.raises(CheckpointRestoreError, match="all 3 step"):
        mgr.restore_latest(init_state(RAFTConfig.full(), cfg, device="cpu"))


def test_structure_mismatch_raises(tmp_path):
    """A saved state whose keys or shapes differ from the run's is fatal,
    not a step to fall back past, and leaves the template as it was."""
    cfg = _cfg(tmp_path, "s")
    mgr = CheckpointManager(str(tmp_path / "s"))
    mgr.save(1, init_state(RAFTConfig.full(), cfg, device="cpu"))
    other = init_state(RAFTConfig.full(corr_levels=3), cfg, device="cpu")
    before = {k: v.clone() for k, v in other.model.state_dict().items()}
    with pytest.raises(CheckpointRestoreError, match="convc1.weight"):
        mgr.restore_latest(other)
    assert all(torch.equal(before[k], v)
               for k, v in other.model.state_dict().items())
    assert mgr.verify(1)["ok"]
    assert not mgr.verify(1, other)["ok"]


def _captured_run(monkeypatch, cfg, batches, **kw):
    """``train()`` with a step that records the noisy frames it is given
    (the real pipeline, state and checkpoints; no model work)."""
    seen = []

    def fake_make_train_step(cfg, device="cpu"):
        def step_fn(state, batch):
            seen.append(batch["image1"].numpy().copy())
            state.step += 1
            return state, {"loss": torch.zeros(())}
        return step_fn

    monkeypatch.setattr(loop, "make_train_step", fake_make_train_step)
    try:
        loop.train(RAFTConfig.full(), cfg, batches, device="cpu", **kw)
    finally:
        monkeypatch.undo()
    return seen


def test_noise_matches_jax_and_prefetch_invariant(tmp_path, monkeypatch):
    """The noise a run adds is JAX's ``add_image_noise`` under a generator
    from ``SeedSequence([seed + 1, 0])``, batch after batch, bit for bit,
    at device prefetch 0 and 3."""
    host = list(_batches(5, seed=4))
    rng = np.random.default_rng(np.random.SeedSequence([11 + 1, 0]))
    want = [jax_add_image_noise(rng, b)["image1"] for b in host]
    for depth in (0, 3):
        cfg = _cfg(tmp_path, f"n{depth}", num_steps=5, val_freq=100,
                   add_noise=True, seed=11, device_prefetch=depth)
        seen = _captured_run(monkeypatch, cfg, iter(host))
        assert len(seen) == 5
        for got, w in zip(seen, want):
            np.testing.assert_array_equal(got, w)
        assert not np.array_equal(seen[0], host[0]["image1"])


def test_resumed_noise_is_keyed_on_the_resume_step(tmp_path, monkeypatch):
    """A run resumed at step k draws its noise from
    ``SeedSequence([seed + 1, k])``, as JAX's loop does, instead of
    replaying the noise of step 0: the batch of step k gets exactly JAX's
    noise for a run started at k."""
    host = list(_batches(6, seed=5))
    cfg = _cfg(tmp_path, "rn", num_steps=6, val_freq=100, add_noise=True,
               seed=2, device_prefetch=2)
    chaos.install(chaos.FaultPlan.parse("preempt@step=3"))
    try:
        with pytest.raises(SystemExit):
            _captured_run(monkeypatch, cfg, iter(host))
    finally:
        chaos.uninstall()
    assert CheckpointManager(str(tmp_path / "rn")).latest_step() == 3
    seen = _captured_run(monkeypatch, cfg, iter(host[3:]))
    rng = np.random.default_rng(np.random.SeedSequence([2 + 1, 3]))
    want = [jax_add_image_noise(rng, b)["image1"] for b in host[3:]]
    assert len(seen) == 3
    for got, w in zip(seen, want):
        np.testing.assert_array_equal(got, w)
    replay = jax_add_image_noise(
        np.random.default_rng(np.random.SeedSequence([3, 0])), host[3])
    assert not np.array_equal(seen[0], replay["image1"])
