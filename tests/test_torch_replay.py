"""``python -m raft_tpu_torch replay-step`` (``cli/replay_step.py``) on
the CPU, against the JAX package's ``scripts/replay_step.py``.

- a tiny port train run (small model, 32x48, batch 2, 2 iterations,
  fp32) with an ``inf`` pixel at step 2 writes a bundle, and the replay
  from the run's checkpoint reproduces it (``--expect-nonfinite`` exits
  0); a clean bundle of step 1, replayed from the run's step-1
  checkpoint, comes out finite with the loop's own loss at that step
  (``--expect-nonfinite`` exits 1);
- parity with JAX's ``replay(..., random_init=True)``: JAX's init at the
  run's seed, converted with ``convert.py`` into a port checkpoint, gives
  the same ``reproduced`` and the same ``batch_nonfinite_elements``, and
  on the clean bundle the same loss within 1e-4 relative.  On the inf
  pixel every leaf JAX names is named, under JAX's name, and four more:
  the motion encoder's conv biases (ROADMAP C4: at a NaN pre-activation
  torch's relu passes the gradient on, JAX's zeroes it);
- the dropout generator: a bundle of a CUDA generator refuses to replay
  on the CPU when the model draws dropout (naming both devices) and
  replays when it does not; a bundle without its batch stops with JAX's
  message.
"""

import importlib.util
import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from raft_tpu.train import step as jax_step
from raft_tpu_torch.cli import replay_step
from raft_tpu_torch.config import RAFTConfig, TrainConfig
from raft_tpu_torch.convert import state_dict_from_flax
from raft_tpu_torch.obs import health
from raft_tpu_torch.train import loop
from raft_tpu_torch.train.checkpoint import CheckpointManager
from raft_tpu_torch.train.step import init_state

jax_init_state = jax_step.init_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the motion encoder's conv biases: each conv feeds a relu whose
# pre-activation is NaN where the inf pixel reached (ROADMAP C4)
RELU_AT_NAN = {f"refine/update_block/encoder/{c}/bias"
               for c in ("conv", "convc1", "convf1", "convf2")}
CFG = dict(name="rp", lr=2e-4, num_steps=3, batch_size=2,
           image_size=(32, 48), iters=2, val_freq=1, log_freq=1,
           device_prefetch=1, forensic_keep=4)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the runner's workers share the cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _batch(seed, b=2, h=32, w=48):
    rng = np.random.default_rng(seed)
    return {"image1": rng.uniform(0, 255, (b, h, w, 3)).astype(np.float32),
            "image2": rng.uniform(0, 255, (b, h, w, 3)).astype(np.float32),
            "flow": (3 * rng.standard_normal((b, h, w, 2))).astype(
                np.float32),
            "valid": (rng.random((b, h, w)) > 0.1).astype(np.float32)}


def _jax_replay():
    spec = importlib.util.spec_from_file_location(
        "replay_step_jax", os.path.join(REPO, "scripts", "replay_step.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.replay


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The tiny run: its poisoned bundle (step 2), a clean bundle of step
    1 with the step-1 checkpoint alone beside it, and the loop's losses."""
    saved = os.environ.pop("RAFT_TELEMETRY_DIR", None)
    torch.set_num_threads(1)
    root = tmp_path_factory.mktemp("replay")
    batches = [_batch(s) for s in range(3)]
    batches[2]["image1"][1, 5, 7, 0] = np.inf
    cfg = TrainConfig(ckpt_dir=str(root / "ck"), **CFG)
    timings = []
    loop.train(RAFTConfig.small_model(), cfg, iter(batches), device="cpu",
               telemetry_dir=str(root / "tel"), timings=timings,
               log=lambda s: None)
    if saved is not None:
        os.environ["RAFT_TELEMETRY_DIR"] = saved
    (poisoned,) = (root / "tel" / "forensics").glob("*.npz")
    _, meta = health.load_forensic_bundle(str(poisoned))
    clean = health.write_forensic_bundle(
        str(root / "clean"), 1, batches[1],
        {k: v for k, v in meta.items()
         if k not in ("step", "batch_captured")})
    ckpt = str(root / "ck" / "rp")
    step1 = root / "ck1"
    step1.mkdir()
    shutil.copytree(os.path.join(ckpt, "1"), step1 / "1")
    shutil.copy(os.path.join(ckpt, "topology.json"), step1)
    return {"poisoned": str(poisoned), "clean": clean, "ckpt": ckpt,
            "ckpt1": str(step1), "meta": meta, "root": root,
            "losses": [float(t["loss"]) for t in timings]}


def test_poisoned_bundle_reproduces(run, capsys):
    assert os.path.basename(run["poisoned"]) == "step00000002.npz"
    assert run["meta"]["rng"]["device"] == "cpu"
    assert not np.isfinite(run["losses"][2])
    rc = replay_step.main(["--bundle", run["poisoned"], "--ckpt",
                           run["ckpt"], "--expect-nonfinite",
                           "--device", "cpu"])
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and rep["reproduced"]
    assert rep["step"] == 2 and rep["restored_step"] == 3
    assert rep["batch_nonfinite_elements"] == {
        "image1": 1, "image2": 0, "flow": 0, "valid": 0}
    assert "fnet/conv1/kernel" in rep["nonfinite_grad_leaves"]
    assert rep["metrics_at_capture"]["nonfinite"] == 1.0


def test_clean_bundle_is_finite_at_the_loops_loss(run, capsys):
    rc = replay_step.main(["--bundle", run["clean"], "--ckpt", run["ckpt1"],
                           "--expect-nonfinite", "--device", "cpu"])
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 1 and not rep["reproduced"]
    assert rep["restored_step"] == 1 and rep["nonfinite_grad_leaves"] == {}
    np.testing.assert_allclose(rep["loss"], run["losses"][1], rtol=1e-5)


def _port_checkpoint(run, jstate) -> str:
    """JAX's ``--random-init`` state as a port checkpoint."""
    model_cfg = RAFTConfig(**run["meta"]["model_cfg"])
    cfg = TrainConfig(**replay_step._tuplify(
        run["meta"]["train_cfg"],
        ("image_size", "validation", "profile_steps")))
    sd = state_dict_from_flax(jax.device_get(
        {"params": jstate.params, "batch_stats": jstate.batch_stats}),
        model_cfg)
    state = init_state(model_cfg, cfg, device="cpu", state_dict=sd)
    path = str(run["root"] / "jax_init")
    CheckpointManager(path).save(0, state)
    return path


def test_replay_matches_jax_random_init(run, monkeypatch):
    """JAX's replay from its init at the run's seed (kept by a spy on the
    ``init_state`` it calls) against the port's from that init."""
    monkeypatch.setenv("RAFT_TUNING", "0")
    inits = []

    def keep(*args, **kw):
        inits.append(jax_init_state(*args, **kw))
        return inits[-1]

    monkeypatch.setattr(jax_step, "init_state", keep)
    jax_replay = _jax_replay()
    want = {name: jax_replay(run[name], random_init=True)
            for name in ("poisoned", "clean")}
    ckpt = _port_checkpoint(run, inits[0])
    for name in ("poisoned", "clean"):
        got = replay_step.replay(run[name], ckpt=ckpt, device="cpu")
        assert got["reproduced"] == want[name]["reproduced"] == (
            name == "poisoned")
        assert got["batch_nonfinite_elements"] == \
            want[name]["batch_nonfinite_elements"]
        names, jax_names = (set(got["nonfinite_grad_leaves"]),
                            set(want[name]["nonfinite_grad_leaves"]))
        if name == "clean":
            assert names == jax_names == set()
            np.testing.assert_allclose(got["loss"], want[name]["loss"],
                                       rtol=1e-4)
        else:
            assert len(jax_names) > 90 and jax_names <= names
            assert names - jax_names == RELU_AT_NAN


def _bundle(run, tmp_path, dropout, gen_state, device):
    meta = {k: v for k, v in run["meta"].items()
            if k not in ("step", "batch_captured")}
    meta["model_cfg"] = dict(meta["model_cfg"], dropout=dropout)
    meta["rng"] = dict(meta["rng"], generator_state=gen_state.hex(),
                       device=device)
    return health.write_forensic_bundle(str(tmp_path), 1, _batch(1), meta)


def test_generator_of_another_device(run, tmp_path):
    cuda_state = bytes(range(16))      # a CUDA generator's seed + offset
    path = _bundle(run, tmp_path, 0.1, cuda_state, "cuda")
    with pytest.raises(SystemExit, match="cuda generator.*runs on cpu"):
        replay_step.replay(path, random_init=True, device="cpu")
    # no dropout: nothing draws from the generator, so it replays
    path = _bundle(run, tmp_path / "nodrop", 0.0, cuda_state, "cuda")
    assert not replay_step.replay(path, random_init=True,
                                  device="cpu")["reproduced"]
    # a CPU generator's state is restored before the dropout draws
    gen = torch.Generator().manual_seed(7)
    path = _bundle(run, tmp_path / "cpu", 0.1,
                   gen.get_state().numpy().tobytes(), "cpu")
    a = replay_step.replay(path, random_init=True, device="cpu")["loss"]
    b = replay_step.replay(path, random_init=True, device="cpu")["loss"]
    assert np.isfinite(a) and a == b


def test_bundle_without_batch_and_missing_ckpt(run, tmp_path):
    path = health.write_forensic_bundle(str(tmp_path), 4, None,
                                        dict(run["meta"]))
    with pytest.raises(SystemExit, match="no batch arrays"):
        replay_step.replay(path, random_init=True, device="cpu")
    with pytest.raises(SystemExit, match="pass --ckpt"):
        replay_step.main(["--bundle", run["clean"], "--device", "cpu"])
    with pytest.raises(SystemExit, match="no checkpoint"):
        replay_step.replay(run["clean"], ckpt=str(tmp_path / "none"),
                           device="cpu")
