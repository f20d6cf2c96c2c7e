"""The port's curriculum driver (twins of ``tests/test_curriculum.py``:
the manifest and the paper's schedule, equal to the JAX package's; argv
building; the stage ledger's resume and refusal; ``run_curriculum`` with
a stub train runner; the ``stage_kill`` fault; the CLI), then the twin of
``tests/test_cli.py::test_train_cli_curriculum_restore`` with ``--small
--device cpu`` and one real two-stage curriculum killed at the stage
boundary and resumed."""

import json
import os
import os.path as osp

import numpy as np
import pytest
import torch
from PIL import Image

from raft_tpu.curriculum import Manifest as JaxManifest
from raft_tpu.curriculum import argv_from_overrides as jax_argv
from raft_tpu.data import frame_utils
from raft_tpu_torch import chaos
from raft_tpu_torch.chaos import FaultPlan
from raft_tpu_torch.curriculum import (LEDGER_FILE, Manifest, StageLedger,
                                       StageSpec, argv_from_overrides,
                                       run_curriculum)
from raft_tpu_torch.train.checkpoint import CheckpointManager

H, W = 64, 96


@pytest.fixture(autouse=True)
def _no_leaked_plan():
    chaos.uninstall()
    yield
    os.environ.pop(chaos.ENV_SPEC, None)
    chaos.uninstall()


@pytest.fixture(autouse=True)
def _one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


class _FakeState:
    def __init__(self, step):
        self.step = step


def _stub_runner(log, final_step=7, die_on=None):
    """argv -> _FakeState; records every call.  ``die_on``: stage name
    whose first run raises SystemExit(143) (cooperative preemption)."""
    dead = set()

    def run(argv):
        log.append(list(argv))
        name = argv[argv.index("--name") + 1]
        if die_on and name == die_on and name not in dead:
            dead.add(name)
            print(f"preempted in {name}")
            raise SystemExit(143)
        print(f"Validation ({name}) epe: 0.5")
        return _FakeState(final_step)

    return run


def _manifest():
    return Manifest(
        base={"iters": 2, "num_steps": 7},
        stages=[StageSpec("s1", "chairs", {"lr": 1e-3}),
                StageSpec("s2", "things", {"small": True})])


# ---------------------------------------------------------------------
# manifest + argv building
# ---------------------------------------------------------------------

def test_manifest_standard_matches_paper_and_jax():
    """The reference train_standard.sh schedule, as data, equal to the JAX
    package's (to_dict and fingerprint)."""
    m = Manifest.standard()
    assert m.to_dict() == JaxManifest.standard().to_dict()
    assert m.fingerprint() == JaxManifest.standard().fingerprint()
    assert [(s.name, s.stage) for s in m.stages] == [
        ("raft-chairs", "chairs"), ("raft-things", "things"),
        ("raft-sintel", "sintel"), ("raft-kitti", "kitti")]
    o = {s.stage: s.overrides for s in m.stages}
    assert [o[s]["num_steps"] for s in
            ("chairs", "things", "sintel", "kitti")] == [
        100000, 100000, 100000, 50000]
    assert [o[s]["batch_size"] for s in
            ("chairs", "things", "sintel", "kitti")] == [10, 6, 6, 6]
    assert o["chairs"]["lr"] == 4e-4 and o["kitti"]["lr"] == 1e-4
    assert o["chairs"]["wdecay"] == 1e-4 and o["sintel"]["wdecay"] == 1e-5
    assert o["sintel"]["gamma"] == 0.85 and "gamma" not in o["chairs"]
    assert o["kitti"]["image_size"] == [288, 960]
    assert Manifest.from_dict(m.to_dict()).fingerprint() == m.fingerprint()


def test_manifest_validation_and_fingerprint(tmp_path):
    with pytest.raises(ValueError, match="no stages"):
        Manifest.from_dict({"stages": []})
    with pytest.raises(ValueError, match="duplicate stage names"):
        Manifest.from_dict({"stages": [
            {"name": "a", "stage": "chairs"},
            {"name": "a", "stage": "things"}]})
    m1, m2 = _manifest(), _manifest()
    assert m1.fingerprint() == m2.fingerprint()
    m2.stages[0].overrides["lr"] = 9e-9
    assert m1.fingerprint() != m2.fingerprint()
    path = tmp_path / "m.json"
    path.write_text(json.dumps(m1.to_dict()))
    assert Manifest.from_json(str(path)).fingerprint() == m1.fingerprint()
    assert JaxManifest.from_json(str(path)).fingerprint() == \
        m1.fingerprint()


def test_argv_from_overrides():
    overrides = {
        "small": True, "mixed_precision": False, "restore_ckpt": None,
        "image_size": [368, 496], "validation": ("chairs", "sintel"),
        "lr": 4e-4, "num_steps": 100000}
    argv = argv_from_overrides(overrides)
    assert argv == ["--small", "--image_size", "368", "496",
                    "--validation", "chairs", "sintel",
                    "--lr", "0.0004", "--num_steps", "100000"]
    assert argv == jax_argv(overrides)


# ---------------------------------------------------------------------
# stage ledger
# ---------------------------------------------------------------------

def test_ledger_begin_update_normalize(tmp_path):
    led = StageLedger(str(tmp_path / LEDGER_FILE))
    led.begin(_manifest())
    assert osp.exists(led.path)
    assert not osp.exists(led.path + ".tmp")  # atomic tmp+rename
    led.update("s1", status="complete", final_step=7)
    led2 = StageLedger(led.path)
    led2.load()
    assert led2.normalized() == {
        "status": "running",
        "stages": {"s1": {"status": "complete", "final_step": 7},
                   "s2": {"status": "pending", "final_step": None}}}


def test_ledger_refuses_changed_manifest(tmp_path):
    led = StageLedger(str(tmp_path / LEDGER_FILE))
    led.begin(_manifest())
    changed = _manifest()
    changed.stages[1].overrides["lr"] = 5e-4
    with pytest.raises(ValueError, match="CHANGED schedule"):
        StageLedger(led.path).begin(changed)
    StageLedger(led.path).begin(_manifest())


# ---------------------------------------------------------------------
# run_curriculum: fresh run, skip-complete, seeding, resume
# ---------------------------------------------------------------------

def test_run_curriculum_fresh_then_noop_rerun(tmp_path, monkeypatch):
    from raft_tpu_torch.obs import events as events_mod

    tel = tmp_path / "tel"
    monkeypatch.setenv("RAFT_TELEMETRY_DIR", str(tel))
    events_mod.reset_default_sink()
    wd = str(tmp_path / "wd")
    log = []
    state = run_curriculum(_manifest(), wd, extra_argv=["--seed", "3"],
                           train_runner=_stub_runner(log))
    assert state["status"] == "complete"
    assert len(log) == 2
    a1, a2 = log
    assert a1[:6] == ["--name", "s1", "--stage", "chairs",
                      "--ckpt_dir", osp.join(wd, "checkpoints")]
    assert a1[-2:] == ["--seed", "3"]
    assert "--lr" in a1 and "--small" not in a1
    assert "--small" in a2
    assert a2[-2:] == ["--restore_ckpt",
                       osp.join(wd, "checkpoints", "s1")]
    assert "--restore_ckpt" not in a1

    led = StageLedger(osp.join(wd, LEDGER_FILE))
    led.load()
    for name in ("s1", "s2"):
        e = led.stage(name)
        assert e["status"] == "complete" and e["final_step"] == 7
        assert e["runs"] == 1
        assert e["validation"] == [f"Validation ({name}) epe: 0.5"]
    # one curriculum_stage event a transition in the process-wide sink's
    # JSONL, the fields of JAX's
    events_mod.default_sink().flush()
    (f,) = tel.glob("telemetry-p*.jsonl")
    events = [json.loads(ln) for ln in f.read_text().splitlines()]
    events_mod.reset_default_sink()
    assert [(e["event"], e["name"], e["status"]) for e in events] == [
        ("curriculum_stage", "s1", "running"),
        ("curriculum_stage", "s1", "complete"),
        ("curriculum_stage", "s2", "running"),
        ("curriculum_stage", "s2", "complete")]
    assert events[0]["attempt"] == 1 and events[1]["final_step"] == 7

    run_curriculum(_manifest(), wd, train_runner=_stub_runner(log))
    events_mod.reset_default_sink()
    assert len(log) == 2


def test_run_curriculum_resumes_mid_stage_kill(tmp_path):
    wd, wd_ref = str(tmp_path / "wd"), str(tmp_path / "ref")
    ref = run_curriculum(_manifest(), wd_ref, train_runner=_stub_runner([]))

    log = []
    with pytest.raises(SystemExit) as ei:
        run_curriculum(_manifest(), wd,
                       train_runner=_stub_runner(log, die_on="s2"))
    assert ei.value.code == 143
    led = StageLedger(osp.join(wd, LEDGER_FILE))
    led.load()
    assert led.stage("s1")["status"] == "complete"
    assert led.stage("s2")["status"] == "running"
    assert led.state["status"] == "running"

    state = run_curriculum(_manifest(), wd, train_runner=_stub_runner(log))
    assert [a[a.index("--name") + 1] for a in log] == ["s1", "s2", "s2"]
    led.load()
    assert led.stage("s2")["runs"] == 2
    assert state["status"] == "complete"
    ref_led = StageLedger(osp.join(wd_ref, LEDGER_FILE))
    ref_led.load()
    assert ref["status"] == "complete"
    assert led.normalized() == ref_led.normalized() == {
        "status": "complete",
        "stages": {"s1": {"status": "complete", "final_step": 7},
                   "s2": {"status": "complete", "final_step": 7}}}


def test_stage_kill_chaos_fires_at_boundary(tmp_path):
    wd = str(tmp_path / "wd")
    log = []
    chaos.install(FaultPlan.parse("stage_kill@step=1"))
    with pytest.raises(SystemExit) as ei:
        run_curriculum(_manifest(), wd, train_runner=_stub_runner(log))
    assert ei.value.code == 143
    led = StageLedger(osp.join(wd, LEDGER_FILE))
    led.load()
    assert led.stage("s1")["status"] == "complete"
    assert led.stage("s2")["status"] == "pending"  # never started

    chaos.uninstall()
    run_curriculum(_manifest(), wd, train_runner=_stub_runner(log))
    assert [a[a.index("--name") + 1] for a in log] == ["s1", "s2"]


def test_curriculum_cli_dump_manifest(capsys):
    from raft_tpu_torch.__main__ import main

    assert main(["curriculum", "--dump-manifest"]) == 0
    dumped = json.loads(capsys.readouterr().out)
    assert Manifest.from_dict(dumped).fingerprint() == \
        Manifest.standard().fingerprint()
    with pytest.raises(SystemExit, match="--workdir is required"):
        main(["curriculum"])


# ---------------------------------------------------------------------
# the real train entry point under the driver, on the CPU
# ---------------------------------------------------------------------

@pytest.fixture
def chairs_tree(tmp_path):
    rng = np.random.default_rng(0)
    data = tmp_path / "datasets" / "FlyingChairs_release" / "data"
    data.mkdir(parents=True)
    n = 4
    for i in range(n):
        for s in (1, 2):
            arr = rng.integers(0, 255, size=(H, W, 3), dtype=np.uint8)
            Image.fromarray(arr).save(data / f"{i:05d}_img{s}.ppm",
                                      format="PPM")
        frame_utils.write_flo(str(data / f"{i:05d}_flow.flo"),
                              rng.normal(size=(H, W, 2)).astype(np.float32))
    split = tmp_path / "chairs_split.txt"
    split.write_text("1\n" * (n - 1) + "2\n")
    return tmp_path


def _common(tree):
    return ["--stage", "chairs", "--small", "--batch_size", "2",
            "--image_size", "48", "64", "--iters", "2", "--precision",
            "fp32", "--device", "cpu",
            "--data_root", str(tree / "datasets"),
            "--chairs_split", str(tree / "chairs_split.txt"),
            "--num_workers", "2"]


def test_train_cli_curriculum_restore(chairs_tree, monkeypatch, capsys):
    """Stage-to-stage weight seeding via ``--restore_ckpt`` (the
    curriculum's chaining mechanism), the small model on the CPU."""
    from raft_tpu_torch.cli import train as train_cli

    monkeypatch.chdir(chairs_tree)
    common = _common(chairs_tree) + ["--ckpt_dir",
                                     str(chairs_tree / "ckpts")]
    train_cli.main(["--name", "stage-a", "--num_steps", "2"] + common)
    train_cli.main(["--name", "stage-b", "--num_steps", "1",
                    "--restore_ckpt", str(chairs_tree / "ckpts/stage-a")]
                   + common)
    out = capsys.readouterr().out
    assert "restored weights from" in out
    assert "remat: --remat none --remat_upsample 0 (the port's defaults" \
        in out
    run_dir = chairs_tree / "ckpts" / "stage-b"
    steps = [d for d in os.listdir(run_dir) if d.isdigit()]
    assert steps, os.listdir(run_dir)


def test_curriculum_cli_stage_kill_then_resume(chairs_tree, capfd):
    """``python -m raft_tpu_torch curriculum`` over two one-step stages of
    the small model: ``stage_kill@step=1`` exits 143 between them with
    stage 1 complete; the rerun skips stage 1 and completes stage 2,
    seeded from stage 1's run directory."""
    from raft_tpu_torch.__main__ import main

    manifest = chairs_tree / "m.json"
    manifest.write_text(json.dumps({
        "base": {"num_steps": 1, "val_freq": 1},
        "stages": [{"name": "a", "stage": "chairs", "overrides": {}},
                   {"name": "b", "stage": "chairs",
                    "overrides": {"lr": 1e-4}}]}))
    wd = chairs_tree / "wd"
    argv = ["curriculum", "--workdir", str(wd), "--manifest", str(manifest),
            *_common(chairs_tree)]
    os.environ[chaos.ENV_SPEC] = "stage_kill@step=1"
    with pytest.raises(SystemExit) as ei:
        main(argv)
    assert ei.value.code == 143
    os.environ.pop(chaos.ENV_SPEC)
    chaos.uninstall()
    led = StageLedger(str(wd / LEDGER_FILE))
    led.load()
    assert led.normalized()["stages"] == {
        "a": {"status": "complete", "final_step": 1},
        "b": {"status": "pending", "final_step": None}}
    capfd.readouterr()

    assert main(argv) == 0
    out = capfd.readouterr().out      # the driver's tee writes to fd 1
    led.load()
    assert led.normalized() == {"status": "complete", "stages": {
        "a": {"status": "complete", "final_step": 1},
        "b": {"status": "complete", "final_step": 1}}}
    assert led.stage("a")["runs"] == 1
    assert led.stage("b")["argv"][-2:] == ["--restore_ckpt",
                                          str(wd / "checkpoints" / "a")]
    assert f"restored weights from {wd / 'checkpoints' / 'a'}" in out
    assert CheckpointManager(str(wd / "checkpoints" / "b")).all_steps() \
        == [1]
