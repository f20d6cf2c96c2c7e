"""The port's train and verify-ckpt CLIs on the CPU (twins of
tests/test_cli.py::test_train_cli_few_steps and
tests/test_chaos.py::test_verify_ckpt_cli): ``python -m raft_tpu_torch
train`` on a synthetic FlyingChairs tree (the full model at 64x96, 2
iterations, batch 2), preempted and resumed, its run directory verified
and read by the evaluate CLI; every JAX flag is accepted (the seven
observability flags reach ``TrainConfig`` or
``train()``; a bad trace rate or profiler window is refused with the JAX
CLI's message), and ``--scan_unroll``, which has no counterpart, names
its reason;
``--corr_precision`` validates as JAX's; ``--remat`` and
``--remat_upsample`` map onto the model configuration as JAX's CLI maps
them."""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from raft_tpu.data import frame_utils
from raft_tpu_torch import chaos
from raft_tpu_torch.__main__ import main
from raft_tpu_torch.cli import train as train_cli
from raft_tpu_torch.config import RAFTConfig, TrainConfig
from raft_tpu_torch.train.checkpoint import CheckpointManager
from raft_tpu_torch.train.step import init_state

H, W = 96, 128


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the test runner runs several workers at once,
    and 8 threads a worker on the same cores spend most of their time
    waiting on each other (alone, one thread is as fast here)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(autouse=True)
def no_chaos():
    """The CLI exports its chaos flag to the environment, as JAX's does;
    each test starts and ends without a plan."""
    yield
    os.environ.pop(chaos.ENV_SPEC, None)
    os.environ.pop(chaos.ENV_SEED, None)
    chaos.uninstall()


@pytest.fixture
def chairs_tree(tmp_path):
    rng = np.random.default_rng(0)
    data = tmp_path / "datasets" / "FlyingChairs_release" / "data"
    data.mkdir(parents=True)
    n = 6
    for i in range(n):
        for s in (1, 2):
            arr = rng.integers(0, 255, size=(H, W, 3), dtype=np.uint8)
            Image.fromarray(arr).save(data / f"{i:05d}_img{s}.ppm",
                                      format="PPM")
        frame_utils.write_flo(
            str(data / f"{i:05d}_flow.flo"),
            rng.normal(size=(H, W, 2)).astype(np.float32))
    split = tmp_path / "chairs_split.txt"
    split.write_text("1\n" * (n - 1) + "2\n")
    return tmp_path


def _train_args(tree, *extra):
    return ["train", "--name", "smoke", "--stage", "chairs",
            "--num_steps", "3", "--batch_size", "2",
            "--image_size", "64", "96", "--iters", "2",
            "--precision", "fp32", "--val_freq", "2", "--device", "cpu",
            "--data_root", str(tree / "datasets"),
            "--chairs_split", str(tree / "chairs_split.txt"),
            "--ckpt_dir", str(tree / "ckpts"), "--num_workers", "2", *extra]


def test_train_cli_few_steps(chairs_tree, capsys):
    """Preempted at step 1 (exit 143, step 1 saved), rerun with the same
    flags (resumes, trains to 3), verified, and evaluated from the run
    directory."""
    with pytest.raises(SystemExit) as ex:
        main(_train_args(chairs_tree, "--chaos", "preempt@step=1"))
    os.environ.pop(chaos.ENV_SPEC)
    chaos.uninstall()
    assert ex.value.code == 143
    run_dir = chairs_tree / "ckpts" / "smoke"
    assert CheckpointManager(str(run_dir)).all_steps() == [1]
    out = capsys.readouterr().out
    assert ("remat: --remat none --remat_upsample 0 (the port's defaults, "
            "chosen on the H100)") in out
    assert "preempted at step 1; checkpointing" in out

    assert main(_train_args(chairs_tree)) == 0
    out = capsys.readouterr().out
    assert "resumed from step 1" in out and "Parameter Count:" in out
    assert "throughput:" in out
    assert CheckpointManager(str(run_dir)).all_steps() == [1, 2, 3]

    assert main(["verify-ckpt", str(run_dir), "--json"]) == 0
    rep = json.loads(capsys.readouterr().out.strip())
    assert rep["latest_valid"] == 3 and rep["ok"]

    main(["evaluate", "--model", str(run_dir), "--dataset", "chairs",
          "--precision", "fp32", "--iters", "2", "--device", "cpu",
          "--data_root", str(chairs_tree / "datasets"),
          "--chairs_split", str(chairs_tree / "chairs_split.txt")])
    assert "Validation Chairs EPE:" in capsys.readouterr().out


def test_verify_ckpt_cli(tmp_path, capsys):
    from raft_tpu_torch.cli.verify_ckpt import main as verify_main

    cfg = TrainConfig(num_steps=5, batch_size=1, image_size=(32, 48))
    state = init_state(RAFTConfig.full(), cfg, device="cpu")
    mgr = CheckpointManager(str(tmp_path / "ck"))
    for s in (1, 2, 3):
        state.step = s
        mgr.save(s, state)
    mgr.close()

    assert verify_main([str(tmp_path / "ck")]) == 0
    out = capsys.readouterr().out
    assert "step 3: ok  [saved on 1 x cpu, world 1]" in out
    assert "resume would restore step 3" in out

    chaos.tear_files(str(tmp_path / "ck" / "3"))
    assert verify_main([str(tmp_path / "ck"), "--json"]) == 1
    rep = json.loads(capsys.readouterr().out.strip())
    assert rep["latest_valid"] == 2 and rep["ok"] is False
    assert [(s["step"], s["ok"]) for s in rep["steps"]] == [
        (1, True), (2, True), (3, False)]

    chaos.tear_files(str(tmp_path / "ck" / "1"))
    chaos.tear_files(str(tmp_path / "ck" / "2"))
    assert verify_main([str(tmp_path / "ck")]) == 2
    assert verify_main([str(tmp_path / "empty")]) == 2
    assert not os.path.exists(tmp_path / "empty")


# the seven observability flags the port once refused, each with a value
# and where it lands: a TrainConfig field or a keyword of train()
UNPORTED_VALUES = {
    "profile_dir": ["p"], "telemetry_dir": ["t"],
    "trace_sample_rate": ["0.5"], "watchdog_timeout": ["30"],
    "watchdog_exit": [], "profile_steps": ["1:2"], "forensic_keep": ["0"]}
LANDS = {"profile_dir": ("kw", "p"), "telemetry_dir": ("kw", "t"),
         "trace_sample_rate": ("cfg", 0.5),
         "watchdog_timeout": ("cfg", 30.0), "watchdog_exit": ("cfg", True),
         "profile_steps": ("cfg", (1, 2)), "forensic_keep": ("cfg", 0)}


@pytest.fixture
def stub_train(monkeypatch, tmp_path):
    """The train CLI up to ``train()``, which records its arguments; the
    CLI's exports (the telemetry directory, the SIGQUIT dump) are undone
    afterwards."""
    import faulthandler
    import signal

    from raft_tpu_torch.obs import events
    from raft_tpu_torch.train import loop

    seen = {}

    def fake_train(model_cfg, cfg, **kw):
        seen.update(cfg=cfg, **kw)
        return None

    monkeypatch.setattr(loop, "train", fake_train)
    monkeypatch.chdir(tmp_path)
    for name in ("RAFT_TELEMETRY_DIR", "RAFT_TRACE_SAMPLE_RATE"):
        monkeypatch.setenv(name, "")         # restored to unset afterwards
        monkeypatch.delenv(name)
    yield seen
    faulthandler.unregister(signal.SIGQUIT)
    events.reset_default_sink()


@pytest.mark.parametrize("flag", sorted(UNPORTED_VALUES))
def test_unported_flags_name_their_roadmap_item(flag, chairs_tree,
                                                stub_train, capsys):
    """Every flag the port once refused (naming ROADMAP A8) is accepted
    now, in both spellings, and reaches ``TrainConfig`` or ``train()``;
    ``UNPORTED`` is empty."""
    assert train_cli.UNPORTED == {}
    where, want = LANDS[flag]
    for spelling in (flag, flag.replace("_", "-")):
        stub_train.clear()
        argv = _train_args(chairs_tree, f"--{spelling}",
                           *UNPORTED_VALUES[flag])[1:]
        train_cli.run(argv)
        got = (getattr(stub_train["cfg"], flag) if where == "cfg"
               else stub_train[flag])
        assert got == want, (spelling, got)
    # every fault of the JAX package is known to the port's plans now: an
    # unknown one is refused with the list, the remote fabric's included
    with pytest.raises(SystemExit, match="unknown fault 'net_nope'.*"
                                         "net_refuse.*net_partition"):
        train_cli.run(["--chaos", "net_nope@step=1", "--device", "cpu"])


@pytest.mark.parametrize("argv,message", [
    (["--trace_sample_rate", "1.5"],
     "--trace_sample_rate must be in [0, 1], got 1.5"),
    (["--trace-sample-rate", "-0.1"],
     "--trace_sample_rate must be in [0, 1], got -0.1"),
    (["--profile_steps", "5"],
     "--profile_steps expects A:B (step window), got '5'"),
    (["--profile-steps", "a:b"],
     "--profile_steps expects A:B (step window), got 'a:b'"),
    (["--profile_steps", "7:7"],
     "--profile_steps window must be non-empty, got '7:7'")])
def test_bad_rate_and_window_refused_as_jax(argv, message, chairs_tree,
                                            stub_train):
    """The JAX CLI's refusals and messages (``raft_tpu/cli/train.py:
    372-389``); the rate's default comes from ``$RAFT_TRACE_SAMPLE_RATE``
    as there."""
    with pytest.raises(SystemExit) as ex:
        train_cli.run(_train_args(chairs_tree, *argv)[1:])
    assert str(ex.value) == message
    assert stub_train == {}


def test_trace_rate_default_from_environment(chairs_tree, stub_train,
                                             monkeypatch):
    monkeypatch.setenv("RAFT_TRACE_SAMPLE_RATE", "0.25")
    train_cli.run(_train_args(chairs_tree)[1:])
    assert stub_train["cfg"].trace_sample_rate == 0.25
    assert stub_train["cfg"].profile_steps is None


def test_scan_unroll_is_refused_with_its_reason():
    """``--scan_unroll`` has no counterpart: the captured graph already
    holds every iteration."""
    with pytest.raises(SystemExit, match="no scan to unroll"):
        train_cli.run(["--scan_unroll", "1", "--device", "cpu"])


@pytest.mark.parametrize("value", ["auto", "default", "high", "highest",
                                   "fp32"])
def test_corr_precision_flag_validates_as_jax(value, capsys):
    """``--corr_precision`` takes JAX's vocabulary on the train and the
    evaluate CLI, reaches the model configuration, and a bad value fails
    at parsing with JAX's message."""
    from raft_tpu.config import validate_corr_precision as jax_validate
    from raft_tpu_torch.cli import evaluate as eval_cli

    parsers = (train_cli.parse_args,
               lambda a: eval_cli.parse_args(["--model", "m.pth",
                                              "--dataset", "sintel", *a]))
    for parse in parsers:
        if value == "fp32":
            with pytest.raises(ValueError) as want:
                jax_validate(value)
            with pytest.raises(SystemExit):
                parse(["--corr_precision", value])
            assert str(want.value) in capsys.readouterr().err
        else:
            assert parse(["--corr_precision", value]).corr_precision == value
    if value != "fp32":
        assert RAFTConfig.full(corr_precision=value).corr_precision == value


def test_train_cli_refuses_quantized_ondemand_and_runs_on_the_card(
        monkeypatch):
    with pytest.raises(SystemExit, match="materialized"):
        train_cli.run(["--corr_dtype", "int8", "--corr_impl", "pallas",
                       "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_cli.run([])


@pytest.mark.parametrize("upsample", ["0", "1"])
@pytest.mark.parametrize("remat", ["none", "full", "dots", "save_corr",
                                   "save_corr_upsample"])
def test_remat_flags_map_as_jax(remat, upsample, capsys):
    """Every value of the JAX CLI's ``--remat`` / ``--remat_upsample``,
    mapped as ``raft_tpu/cli/train.py`` maps them, with one line naming
    the policy in force."""
    args = train_cli.parse_args(["--remat", remat,
                                 "--remat_upsample", upsample])
    kw = train_cli.remat_kwargs(args)
    assert kw == dict(remat=remat != "none",
                      remat_policy=remat if remat != "none" else "save_corr",
                      remat_upsample=upsample == "1")
    cfg = RAFTConfig.small_model(**kw)
    assert (cfg.remat, cfg.remat_policy, cfg.remat_upsample) == (
        kw["remat"], kw["remat_policy"], kw["remat_upsample"])
    assert capsys.readouterr().out.startswith(
        f"remat: --remat {remat} --remat_upsample {upsample}")
    defaults = train_cli.parse_args([])
    assert (defaults.remat, defaults.remat_upsample) == ("none", 0)
