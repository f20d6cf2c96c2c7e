"""The port's ``cost`` CLI (``raft_tpu_torch/cli/cost.py``) against the
JAX package's (``raft_tpu/cli/cost.py``):

- the envelope, the table and the argument plumbing with canned costs
  (the twin of ``tests/test_cost.py::test_cost_cli_envelope``): the same
  ``--json`` object and the same table from both CLIs, the same presets;
- a real ``--tiny --device cpu`` drive through ``python -m
  raft_tpu_torch cost``: the four programs, each counted over one eager
  call (FLOPs and bytes > 0, ``source`` ``counted``), unknown peaks on the
  CPU.
"""

import json

import pytest
import torch

from raft_tpu.cli import cost as jcli
from raft_tpu.obs import cost as jcost
from raft_tpu_torch import __main__ as entry
from raft_tpu_torch.cli import cost as cli
from raft_tpu_torch.obs import cost

PROGRAMS = ["train_step", "inference_48x64", "serve_enc_40x56_b2",
            "serve_iter_40x56_b2"]


def _canned(mod):
    # the default source differs (JAX's "xla", the port's "counted")
    return [mod.ProgramCost(program=p, flops=f, bytes=b, pairs_per_call=n,
                            source="counted")
            for p, f, b, n in zip(PROGRAMS, (4.0e9, 1.0e9, 6.0e8, 2.0e8),
                                  (2.0e9, 5.0e8, 3.0e8, 1.0e8),
                                  (2, 1, 2, 2))]


def test_cost_cli_envelope_matches_jax(capsys, monkeypatch):
    seen = {}

    def fake_jax(model_cfg, train_hw, batch, iters, bucket, lanes,
                 num_data=None):
        seen["jax"] = dict(train_hw=train_hw, batch=batch, iters=iters,
                           bucket=bucket, lanes=lanes)
        return _canned(jcost)

    def fake_port(model_cfg, train_hw, batch, iters, bucket, lanes,
                  device="cuda"):
        seen["port"] = dict(train_hw=train_hw, batch=batch, iters=iters,
                            bucket=bucket, lanes=lanes)
        seen["device"] = str(device)
        return _canned(cost)

    monkeypatch.setattr(jcli, "collect_costs", fake_jax)
    monkeypatch.setattr(cli, "collect_costs", fake_port)
    for argv in (["--tiny", "--json"], ["--tiny"],
                 ["--image-size", "96x128", "--batch", "4", "--json"]):
        assert jcli.main(argv) == 0
        want = capsys.readouterr().out.splitlines()
        assert cli.main(argv + ["--device", "cpu"]) == 0
        got = capsys.readouterr().out.splitlines()
        assert seen["port"] == seen["jax"], argv
        if "--json" in argv:
            assert json.loads(got[-1]) == json.loads(want[-1])
        else:
            # the note names the hardware each package knows peaks for
            assert got[:-1] == want[:-1]
            assert "unknown device peak" in got[-1]
    assert seen["device"] == "cpu"
    assert seen["port"]["train_hw"] == (96, 128)
    assert seen["port"]["bucket"] == (440, 1024)


def test_cost_cli_tiny_drive_on_cpu(capsys):
    torch.set_num_threads(1)
    assert entry.main(["cost", "--tiny", "--device", "cpu", "--json"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert [p["program"] for p in out["programs"]] == PROGRAMS
    for p in out["programs"]:
        assert p["flops"] > 0 and p["bytes"] > 0, p
        assert p["source"] == "counted" and p["device_kind"] == "cpu"
        assert p["flops_per_pair"] > 0
    assert out["peak_tflops"] is None and out["device_kind"] == "cpu"
    if not torch.cuda.is_available():    # the card is the default
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(["--tiny"])
