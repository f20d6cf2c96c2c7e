"""``python -m raft_tpu_torch autotune`` (``cli/autotune.py``) on the CPU,
against the JAX package's ``scripts/autotune.py``.

- the grids: the port's on-card grid is JAX's on-TPU grid less the knobs
  the port's ``RAFTConfig`` lacks, its CPU grid JAX's off-TPU one;
- the point order: ``points`` equals JAX's ``_points`` for the tiny,
  eval and serve grids at seeds 0-2, and on the train grid (and the
  quantized eval grid) JAX's order with the refused points removed;
- ``sweep_id`` moves with each of its inputs, the kernel sources' hash
  among them;
- a sweep's entry is read by JAX's ``raft_tpu.tuning.lookup``; a refused
  point is never timed; the time box still completes one point; a
  previous winner in the registry does not reach the point under test;
- ``autotune --tiny --device cpu`` (train, and ``--kind serve``): sweep,
  cache hit, consumption; ``--seed-known`` refuses off the H100 and
  writes under a monkeypatched H100 device kind.
"""

import importlib.util
import json
import os

import jax
import pytest
import torch

from raft_tpu import tuning as jtuning
from raft_tpu_torch import tuning
from raft_tpu_torch.cli import autotune
from raft_tpu_torch.train import step as step_mod

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(hw=(48, 64), batch_per_chip=2, iters=2, steps=1, warmup=1,
            time_box=900.0, seed=0, tiny=True, device="cpu")
# the JAX knobs the port's RAFTConfig does not have
JAX_ONLY = ("scan_unroll", "fuse_upsample_in_scan")


@pytest.fixture(scope="module")
def jax_autotune():
    spec = importlib.util.spec_from_file_location(
        "autotune_jax", os.path.join(REPO, "scripts", "autotune.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def one_torch_thread(monkeypatch):
    """One intra-op thread (the runner's workers share the cores), and
    neither the tuning switch nor the telemetry directory from outside."""
    monkeypatch.delenv("RAFT_TUNING", raising=False)
    monkeypatch.delenv("RAFT_TELEMETRY_DIR", raising=False)
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.mark.parametrize("kind", ["train", "eval", "serve", "tiny"])
@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_grid_is_jax_grid_less_its_own_knobs(kind, device, jax_autotune,
                                             monkeypatch):
    backend = "tpu" if device == "cuda" else "cpu"
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    want = jax_autotune._grid("train" if kind == "tiny" else kind,
                              kind == "tiny", False)
    got = autotune.grid("train" if kind == "tiny" else kind, kind == "tiny",
                        False, device)
    assert got == {k: v for k, v in want.items() if k not in JAX_ONLY}


POINT_GRIDS = {
    "tiny": lambda: autotune.grid("train", True, False, "cpu"),
    "eval/cpu": lambda: autotune.grid("eval", False, False, "cpu"),
    "eval/card": lambda: autotune.grid("eval", False, False, "cuda"),
    "serve/cpu": lambda: autotune.grid("serve", False, False, "cpu"),
    "serve/card": lambda: autotune.grid("serve", False, False, "cuda"),
    "serve/tiny": lambda: autotune.grid("serve", True, False, "cpu"),
}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name", POINT_GRIDS)
def test_points_equal_jax_points(name, seed, jax_autotune):
    g = POINT_GRIDS[name]()
    want = jax_autotune._points(g, seed)
    assert autotune.points(g, seed) == want
    assert len(want) > 1


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name", ["train/card", "train/cpu",
                                  "eval/quantized"])
def test_points_are_jax_order_less_refused(name, seed, jax_autotune):
    g = {"train/card": lambda: autotune.grid("train", device="cuda"),
         "train/cpu": lambda: autotune.grid("train", device="cpu"),
         "eval/quantized": lambda: autotune.grid(
             "eval", allow_quantized=True, device="cpu")}[name]()
    every = jax_autotune._points(g, seed)
    got = autotune.points(g, seed)
    refused = [p for p in every if autotune.refusal(p) is not None]
    assert got == [p for p in every if p not in refused]
    if name == "train/card":
        # fused_lookup_encoder needs the materialized pyramid kernel
        assert len(every) == 128 and len(refused) == 32
        assert all(p["fused_lookup_encoder"]
                   and p["corr_impl"] != "allpairs_pallas" for p in refused)
    elif name == "eval/quantized":
        # an int8 pyramid needs a materialized one: not under chunked
        assert [(p["corr_impl"], p["corr_dtype"]) for p in refused] == [
            ("chunked", "int8")]
    else:
        assert refused == []


def test_sweep_id_moves_with_each_input():
    base = dict(kind="train", g={"fused_gru": [False, True]}, hw=(48, 64),
                batch=2, iters=2, steps=2, warmup=1, seed=0,
                kernels="k0")
    ids = {autotune.sweep_id(**base)}
    for k, v in (("kind", "eval"), ("g", {"fused_gru": [True, False]}),
                 ("hw", (48, 72)), ("batch", 4), ("iters", 3), ("steps", 3),
                 ("warmup", 2), ("seed", 1), ("kernels", "k1")):
        ids.add(autotune.sweep_id(**dict(base, **{k: v})))
    assert len(ids) == 10
    assert autotune.sweep_id(**base) == autotune.sweep_id(**base)
    # by default the kernels' hash is the one the build keys them by
    no_k = dict(base, kernels=None)
    assert autotune.sweep_id(**no_k) == autotune.sweep_id(
        **dict(base, kernels=autotune.kernel_digest()))


def test_entry_read_by_jax_lookup(tmp_path, capsys):
    out = str(tmp_path / "tuning.json")
    rec = autotune.run_sweep("train", out=out, **TINY)
    cfg = rec["config"]
    assert not cfg["cache_hit"] and cfg["points_refused"] == 0
    assert cfg["points_tried"] == cfg["points_total"] == 2
    assert [r["knobs"] for r in cfg["results"]] == autotune.points(
        autotune.grid("train", True, False, "cpu"), 0)
    key, entry, exact = jtuning.lookup("train", (48, 64), 2, path=out,
                                       device="cpu")
    assert exact and key == cfg["key"] == "train|cpu|48x64|b2"
    assert entry["knobs"] == cfg["knobs"]
    prov = entry["provenance"]
    assert prov["tool"] == "raft_tpu_torch autotune"
    assert prov["sweep_id"] == cfg["sweep_id"] and prov["card"] == "cpu"
    assert "[2/2]" in capsys.readouterr().out
    # the same sweep again: a hit, no point timed
    again = autotune.run_sweep("train", out=out, **TINY)
    assert again["config"]["cache_hit"] and "results" not in again["config"]


def test_refused_point_never_timed_and_time_box(tmp_path, monkeypatch):
    timed = []
    monkeypatch.setitem(autotune.TIMERS, "train",
                        lambda knobs, *a: timed.append(knobs) or 1.0)
    g = {"corr_impl": ["allpairs"], "fused_lookup_encoder": [False, True],
         "fused_gru": [False, True]}
    rec = autotune.run_sweep("train", out=str(tmp_path / "a.json"),
                             grid=g, **TINY)
    assert rec["config"]["points_refused"] == 2
    assert rec["config"]["points_total"] == 2
    assert timed and all(not k["fused_lookup_encoder"] for k in timed)
    timed.clear()
    rec = autotune.run_sweep("train", out=str(tmp_path / "b.json"),
                             grid=g, **dict(TINY, time_box=0.0))
    assert len(timed) == 1 and rec["config"]["points_tried"] == 1


def test_previous_winner_does_not_leak(tmp_path, monkeypatch):
    """A registry whose winner pins ``fused_gru=True`` for the very key
    under sweep: the point ``fused_gru=False`` still runs unfused, and
    the registry switch is back as it was afterwards."""
    out = str(tmp_path / "tuning.json")
    tuning.save_entry("train", (48, 64), 2, {"fused_gru": True}, path=out)
    monkeypatch.setenv(tuning.ENV_REGISTRY, out)
    seen = []
    real = step_mod._apply_tuning

    def spy(model, cfg, world):
        info = real(model, cfg, world)
        seen.append((info.tuned, model.config.fused_gru))
        return info

    monkeypatch.setattr(step_mod, "_apply_tuning", spy)
    rec = autotune.run_sweep("train", out=out, grid={"fused_gru": [False]},
                             **TINY)
    assert seen == [(False, False)]
    assert rec["config"]["knobs"] == {"fused_gru": False}
    assert os.environ.get(tuning.ENV_DISABLE) is None


def test_tiny_cli(tmp_path, capsys):
    out = str(tmp_path / "tuning.json")
    rc = autotune.main(["--tiny", "--device", "cpu", "--out", out])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and rec["metric"] == "autotune_tiny", rec
    cfg = rec["config"]
    assert cfg["first_cache_hit"] is False
    assert cfg["second_cache_hit"] is True
    assert cfg["consumed_by_train_step"] is True
    assert cfg["consumed_key"] == "train|cpu|48x64|b2"
    assert cfg["tiny_output_finite"] is True and cfg["registry_hash"]
    assert os.environ.get(tuning.ENV_DISABLE) is None
    assert os.environ[tuning.ENV_REGISTRY] != out     # restored


def test_tiny_serve_sweep(tmp_path, capsys):
    out = str(tmp_path / "tuning.json")
    rc = autotune.main(["--tiny", "--kind", "serve", "--device", "cpu",
                        "--out", out])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0, rec
    cfg = rec["config"]
    assert cfg["second_cache_hit"] and cfg["consumed_by_engine"]
    assert cfg["winner"]["batching"] in ("request", "slot")
    assert cfg["consumed_key"] == "serve|cpu|48x64|b2"


def test_seed_known_only_on_the_h100(tmp_path, capsys, monkeypatch):
    out = str(tmp_path / "tuning.json")
    assert autotune.main(["--seed-known", "--out", out]) == 2
    err = capsys.readouterr().err
    assert autotune.KNOWN_DEVICE in err and "'cpu'" in err
    assert not os.path.exists(out)
    monkeypatch.setattr(tuning, "device_kind",
                        lambda: autotune.KNOWN_DEVICE)
    assert autotune.main(["--seed-known", "--out", out]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["value"] == float(len(autotune.KNOWN_WINNERS)) == 3.0
    for (kind, hw, batch), (knobs, value) in autotune.KNOWN_WINNERS.items():
        key, entry, exact = tuning.lookup(kind, hw, batch, path=out)
        assert exact and entry["knobs"] == knobs
        assert entry["device_kind"] == autotune.KNOWN_DEVICE
        prov = entry["provenance"]
        assert prov["mode"] == "seed-known" and "sweep_id" not in prov
        assert prov["card"] == autotune.KNOWN_DEVICE
        assert prov["power_limit"] == autotune.KNOWN_POWER_LIMIT
        assert prov["best_value"] == value and value > 0
        allowed = set(tuning.TUNABLE_KNOBS) | (
            set(tuning.SERVE_TUNABLE_KNOBS) if kind == "serve" else set())
        assert set(knobs) <= allowed
        assert autotune.refusal(knobs) is None
        # a seeded entry never turns early exit on: answers stay exact
        assert knobs.get("early_exit_threshold", 0.0) == 0.0


def test_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        autotune.main(["--tiny"])
