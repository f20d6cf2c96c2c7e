"""The port's tuning registry (``raft_tpu_torch/tuning.py``) against the JAX
package's (``raft_tpu/tuning.py``), and ``RAFTConfig.upsample_dtype``.

- Twins of ``tests/test_tuning.py``'s registry cases, each run on both
  packages with knobs both ``RAFTConfig``s have: the round trip, the
  strict write side, the nearest-bucket fallback and its cutoff, no
  fallback across device or kind, the kind preference, defaults-only
  idempotent resolution, pinned knobs, ``RAFT_TUNING=0``, a corrupt
  file, the provenance stamp, and the serve knobs.
- A registry written by the JAX package's ``save_entry`` resolves to the
  same knobs in the port for the knobs both have; a knob the port lacks
  (``scan_unroll`` ...) is ignored with a warning, JAX's rule for
  unknown knobs.
- The consumers: ``make_train_step`` (the state's model reconfigured),
  ``make_inference_model`` (tuning, then the inference override) and the
  serving engine (``stats()["tuning"]``).
- ``upsample_dtype``: each value of the fused-loss training forward
  against JAX's on converted weights (rtol 1e-4, atol 1e-5: the two
  packages sum the same fp32 terms in another order; a bf16 chain rounds
  the same upsampled values in both).
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from raft_tpu import tuning as jtuning
from raft_tpu.config import RAFTConfig as JaxRAFTConfig
from raft_tpu_torch import tuning
from raft_tpu_torch.config import RAFTConfig, TrainConfig

PKGS = {"jax": (jtuning, JaxRAFTConfig), "port": (tuning, RAFTConfig)}


@pytest.fixture
def reg(tmp_path, monkeypatch):
    monkeypatch.delenv("RAFT_TUNING", raising=False)
    return str(tmp_path / "tuning.json")


def _save(mod, reg, kind="train", hw=(368, 496), batch=16, knobs=None,
          device="cpu"):
    return mod.save_entry(kind, hw, batch,
                          knobs or {"corr_block_size": 128, "fused_gru": True},
                          path=reg, device=device)


@pytest.mark.parametrize("pkg", PKGS)
def test_round_trip_and_strict_writes(pkg, reg):
    mod, _ = PKGS[pkg]
    key = _save(mod, reg)
    got_key, entry, exact = mod.lookup("train", (368, 496), 16, path=reg,
                                       device="cpu")
    assert got_key == key == "train|cpu|368x496|b16" and exact
    assert entry["knobs"] == {"corr_block_size": 128, "fused_gru": True}
    assert entry["provenance"]["host"] and entry["provenance"]["updated"]
    with pytest.raises(ValueError, match="unknown tunable knob"):
        _save(mod, reg, knobs={"fused_gru": True, "warp_factor": 9})
    with pytest.raises(ValueError, match="unknown tunable knob"):
        _save(mod, reg, kind="train", knobs={"slots": 16})
    assert _save(mod, reg, kind="serve", knobs={"slots": 16,
                                                "batching": "slot"})


@pytest.mark.parametrize("pkg", PKGS)
def test_nearest_bucket_cutoff_device_and_kind(pkg, reg):
    mod, _ = PKGS[pkg]
    _save(mod, reg, hw=(368, 496), knobs={"corr_block_size": 64})
    _save(mod, reg, hw=(288, 960), knobs={"corr_block_size": 512})
    _, entry, exact = mod.lookup("train", (380, 520), 16, path=reg,
                                 device="cpu")
    assert not exact and entry["bucket_hw"] == [368, 496]
    _, entry, _ = mod.lookup("train", (300, 940), 16, path=reg,
                             device="cpu")
    assert entry["bucket_hw"] == [288, 960]
    _save(mod, reg, hw=(368, 496), batch=4, knobs={"corr_block_size": 32})
    _, entry, _ = mod.lookup("train", (368, 496), 5, path=reg,
                             device="cpu")
    assert entry["batch"] == 4
    # past the cutoff the defaults are the safer guess
    assert mod.lookup("train", (1440, 2560), 1, path=reg,
                      device="cpu") is None
    assert mod.lookup("train", (400, 720), 8, path=reg,
                      device="cpu") is not None
    # never across device kinds or workload kinds
    assert mod.lookup("train", (368, 496), 16, path=reg,
                      device="NVIDIA H100 80GB HBM3") is None
    assert mod.lookup("eval", (368, 496), 16, path=reg,
                      device="cpu") is None
    _save(mod, reg, kind="eval", knobs={"corr_dtype": "float32"})
    assert mod.lookup(("serve", "eval"), (368, 496), 16, path=reg,
                      device="cpu")[1]["kind"] == "eval"
    _save(mod, reg, kind="serve", knobs={"corr_dtype": "bfloat16"})
    assert mod.lookup(("serve", "eval"), (368, 496), 16, path=reg,
                      device="cpu")[1]["kind"] == "serve"


@pytest.mark.parametrize("pkg", PKGS)
def test_resolve_precedence_env_stamp_and_corrupt_file(pkg, reg,
                                                       monkeypatch):
    mod, cfg_cls = PKGS[pkg]
    _save(mod, reg, knobs={"corr_block_size": 128, "fused_gru": True,
                           "upsample_dtype": "bfloat16"})
    tuned, info = mod.resolve_config(cfg_cls.full(), "train", (368, 496),
                                     16, path=reg)
    assert info.tuned and info.exact
    assert (tuned.corr_block_size, tuned.fused_gru,
            tuned.upsample_dtype) == (128, True, "bfloat16")
    again, info2 = mod.resolve_config(tuned, "train", (368, 496), 16,
                                      path=reg)
    assert again == tuned and info2.applied == {}
    pinned, info3 = mod.resolve_config(cfg_cls.full(corr_block_size=32),
                                       "train", (368, 496), 16, path=reg)
    assert pinned.corr_block_size == 32
    assert info3.pinned == {"corr_block_size": 32}
    assert info3.applied == {"fused_gru": True,
                             "upsample_dtype": "bfloat16"}
    stamp = info.stamp()
    assert stamp == {"tuned": True, "tuning_key": "train|cpu|368x496|b16",
                     "tuning_registry_hash": mod.registry_file_hash(reg)}
    _, near = mod.resolve_config(cfg_cls.full(), "train", (400, 720), 8,
                                 path=reg)
    assert near.stamp()["tuning_fallback"] == "nearest-bucket"
    assert mod.TuningInfo(tuned=False).stamp() == {"tuned": False}
    monkeypatch.setenv("RAFT_TUNING", "0")
    off, info4 = mod.resolve_config(cfg_cls.full(), "train", (368, 496),
                                    16, path=reg)
    assert not info4.tuned and off == cfg_cls.full()
    monkeypatch.delenv("RAFT_TUNING")
    bad = reg + ".bad"
    with open(bad, "w") as f:
        f.write("{not json")
    with pytest.warns(UserWarning, match="unreadable"):
        assert mod.lookup("train", (368, 496), 16, path=bad,
                          device="cpu") is None


@pytest.mark.parametrize("pkg", PKGS)
def test_resolve_serve_config(pkg, reg, monkeypatch):
    mod, _ = PKGS[pkg]
    if pkg == "jax":
        from raft_tpu.serve import ServeConfig
    else:
        from raft_tpu_torch.serve import ServeConfig
    _save(mod, reg, kind="serve", knobs={"batching": "slot", "slots": 16,
                                         "early_exit_threshold": 0.05})
    tuned, info = mod.resolve_serve_config(ServeConfig(), path=reg)
    assert (tuned.batching, tuned.slots, tuned.early_exit_threshold) == \
        ("slot", 16, 0.05)
    assert set(info.applied) == {"batching", "slots",
                                 "early_exit_threshold"}
    tuned2, info2 = mod.resolve_serve_config(ServeConfig(slots=4),
                                             path=reg)
    assert tuned2.slots == 4 and info2.pinned == {"slots": 4}
    monkeypatch.setenv("RAFT_TUNING", "0")
    tuned3, info3 = mod.resolve_serve_config(ServeConfig(), path=reg)
    assert not info3.tuned and tuned3 == ServeConfig()


def test_jax_registry_resolves_in_the_port(reg):
    """A registry written by the JAX package (its file, its key) gives the
    port the same knobs for the knobs both have; the JAX-only ones are
    ignored with a warning."""
    shared = {"corr_impl": "chunked", "corr_dtype": "float32",
              "corr_block_size": 64, "remat": True,
              "remat_policy": "full", "remat_upsample": True,
              "upsample_dtype": "bfloat16", "upsample_loss_kernel": "pallas",
              "fused_gru": True}
    key = jtuning.save_entry("train", (368, 496), 8,
                             dict(shared, scan_unroll=6, upsample_group=2),
                             path=reg, device="cpu")
    want, jinfo = jtuning.resolve_config(JaxRAFTConfig.full(), "train",
                                         (368, 496), 8, path=reg)
    with pytest.warns(UserWarning, match="unknown knob"):
        got, info = tuning.resolve_config(RAFTConfig.full(), "train",
                                          (368, 496), 8, path=reg)
    assert info.key == jinfo.key == key
    assert info.applied == shared
    # remat and remat_upsample default to on in JAX (off in the port,
    # PERF.md): the same resolved values, applied only in the port
    assert {k: jinfo.applied[k] for k in shared
            if k not in ("remat", "remat_upsample")} == {
        k: v for k, v in shared.items()
        if k not in ("remat", "remat_upsample")}
    for k in shared:
        assert getattr(got, k) == getattr(want, k), k
    assert info.stamp() == jinfo.stamp()


def test_consumers_apply_the_registry(reg, monkeypatch):
    """``make_train_step`` reconfigures the state's model on its first
    call, ``make_inference_model`` applies tuning before the inference
    override, and the engine reports both tunings in ``stats()``."""
    from raft_tpu_torch.evaluate import make_inference_model
    from raft_tpu_torch.serve import InferenceEngine, ServeConfig
    from raft_tpu_torch.train.step import init_state, make_train_step

    torch.set_num_threads(1)
    monkeypatch.setenv("RAFT_TUNING_REGISTRY", reg)
    tuning.save_entry("train", (32, 32), 2, {"fused_gru": True},
                      path=reg, device="cpu")
    tuning.save_entry("eval", (32, 32), 1,
                      {"corr_impl": "allpairs_pallas",
                       "corr_block_size": 64}, path=reg, device="cpu")
    tuning.save_entry("serve", (40, 56), 2,
                      {"slots": 3, "corr_block_size": 32}, path=reg,
                      device="cpu")
    cfg = TrainConfig(num_steps=2, batch_size=2, image_size=(32, 32),
                      iters=1)
    state = init_state(RAFTConfig.small_model(), cfg, device="cpu")
    gru = state.model.refine["update_block"].gru
    assert not gru.fused
    rng = np.random.default_rng(0)
    batch = {"image1": rng.uniform(0, 255, (2, 32, 32, 3)),
             "image2": rng.uniform(0, 255, (2, 32, 32, 3)),
             "flow": rng.normal(0, 1, (2, 32, 32, 2)),
             "valid": np.ones((2, 32, 32))}
    batch = {k: v.astype(np.float32) for k, v in batch.items()}
    make_train_step(cfg, device="cpu")(state, batch)
    assert state.model.config.fused_gru and gru.fused
    with pytest.raises(ValueError, match="hidden_dim"):
        state.model.reconfigure(RAFTConfig.full())

    model = make_inference_model(RAFTConfig.small_model(), device="cpu",
                                 tuning_kind=("eval",))
    # the registry's corr_impl, then the inference override on top of it
    assert model.config.corr_impl == "allpairs"
    assert model.config.corr_block_size == 64
    # the serve entry's ServeConfig knob is unknown to the model's
    # resolution: ignored there with JAX's warning
    with pytest.warns(UserWarning, match="unknown knob"):
        eng = InferenceEngine(model.state_dict(), RAFTConfig.small_model(),
                              ServeConfig(iters=1), device="cpu")
    st = eng.stats()["tuning"]
    assert eng.cfg.slots == 3 and st["serve_applied"] == {"slots": 3}
    assert st["tuned"] and st["applied"] == {"corr_block_size": 32}
    assert st["tuning_key"] == "serve|cpu|40x56|b2"
    assert eng._model_cfg.corr_block_size == 32
    eng.stop()
    json.dumps(st)


@pytest.fixture(scope="module")
def loss_case():
    from test_torch_fixtures import full_raft_variables, images

    variables, sd = full_raft_variables(0)
    i1, i2 = images(0, 48, 64)
    rng = np.random.default_rng(1)
    gt = (3 * rng.standard_normal((1, 48, 64, 2))).astype(np.float32)
    valid = (rng.random((1, 48, 64)) > 0.1).astype(np.float32)
    return variables, sd, (i1, i2), (gt, valid, 400.0)


@pytest.mark.parametrize("upsample_dtype", ["auto", "float32", "bfloat16"])
def test_upsample_dtype_matches_jax(loss_case, upsample_dtype):
    """The fused-loss training forward (the plain upsample chain) under
    each ``upsample_dtype`` against JAX's: the per-iteration loss terms
    and the metrics."""
    from raft_tpu.models.raft import RAFT as JaxRAFT
    from raft_tpu_torch.models.raft import RAFT

    torch.set_num_threads(1)
    variables, sd, (i1, i2), (gt, valid, max_flow) = loss_case
    (jper, jmet), _ = JaxRAFT(JaxRAFTConfig.full(
        upsample_dtype=upsample_dtype)).apply(
        variables, i1, i2, iters=2, train=True,
        loss_targets=(gt, valid, max_flow), mutable=["batch_stats"])
    cfg = RAFTConfig.full(upsample_dtype=upsample_dtype)
    assert cfg.resolved_upsample_dtype == JaxRAFTConfig.full(
        upsample_dtype=upsample_dtype).resolved_upsample_dtype
    model = RAFT(cfg)
    model.load_state_dict(sd)
    model.train()
    with torch.no_grad():
        per, met = model(torch.from_numpy(i1), torch.from_numpy(i2),
                         iters=2, loss_targets=(torch.from_numpy(gt),
                                                torch.from_numpy(valid),
                                                max_flow))
    np.testing.assert_allclose(per.numpy(), np.asarray(jper), rtol=1e-4,
                               atol=1e-5)
    for k, v in met.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jmet[k]),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    if upsample_dtype == "bfloat16":
        # the knob reached the chain: bf16 rounding moves the 1px share
        fp32 = RAFT(dataclasses.replace(cfg, upsample_dtype="float32"))
        fp32.load_state_dict(sd)
        fp32.train()
        with torch.no_grad():
            _, met32 = fp32(torch.from_numpy(i1), torch.from_numpy(i2),
                            iters=2, loss_targets=(torch.from_numpy(gt),
                                                   torch.from_numpy(valid),
                                                   max_flow))
        assert float(met32["1px"]) != float(met["1px"])
    with pytest.raises(ValueError, match="upsample_dtype"):
        RAFTConfig.full(upsample_dtype="float16")
