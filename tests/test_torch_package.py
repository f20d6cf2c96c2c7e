"""Package contract of the PyTorch port: JAX-free, no silent moves to the
CPU, kernel wrappers that launch or raise."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from raft_tpu_torch.cli import serve as serve_cli
from raft_tpu_torch.cli import train as train_cli
from raft_tpu_torch.config import RAFTConfig, TrainConfig
from raft_tpu_torch.evaluate import (VALIDATORS, evaluate_early_exit_delta,
                                     make_eval_fn, make_inference_model)
from raft_tpu_torch.models.raft import RAFT
from raft_tpu_torch.ops import (build, corr_kernels, gru_gates, lookup_encode,
                                pyramid_kernels, upsample_loss)
from raft_tpu_torch.ops.corr import QuantizedLevel, pool_fmap_pyramid
from raft_tpu_torch.serve import EarlyExitRunner, InferenceEngine
from raft_tpu_torch.train.loop import train
from raft_tpu_torch.train.step import init_state, make_train_step

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "raft_tpu_torch"
MODULES = sorted(
    ".".join(p.relative_to(REPO).with_suffix("").parts).replace(
        ".__init__", "") for p in PKG.rglob("*.py"))


def _forbidden(name):
    return name in ("jax", "raft_tpu") or name.startswith(
        ("jax.", "raft_tpu."))


def test_import_loads_no_jax_and_no_raft_tpu():
    code = ("import sys, importlib\n"
            f"for m in {MODULES!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m in ('jax', 'raft_tpu') or "
            "m.startswith(('jax.', 'raft_tpu.'))]\n"
            "print(len(sys.modules), bad)\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "raft_tpu_torch.cli.demo" in MODULES
    assert {"raft_tpu_torch.train.step", "raft_tpu_torch.train.loop",
            "raft_tpu_torch.ops.pyramid_kernels",
            "raft_tpu_torch.ops.upsample_loss",
            "raft_tpu_torch.ops.lookup_encode", "raft_tpu_torch.__main__",
            "raft_tpu_torch.cli.evaluate", "raft_tpu_torch.data.datasets",
            "raft_tpu_torch.data.png16", "raft_tpu_torch.utils.warp",
            "raft_tpu_torch.native.build", "raft_tpu_torch.data.augment",
            "raft_tpu_torch.data.prefetch", "raft_tpu_torch.chaos",
            "raft_tpu_torch.chaos.errors", "raft_tpu_torch.chaos.plan",
            "raft_tpu_torch.train.checkpoint", "raft_tpu_torch.train.logger",
            "raft_tpu_torch.cli.train", "raft_tpu_torch.cli.verify_ckpt",
            "raft_tpu_torch.curriculum", "raft_tpu_torch.cli.curriculum",
            "raft_tpu_torch.cli.lk_compare", "raft_tpu_torch.serve",
            "raft_tpu_torch.serve.engine", "raft_tpu_torch.serve.slots",
            "raft_tpu_torch.serve.stats", "raft_tpu_torch.cli.serve",
            "raft_tpu_torch.obs", "raft_tpu_torch.obs.registry",
            "raft_tpu_torch.obs.events",
            "raft_tpu_torch.obs.exposition", "raft_tpu_torch.tuning",
            "raft_tpu_torch.cli.cost",
            "raft_tpu_torch.cli.incidents", "raft_tpu_torch.cli.autotune",
            "raft_tpu_torch.cli.replay_step"} <= set(MODULES)
    for name in ("png_filters.c", "aug_ops.c"):
        assert (PKG / "native" / name).is_file()


def test_no_source_imports_jax_or_raft_tpu():
    found = []
    paths = list(PKG.rglob("*.py"))
    assert PKG / "train" / "step.py" in paths
    for path in paths:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            found += [f"{path.name}: {n}" for n in names if _forbidden(n)]
    assert not found, found


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_eval_fn(RAFTConfig.full(), 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_inference_model(RAFTConfig.full())
    for validate in VALIDATORS.values():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            validate({})
    cfg = TrainConfig(num_steps=1, batch_size=1, iters=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_train_step(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_state(RAFTConfig.full(), cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train(RAFTConfig.full(), cfg, iter([]))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_cli.run(["--num_steps", "1"])
    sd = RAFT(RAFTConfig.small_model()).state_dict()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceEngine(sd, RAFTConfig.small_model())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_cli.main(["--random-init", "--small"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        EarlyExitRunner(RAFTConfig.small_model())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        evaluate_early_exit_delta(sd, RAFTConfig.small_model(), [0.1])
    assert InferenceEngine(sd, RAFTConfig.small_model(),
                           device="cpu").device.type == "cpu"
    assert make_eval_fn(RAFTConfig.full(), 2, device="cpu") is not None
    assert make_train_step(cfg, device="cpu") is not None


def test_unported_paths_name_their_slice():
    img = torch.zeros(1, 16, 16, 3)
    cfg = TrainConfig(num_steps=1, batch_size=1, iters=1,
                      image_size=(16, 16))
    batch = {"image1": img.numpy(), "image2": img.numpy(),
             "flow": torch.zeros(1, 16, 16, 2).numpy(),
             "valid": torch.ones(1, 16, 16).numpy()}
    for kw in ({"corr_impl": "pallas"}, {"fused_gru": True},
               {"corr_impl": "pallas", "fused_gru": True,
                "upsample_loss_kernel": "pallas"}):
        # the on-demand lookup and the fused gates train
        state = init_state(RAFTConfig.full(**kw), cfg, device="cpu")
        state, met = make_train_step(cfg, device="cpu")(state, batch)
        assert state.step == 1 and torch.isfinite(met["loss"])
        model = RAFT(RAFTConfig.full(**kw))   # nn.Module starts in train
        flows = model(img, img, iters=1)
        assert flows.shape == (1, 1, 16, 16, 2) and flows.requires_grad
        with torch.no_grad():                 # inference stays open
            lo, _ = model.eval()(img, img, iters=1, test_mode=True)
        assert lo.shape == (1, 2, 2, 2)
    for name in ("int8", "float8_e4m3fn", "float8_e5m2"):
        # quantized pyramids train, unfused and fused; the on-demand
        # lookups and an unfusable configuration are refused at once
        for kw in ({"corr_impl": "allpairs"},
                   {"corr_impl": "allpairs_pallas",
                    "fused_lookup_encoder": True}):
            model = RAFT(RAFTConfig.full(corr_dtype=name, **kw))
            flows = model(img, img, iters=1)
            assert flows.shape == (1, 1, 16, 16, 2) and flows.requires_grad
        with pytest.raises(ValueError, match="materialized"):
            RAFTConfig.full(corr_dtype=name, corr_impl="pallas")
    with pytest.raises(ValueError, match="allpairs_pallas"):
        RAFTConfig.full(fused_lookup_encoder=True)
    # the small model builds, trains and infers; no mask head
    small = RAFT(RAFTConfig.small_model(corr_impl="allpairs_pallas"))
    assert not hasattr(small, "upsampler")
    flows = small(img, img, iters=1)
    assert flows.shape == (1, 1, 16, 16, 2) and flows.requires_grad
    with pytest.raises(ValueError, match="corr_impl"):
        RAFTConfig.full(corr_impl="nope")
    with pytest.raises(ValueError, match="upsample_loss_kernel"):
        RAFTConfig.full(upsample_loss_kernel="triton")
    # the training slice's own configuration runs in train mode
    model = RAFT(RAFTConfig.full(corr_impl="allpairs_pallas",
                                 upsample_loss_kernel="pallas"))
    flows = model(img, img, iters=2)
    assert flows.shape == (2, 1, 16, 16, 2) and flows.requires_grad
    with torch.device("meta"):               # shapes only, no init
        assert RAFT(RAFTConfig.full()).fnet.conv1.weight.is_meta


def test_serving_faults_accepted_net_faults_named():
    """The serving engine's faults and the remote fabric's ``net_*``
    faults parse and fire at their seams (the fabric's by the rule's own
    check ordinal, ``heal=`` closing the window); no fault is left for a
    later slice."""
    from raft_tpu_torch import chaos
    from raft_tpu_torch.chaos.plan import LATER_FAULTS

    for fault in ("device_err", "replica_slow", "replica_hang",
                  "replica_kill"):
        plan = chaos.FaultPlan.parse(f"{fault}@batch=2")
        assert [plan.fires(fault, step=s) for s in (1, 2, 2)] == \
            [False, True, False]
    for fault in ("net_refuse", "net_slow", "net_drop", "net_partition"):
        assert fault in chaos.FAULTS
        plan = chaos.FaultPlan.parse(f"{fault}@step=1,heal=3")
        assert [plan.fires(fault) for _ in range(4)] == \
            [False, True, True, False]
    assert LATER_FAULTS == {}


def test_kernel_wrappers_refuse_meta_tensors():
    """A tensor that is not on the CPU goes to the kernel or raises; it
    never takes the plain version."""
    counters = (corr_kernels.LAUNCHES, gru_gates.LAUNCHES,
                pyramid_kernels.LAUNCHES, upsample_loss.LAUNCHES,
                lookup_encode.LAUNCHES)
    before = [dict(c) for c in counters]
    f1 = torch.empty(1, 6, 8, 32, device="meta")
    f2 = pool_fmap_pyramid(torch.empty(1, 6, 8, 32, device="meta"), 4)
    coords = torch.empty(1, 6, 8, 2, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        corr_kernels.corr_lookup_ondemand(f1, f2, coords, 4)
    with pytest.raises(ValueError, match="CUDA"):
        corr_kernels.corr_lookup_ondemand_nchw(f1, f2, coords, 4)
    h = torch.empty(2, 8, 4, 4, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        gru_gates.gru_gate_rh(h, h)
    with pytest.raises(ValueError, match="CUDA"):
        gru_gates.gru_gate_blend(h, h, h)
    pyr = [torch.empty(1, 48, 6 >> i, 8 >> i, device="meta")
           for i in range(4)]
    with pytest.raises(ValueError, match="CUDA"):
        pyramid_kernels.pyramid_lookup(pyr, coords, 4)
    with pytest.raises(ValueError, match="CUDA"):
        pyramid_kernels.pyramid_lookup_nchw(pyr, coords, 4)
    qpyr = [QuantizedLevel(lv.to(torch.int8), torch.empty(1, 1, 1, 1,
                                                          device="meta"))
            for lv in pyr]
    for fn in (pyramid_kernels.pyramid_lookup_quantized,
               pyramid_kernels.pyramid_lookup_quantized_nchw):
        with pytest.raises(ValueError, match="CUDA"):
            fn(qpyr, coords, 4)
    w = torch.empty(256, 324, 1, 1, device="meta")
    for p in (pyr, qpyr):
        with pytest.raises(ValueError, match="CUDA"):
            lookup_encode.pyramid_lookup_encode(p, coords, 4, w, w[:, 0, 0, 0])
    flow = torch.empty(2, 6, 8, 2, device="meta")
    mask = torch.empty(2, 576, 6, 8, device="meta")
    gt = torch.empty(1, 48, 64, 2, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        upsample_loss.upsample_loss_sums(flow, mask, gt, gt[..., 0])
    assert [dict(c) for c in counters] == before


def test_counters_stay_zero_on_cpu_forward():
    counters = (corr_kernels.LAUNCHES, gru_gates.LAUNCHES,
                pyramid_kernels.LAUNCHES, upsample_loss.LAUNCHES,
                lookup_encode.LAUNCHES)
    before = [dict(c) for c in counters]
    eval_fn = make_eval_fn(RAFTConfig.full(corr_impl="pallas",
                                           fused_gru=True), 2, device="cpu")
    img = torch.rand(1, 32, 48, 3) * 255
    lo, up = eval_fn(RAFT(RAFTConfig.full()).state_dict(), img, img)
    assert lo.shape == (1, 4, 6, 2) and up.shape == (1, 32, 48, 2)
    assert torch.isfinite(up).all()
    cfg = TrainConfig(num_steps=1, batch_size=1, iters=2)
    state = init_state(RAFTConfig.full(corr_impl="allpairs_pallas",
                                       upsample_loss_kernel="pallas"), cfg,
                       device="cpu")
    batch = {"image1": img.numpy(), "image2": img.numpy(),
             "flow": torch.zeros(1, 32, 48, 2).numpy(),
             "valid": torch.ones(1, 32, 48).numpy()}
    state, met = make_train_step(cfg, device="cpu")(state, batch)
    assert state.step == 1 and torch.isfinite(met["loss"])
    for kw in ({"corr_impl": "pallas", "fused_gru": True},
               {"corr_impl": "allpairs_pallas", "corr_dtype": "int8",
                "fused_lookup_encoder": True},
               {"corr_impl": "allpairs_pallas", "corr_dtype": "int8"}):
        state = init_state(RAFTConfig.full(upsample_loss_kernel="pallas",
                                           **kw), cfg, device="cpu")
        state, met = make_train_step(cfg, device="cpu")(state, batch)
        assert state.step == 1 and torch.isfinite(met["loss"])
    assert [dict(c) for c in counters] == before


def test_build_names_sources_and_needs_nvcc(monkeypatch, tmp_path):
    paths = {n: build.library_path(n) for n in build.SOURCES}
    assert set(paths) == {"corr_ondemand", "gru_gates", "lookup_encode",
                          "pyramid_lookup", "upsample_loss"}
    for name, p in paths.items():
        assert (build.CSRC_DIR / f"{name}.cu").is_file()
        assert p.parent == REPO / "build" / "raft_tpu_torch"
        assert p.name.startswith(name + "-") and p.suffix == ".so"
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.find_nvcc()
