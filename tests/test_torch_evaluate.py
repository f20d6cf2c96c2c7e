"""The port's evaluation path against the JAX package's (twins of
tests/test_evaluate.py): validators, submissions, ``evaluate_epe_delta``
and the evaluate CLI on the same synthetic trees, with the full model at
48x64, 2 iterations, fp32, on converted seeded weights.

Tolerances: per-pixel flows rtol 1e-4, atol 1e-3 px (the bound of
tests/test_torch_raft.py); EPE and the 1/3/5 px fractions within 1e-3;
KITTI's F1-all equal up to the pixels whose EPE lies within 1e-3 px of a
threshold (3 px, or 5% of |gt|), which are counted and allowed.

Every fixture is 48x64 (KITTI's mixed resolutions bucket to it), so the
JAX validators share one ``make_eval_fn`` at batch 2: JAX compiles the
forward once with ``flow_init`` and once without (plus batch 1 for the
exactly padded KITTI submission).  The JAX arms run with ``RAFT_TUNING=0``
so that no tuning registry on the machine changes their configuration.
"""

import os.path as osp
import re

import numpy as np
import pytest
import torch
from PIL import Image

from raft_tpu import evaluate as jev
from raft_tpu.config import RAFTConfig as JaxRAFTConfig
from raft_tpu.data import datasets as jds
from raft_tpu.data import frame_utils as jfu
from raft_tpu_torch import __main__ as tmain
from raft_tpu_torch import evaluate as tev
from raft_tpu_torch.cli import evaluate as tcli
from raft_tpu_torch.config import RAFTConfig
from raft_tpu_torch.data import datasets as tds
from raft_tpu_torch.data import frame_utils as tfu

from test_torch_fixtures import full_raft_variables

H, W = 48, 64
ITERS, BS = 2, 2
TOL = dict(rtol=1e-4, atol=1e-3)
KITTI_SIZES = [(48, 64), (42, 58), (46, 62)]
SUBMISSION_LANES = {"alley_1": 4, "bandage_2": 2}   # frame pairs a scene


@pytest.fixture(autouse=True)
def _no_tuning_no_telemetry(monkeypatch):
    monkeypatch.setenv("RAFT_TUNING", "0")
    monkeypatch.delenv("RAFT_TELEMETRY_DIR", raising=False)


@pytest.fixture(scope="module")
def weights():
    return full_raft_variables(0)


@pytest.fixture(scope="module")
def jax_eval_fn():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RAFT_TUNING", "0")
        return jev.make_eval_fn(JaxRAFTConfig.full(), ITERS)


def _img(path, rng, size=(H, W), fmt=None):
    Image.fromarray(rng.integers(0, 255, size + (3,), dtype=np.uint8)).save(
        path, format=fmt)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("datasets")
    rng = np.random.default_rng(0)
    sintel = root / "Sintel"
    for split, lanes in (("training", {"alley_1": 2, "ambush_2": 1}),
                         ("test", SUBMISSION_LANES)):
        for scene, pairs in lanes.items():
            for dstype in ("clean", "final"):
                d = sintel / split / dstype / scene
                d.mkdir(parents=True)
                for i in range(pairs + 1):
                    _img(d / f"frame_{i:04d}.png", rng)
            if split == "training":
                d = sintel / "training" / "flow" / scene
                d.mkdir(parents=True)
                for i in range(pairs):
                    jfu.write_flo(str(d / f"frame_{i:04d}.flo"),
                                  rng.normal(scale=2, size=(H, W, 2)))
    kitti = root / "KITTI"
    for split in ("training", "testing"):
        d = kitti / split / "image_2"
        d.mkdir(parents=True)
        for i, size in enumerate(KITTI_SIZES):
            _img(d / f"{i:06d}_10.png", rng, size)
            _img(d / f"{i:06d}_11.png", rng, size)
    (kitti / "training" / "flow_occ").mkdir()
    for i, size in enumerate(KITTI_SIZES):
        flow = rng.normal(scale=3, size=size + (2,))
        png = np.concatenate([64.0 * flow + 2 ** 15,
                              rng.random(size + (1,)) > 1 / 3], -1)
        jfu.write_png(str(kitti / "training" / "flow_occ" / f"{i:06d}_10.png"),
                      png.astype(np.uint16))
    chairs = root / "FlyingChairs_release" / "data"
    chairs.mkdir(parents=True)
    for i in range(3):
        _img(chairs / f"{i:05d}_img1.ppm", rng, fmt="PPM")
        _img(chairs / f"{i:05d}_img2.ppm", rng, fmt="PPM")
        jfu.write_flo(str(chairs / f"{i:05d}_flow.flo"),
                      rng.normal(scale=2, size=(H, W, 2)))
    (root / "chairs_split.txt").write_text("2\n1\n2\n")
    return {"root": str(root), "sintel": str(sintel), "kitti": str(kitti),
            "chairs": str(chairs), "split": str(root / "chairs_split.txt")}


def _flows(weights, jax_eval_fn, jax_ds, port_ds, mode, target=None):
    """Per-image flows of both packages through their ``_batched_flows``,
    held to the per-pixel tolerance; returns (samples, port, jax)."""
    variables, sd = weights
    want = list(jev._batched_flows(variables, jax_eval_fn, jax_ds, mode, BS,
                                   target=target))
    eval_fn = tev.make_eval_fn(RAFTConfig.full(), ITERS, device="cpu")
    got = list(tev._batched_flows(sd, eval_fn, port_ds, mode, BS,
                                  target=target))
    assert len(got) == len(want) == len(jax_ds)
    for (s, g), (_, w) in zip(got, want):
        assert g.shape == w.shape == s["image1"].shape[:2] + (2,)
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, np.asarray(w), **TOL)
    return ([s for s, _ in got], [g for _, g in got],
            [np.asarray(w) for _, w in want])


def _lines(out):
    """Printed validator lines with their numbers taken out, and the
    numbers."""
    lines = [ln for ln in out.splitlines() if ln.startswith(("Validation",
                                                             "EPE delta"))]
    return ([re.sub(r"[-+]?\d+\.\d+", "#", ln) for ln in lines],
            [float(x) for ln in lines
             for x in re.findall(r"[-+]?\d+\.\d+", ln)])


def _same_lines(capsys, run_port, run_jax):
    """Both arms' results and printed lines: the same text, numbers
    within 1e-3 (plus the last printed digit's rounding)."""
    capsys.readouterr()
    got = run_port()
    port_text, port_nums = _lines(capsys.readouterr().out)
    want = run_jax()
    jax_text, jax_nums = _lines(capsys.readouterr().out)
    assert port_text == jax_text and port_text
    np.testing.assert_allclose(port_nums, jax_nums, rtol=0, atol=1.5e-3)
    return got, want


def test_validate_sintel(weights, jax_eval_fn, trees, capsys):
    variables, sd = weights
    got, want = _same_lines(
        capsys,
        lambda: tev.validate_sintel(sd, RAFTConfig.full(), iters=ITERS,
                                    root=trees["sintel"], batch_size=BS,
                                    device="cpu"),
        lambda: jev.validate_sintel(variables, JaxRAFTConfig.full(),
                                    iters=ITERS, root=trees["sintel"],
                                    eval_fn=jax_eval_fn, batch_size=BS))
    assert got.keys() == want.keys() == {"clean", "final"}
    for dstype in ("clean", "final"):
        assert abs(got[dstype] - want[dstype]) <= 1e-3
        kw = dict(split="training", dstype=dstype, root=trees["sintel"])
        jds_, tds_ = jds.MpiSintel(**kw), tds.MpiSintel(**kw)
        assert tev._bucket_hw(tds_) == jev._bucket_hw(jds_) == (H, W)
        samples, port, jax_ = _flows(weights, jax_eval_fn, jds_, tds_,
                                     "sintel", target=(H, W))
        epe_t = np.concatenate([np.linalg.norm(f - s["flow"], axis=-1).ravel()
                                for s, f in zip(samples, port)])
        epe_j = np.concatenate([np.linalg.norm(f - s["flow"], axis=-1).ravel()
                                for s, f in zip(samples, jax_)])
        assert abs(epe_t.mean() - got[dstype]) <= 1e-6
        for px in (1, 3, 5):
            assert abs((epe_t < px).mean() - (epe_j < px).mean()) <= 1e-3


def test_validate_kitti_bucketed_mixed_resolutions(weights, jax_eval_fn,
                                                   trees, capsys):
    variables, sd = weights
    got, want = _same_lines(
        capsys,
        lambda: tev.validate_kitti(sd, RAFTConfig.full(), iters=ITERS,
                                   root=trees["kitti"], batch_size=BS,
                                   device="cpu"),
        lambda: jev.validate_kitti(variables, JaxRAFTConfig.full(),
                                   iters=ITERS, root=trees["kitti"],
                                   eval_fn=jax_eval_fn, batch_size=BS))
    assert abs(got["kitti-epe"] - want["kitti-epe"]) <= 1e-3
    jds_ = jds.KITTI(split="training", root=trees["kitti"])
    tds_ = tds.KITTI(split="training", root=trees["kitti"])
    assert tev._bucket_hw(tds_) == jev._bucket_hw(jds_) == (H, W)
    samples, port, jax_ = _flows(weights, jax_eval_fn, jds_, tds_, "kitti",
                                 target=(H, W))
    assert [s["flow"].shape[:2] for s in samples] == KITTI_SIZES
    boundary = n_valid = 0
    for s, fj in zip(samples, jax_):
        epe = np.linalg.norm(fj - s["flow"], axis=-1)
        mag = np.linalg.norm(s["flow"], axis=-1)
        val = s["valid"] >= 0.5
        near = (np.abs(epe - 3.0) <= 1e-3) | (np.abs(epe - 0.05 * mag)
                                              <= 1e-3)
        boundary += int((near & val).sum())
        n_valid += int(val.sum())
    assert 0 < n_valid < sum(h * w for h, w in KITTI_SIZES)
    allowed = 100.0 * boundary / n_valid
    assert 0 < want["kitti-f1"] < 100
    assert abs(got["kitti-f1"] - want["kitti-f1"]) <= allowed, (
        got, want, boundary)
    # the exact per-shape padding takes one image a batch
    exact = tev.validate_kitti(sd, RAFTConfig.full(), iters=ITERS,
                               root=trees["kitti"], bucket=False,
                               device="cpu")
    assert np.isfinite(exact["kitti-epe"])
    assert exact["kitti-epe"] == pytest.approx(got["kitti-epe"], rel=0.15)


def test_validate_chairs(weights, jax_eval_fn, trees, capsys):
    variables, sd = weights
    got, want = _same_lines(
        capsys,
        lambda: tev.validate_chairs(sd, RAFTConfig.full(), iters=ITERS,
                                    root=trees["chairs"],
                                    split_file=trees["split"],
                                    batch_size=BS, device="cpu"),
        lambda: jev.validate_chairs(variables, JaxRAFTConfig.full(),
                                    iters=ITERS, root=trees["chairs"],
                                    split_file=trees["split"],
                                    eval_fn=jax_eval_fn, batch_size=BS))
    assert abs(got["chairs"] - want["chairs"]) <= 1e-3
    kw = dict(split="validation", root=trees["chairs"],
              split_file=trees["split"])
    _flows(weights, jax_eval_fn, jds.FlyingChairs(**kw),
           tds.FlyingChairs(**kw), "chairs")


def test_sintel_submission_warm_start(weights, jax_eval_fn, trees, tmp_path):
    """Ragged sequences in batch lanes with a warm start: the port at
    batch 2 and batch 1 against JAX at batch 2, every ``.flo``."""
    variables, sd = weights
    jev.create_sintel_submission(variables, JaxRAFTConfig.full(),
                                 iters=ITERS, warm_start=True,
                                 root=trees["sintel"],
                                 output_path=str(tmp_path / "jax"),
                                 eval_fn=jax_eval_fn, batch_size=BS)
    for bs in (2, 1):
        out = str(tmp_path / f"port{bs}")
        tev.create_sintel_submission(sd, RAFTConfig.full(), iters=ITERS,
                                     warm_start=True, root=trees["sintel"],
                                     output_path=out, batch_size=bs,
                                     device="cpu")
        n = 0
        for dstype in ("clean", "final"):
            for scene, pairs in SUBMISSION_LANES.items():
                for frame in range(1, pairs + 1):
                    rel = osp.join(dstype, scene, f"frame{frame:04d}.flo")
                    got = tfu.read_flo(osp.join(out, rel))
                    want = jfu.read_flo(str(tmp_path / "jax" / rel))
                    assert got.shape == (H, W, 2) and np.isfinite(got).all()
                    np.testing.assert_allclose(got, want, **TOL)
                    n += 1
        assert n == 2 * sum(SUBMISSION_LANES.values())


def test_kitti_submission(weights, jax_eval_fn, trees, tmp_path):
    variables, sd = weights
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RAFT_TUNING", "0")
        jax_fn1 = jev.make_eval_fn(JaxRAFTConfig.full(), ITERS)
    jev.create_kitti_submission(variables, JaxRAFTConfig.full(), iters=ITERS,
                                root=trees["kitti"],
                                output_path=str(tmp_path / "jax"),
                                eval_fn=jax_fn1)
    tev.create_kitti_submission(sd, RAFTConfig.full(), iters=ITERS,
                                root=trees["kitti"],
                                output_path=str(tmp_path / "port"),
                                device="cpu")
    for i, size in enumerate(KITTI_SIZES):
        p = str(tmp_path / "port" / f"{i:06d}_10.png")
        got, valid = tfu.read_flow_kitti(p)
        jgot, jvalid = jfu.read_flow_kitti(p)
        np.testing.assert_array_equal(got, jgot)
        np.testing.assert_array_equal(valid, jvalid)
        assert got.shape == size + (2,) and valid.all()
        want, _ = jfu.read_flow_kitti(str(tmp_path / "jax"
                                          / f"{i:06d}_10.png"))
        # 1/64 px quantization: agreeing flows may round one step apart
        np.testing.assert_allclose(got, want, rtol=0, atol=1 / 64 + 1e-3)


def test_evaluate_epe_delta_matches_jax(weights, trees, capsys):
    variables, sd = weights
    kw = dict(root=trees["chairs"], split_file=trees["split"])
    got, want = _same_lines(
        capsys,
        lambda: tev.evaluate_epe_delta(sd, RAFTConfig.full(),
                                       ["float32", "int8"], dataset="chairs",
                                       iters=ITERS, batch_size=BS,
                                       device="cpu", **kw),
        lambda: jev.evaluate_epe_delta(variables, JaxRAFTConfig.full(),
                                       ["float32", "int8"], dataset="chairs",
                                       iters=ITERS, batch_size=BS, **kw))
    assert got.keys() == want.keys()
    assert got["dtypes"] == want["dtypes"] == ["float32", "int8"]
    for dt in ("float32", "int8"):
        assert abs(got["per_dtype"][dt]["chairs"]
                   - want["per_dtype"][dt]["chairs"]) <= 1e-3
    assert abs(got["delta_vs_float32"]["int8"]["chairs"]
               - want["delta_vs_float32"]["int8"]["chairs"]) <= 1e-3
    with pytest.raises(ValueError, match="allowed"):
        tev.evaluate_epe_delta(sd, RAFTConfig.full(), ["float32", "int4"])


def test_cli_on_cpu_matches_jax_validator(weights, jax_eval_fn, trees,
                                          tmp_path, capsys):
    variables, sd = weights
    model = str(tmp_path / "w.pth")
    torch.save(sd, model)
    args = ["--model", model, "--dataset", "chairs", "--precision", "fp32",
            "--iters", str(ITERS), "--data_root", trees["root"],
            "--chairs_split", trees["split"], "--eval_batch", str(BS)]
    want = jev.validate_chairs(variables, JaxRAFTConfig.full(), iters=ITERS,
                               root=trees["chairs"],
                               split_file=trees["split"],
                               eval_fn=jax_eval_fn, batch_size=BS)["chairs"]
    capsys.readouterr()
    assert tmain.main(["evaluate", *args, "--device", "cpu"]) == 0
    printed = capsys.readouterr().out
    m = re.fullmatch(r"Validation Chairs EPE: (\d+\.\d{3})\n", printed)
    assert m, printed
    assert abs(float(m.group(1)) - want) <= 1e-3
    res = tcli.main([*args, "--device", "cpu", "--alternate_corr",
                     "--epe_delta", "float32,bfloat16"])
    assert set(res["delta_vs_float32"]) == {"bfloat16"}
    # on the card by default: without CUDA it raises
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tcli.main(args)
    # --small builds the small model, which refuses the full model's file
    with pytest.raises(ValueError, match="missing"):
        tcli.main([*args, "--device", "cpu", "--small"])
    with pytest.raises(SystemExit):
        tcli.parse_args([*args, "--corr_dtype", "int4"])
    with pytest.raises(SystemExit):
        tcli.parse_args([*args, "--epe_delta", "float32"])


def test_cli_telemetry_events(weights, trees, tmp_path, monkeypatch,
                              capsys):
    """``--telemetry_dir``: the JAX validator's stream — one
    ``raft_eval_forward`` span event a batch, one ``cost_report`` a
    forward shape (counted on its first call: ``inference_48x64``, the
    JAX record's keys), the ``eval`` record with the printed EPE — and the
    pad and EPE spans' histograms; ``RAFT_TELEMETRY_COST=0`` drops the
    cost report."""
    import json

    from raft_tpu.obs import cost as jcost
    from raft_tpu_torch.obs import default_registry, reset_default_sink

    _, sd = weights
    model = str(tmp_path / "w.pth")
    torch.save(sd, model)
    args = ["--model", model, "--dataset", "chairs", "--precision", "fp32",
            "--iters", str(ITERS), "--data_root", trees["root"],
            "--chairs_split", trees["split"], "--eval_batch", str(BS),
            "--device", "cpu"]
    streams = {}
    for cost_on in ("1", "0"):
        tdir = tmp_path / f"tel{cost_on}"
        monkeypatch.setenv("RAFT_TELEMETRY_DIR", "unset")
        monkeypatch.setenv("RAFT_TELEMETRY_COST", cost_on)
        try:
            res = tcli.main([*args, "--telemetry_dir", str(tdir)])
        finally:
            reset_default_sink()
        (f,) = tdir.glob("*.jsonl")
        streams[cost_on] = [json.loads(ln)
                            for ln in f.read_text().splitlines()]
    printed = capsys.readouterr().out
    recs = streams["1"]
    names = [(r["event"], r.get("name")) for r in recs]
    assert names == [("cost_report", None),
                     ("span", "raft_eval_forward"), ("eval", None)]
    cost = recs[0]
    want_keys = set(jcost.ProgramCost("p", 1.0, 1.0, pairs_per_call=BS)
                    .as_record())
    assert set(cost) - {"event", "t_wall", "t_mono", "process",
                        "step"} == want_keys
    assert cost["program"] == "inference_48x64"
    assert cost["source"] == "counted" and cost["flops"] > 0
    assert cost["pairs_per_call"] == BS
    assert recs[1]["dataset"] == "chairs" and recs[1]["seconds"] > 0
    assert recs[2]["dataset"] == "chairs"
    assert f"Validation Chairs EPE: {recs[2]['chairs']:.3f}" in printed
    assert abs(recs[2]["chairs"] - res["chairs"]) < 1e-9
    assert [r["event"] for r in streams["0"]] == ["span", "eval"]
    snap = default_registry().snapshot()
    for name in ("raft_eval_pad_seconds", "raft_eval_epe_seconds",
                 "raft_eval_forward_seconds"):
        assert name in json.dumps(snap), name
