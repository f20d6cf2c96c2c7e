"""``python -m raft_tpu_torch lk-compare`` (the twin of
``tests/test_cli.py::test_lk_compare_cli``): the small model on JAX's
weights carried across, a textured frame and its 3-px shift at 64x96.
The port's bf16 flow is held against JAX's bf16 ``make_eval_fn`` on the
same padded pair within the bf16 bound of ``test_torch_raft.py``
(``rtol = atol = 2e-2``), and the side-by-side image is twice the
frame's width.  Also ``demo --small``, the demo half of
``tests/test_cli.py::test_evaluate_and_demo_cli``."""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from raft_tpu.config import RAFTConfig as JaxRAFTConfig
from raft_tpu.evaluate import make_eval_fn as jax_make_eval_fn
from raft_tpu.ops.pad import InputPadder as JaxPadder
from raft_tpu_torch.__main__ import main
from raft_tpu_torch.cli.lk_compare import lk_tracks

from test_torch_fixtures import small_raft_variables

H, W, ITERS = 64, 96, 2


@pytest.fixture(autouse=True)
def _one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def test_lk_compare_cli(tmp_path, capsys):
    variables, sd = small_raft_variables(0)
    weights = tmp_path / "small.pth"
    torch.save(sd, weights)

    rng = np.random.default_rng(2)
    base = rng.integers(0, 255, size=(H, W, 3), dtype=np.uint8)
    shifted = np.roll(base, 3, axis=1)
    p1, p2 = tmp_path / "a.png", tmp_path / "b.png"
    Image.fromarray(base).save(p1)
    Image.fromarray(shifted).save(p2)
    out = tmp_path / "cmp.png"
    assert main(["lk-compare", "--model", str(weights), "--image1", str(p1),
                 "--image2", str(p2), "--out", str(out), "--small",
                 "--iters", str(ITERS), "--device", "cpu"]) == 0
    side = np.asarray(Image.open(out))
    assert side.shape == (H, 2 * W, 3)
    printed = capsys.readouterr().out
    m = re.search(r"(\d+) LK tracks; median \|LK - RAFT\| = ([\d.]+)px",
                  printed)
    assert m and int(m.group(1)) > 0, printed

    from raft_tpu_torch.cli import lk_compare

    flow, median = lk_compare.main([
        "--model", str(weights), "--image1", str(p1), "--image2", str(p2),
        "--out", str(tmp_path / "again.png"), "--small", "--iters",
        str(ITERS), "--device", "cpu"])
    assert f"{median:.2f}" == m.group(2)

    eval_fn = jax_make_eval_fn(
        JaxRAFTConfig.small_model(compute_dtype="bfloat16"), ITERS)
    j1 = jnp.asarray(base, jnp.float32)[None]
    j2 = jnp.asarray(shifted, jnp.float32)[None]
    padder = JaxPadder(j1.shape)
    _, up = eval_fn(variables, *padder.pad(j1, j2))
    want = np.asarray(padder.unpad(up)[0], np.float32)
    assert flow.shape == want.shape == (H, W, 2)
    np.testing.assert_allclose(flow, want, rtol=2e-2, atol=2e-2)

    # the statistic on JAX's flow: the same LK tracks, the same median
    # within the flows' difference
    t0, t1 = lk_tracks(base, shifted)
    xi = np.clip(t0[:, 0].round().astype(int), 0, W - 1)
    yi = np.clip(t0[:, 1].round().astype(int), 0, H - 1)
    jmed = np.median(np.linalg.norm((t1 - t0) - want[yi, xi], axis=1))
    assert abs(median - jmed) <= np.abs(flow - want).max() + 1e-6


@pytest.mark.parametrize("alternate_corr", [False, True])
def test_demo_cli_small(tmp_path, alternate_corr):
    """``demo --small`` (the demo half of ``tests/test_cli.py::
    test_evaluate_and_demo_cli``): one stacked image a consecutive pair,
    the small model's weights read from the port's ``.pth``."""
    import os

    _, sd = small_raft_variables(0)
    weights = tmp_path / "small.pth"
    torch.save(sd, weights)
    frames = tmp_path / "frames"
    frames.mkdir()
    rng = np.random.default_rng(1)
    for i in range(3):
        Image.fromarray(rng.integers(0, 255, size=(H, W, 3),
                                     dtype=np.uint8)).save(
            frames / f"f{i:02d}.png")
    out = tmp_path / "demo-out"
    args = ["demo", "--model", str(weights), "--path", str(frames), "--out",
            str(out), "--small", "--precision", "fp32", "--iters", "2",
            "--device", "cpu"]
    assert main(args + (["--alternate_corr"] if alternate_corr else [])) == 0
    assert sorted(os.listdir(out)) == ["f00_flow.png", "f01_flow.png"]
    assert np.asarray(Image.open(out / "f00_flow.png")).shape == (2 * H, W,
                                                                  3)
