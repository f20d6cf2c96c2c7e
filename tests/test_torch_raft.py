"""The slice as a whole: the port's full-RAFT test-mode forward against the
JAX package's on converted weights, and the demo CLI on the CPU.

fp32 tolerance rtol 1e-4, atol 1e-3 px, the bound the repo uses for a
torch RAFT against the JAX one (tests/test_convert.py): three refinement
iterations feed each flow back through the correlation lookup, so the
encoder's reordering noise (see test_torch_modules.py) grows a little per
iteration.  48x64 gives a 6x8 feature grid whose fourth pyramid level
pools to nothing.
"""

import numpy as np
import pytest
import torch
from PIL import Image

from raft_tpu.config import RAFTConfig as JaxRAFTConfig
from raft_tpu.models.raft import RAFT as JaxRAFT
from raft_tpu_torch.cli import demo
from raft_tpu_torch.config import RAFTConfig
from raft_tpu_torch.evaluate import make_eval_fn
from raft_tpu_torch.models.raft import RAFT
from raft_tpu_torch.ops import corr_kernels, gru_gates

from test_torch_fixtures import full_raft_variables, images

ITERS = 3
TOL = dict(rtol=1e-4, atol=1e-3)


def _jax(cfg, variables, i1, i2, flow_init=None):
    lo, up = JaxRAFT(cfg).apply(variables, i1, i2, iters=ITERS,
                                flow_init=flow_init, test_mode=True)
    return np.asarray(lo, np.float32), np.asarray(up, np.float32)


def _port(cfg, sd, i1, i2, flow_init=None):
    eval_fn = make_eval_fn(cfg, ITERS, device="cpu")
    lo, up = eval_fn(sd, i1, i2, flow_init)
    return lo.numpy(), up.numpy()


def _assert_close(got, want, **tol):
    for g, w in zip(got, want):
        assert g.shape == w.shape and np.isfinite(g).all()
        np.testing.assert_allclose(g, w, **tol)


@pytest.mark.parametrize("hw", [(64, 96), (48, 64)])
def test_allpairs_matches_jax(hw):
    variables, sd = full_raft_variables(0)
    i1, i2 = images(1, *hw)
    want = _jax(JaxRAFTConfig.full(), variables, i1, i2)
    got = _port(RAFTConfig.full(), sd, i1, i2)
    assert got[1].shape == (1, *hw, 2)
    _assert_close(got, want, **TOL)


def test_kernel_config_matches_jax_pallas_fused():
    """The port's kernel configuration (on the CPU: the plain on-demand
    lookup and the plain fused gates) against JAX's on-demand Pallas
    kernel and Pallas gate kernels in interpret mode."""
    variables, sd = full_raft_variables(0)
    i1, i2 = images(2, 48, 64)
    want = _jax(JaxRAFTConfig.full(corr_impl="pallas", fused_gru=True,
                                   pallas_offtpu="interpret"),
                variables, i1, i2)
    before = (dict(corr_kernels.LAUNCHES), dict(gru_gates.LAUNCHES))
    got = _port(RAFTConfig.full(corr_impl="chunked", fused_gru=True),
                sd, i1, i2)
    _assert_close(got, want, **TOL)
    kernel = _port(RAFTConfig.full(corr_impl="pallas", fused_gru=True),
                   sd, i1, i2)
    _assert_close(kernel, got, rtol=0, atol=0)
    assert (corr_kernels.LAUNCHES, gru_gates.LAUNCHES) == before


def test_flow_init_matches_jax():
    variables, sd = full_raft_variables(0)
    i1, i2 = images(3, 48, 64)
    rng = np.random.default_rng(3)
    flow_init = rng.uniform(-2, 2, (1, 6, 8, 2)).astype(np.float32)
    want = _jax(JaxRAFTConfig.full(), variables, i1, i2, flow_init)
    got = _port(RAFTConfig.full(), sd, i1, i2, flow_init)
    _assert_close(got, want, **TOL)
    cold = _port(RAFTConfig.full(), sd, i1, i2)
    assert np.abs(cold[0] - got[0]).max() > 0.1      # the init is used


def test_bf16_matches_jax_bf16():
    """bf16 compute with the pyramid stored fp32 on both sides
    (``corr_dtype='float32'``).  Looser bound: bf16 keeps 8 significant
    bits (0.4% per rounding) and the two frameworks round at different
    places (flax adds the conv bias after rounding the conv output, norms
    round in other orders), and three iterations feed the rounded flow
    back.  Measured ~3e-3 px max here, against ~5e-3 px between bf16 and
    fp32."""
    variables, sd = full_raft_variables(0)
    i1, i2 = images(4, 48, 64)
    want = _jax(JaxRAFTConfig.full(compute_dtype="bfloat16",
                                   corr_dtype="float32"),
                variables, i1, i2)
    got = _port(RAFTConfig.full(compute_dtype="bfloat16",
                                corr_dtype="float32"), sd, i1, i2)
    _assert_close(got, want, rtol=2e-2, atol=2e-2)
    fp32 = _port(RAFTConfig.full(), sd, i1, i2)
    assert np.abs(fp32[1] - got[1]).max() > 0        # bf16 really ran


def test_bf16_default_config_matches_jax_default_bf16():
    """JAX's default bf16 configuration (``corr_dtype`` unset: 'auto',
    so the pyramid is stored bf16) against the port's, unset too.

    End to end the storage rounding hides in the other bf16 noise (bound
    as above), so the correlation the refinement loop reads is checked
    on its own: the taps the model's lookup returns from the same feature
    maps agree with JAX's lookup of its bf16 pyramid to 1e-6 on average
    and one bf16 ulp at most (where an fp32 sum in another order rounds
    to the neighbouring bf16 value).  A pyramid stored fp32 misses that
    by the bf16 rounding itself (~1e-4 on average here)."""
    from raft_tpu.models.raft import _build_corr_state
    from raft_tpu.ops.corr import corr_lookup as jax_corr_lookup

    jcfg = JaxRAFTConfig.full(compute_dtype="bfloat16")
    cfg = RAFTConfig.full(compute_dtype="bfloat16")
    assert jcfg.resolved_corr_dtype == cfg.resolved_corr_dtype == "bfloat16"
    rng = np.random.default_rng(6)
    f1, f2 = (rng.standard_normal((2, 6, 8, 256)).astype(np.float32)
              for _ in range(2))
    ys, xs = np.meshgrid(np.arange(6), np.arange(8), indexing="ij")
    coords = (np.stack([xs, ys], -1)[None]
              + rng.uniform(-3, 3, (2, 6, 8, 2))).astype(np.float32)
    want = np.asarray(jax_corr_lookup(
        _build_corr_state(jcfg, f1, f2), coords, 4)).transpose(0, 3, 1, 2)
    model = RAFT(cfg)
    with torch.no_grad():
        state = model.corr_state(torch.from_numpy(f1), torch.from_numpy(f2))
        got = model.corr_lookup(state, torch.from_numpy(coords)).float(
        ).numpy()
    diff = np.abs(got - want)
    assert diff.mean() < 1e-6, diff.mean()
    assert diff.max() <= 2.0 ** -7 * np.abs(want).max()

    variables, sd = full_raft_variables(0)
    i1, i2 = images(4, 48, 64)
    _assert_close(_port(cfg, sd, i1, i2), _jax(jcfg, variables, i1, i2),
                  rtol=2e-2, atol=2e-2)


def test_demo_cli_on_cpu_writes_pngs(tmp_path):
    _, sd = full_raft_variables(0)
    frames = tmp_path / "frames"
    frames.mkdir()
    rng = np.random.default_rng(5)
    base = rng.integers(0, 256, (52, 76, 3), dtype=np.uint8)
    for i in range(3):
        Image.fromarray(np.roll(base, 2 * i, axis=1)[2:50, 4:70]).save(
            frames / f"frame_{i:04d}.png")
    weights = tmp_path / "weights.pth"
    torch.save(sd, weights)
    out = tmp_path / "out"
    before = dict(corr_kernels.LAUNCHES)
    written = demo.main(["--model", str(weights), "--path", str(frames),
                         "--out", str(out), "--iters", "2",
                         "--alternate_corr", "--device", "cpu"])
    assert sorted(p.name for p in out.iterdir()) == [
        "frame_0000_flow.png", "frame_0001_flow.png"]
    assert len(written) == 2
    with Image.open(written[0]) as im:
        assert im.size == (66, 96)        # frame over flow, 48x66 each
    assert corr_kernels.LAUNCHES == before
