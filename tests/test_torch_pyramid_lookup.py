"""The materialized-pyramid lookup of the port (the plain version of its
CUDA kernel) against the JAX package's TPU kernel ``pallas_pyramid_lookup``
in interpret mode, on a ``build_corr_pyramid_flat`` pyramid: twins of
``tests/test_pallas_corr.py:183-257``.

The JAX pyramid is query-minor and padded, ``(B, Hl, Wl, Npad)``; the
port's is query-major, ``(B, N, Hl, Wl)``: the tests compare
``level.transpose(0, 3, 1, 2)[:, :N]``.  A 6x10 feature grid pools to
3x5, 1x2 and an empty 0x1 level; centers include asymmetric flows and
points far off the image.  Tolerances: taps 1e-5 (fp32, sums in another
order); bf16 levels of the two builds within one bf16 rounding;
``dpyramid`` and the feature-map gradients through the pyramid
build 1e-4; bf16 storage rtol 0.02 / atol 0.05 (correlation values are
O(sqrt(C)) and bf16 keeps 8 significant bits; each tap mixes four stored
values), with the cotangent in the level's dtype.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.ops import corr as jcorr
from raft_tpu.ops.pallas_corr import pallas_pyramid_lookup
from raft_tpu_torch.ops import corr as tcorr
from raft_tpu_torch.ops import pyramid_kernels
from raft_tpu_torch.ops.pyramid_kernels import (pyramid_lookup,
                                                pyramid_lookup_nchw,
                                                pyramid_lookup_plain)

B, H, W, C, LEVELS, PAD_Q = 2, 6, 10, 32, 4, 64
N = H * W
TOL = dict(rtol=1e-5, atol=1e-5)


def _setup(seed):
    rng = np.random.default_rng(seed)
    f1 = rng.standard_normal((B, H, W, C)).astype(np.float32)
    f2 = rng.standard_normal((B, H, W, C)).astype(np.float32)
    ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    grid = np.stack([xs, ys], -1).astype(np.float32)[None]
    flow = np.stack([rng.uniform(-3.0, 6.0, (B, H, W)),
                     rng.uniform(-1.5, 2.5, (B, H, W))], -1)
    coords = (grid + flow).astype(np.float32)
    coords[0, 0, 0] = (40.0, -30.0)          # far outside the image
    coords[1, 2, 3] = (-1e6, 3.5)
    coords[1, 5, 9] = (9.0, 5.0)             # integer, on the last pixel
    return f1, f2, coords


def _jax_flat(f1, f2, dtype=jnp.float32):
    return jcorr.build_corr_pyramid_flat(jnp.asarray(f1), jnp.asarray(f2),
                                         LEVELS, pad_q=PAD_Q,
                                         out_dtype=dtype)


def _query_major(level):
    """JAX ``(B, Hl, Wl, Npad)`` -> the port's ``(B, N, Hl, Wl)``."""
    return np.asarray(level.astype(jnp.float32)).transpose(0, 3, 1,
                                                           2)[:, :N]


def _jax_lookup(pyr, coords):
    return pallas_pyramid_lookup(pyr, jnp.asarray(coords), 4, PAD_Q, True)


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.fixture(scope="module")
def jax_ref():
    """The TPU kernel's taps and ``dpyramid`` (cotangent of
    ``sum(sin(taps))``) for fp32 and bf16 storage, and the feature-map
    gradients through the fp32 build: one trace of the interpreted kernel
    per direction and dtype (each costs seconds on the CPU)."""
    f1, f2, coords = _setup(4)
    out = {}
    for dtype in (jnp.float32, jnp.bfloat16):
        pyr = _jax_flat(f1, f2, dtype)
        taps, vjp = jax.vjp(lambda p: _jax_lookup(p, coords), pyr)
        (dpyr,) = vjp(jnp.cos(taps))
        out[dtype] = (pyr, np.asarray(taps), dpyr)
    _, build_vjp = jax.vjp(
        lambda a, b: jcorr.build_corr_pyramid_flat(a, b, LEVELS,
                                                   pad_q=PAD_Q),
        jnp.asarray(f1), jnp.asarray(f2))
    out["dfmaps"] = [np.asarray(d) for d in build_vjp(out[jnp.float32][2])]
    return out


def test_pyramid_build_is_the_flat_pyramid_query_major():
    f1, f2, _ = _setup(4)
    jpyr = _jax_flat(f1, f2)
    tpyr = tcorr.build_corr_pyramid(*_t(f1, f2), LEVELS)
    for a, b in zip(tpyr, jpyr):
        assert a.shape[:2] == (B, N) and a.shape[2:] == b.shape[1:3]
        np.testing.assert_allclose(a.numpy(), _query_major(b), **TOL)
    assert tpyr[-1].numel() == 0                     # the empty level
    t16 = tcorr.build_corr_pyramid(*_t(f1, f2), LEVELS, torch.bfloat16)
    for a, b in zip(t16, _jax_flat(f1, f2, jnp.bfloat16)):
        assert a.dtype == torch.bfloat16
        np.testing.assert_allclose(a.float().numpy(), _query_major(b),
                                   rtol=2 ** -8, atol=1e-6)


def test_plain_lookup_matches_pallas_kernel(jax_ref):
    f1, f2, coords = _setup(4)
    want = jax_ref[jnp.float32][1]
    tf1, tf2, tc = _t(f1, f2, coords)
    got = pyramid_lookup(tcorr.build_corr_pyramid(tf1, tf2, LEVELS), tc,
                         4).numpy()
    assert got.shape == want.shape == (B, H, W, LEVELS * 81)
    np.testing.assert_allclose(got, want, **TOL)
    assert np.all(got[..., 3 * 81:] == 0.0)          # the empty level
    for q in ((0, 0, 0), (1, 2, 3)):                 # far off the image
        assert np.all(got[q] == 0.0) and np.all(want[q] == 0.0)


def test_out_of_range_centers_give_zero():
    f1, f2, _ = _setup(3)
    coords = np.full((B, H, W, 2), -100.0, np.float32)
    coords[1, 1] = (np.inf, np.nan)
    coords[1, 2] = (3.0, 1e30)
    tf1, tf2, tc = _t(f1, f2, coords)
    pyr = [lv.requires_grad_(True)
           for lv in tcorr.build_corr_pyramid(tf1, tf2, LEVELS)]
    got = pyramid_lookup(pyr, tc, 4)
    assert torch.all(got[0] == 0.0) and torch.all(got[1, 2] == 0.0)
    got[0].sum().backward()
    assert all(torch.all(lv.grad[0] == 0.0) for lv in pyr)


def test_grads_match_pallas_kernel(jax_ref):
    """``dpyramid`` of ``sum(sin(taps))`` (the custom_vjp's transpose
    against autograd of the plain version), and the feature-map gradients
    through the pyramid build."""
    f1, f2, coords = _setup(4)
    tf1, tf2, tc = _t(f1, f2, coords)
    tpyr = [lv.detach().requires_grad_(True)
            for lv in tcorr.build_corr_pyramid(tf1, tf2, LEVELS)]
    torch.sin(pyramid_lookup(tpyr, tc, 4)).sum().backward()
    for lv, d in zip(tpyr, jax_ref[jnp.float32][2]):
        np.testing.assert_allclose(lv.grad.numpy(), _query_major(d),
                                   rtol=1e-4, atol=1e-4)
    tf1.requires_grad_(True)
    tf2.requires_grad_(True)
    pyr = tcorr.build_corr_pyramid(tf1, tf2, LEVELS)
    torch.sin(pyramid_lookup(pyr, tc, 4)).sum().backward()
    for got, want in zip((tf1.grad, tf2.grad), jax_ref["dfmaps"]):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_bf16_storage_close_and_grad_dtype(jax_ref):
    f1, f2, coords = _setup(4)
    want = jax_ref[jnp.float32][1]
    want16 = jax_ref[jnp.bfloat16][1]
    tf1, tf2, tc = _t(f1, f2, coords)
    pyr16 = [lv.requires_grad_(True) for lv in tcorr.build_corr_pyramid(
        tf1, tf2, LEVELS, out_dtype=torch.bfloat16)]
    assert all(lv.dtype == torch.bfloat16 for lv in pyr16)
    got = pyramid_lookup(pyr16, tc, 4)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0.02,
                               atol=0.05)
    np.testing.assert_allclose(got.detach().numpy(), want16, rtol=0.02,
                               atol=0.05)
    torch.sin(got).sum().backward()
    for lv, d in zip(pyr16, jax_ref[jnp.bfloat16][2]):
        assert lv.grad.dtype == torch.bfloat16 and d.dtype == jnp.bfloat16
        assert torch.isfinite(lv.grad.float()).all()
        np.testing.assert_allclose(lv.grad.float().numpy(), _query_major(d),
                                   rtol=0.02, atol=0.05)
    taps16 = pyramid_lookup(pyr16, tc, 4, out_dtype=torch.bfloat16)
    assert taps16.dtype == torch.bfloat16
    assert torch.equal(taps16, got.detach().to(torch.bfloat16))


def test_cpu_wrappers_are_the_plain_version():
    f1, f2, coords = _setup(7)
    tf1, tf2, tc = _t(f1, f2, coords)
    pyr = tcorr.build_corr_pyramid(tf1, tf2, LEVELS)
    before = dict(pyramid_kernels.LAUNCHES)
    taps = pyramid_lookup(pyr, tc, 4)
    assert torch.equal(taps, pyramid_lookup_plain(pyr, tc, 4))
    assert torch.equal(taps, tcorr.corr_lookup(pyr, tc, 4))
    nchw = pyramid_lookup_nchw(pyr, tc, 4, torch.bfloat16)
    assert nchw.is_contiguous() and nchw.dtype == torch.bfloat16
    assert torch.equal(nchw, taps.to(torch.bfloat16).permute(0, 3, 1, 2))
    assert pyramid_kernels.LAUNCHES == before
