"""The port's plain correlation paths against the JAX package's.

``chunked_corr_lookup`` is the plain version of the on-demand CUDA
kernel, so it is held against both JAX ``chunked_corr_lookup`` and JAX
``pallas_corr_lookup`` (the TPU kernel, in interpret mode).  Cases cover
r = 3 and 4, a non-square level grid whose last level pools to nothing
(6 x 10 -> 3 x 5 -> 1 x 2 -> 0 x 1), asymmetric flows, and centers far
outside the image.  fp32 tolerance rtol = atol = 1e-5 (sums in another
order).

Gradients: ``df1`` and ``df2`` of the port's on-demand lookup (through
``pool_fmap_pyramid``) against ``jax.vjp`` of JAX ``pallas_corr_lookup``
in interpret mode, twins of ``tests/test_pallas_corr.py``'s gradient
tests: the fused backward, every level on the blocked pair, a mixed
partition (level 0 blocked), offsets of +-20 px, an empty level; radius
3 and rtol = atol = 1e-4 as there.  ``coords`` get no gradient.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.ops import corr as jcorr
from raft_tpu.ops.pallas_corr import pallas_corr_lookup
from raft_tpu_torch.ops import corr as tcorr
from raft_tpu_torch.ops import corr_kernels
from raft_tpu_torch.ops.corr_kernels import (corr_lookup_ondemand,
                                             corr_lookup_ondemand_bwd_plain,
                                             corr_lookup_ondemand_nchw)

B, H, W, C, LEVELS = 2, 6, 10, 32, 4
TOL = dict(rtol=1e-5, atol=1e-5)


def _setup(seed):
    rng = np.random.default_rng(seed)
    f1 = rng.standard_normal((B, H, W, C)).astype(np.float32)
    f2 = rng.standard_normal((B, H, W, C)).astype(np.float32)
    ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    grid = np.stack([xs, ys], -1).astype(np.float32)[None]
    flow = np.stack([rng.uniform(-3.0, 6.0, (B, H, W)),       # asymmetric:
                     rng.uniform(-1.5, 2.5, (B, H, W))], -1)  # x != y ranges
    coords = (grid + flow).astype(np.float32)
    coords[0, 0, 0] = (40.0, -30.0)          # far outside the image
    coords[1, 2, 3] = (-1e6, 3.5)
    coords[1, 5, 9] = (9.5, 5.5)             # exactly on the last pixels
    return f1, f2, coords


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("radius", [3, 4])
def test_chunked_matches_jax_chunked_and_pallas(radius):
    f1, f2, coords = _setup(radius)
    jf2 = jcorr.pool_fmap_pyramid(jnp.asarray(f2), LEVELS)
    assert jf2[-1].shape[1] == 0                     # an empty level
    want_chunked = np.asarray(jcorr.chunked_corr_lookup(
        jnp.asarray(f1), jf2, jnp.asarray(coords), radius, block_size=32))
    want_pallas = np.asarray(pallas_corr_lookup(
        jnp.asarray(f1), tuple(jf2), jnp.asarray(coords), radius, 64, True))

    tf1, tf2, tc = _t(f1, f2, coords)
    got = tcorr.chunked_corr_lookup(
        tf1, tcorr.pool_fmap_pyramid(tf2, LEVELS), tc, radius,
        block_size=48).numpy()
    k2 = (2 * radius + 1) ** 2
    assert got.shape == (B, H, W, LEVELS * k2)
    np.testing.assert_allclose(got, want_chunked, **TOL)
    np.testing.assert_allclose(got, want_pallas, **TOL)
    assert np.all(got[..., 3 * k2:] == 0.0)           # the empty level
    assert np.all(got[0, 0, 0] == 0.0)                # window off the image


@pytest.mark.parametrize("radius", [3, 4])
def test_materialized_pyramid_lookup_matches_jax(radius):
    f1, f2, coords = _setup(10 + radius)
    jpyr = jcorr.build_corr_pyramid(jnp.asarray(f1), jnp.asarray(f2),
                                    LEVELS)
    want = np.asarray(jcorr.corr_lookup(jpyr, jnp.asarray(coords), radius))
    tf1, tf2, tc = _t(f1, f2, coords)
    tpyr = tcorr.build_corr_pyramid(tf1, tf2, LEVELS)
    for a, b in zip(tpyr, jpyr):
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    got = tcorr.corr_lookup(tpyr, tc, radius).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    # pooling the volume == correlating against pooled features
    onde = tcorr.chunked_corr_lookup(
        tf1, tcorr.pool_fmap_pyramid(tf2, LEVELS), tc, radius).numpy()
    np.testing.assert_allclose(onde, got, **TOL)


def test_pool_fmap_pyramid_odd_dims():
    rng = np.random.default_rng(3)
    f = rng.standard_normal((1, 7, 11, 8)).astype(np.float32)
    want = jcorr.pool_fmap_pyramid(jnp.asarray(f), 4)
    got = tcorr.pool_fmap_pyramid(torch.from_numpy(f), 4)
    assert [tuple(g.shape) for g in got] == [
        (1, 7, 11, 8), (1, 3, 5, 8), (1, 1, 2, 8), (1, 0, 1, 8)]
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_ondemand_wrapper_on_cpu_is_the_plain_version():
    f1, f2, coords = _setup(7)
    tf1, tf2, tc = _t(f1, f2, coords)
    pyr = tcorr.pool_fmap_pyramid(tf2, LEVELS)
    before = dict(corr_kernels.LAUNCHES)
    got = corr_lookup_ondemand(tf1, pyr, tc, 4)
    assert torch.equal(got, tcorr.chunked_corr_lookup(tf1, pyr, tc, 4))
    assert corr_kernels.LAUNCHES == before


def _grad_case(seed, shape, levels, offset, radius=4):
    """fp32 (f1, f2, coords, g): centers = grid + U(-offset, offset), plus
    a few far outside the image, and a random tap cotangent."""
    rng = np.random.default_rng(seed)
    b, h, w, c = shape
    f1, f2 = (rng.standard_normal(shape).astype(np.float32)
              for _ in range(2))
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    grid = np.stack([xs, ys], -1).astype(np.float32)[None]
    coords = (grid + rng.uniform(-offset, offset, (b, h, w, 2))).astype(
        np.float32)
    coords[0, 0, 0] = (40.0, -30.0)
    coords[-1, 1, 2] = (-1e6, 3.5)
    g = rng.standard_normal((b, h, w, levels * (2 * radius + 1) ** 2)
                            ).astype(np.float32)
    return f1, f2, coords, g


# (label, (B, H, W, C), levels, offset px, JAX backward partition)
GRAD_CASES = [
    ("fused_empty_level", (2, 6, 10, 32), 4, 3.0, "fused"),
    ("blocked_empty_level", (2, 6, 10, 32), 4, 3.0, "blocked"),
    ("mixed_empty_level", (2, 6, 10, 32), 4, 3.0, "mixed"),
    ("fused_offsets20", (2, 12, 16, 32), 3, 20.0, "fused"),
    ("blocked_offsets20", (2, 12, 16, 32), 3, 20.0, "blocked"),
]


@pytest.mark.parametrize("label,shape,levels,offset,partition", GRAD_CASES,
                         ids=[c[0] for c in GRAD_CASES])
def test_ondemand_gradients_match_jax_pallas(monkeypatch, label, shape,
                                             levels, offset, partition):
    from raft_tpu.ops import pallas_corr as pc

    radius = 3
    f1, f2, coords, g = _grad_case(len(label), shape, levels, offset,
                                   radius)
    jf2_levels = [(lvl, x) for lvl, x in enumerate(
        jcorr.pool_fmap_pyramid(jnp.asarray(f2), levels))
        if x.shape[1] and x.shape[2]]
    k = 2 * radius + 1
    if partition == "blocked":
        monkeypatch.setattr(pc, "_FUSED_BWD_BUDGET", 0)
    elif partition == "mixed":
        small = pc._fused_bwd_est(jf2_levels[1:], 64, k)
        assert small < pc._fused_bwd_est(jf2_levels, 64, k)
        monkeypatch.setattr(pc, "_FUSED_BWD_BUDGET", small + 1)
    monkeypatch.setattr(pc, "_BWD_BLOCK_Q", 64)
    blocked, fused = pc._partition_bwd_levels(jf2_levels, 64, k)
    assert {"fused": (0, len(jf2_levels)), "blocked": (len(jf2_levels), 0),
            "mixed": (1, len(jf2_levels) - 1)}[partition] == (
        len(blocked), len(fused))

    def jax_fn(a, b):
        pyr = tuple(jcorr.pool_fmap_pyramid(b, levels))
        return pallas_corr_lookup(a, pyr, jnp.asarray(coords), radius, 64,
                                  True)

    _, vjp = jax.vjp(jax_fn, jnp.asarray(f1), jnp.asarray(f2))
    want = [np.asarray(x) for x in vjp(jnp.asarray(g))]

    tf1, tf2 = (torch.from_numpy(a).requires_grad_(True) for a in (f1, f2))
    tc = torch.from_numpy(coords).requires_grad_(True)
    pyr = tcorr.pool_fmap_pyramid(tf2, levels)
    if label.endswith("empty_level"):
        assert pyr[-1].numel() == 0
    out = corr_lookup_ondemand(tf1, pyr, tc, radius)
    got = torch.autograd.grad(out, (tf1, tf2), torch.from_numpy(g))
    for a, b in zip(got, want):
        assert np.abs(b).max() > 0
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("nchw", [False, True])
def test_ondemand_plain_backward_and_zero_coords_gradient(nchw):
    """``corr_lookup_ondemand_bwd_plain`` (what the backward kernel is held
    against on the card) against autograd of the wrapper, per level; the
    empty level gets a zero ``df2``; ``coords`` get no gradient (twin of
    ``test_coords_gradient_is_zero``)."""
    f1, f2, coords, g = _grad_case(11, (B, H, W, C), LEVELS, 3.0)
    tf1 = torch.from_numpy(f1).requires_grad_(True)
    tc = torch.from_numpy(coords).requires_grad_(True)
    pyr = [lv.detach().requires_grad_(True)
           for lv in tcorr.pool_fmap_pyramid(torch.from_numpy(f2), LEVELS)]
    assert pyr[-1].numel() == 0
    tg = torch.from_numpy(g)
    if nchw:
        out = corr_lookup_ondemand_nchw(tf1, pyr, tc, 4)
        cot = tg.permute(0, 3, 1, 2)
    else:
        out = corr_lookup_ondemand(tf1, pyr, tc, 4)
        cot = tg
    want = torch.autograd.grad(out, [tf1, *pyr], cot, retain_graph=True)
    df1, df2 = corr_lookup_ondemand_bwd_plain(tf1, pyr, tc, 4, tg)
    assert len(df2) == LEVELS and df2[-1].shape == pyr[-1].shape
    for a, b in zip([df1, *df2], want):
        assert a.shape == b.shape and a.dtype == torch.float32
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    (dc,) = torch.autograd.grad(out, tc, cot, allow_unused=True)
    assert dc is None or not dc.any()
