"""The on-demand lookup's plain version under the center distributions the
CUDA kernels are checked and timed with (``corr_kernels.sample_centers``:
near-grid, smooth flow, spread, and half of each), against the JAX
package's ``pallas_corr_lookup`` (the TPU kernel, in interpret mode).

On the card the kernels take per (tile, level) their box path or their
per-query path depending on these centers (``tests/test_torch_cuda.py``);
here the plain version they are held to is held to JAX on the same
centers.  The grid (12 x 20) is not a multiple of the kernels' 4 x 8
query tile.  fp32 tolerance rtol = atol = 1e-5 for the taps (sums in
another order), 1e-4 for the gradients, as in ``tests/test_torch_corr.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.ops import corr as jcorr
from raft_tpu.ops.pallas_corr import pallas_corr_lookup
from raft_tpu_torch.ops import corr as tcorr
from raft_tpu_torch.ops.corr_kernels import (corr_lookup_ondemand,
                                             corr_lookup_ondemand_bwd_plain,
                                             sample_centers)

B, H, W, C, LEVELS, RADIUS = 2, 12, 20, 32, 4, 4


def _features(seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, W, C)).astype(np.float32),
            rng.standard_normal((B, H, W, C)).astype(np.float32))


def test_sample_centers_kinds():
    ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    grid = np.stack([xs, ys], -1)[None]
    near = sample_centers("near", B, H, W, 0)
    assert near.shape == (B, H, W, 2) and near.dtype == np.float32
    assert np.abs(near - grid).max() <= 1.0
    for kind in ("smooth", "spread", "mixed"):
        c = sample_centers(kind, 4, 30, 48, 1)
        off = np.abs(c - np.stack(np.meshgrid(np.arange(48), np.arange(30)),
                                  -1)[None])
        far = (off > 21).any(-1)
        assert 0 < far.mean() < 0.05, kind          # ~2% far off
        assert off[~far].max() <= 20.0 + 1e-4
    smooth = sample_centers("smooth", 4, 30, 48, 1)
    step = np.abs(np.diff(smooth, axis=2))[..., 0]
    assert np.median(step) < 1.5                    # neighbours move alike
    mixed = sample_centers("mixed", 4, 30, 48, 1)   # near left of x = 16
    gx = np.arange(16)[None, None, :]
    assert np.abs(mixed[:, :, :16, 0] - gx).max() <= 1.0
    assert np.array_equal(sample_centers("spread", B, H, W, 3),
                          sample_centers("spread", B, H, W, 3))
    with pytest.raises(ValueError):
        sample_centers("uniform", B, H, W, 0)


@pytest.mark.parametrize("kind", ["near", "smooth", "spread", "mixed"])
def test_plain_lookup_matches_jax_pallas(kind):
    f1, f2 = _features(7)
    coords = sample_centers(kind, B, H, W, 11)
    jf2 = jcorr.pool_fmap_pyramid(jnp.asarray(f2), LEVELS)
    want = np.asarray(pallas_corr_lookup(
        jnp.asarray(f1), tuple(jf2), jnp.asarray(coords), RADIUS, 64, True))
    tf1, tf2, tc = (torch.from_numpy(a) for a in (f1, f2, coords))
    pyr = tcorr.pool_fmap_pyramid(tf2, LEVELS)
    got = corr_lookup_ondemand(tf1, pyr, tc, RADIUS).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert np.abs(got).max() > 0


def test_plain_backward_matches_jax_vjp_mixed():
    """Half near-grid, half spread centers: the kernels' two paths in one
    launch on the card; here the plain backward against ``jax.vjp``."""
    f1, f2 = _features(8)
    coords = sample_centers("mixed", B, H, W, 12)
    g = np.random.default_rng(13).standard_normal(
        (B, H, W, LEVELS * (2 * RADIUS + 1) ** 2)).astype(np.float32)

    def jfn(a, b):
        return pallas_corr_lookup(a, tuple(jcorr.pool_fmap_pyramid(
            b, LEVELS)), jnp.asarray(coords), RADIUS, 64, True)

    _, vjp = jax.vjp(jfn, jnp.asarray(f1), jnp.asarray(f2))
    want1, want2 = (np.asarray(d) for d in vjp(jnp.asarray(g)))

    tf1 = torch.from_numpy(f1)
    tf2 = torch.from_numpy(f2).requires_grad_(True)
    pyr = tcorr.pool_fmap_pyramid(tf2, LEVELS)
    df1, df2 = corr_lookup_ondemand_bwd_plain(tf1, pyr, torch.from_numpy(
        coords), RADIUS, torch.from_numpy(g))
    got2, = torch.autograd.grad(pyr, [tf2], df2)
    np.testing.assert_allclose(df1.numpy(), want1, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got2.numpy(), want2, rtol=1e-4, atol=1e-4)
