"""Correlation volumes and window lookups: the plain PyTorch paths (the
port of ``raft_tpu/ops/corr.py:188-435``).

- ``'allpairs'``: :func:`build_corr_pyramid` materializes
  ``<f1(x), f2(y)> / sqrt(C)`` for every pair of 1/8-res pixels and
  average-pools it over the target dims; :func:`corr_lookup` samples the
  bilinear ``(2r+1)^2`` window around ``coords / 2^l`` at each level.
- ``'chunked'``: :func:`chunked_corr_lookup` never materializes the
  volume; per block of queries it correlates against the pooled target
  features (:func:`pool_fmap_pyramid`) and samples the windows.  Pooling
  is linear, so both paths compute the same function.  It is the plain
  version of the on-demand CUDA kernel (``ops/corr_kernels.py``).

Window sampling is written as two dense 1-D interpolation-weight
products, as in the JAX package; the semantics are those of
``grid_sample(align_corners=True, padding_mode='zeros')``.

Pyramid layout.  The materialized pyramid is query-major, level l being
``(B, N, H/2^l, W/2^l)`` with ``N = H*W`` queries, for both ``'allpairs'``
and ``'allpairs_pallas'``: the two configurations share one pyramid build
and differ only in the lookup.  On the GPU each query's correlation row is
then contiguous, so the lookup kernel reads each window as a few short
runs and its backward writes each query's dense ``dcorr`` row coalesced,
without atomics and without query padding.  The JAX package's
``build_corr_pyramid_flat`` stores the same values query-minor,
``(B, Hl, Wl, Npad)`` with N padded to a multiple of 128, because the TPU
wants queries in its 128 lanes; ``level.permute(0, 3, 1, 2)[:, :N]`` of
that layout is this one.  Levels are stored in ``out_dtype`` (the
config's ``corr_dtype``); the volume and its pooling are computed in fp32
and the lookups accumulate in fp32.

Tap-order contract: the output channel is ``l * k^2 + i * k + j`` with
``k = 2r+1``, where ``i`` walks x (displacement ``i - r``) and ``j`` walks
y.  Public functions take and return the JAX layout: NHWC feature maps,
``(B, H, W, 2)`` coords with ``(x, y)`` last, ``(B, H, W, L*k^2)`` taps.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import torch


def all_pairs_correlation(fmap1: torch.Tensor,
                          fmap2: torch.Tensor) -> torch.Tensor:
    """``(B, H, W, C) x (B, H, W, C) -> (B, H1*W1, H2, W2)`` fp32 volume."""
    B, H, W, C = fmap1.shape
    f1 = fmap1.reshape(B, H * W, C).float()
    f2 = fmap2.reshape(B, H * W, C).float()
    corr = torch.matmul(f1, f2.transpose(1, 2)) * (1.0 / math.sqrt(C))
    return corr.reshape(B, H * W, H, W)


def _avg_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2/stride-2 average pool over the last two dims of ``(B, N, H, W)``;
    an odd trailing row/col is dropped (torch ``avg_pool2d``)."""
    B, N, H, W = x.shape
    H2, W2 = H // 2, W // 2
    x = x[:, :, :H2 * 2, :W2 * 2].reshape(B, N, H2, 2, W2, 2)
    return x.sum(dim=(3, 5)) * 0.25


def build_corr_pyramid(fmap1: torch.Tensor, fmap2: torch.Tensor,
                       num_levels: int = 4,
                       out_dtype: torch.dtype = torch.float32
                       ) -> List[torch.Tensor]:
    """Materialized pyramid: level l is ``(B, H1*W1, H/2^l, W/2^l)``,
    pooled in fp32 and stored in ``out_dtype`` (fp32 or bf16)."""
    corr = all_pairs_correlation(fmap1, fmap2)
    pyramid = [corr.to(out_dtype)]
    for _ in range(num_levels - 1):
        corr = _avg_pool_2x2(corr)
        pyramid.append(corr.to(out_dtype))
    return pyramid


def _interp_weights_1d(c: torch.Tensor, n: int,
                       radius: int) -> torch.Tensor:
    """Dense bilinear weights ``w[..., t, p] = max(0, 1 - |c + t - r - p|)``
    for positions ``p in [0, n)``: at most two nonzero weights per tap,
    all-zero rows for taps outside the image (zeros padding)."""
    k = 2 * radius + 1
    taps = torch.arange(k, dtype=torch.float32, device=c.device) - radius
    pos = torch.arange(n, dtype=torch.float32, device=c.device)
    return torch.clamp(
        1.0 - torch.abs(c[..., None, None] + taps[:, None] - pos), min=0.0)


def _sample_windows(corr: torch.Tensor, coords: torch.Tensor,
                    radius: int) -> torch.Tensor:
    """Bilinear window sampling of one level.

    Args:
      corr: ``(B, N, H, W)`` correlation rows of N query pixels.
      coords: ``(B, N, 2)`` query centers in this level's pixel units.

    Returns:
      ``(B, N, (2r+1)^2)`` taps, x-major.
    """
    B, N, H, W = corr.shape
    k = 2 * radius + 1
    c = coords.float()
    wx = _interp_weights_1d(c[..., 0], W, radius)       # (B, N, k, W)
    wy = _interp_weights_1d(c[..., 1], H, radius)       # (B, N, k, H)
    a = torch.matmul(wy, corr.float())                  # (B, N, k_j, W)
    taps = torch.matmul(wx, a.transpose(-1, -2))        # (B, N, k_i, k_j)
    return taps.reshape(B, N, k * k)


def corr_lookup(pyramid: Sequence[torch.Tensor], coords: torch.Tensor,
                radius: int) -> torch.Tensor:
    """Sample the materialized pyramid at ``(B, H1, W1, 2)`` level-0
    coords -> ``(B, H1, W1, levels * (2r+1)^2)`` fp32."""
    B, H1, W1, _ = coords.shape
    c = coords.reshape(B, H1 * W1, 2).float()
    outs = [_sample_windows(corr, c / (2.0 ** lvl), radius)
            for lvl, corr in enumerate(pyramid)]
    return torch.cat(outs, dim=-1).reshape(B, H1, W1, -1)


def pool_fmap_pyramid(fmap2: torch.Tensor,
                      num_levels: int) -> List[torch.Tensor]:
    """Pooled target features ``(B, H_l, W_l, C)`` per level; an odd
    trailing row/col is dropped, so a level may be empty."""
    levels = [fmap2]
    cur = fmap2
    for _ in range(num_levels - 1):
        B, H, W, C = cur.shape
        H2, W2 = H // 2, W // 2
        cur = cur[:, :H2 * 2, :W2 * 2].reshape(B, H2, 2, W2, 2, C)
        cur = cur.sum(dim=(2, 4)) * 0.25
        levels.append(cur)
    return levels


def chunked_corr_lookup(fmap1: torch.Tensor,
                        fmap2_pyramid: Sequence[torch.Tensor],
                        coords: torch.Tensor, radius: int,
                        block_size: int = 256) -> torch.Tensor:
    """On-demand blockwise correlation lookup.

    For each block of ``block_size`` query pixels: correlate against each
    pooled ``f2`` level, sample the window, discard the rows.

    Args:
      fmap1: ``(B, H1, W1, C)`` query features.
      fmap2_pyramid: from :func:`pool_fmap_pyramid`.
      coords: ``(B, H1, W1, 2)`` level-0 centers, ``(x, y)`` last.

    Returns:
      ``(B, H1, W1, levels * (2r+1)^2)`` fp32.
    """
    B, H1, W1, C = fmap1.shape
    N = H1 * W1
    scale = 1.0 / math.sqrt(C)
    f1 = fmap1.reshape(B, N, C).float()
    c = coords.reshape(B, N, 2).float()
    f2_flat = [f2.float().reshape(B, f2.shape[1] * f2.shape[2], C)
               .transpose(1, 2) for f2 in fmap2_pyramid]
    blocks = []
    for n0 in range(0, N, block_size):
        f1_b, c_b = f1[:, n0:n0 + block_size], c[:, n0:n0 + block_size]
        outs = []
        for lvl, (f2, f2t) in enumerate(zip(fmap2_pyramid, f2_flat)):
            _, Hl, Wl, _ = f2.shape
            rows = torch.matmul(f1_b, f2t) * scale      # (B, bs, Hl*Wl)
            outs.append(_sample_windows(
                rows.reshape(B, f1_b.shape[1], Hl, Wl), c_b / (2.0 ** lvl),
                radius))
        blocks.append(torch.cat(outs, dim=-1))
    return torch.cat(blocks, dim=1).reshape(B, H1, W1, -1)
