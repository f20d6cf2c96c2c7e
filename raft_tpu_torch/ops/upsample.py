"""Convex-combination flow upsampling (the port of
``raft_tpu/ops/upsample.py:22-127``).

Each full-resolution pixel is a convex combination (softmax weights) of
the 3x3 coarse-grid neighborhood of its parent cell.  Channel contract of
the ``9 * 64`` mask channels: ``k * 64 + p * 8 + q``, where ``k`` is the
3x3 tap in unfold (row, col) order and ``(p, q)`` the subpixel position.

The flat (space-to-depth) form is the training path's: the upsampled
flow stays at 1/8 resolution with ``2 * 64`` channels in ``(c, p, q)``
order, and the ground truth is brought to the same layout
(:func:`space_to_depth_flow`), so the sequence loss never materializes
full-resolution per-iteration flows.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def convex_upsample_nchw(flow: torch.Tensor, mask: torch.Tensor,
                         halo: int = 0) -> torch.Tensor:
    """``(B, 2, H, W)`` flow, ``(B, 576, H, W)`` mask -> ``(B, 2, 8H, 8W)``:
    the model's internal layout.  ``halo=1``: ``flow`` carries ``H + 2``
    rows, a row of the shards above and below (``parallel.halo_rows``)
    in place of the zero padding."""
    B, _, H, W = mask.shape
    f = 8
    m = torch.softmax(mask.view(B, 1, 9, f, f, H, W), dim=2)
    patches = F.unfold(f * flow, [3, 3], padding=(1 - halo, 1)).view(
        B, 2, 9, 1, 1, H, W)
    up = torch.sum(m * patches, dim=2)                 # (B, 2, f, f, H, W)
    return up.permute(0, 1, 4, 2, 5, 3).reshape(B, 2, f * H, f * W)


def convex_upsample(flow: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Upsample ``(B, H, W, 2)`` flow (coarse-pixel units, scaled by 8
    inside) to ``(B, 8H, 8W, 2)`` with a ``(B, H, W, 576)`` mask of
    unnormalized weights (the JAX layout)."""
    up = convex_upsample_nchw(flow.permute(0, 3, 1, 2),
                              mask.permute(0, 3, 1, 2))
    return up.permute(0, 2, 3, 1)


def convex_upsample_flat_nchw(flow: torch.Tensor, mask: torch.Tensor,
                              compute_dtype: torch.dtype = torch.float32,
                              halo: int = 0) -> torch.Tensor:
    """``(B, 2, H, W)`` flow, ``(B, 576, H, W)`` mask -> ``(B, 128, H, W)``
    upsampled flow in ``(c, p, q)`` channel order, computed in
    ``compute_dtype`` with the JAX package's operation order: per-group
    max subtraction (a per-pixel max would underflow far-below-max
    groups), nine multiply-adds, one reciprocal.  ``halo=1``: ``flow``
    carries ``H + 2`` rows, as for :func:`convex_upsample_nchw`."""
    _, _, H, W = mask.shape
    m = mask.to(compute_dtype)
    taps = [m[:, k * 64:(k + 1) * 64] for k in range(9)]
    gmax = taps[0]
    for t in taps[1:]:
        gmax = torch.maximum(gmax, t)
    gmax = gmax.detach()
    e = [torch.exp(t - gmax) for t in taps]
    denom = e[0]
    for t in e[1:]:
        denom = denom + t
    f8 = F.pad(8 * flow.to(compute_dtype), (1, 1, 1 - halo, 1 - halo))
    outx = outy = 0.0
    for k in range(9):
        di, dj = divmod(k, 3)              # unfold tap order (row-major)
        fk = f8[:, :, di:di + H, dj:dj + W]
        outx = outx + e[k] * fk[:, 0:1]
        outy = outy + e[k] * fk[:, 1:2]
    inv = 1.0 / denom
    return torch.cat([outx * inv, outy * inv], dim=1)


def convex_upsample_flat(flow: torch.Tensor, mask: torch.Tensor,
                         compute_dtype: torch.dtype = torch.float32
                         ) -> torch.Tensor:
    """:func:`convex_upsample_flat_nchw` in the JAX layout: ``(B, H, W, 2)``
    flow and ``(B, H, W, 576)`` mask -> ``(B, H, W, 128)``, where
    ``out[..., c*64 + p*8 + q] == convex_upsample(...)[.., 8h+p, 8w+q, c]``."""
    out = convex_upsample_flat_nchw(flow.permute(0, 3, 1, 2),
                                    mask.permute(0, 3, 1, 2), compute_dtype)
    return out.permute(0, 2, 3, 1)


def space_to_depth_flow(x: torch.Tensor, factor: int = 8) -> torch.Tensor:
    """``(B, f*H, f*W, C)`` -> ``(B, H, W, C*f*f)``, channel order
    ``(c, p, q)``: the ground-truth side of the flat loss."""
    B, FH, FW, C = x.shape
    H, W = FH // factor, FW // factor
    x = x.reshape(B, H, factor, W, factor, C).permute(0, 1, 3, 5, 2, 4)
    return x.reshape(B, H, W, C * factor * factor)


def depth_to_space_flow(x: torch.Tensor, channels: int = 2,
                        factor: int = 8) -> torch.Tensor:
    """Inverse of :func:`space_to_depth_flow`: ``(B, H, W, C*f*f)`` ->
    ``(B, f*H, f*W, C)``."""
    B, H, W, _ = x.shape
    x = x.reshape(B, H, W, channels, factor, factor).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(B, H * factor, W * factor, channels)
