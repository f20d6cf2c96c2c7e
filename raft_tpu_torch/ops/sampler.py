"""Coordinate grids and the small model's bilinear 8x upsample (the port
of ``raft_tpu/ops/sampler.py:26-33`` and ``:143-181``)."""

from __future__ import annotations

import functools

import numpy as np
import torch


def coords_grid(batch: int, ht: int, wd: int, device=None) -> torch.Tensor:
    """Pixel-coordinate grid ``(B, H, W, 2)`` fp32, last axis ``(x, y)``."""
    y, x = torch.meshgrid(
        torch.arange(ht, dtype=torch.float32, device=device),
        torch.arange(wd, dtype=torch.float32, device=device), indexing="ij")
    grid = torch.stack([x, y], dim=-1)
    return grid[None].expand(batch, ht, wd, 2).contiguous()


@functools.lru_cache(maxsize=64)
def _interp_matrix(src: int, dst: int) -> np.ndarray:
    """Dense ``(dst, src)`` ``align_corners=True`` bilinear interpolation
    matrix (host constant)."""
    if src == 1:
        return np.ones((dst, 1), dtype=np.float32)
    pos = np.arange(dst, dtype=np.float64) * (src - 1) / max(dst - 1, 1)
    lo = np.clip(np.floor(pos), 0, src - 2).astype(np.int64)
    frac = (pos - lo).astype(np.float32)
    rows = np.arange(dst)
    m = np.zeros((dst, src), dtype=np.float32)
    m[rows, lo] += 1.0 - frac
    m[rows, lo + 1] += frac
    return m


def resize_bilinear_align_corners(x: torch.Tensor, new_hw) -> torch.Tensor:
    """``align_corners=True`` bilinear resize of ``(B, H, W, C)``: two
    dense products with the separable interpolation matrices, in the
    order of the JAX package (rows, then columns)."""
    _, H, W, _ = x.shape
    nh, nw = new_hw
    mh = torch.from_numpy(_interp_matrix(H, nh)).to(x.device, x.dtype)
    mw = torch.from_numpy(_interp_matrix(W, nw)).to(x.device, x.dtype)
    out = torch.einsum("ih,bhwc->biwc", mh, x)
    return torch.einsum("jw,biwc->bijc", mw, out)


def upflow8(flow: torch.Tensor) -> torch.Tensor:
    """8x upsample a flow field ``(B, H, W, 2)`` and scale it by 8."""
    _, H, W, _ = flow.shape
    return 8.0 * resize_bilinear_align_corners(flow, (8 * H, 8 * W))
