"""Coordinate grids and the small model's bilinear 8x upsample (the port
of ``raft_tpu/ops/sampler.py:26-33`` and ``:143-181``)."""

from __future__ import annotations

import torch


def coords_grid(batch: int, ht: int, wd: int, device=None) -> torch.Tensor:
    """Pixel-coordinate grid ``(B, H, W, 2)`` fp32, last axis ``(x, y)``."""
    y, x = torch.meshgrid(
        torch.arange(ht, dtype=torch.float32, device=device),
        torch.arange(wd, dtype=torch.float32, device=device), indexing="ij")
    grid = torch.stack([x, y], dim=-1)
    return grid[None].expand(batch, ht, wd, 2).contiguous()


def _interp_matrix(src: int, dst: int, device) -> torch.Tensor:
    """Dense ``(dst, src)`` ``align_corners=True`` bilinear interpolation
    matrix, fp32, made on ``device`` (no host-to-device copy, so that a
    captured graph may build it)."""
    if src == 1:
        return torch.ones((dst, 1), dtype=torch.float32, device=device)
    pos = (torch.arange(dst, dtype=torch.float64, device=device)
           * (src - 1) / max(dst - 1, 1))
    lo = torch.clamp(torch.floor(pos), 0, src - 2).long()
    frac = (pos - lo).float()
    m = torch.zeros((dst, src), dtype=torch.float32, device=device)
    m.scatter_(1, lo[:, None], (1.0 - frac)[:, None])
    return m.scatter_add_(1, lo[:, None] + 1, frac[:, None])


def resize_bilinear_align_corners(x: torch.Tensor, new_hw) -> torch.Tensor:
    """``align_corners=True`` bilinear resize of ``(B, H, W, C)``: two
    dense products with the separable interpolation matrices, in the
    order of the JAX package (rows, then columns)."""
    _, H, W, _ = x.shape
    nh, nw = new_hw
    mh = _interp_matrix(H, nh, x.device).to(x.dtype)
    mw = _interp_matrix(W, nw, x.device).to(x.dtype)
    out = torch.einsum("ih,bhwc->biwc", mh, x)
    return torch.einsum("jw,biwc->bijc", mw, out)


def upflow8(flow: torch.Tensor) -> torch.Tensor:
    """8x upsample a flow field ``(B, H, W, 2)`` and scale it by 8."""
    _, H, W, _ = flow.shape
    return 8.0 * resize_bilinear_align_corners(flow, (8 * H, 8 * W))
