"""Coordinate grids, bilinear sampling with zero padding, the forward warp
of a flow field and the small model's bilinear 8x upsample (the port of
``raft_tpu/ops/sampler.py:26-83``, ``:86-140`` and ``:143-181``)."""

from __future__ import annotations

import torch


def coords_grid(batch: int, ht: int, wd: int, device=None,
                row0: int = 0) -> torch.Tensor:
    """Pixel-coordinate grid ``(B, H, W, 2)`` fp32, last axis ``(x, y)``;
    its rows are ``row0 .. row0 + H - 1`` (a shard of a taller image's
    rows keeps the image's own coordinates)."""
    y, x = torch.meshgrid(
        torch.arange(row0, row0 + ht, dtype=torch.float32, device=device),
        torch.arange(wd, dtype=torch.float32, device=device), indexing="ij")
    grid = torch.stack([x, y], dim=-1)
    return grid[None].expand(batch, ht, wd, 2).contiguous()


def bilinear_sampler(img: torch.Tensor, coords: torch.Tensor,
                     mask: bool = False):
    """Sample ``img`` ``(B, H, W, C)`` at pixel coordinates ``coords``
    ``(B, ..., 2)`` (last axis ``(x, y)``) with zero padding: a corner
    outside the image contributes 0.  With ``mask`` also returns the
    in-bounds indicator ``(B, ...)`` in ``img``'s dtype, with strict
    inequalities (``0 < x < W - 1``, ``0 < y < H - 1``), as the JAX
    package's."""
    B, H, W, C = img.shape
    x = coords[..., 0]
    y = coords[..., 1]
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = (x - x0)[..., None].to(img.dtype)
    wy = (y - y0)[..., None].to(img.dtype)
    flat = img.reshape(B, H * W, C)

    def gather(ix, iy):
        valid = (ix >= 0) & (ix <= W - 1) & (iy >= 0) & (iy <= H - 1)
        idx = (torch.clamp(iy, 0, H - 1) * W
               + torch.clamp(ix, 0, W - 1)).long().reshape(B, -1)
        out = torch.gather(flat, 1, idx[..., None].expand(B, idx.shape[1],
                                                           C))
        return out.reshape(*ix.shape, C) * valid[..., None].to(img.dtype)

    v00 = gather(x0, y0)
    v01 = gather(x0 + 1, y0)
    v10 = gather(x0, y0 + 1)
    v11 = gather(x0 + 1, y0 + 1)
    out = ((1 - wy) * ((1 - wx) * v00 + wx * v01)
           + wy * ((1 - wx) * v10 + wx * v11))
    if mask:
        inb = (x > 0) & (x < W - 1) & (y > 0) & (y < H - 1)
        return out, inb.to(img.dtype)
    return out


def forward_warp_flow(flow: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    """Forward-warp (bilinear splat) a ``(B, H, W, 2)`` flow field onto the
    next frame: the warm start of a streamed frame.

    The pixel at ``x`` with flow ``f(x)`` lands at ``x + f(x)`` and splats
    ``f(x)`` into the four integer neighbours of its landing site with
    bilinear weights; the splats and the weights are summed and the sum
    is divided by the weight.  A target that nobody lands on (weight at
    most ``eps``) gets zero flow, the cold start.

    The sums are one ``index_put_(accumulate=True)``: in element order on
    the CPU, and through a stable sort of the indices on the card, so a
    target's contributions are added in the same order on every run (an
    ``index_add_`` adds with atomics, in a different order each run).
    The splats are ordered corner by corner, as in the JAX package."""
    B, H, W, C = flow.shape
    base = coords_grid(B, H, W, device=flow.device).to(flow.dtype)
    tgt = base + flow
    x = tgt[..., 0].reshape(B, -1)
    y = tgt[..., 1].reshape(B, -1)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = x - x0
    wy = y - y0
    vals = flow.reshape(B, -1, C)
    idxs, payloads = [], []
    for dx, dy, w in ((0, 0, (1 - wx) * (1 - wy)),
                      (1, 0, wx * (1 - wy)),
                      (0, 1, (1 - wx) * wy),
                      (1, 1, wx * wy)):
        ix = x0 + dx
        iy = y0 + dy
        valid = ((ix >= 0) & (ix <= W - 1) & (iy >= 0)
                 & (iy <= H - 1)).to(flow.dtype)
        w = w * valid
        idxs.append((torch.clamp(iy, 0, H - 1) * W
                     + torch.clamp(ix, 0, W - 1)).long())
        payloads.append(torch.cat([vals * w[..., None], w[..., None]], -1))
    idx = torch.cat(idxs, dim=1)                       # (B, 4*H*W)
    idx = idx + torch.arange(B, device=flow.device)[:, None] * (H * W)
    val = torch.cat(payloads, dim=1)                   # (B, 4*H*W, C+1)
    acc = torch.zeros(B * H * W, C + 1, dtype=flow.dtype, device=flow.device)
    acc.index_put_((idx.reshape(-1),), val.reshape(-1, C + 1),
                   accumulate=True)
    acc = acc.reshape(B, H * W, C + 1)
    den = acc[..., C:]
    out = torch.where(den > eps, acc[..., :C] / torch.clamp(den, min=eps),
                      torch.zeros((), dtype=flow.dtype, device=flow.device))
    return out.reshape(B, H, W, C)


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


def resize_bilinear_align_corners(x: torch.Tensor, new_hw,
                                  rows=None) -> torch.Tensor:
    """``align_corners=True`` bilinear resize of ``(B, H, W, C)``: two
    dense products with the separable interpolation matrices, in the
    order of the JAX package (rows, then columns).  ``rows``: ``(start,
    stop)``, only those rows of the result."""
    _, H, W, _ = x.shape
    nh, nw = new_hw
    mh = _interp_matrix(H, nh, x.device).to(x.dtype)
    if rows is not None:
        mh = mh[rows[0]:rows[1]]
    mw = _interp_matrix(W, nw, x.device).to(x.dtype)
    out = torch.einsum("ih,bhwc->biwc", mh, x)
    return torch.einsum("jw,biwc->bijc", mw, out)


def upflow8(flow: torch.Tensor, rows=None) -> torch.Tensor:
    """8x upsample a flow field ``(B, H, W, 2)`` and scale it by 8;
    ``rows``: only the rows ``(start, stop)`` of the result (a shard's,
    from the whole image's flow)."""
    _, H, W, _ = flow.shape
    return 8.0 * resize_bilinear_align_corners(flow, (8 * H, 8 * W), rows)
