"""Host-side flow warping (the port's copy of ``raft_tpu/utils/warp.py``).

``forward_interpolate`` forward-warps a flow field along itself to seed
the next frame's estimate: the Sintel-submission warm start.  The
reference calls ``scipy.interpolate.griddata(method='nearest')`` once a
channel; that is a ``cKDTree`` nearest-neighbour query, so the tree is
built once and queried once for both channels.  It runs on the host: the
scattered targets are irregular.
"""

from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree


def forward_interpolate(flow: np.ndarray) -> np.ndarray:
    """Forward-warp ``(H, W, 2)`` flow along itself by nearest-neighbour
    resampling of the scattered targets.  Returns ``(H, W, 2)`` float32;
    zeros when every target leaves the frame."""
    flow = np.asarray(flow, np.float32)
    if flow.ndim != 3 or flow.shape[2] != 2:
        raise ValueError(f"flow must be (H, W, 2), got {flow.shape}")
    h, w, _ = flow.shape
    dx, dy = flow[..., 0], flow[..., 1]

    x0, y0 = np.meshgrid(np.arange(w), np.arange(h))
    x1 = (x0 + dx).ravel()
    y1 = (y0 + dy).ravel()

    valid = (x1 > 0) & (x1 < w) & (y1 > 0) & (y1 < h)
    if not valid.any():
        return np.zeros_like(flow)

    pts = np.stack([x1[valid], y1[valid]], axis=-1)
    vals = flow.reshape(-1, 2)[valid]

    tree = cKDTree(pts)
    _, idx = tree.query(
        np.stack([x0.ravel(), y0.ravel()], axis=-1).astype(np.float32))
    return vals[idx].reshape(h, w, 2).astype(np.float32)
