"""Input padding to multiples of 8 and the compile-bucket policy (the port
of ``raft_tpu/ops/pad.py``).

The model downsamples by 8, so H and W must be divisible by 8.  'sintel'
mode centers the height padding; every other mode puts all height padding
at the bottom.  Width padding is always centered.  Padding is
edge-replicate.  Images are NHWC, as in the JAX package.

``target=(H, W)`` pads up to a fixed bucket shape instead of the next
multiple of 8: the validators pad every KITTI resolution to one shape so
that a split streams through batches of one shape (the mode's placement
is kept; edge-replicate rows are identical however many there are).
"""

from __future__ import annotations

from typing import Iterable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def ceil_to_multiple(x: int, multiple: int = 8) -> int:
    """Smallest multiple of ``multiple`` that is >= ``x``."""
    return -(-int(x) // multiple) * multiple


def bucket_hw(ht: int, wd: int, multiple: int = 8,
              ladder: Optional[Sequence[Tuple[int, int]]] = None,
              ) -> Tuple[int, int]:
    """The /``multiple``-aligned bucket covering an ``(ht, wd)`` image:
    the exact round-up, or with a ``ladder`` of ``(H, W)`` buckets the
    smallest entry that covers it (the round-up when none does)."""
    bh, bw = ceil_to_multiple(ht, multiple), ceil_to_multiple(wd, multiple)
    if ladder:
        fits = [(H, W) for (H, W) in ladder if H >= bh and W >= bw]
        if fits:
            return min(fits, key=lambda t: (t[0] * t[1], t))
    return bh, bw


def max_bucket_hw(shapes: Iterable[Tuple[int, int]],
                  multiple: int = 8) -> Tuple[int, int]:
    """One bucket covering every ``(ht, wd)`` in ``shapes``."""
    hs, ws = zip(*shapes)
    return ceil_to_multiple(max(hs), multiple), \
        ceil_to_multiple(max(ws), multiple)


class InputPadder:
    """Pads NHWC images so H, W are divisible by 8 (or match ``target``);
    unpads flow back.  ``dims`` is an NHWC shape or a bare ``(H, W)``."""

    def __init__(self, dims, mode: str = "sintel",
                 target: Optional[Tuple[int, int]] = None):
        self.ht, self.wd = dims[-3:-1] if len(dims) >= 3 else dims
        if target is None:
            pad_ht = ceil_to_multiple(self.ht) - self.ht
            pad_wd = ceil_to_multiple(self.wd) - self.wd
        else:
            pad_ht, pad_wd = target[0] - self.ht, target[1] - self.wd
            if pad_ht < 0 or pad_wd < 0:
                raise ValueError(f"target {tuple(target)} smaller than "
                                 f"image ({self.ht}, {self.wd})")
        if mode == "sintel":
            self._pad = [pad_wd // 2, pad_wd - pad_wd // 2,
                         pad_ht // 2, pad_ht - pad_ht // 2]
        else:
            self._pad = [pad_wd // 2, pad_wd - pad_wd // 2, 0, pad_ht]

    def pad(self, *inputs):
        """Edge-pad ``(B, H, W, C)`` tensors."""
        out = [F.pad(x.permute(0, 3, 1, 2), self._pad, mode="replicate")
               .permute(0, 2, 3, 1) for x in inputs]
        return out if len(out) > 1 else out[0]

    def pad_np(self, *inputs):
        """Edge-pad ``(H, W, C)`` NumPy arrays on the host (assembling a
        batch without a device round trip per image)."""
        l, r, t, b = self._pad
        out = [np.pad(x, ((t, b), (l, r), (0, 0)), mode="edge")
               for x in inputs]
        return out if len(out) > 1 else out[0]

    def unpad(self, x):
        """Crop a padded ``(..., H, W, C)`` tensor or array back."""
        ht, wd = x.shape[-3:-1]
        l, r, t, b = self._pad
        return x[..., t:ht - b, l:wd - r, :]
