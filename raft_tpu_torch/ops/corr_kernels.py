"""On-demand correlation lookup: the CUDA kernels' wrappers.

``csrc/corr_ondemand.cu`` replaces the TPU kernels behind
``raft_tpu.ops.pallas_corr.pallas_corr_lookup``: ``_odm_fwd_kernel``
(forward) and, in one backward kernel, ``_odm_bwd_kernel`` and the
blocked pair ``_odm_bwd_df1/df2_blocked_kernel``.  The plain version of
the forward is :func:`raft_tpu_torch.ops.corr.chunked_corr_lookup` (the
same function, blockwise in PyTorch) with an empty level's taps set to
zero, what the wrappers run on the CPU; that of the backward
:func:`corr_lookup_ondemand_bwd_plain`.  :class:`CorrLookupOndemand` is
the ``torch.autograd.Function`` around the two kernels: it saves
``fmap1``, the pooled levels and ``coords``; gradients reach ``fmap2``
through :func:`raft_tpu_torch.ops.corr.pool_fmap_pyramid` by autograd.

``coords`` get no gradient on either device (the JAX ``custom_vjp``
returns zeros; the model detaches them every iteration): both wrappers
detach them.  On an empty level the wrappers give zero taps whatever the
center, as the kernels and the TPU kernel do (``chunked_corr_lookup``,
the twin of JAX's plain function, gives NaN there for a NaN center).  A
NaN center gives NaN taps on the other levels and, in the backward, a
NaN ``df1`` row and NaN over all of its batch element's ``df2_l``.

A wrapper takes the plain version only for tensors on the CPU.  For any
other device it launches the kernel or raises; nothing falls back.
``LAUNCHES`` counts kernel launches, forward and backward, so a run can
show which path it took.  Inside the kernels a tile of queries takes, per
level, the box path or the per-query path (``csrc/corr_ondemand.cu``);
:func:`kernel_path_counts` reports which, as a measurement aid.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Sequence

import numpy as np
import torch

from raft_tpu_torch.ops import build
from raft_tpu_torch.ops.corr import chunked_corr_lookup
from raft_tpu_torch.ops.pyramid_kernels import _zero_empty_levels

LAUNCHES = {"corr_ondemand": 0, "corr_ondemand_bwd": 0}

_SUPPORTED_C = (32, 64, 128, 256, 512)
_MAX_LEVELS = 8


def corr_lookup_ondemand_bwd_plain(fmap1: torch.Tensor,
                                   fmap2_pyramid: Sequence[torch.Tensor],
                                   coords: torch.Tensor, radius: int,
                                   g: torch.Tensor):
    """Plain version of the backward kernel: ``(df1, [df2_l])`` fp32 from
    the ``(B, H1, W1, P)`` tap cotangent ``g``, by autograd of
    :func:`chunked_corr_lookup` with ``coords`` detached.  An empty level
    gets a zero ``df2_l``."""
    with torch.enable_grad():
        f1 = fmap1.detach().float().requires_grad_(True)
        levels = [lv.detach().float().requires_grad_(True)
                  for lv in fmap2_pyramid]
        out = chunked_corr_lookup(f1, levels, coords.detach(), radius)
        grads = torch.autograd.grad(out, [f1, *levels], g.float(),
                                    allow_unused=True)
    grads = [torch.zeros_like(t) if d is None else d
             for t, d in zip([f1, *levels], grads)]
    return grads[0], grads[1:]


def _fn(symbol: str):
    fn = getattr(build.load("corr_ondemand"), symbol)
    if fn.argtypes is None:
        ll, vp, ci = ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int
        ptrs, ints = ctypes.POINTER(ll), ctypes.POINTER(ci)
        fn.argtypes = {
            # (device, f1, coords, f2s, hs, ws, L, B, H1, W1, C, r,
            #  1/sqrt(C), out, out strides x3, path counts, stream)
            "corr_ondemand_fwd": [ci, vp, vp, ptrs, ints, ints] + [ci] * 6
            + [ctypes.c_float, vp, ll, ll, ll, vp, vp],
            # (device, f1, coords, f2s, df2s, hs, ws, L, B, H1, W1, C, r,
            #  1/sqrt(C), g, g strides x3, df1, path counts, stream)
            "corr_ondemand_bwd": [ci, vp, vp, ptrs, ptrs, ints, ints]
            + [ci] * 6 + [ctypes.c_float, vp, ll, ll, ll, vp, vp, vp],
            # (backward?, C, r, L) -> dynamic shared memory bytes
            "corr_ondemand_smem": [ci, ci, ci, ci],
            # (device) -> the most a block may opt in to
            "corr_ondemand_smem_limit": [ci]}[symbol]
        fn.restype = ll if symbol.startswith("corr_ondemand_smem") else ci
    return fn


def _level_args(tensors):
    L = len(tensors)
    return ((ctypes.c_longlong * L)(*[t.data_ptr() for t in tensors]),
            (ctypes.c_int * L)(*[t.shape[1] for t in tensors]),
            (ctypes.c_int * L)(*[t.shape[2] for t in tensors]))


@functools.lru_cache(maxsize=None)
def _smem_need_and_limit(device: int, C: int, radius: int, L: int):
    """Dynamic shared memory the larger of the two kernels needs, and the
    most a block may opt in to on ``device`` (bytes), from the library."""
    need = max(_fn("corr_ondemand_smem")(bwd, C, radius, L)
               for bwd in (0, 1))
    return need, _fn("corr_ondemand_smem_limit")(device)


def _check(fmap1, levels, coords, radius):
    """Shapes, dtypes and layouts the kernels take, and the kernels'
    shared memory against the card's; returns (B, N, C)."""
    name = "corr_lookup_ondemand"
    build.check_device(name, fmap1, coords, *levels)
    B, H1, W1, C = fmap1.shape
    N = H1 * W1
    L = len(levels)
    if C not in _SUPPORTED_C:
        raise ValueError(f"{name}: channels {C} not in {_SUPPORTED_C}")
    if not 1 <= L <= _MAX_LEVELS:
        raise ValueError(f"{name}: {L} levels, kernel takes 1..{_MAX_LEVELS}")
    if radius < 0:
        raise ValueError(f"{name}: radius {radius} < 0")
    need, limit = _smem_need_and_limit(fmap1.device.index or 0, C, radius,
                                       L)
    if need > limit:
        raise ValueError(f"{name}: radius {radius}, {C} channels and {L} "
                         f"levels need {need} bytes of shared memory, the "
                         f"card gives {limit} a block")
    if tuple(coords.shape) != (B, H1, W1, 2):
        raise ValueError(f"{name}: coords {tuple(coords.shape)} do not match "
                         f"fmap1 {tuple(fmap1.shape)}")
    dev = fmap1.device
    for t in [fmap1, coords, *levels]:
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous float32 tensors, "
                             f"got {t.dtype} with strides {t.stride()}")
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
    for lv in levels:
        if lv.dim() != 4 or lv.shape[0] != B or lv.shape[3] != C:
            raise ValueError(f"{name}: level {tuple(lv.shape)} does not "
                             f"match (B, Hl, Wl, C) = ({B}, ., ., {C})")
    for t in [fmap1, *levels]:
        if t.numel() and t.data_ptr() % 16:
            raise ValueError(f"{name}: feature maps must be 16-byte aligned")
    return B, N, C


def _tap_strides(N: int, P: int, nchw: bool):
    """Element strides (batch, query, tap) of the taps: ``(B, P, H1, W1)``
    when ``nchw`` else ``(B, H1, W1, P)``."""
    return (P * N, 1, N) if nchw else (N * P, P, 1)


def _launch_fwd(fmap1, levels, coords, radius, nchw, counts=None):
    """One forward launch; ``counts`` (int32 ``[2]`` on the card, or None)
    gains the (tile, level) pairs of the box and the per-query path."""
    B, N, C = _check(fmap1, levels, coords, radius)
    _, H1, W1, _ = fmap1.shape
    P = len(levels) * (2 * radius + 1) ** 2
    shape = (B, P, H1, W1) if nchw else (B, H1, W1, P)
    out = torch.empty(shape, dtype=torch.float32, device=fmap1.device)
    rc = _fn("corr_ondemand_fwd")(
        fmap1.device.index or 0, fmap1.data_ptr(), coords.data_ptr(),
        *_level_args(levels), len(levels), B, H1, W1, C, radius,
        1.0 / math.sqrt(C), out.data_ptr(), *_tap_strides(N, P, nchw),
        None if counts is None else counts.data_ptr(),
        build.stream_handle(fmap1))
    build.check_status("corr_lookup_ondemand", rc)
    return out


def _launch_bwd(fmap1, levels, coords, radius, nchw, g, counts=None):
    """One backward launch from the tap gradient ``g`` in the forward's
    layout: ``(df1, [df2_l])``; ``counts`` as for :func:`_launch_fwd`."""
    name = "corr_lookup_ondemand_bwd"
    if g.dtype != torch.float32:
        raise ValueError(f"{name}: expected a float32 tap gradient, got "
                         f"{g.dtype}")
    B, H1, W1, C = fmap1.shape
    N, P = H1 * W1, g.shape[1 if nchw else 3]
    g = g.contiguous()              # the layout the forward wrote
    df1 = torch.empty_like(fmap1)
    df2 = [torch.zeros_like(lv) for lv in levels]
    ptrs, hs, ws = _level_args(levels)
    rc = _fn("corr_ondemand_bwd")(
        fmap1.device.index or 0, fmap1.data_ptr(), coords.data_ptr(),
        ptrs, _level_args(df2)[0], hs, ws, len(levels), B, H1, W1, C,
        radius, 1.0 / math.sqrt(C), g.data_ptr(),
        *_tap_strides(N, P, nchw), df1.data_ptr(),
        None if counts is None else counts.data_ptr(),
        build.stream_handle(fmap1))
    build.check_status(name, rc)
    return df1, df2


class CorrLookupOndemand(torch.autograd.Function):
    """``(fmap1, coords, radius, nchw, *levels) -> taps`` on the card:
    ``(B, P, H1, W1)`` when ``nchw`` else ``(B, H1, W1, P)``, fp32;
    differentiable with respect to ``fmap1`` and the levels."""

    @staticmethod
    def forward(ctx, fmap1, coords, radius, nchw, *levels):
        out = _launch_fwd(fmap1, levels, coords, radius, nchw)
        LAUNCHES["corr_ondemand"] += 1
        ctx.save_for_backward(fmap1, coords, *levels)
        ctx.radius, ctx.nchw = radius, nchw
        return out

    @staticmethod
    def backward(ctx, g):
        fmap1, coords, *levels = ctx.saved_tensors
        if not (ctx.needs_input_grad[0] or any(ctx.needs_input_grad[4:])):
            return (None,) * (4 + len(levels))
        df1, df2 = _launch_bwd(fmap1, levels, coords, ctx.radius, ctx.nchw, g)
        LAUNCHES["corr_ondemand_bwd"] += 1
        return (df1, None, None, None, *df2)


def _plain(fmap1, fmap2_pyramid, coords, radius):
    """The plain version of the forward kernel: ``chunked_corr_lookup``
    with an empty level's taps set to zero."""
    return _zero_empty_levels(
        chunked_corr_lookup(fmap1, fmap2_pyramid, coords, radius),
        [f2.shape[1:3].numel() == 0 for f2 in fmap2_pyramid], radius)


def kernel_path_counts(fmap1: torch.Tensor,
                       fmap2_pyramid: Sequence[torch.Tensor],
                       coords: torch.Tensor, radius: int,
                       g: torch.Tensor = None) -> dict:
    """Which path the kernels take on these inputs: one forward launch
    (and one backward launch from the NHWC tap gradient ``g``, when
    given) with a path counter, not counted in ``LAUNCHES``.  Returns
    ``{"fwd": (box, per_query), "bwd": (box, per_query)}``: the (tile,
    level) pairs with at least one window in the level that took each
    path.  A measurement aid; the model never calls it."""
    counts = torch.zeros(4, dtype=torch.int32, device=fmap1.device)
    coords = coords.detach()
    _launch_fwd(fmap1, fmap2_pyramid, coords, radius, False, counts[:2])
    if g is not None:
        _launch_bwd(fmap1, fmap2_pyramid, coords, radius, False, g,
                    counts[2:])
    c = counts.tolist()
    return {"fwd": (c[0], c[1]), "bwd": (c[2], c[3])}


def sample_centers(kind: str, B: int, H: int, W: int,
                   seed: int) -> np.ndarray:
    """Level-0 centers ``(B, H, W, 2)`` fp32 for checking and timing the
    kernels: the grid plus
      - ``"near"``: U(-1, 1) px, as early in training;
      - ``"smooth"``: a smooth flow, per component three sinusoids of
        20/3 px with random phase and wavelengths of 1-4 times the grid's
        larger side (up to +-20 px), 2% of the queries far off;
      - ``"spread"``: U(-20, 20) px per query, 2% far off;
      - ``"mixed"``: ``"near"`` left of the middle tile column, ``"spread"``
        from it on, so one launch meets both kernel paths.
    Far centers are -1e3, -45, W + 45 or 1e4 px in each coordinate."""
    rng = np.random.default_rng(seed)
    ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    grid = np.broadcast_to(np.stack([xs, ys], -1)[None], (B, H, W, 2))
    near = grid + rng.uniform(-1, 1, (B, H, W, 2))
    spread = grid + rng.uniform(-20, 20, (B, H, W, 2))
    if kind == "near":
        return near.astype(np.float32)
    if kind == "smooth":
        flow = np.zeros((B, H, W, 2))
        side = max(H, W)
        for _ in range(3):
            wave = rng.uniform(side, 4 * side, (B, 2, 1, 1))
            ang = rng.uniform(0, 2 * np.pi, (B, 2, 1, 1))
            phase = rng.uniform(0, 2 * np.pi, (B, 2, 1, 1))
            arg = (np.cos(ang) * xs + np.sin(ang) * ys) * 2 * np.pi / wave
            flow += 20.0 / 3 * np.sin(arg + phase).transpose(0, 2, 3, 1)
        out = grid + flow
    elif kind == "spread":
        out = spread
    elif kind == "mixed":
        split = ((W // 8) // 2) * 8
        out = np.where(xs[None, ..., None] < split, near, spread)
    else:
        raise ValueError(f"sample_centers: unknown kind {kind!r}")
    out = out.astype(np.float32)
    far = rng.random((B, H, W)) < 0.02
    if kind == "mixed":
        far &= xs[None] >= split
    out[far] = rng.choice([-1e3, -45.0, W + 45.0, 1e4], (int(far.sum()), 2))
    return out


def corr_lookup_ondemand(fmap1: torch.Tensor,
                         fmap2_pyramid: Sequence[torch.Tensor],
                         coords: torch.Tensor, radius: int) -> torch.Tensor:
    """On-demand pyramid correlation lookup.

    Args:
      fmap1: ``(B, H1, W1, C)`` fp32 query features.
      fmap2_pyramid: pooled target features ``(B, Hl, Wl, C)`` fp32 per
        level (:func:`raft_tpu_torch.ops.corr.pool_fmap_pyramid`).
      coords: ``(B, H1, W1, 2)`` fp32 level-0 centers, ``(x, y)`` last.
      radius: window radius r.

    Returns:
      ``(B, H1, W1, L * (2r+1)^2)`` fp32 taps, x-major within a level;
      differentiable with respect to ``fmap1`` and the levels, not
      ``coords``.
    """
    if fmap1.device.type == "cpu":
        return _plain(fmap1, fmap2_pyramid, coords.detach(), radius)
    return CorrLookupOndemand.apply(fmap1, coords.detach(), radius, False,
                                    *fmap2_pyramid)


def corr_lookup_ondemand_nchw(fmap1: torch.Tensor,
                              fmap2_pyramid: Sequence[torch.Tensor],
                              coords: torch.Tensor,
                              radius: int) -> torch.Tensor:
    """:func:`corr_lookup_ondemand` writing ``(B, L*(2r+1)^2, H1, W1)``,
    the layout the motion encoder's first conv reads (the model's entry)."""
    if fmap1.device.type == "cpu":
        return _plain(fmap1, fmap2_pyramid, coords.detach(),
                      radius).permute(0, 3, 1, 2).contiguous()
    return CorrLookupOndemand.apply(fmap1, coords.detach(), radius, True,
                                    *fmap2_pyramid)
