"""Materialized-pyramid lookup: the CUDA kernels' wrappers and their plain
version (the port of ``raft_tpu.ops.pallas_corr.pallas_pyramid_lookup``,
``raft_tpu/ops/pallas_corr.py:783-868``).

``csrc/pyramid_lookup.cu`` replaces the TPU kernels
``_pyr_multi_fwd_kernel`` (forward) and ``_pyr_multi_bwd_kernel`` (its
exact transpose).  :class:`PyramidLookup` is the ``torch.autograd.Function``
around them: forward taps in ``out_dtype``; backward a dense ``dcorr`` per
level in the level's stored dtype, and no gradient for ``coords`` (the
model detaches them every iteration, as the JAX custom_vjp returns zeros).

The pyramid is the port's query-major one (``ops/corr.py``), levels
``(B, N, Hl, Wl)`` fp32 or bf16 from :func:`raft_tpu_torch.ops.corr.
build_corr_pyramid`; the plain version is
:func:`raft_tpu_torch.ops.corr.corr_lookup` cast to ``out_dtype``.

A wrapper takes the plain version only for tensors on the CPU.  For any
other device it launches the kernel or raises; nothing falls back.
``LAUNCHES`` counts kernel launches, forward and backward.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from raft_tpu_torch.ops import build
from raft_tpu_torch.ops.corr import corr_lookup

LAUNCHES = {"pyramid_lookup_fwd": 0, "pyramid_lookup_bwd": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_LEVELS = 8
_SMEM_LIMIT = 48 * 1024
_QPB = 8   # queries per block, as in the kernels


def pyramid_lookup_plain(pyramid: Sequence[torch.Tensor],
                         coords: torch.Tensor, radius: int,
                         out_dtype: torch.dtype = torch.float32
                         ) -> torch.Tensor:
    """Plain version: ``(B, H1, W1, L*(2r+1)^2)`` taps in ``out_dtype``,
    accumulated in fp32 whatever the levels' dtype."""
    return corr_lookup(pyramid, coords, radius).to(out_dtype)


def _fn(symbol: str):
    fn = getattr(build.load("pyramid_lookup"), symbol)
    if fn.argtypes is None:
        vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lvl = [ctypes.POINTER(ll), ctypes.POINTER(ci), ctypes.POINTER(ci),
               ci, ci, ci, ci]
        fn.argtypes = [ci, ci, ci] + lvl + [vp, vp, ll, ll, ll, vp]
        fn.restype = ci
    return fn


def _check(name, levels, coords, radius):
    """Shapes, dtypes and layouts the kernels take; returns (B, N)."""
    build.check_device(name, coords, *levels)
    B, H1, W1, _ = coords.shape
    N = H1 * W1
    L = len(levels)
    k = 2 * radius + 1
    if not 1 <= L <= _MAX_LEVELS:
        raise ValueError(f"{name}: {L} levels, kernel takes 1..{_MAX_LEVELS}")
    if radius < 0 or _QPB * (2 * L * k * k + L * ((k + 1) ** 2 + 3)) * 4 \
            > _SMEM_LIMIT:
        raise ValueError(f"{name}: radius {radius} with {L} levels does not "
                         "fit the kernels' shared-memory tiles")
    if coords.dtype != torch.float32 or not coords.is_contiguous() \
            or coords.shape[-1] != 2:
        raise ValueError(f"{name}: expected contiguous float32 (B, H, W, 2) "
                         f"coords, got {coords.dtype} {tuple(coords.shape)}")
    dt = levels[0].dtype
    if dt not in _DTYPE_CODES:
        raise ValueError(f"{name}: level dtype {dt} not in float32/bfloat16")
    for lv in levels:
        if lv.dim() != 4 or tuple(lv.shape[:2]) != (B, N):
            raise ValueError(f"{name}: level {tuple(lv.shape)} does not "
                             f"match (B, N, Hl, Wl) = ({B}, {N}, ., .)")
        if lv.dtype != dt or not lv.is_contiguous() \
                or lv.device != coords.device:
            raise ValueError(f"{name}: levels must be contiguous, of one "
                             "dtype and on the coords' device")
    return B, N


def _level_args(levels):
    L = len(levels)
    return ((ctypes.c_longlong * L)(*[lv.data_ptr() for lv in levels]),
            (ctypes.c_int * L)(*[lv.shape[2] for lv in levels]),
            (ctypes.c_int * L)(*[lv.shape[3] for lv in levels]), L)


class PyramidLookup(torch.autograd.Function):
    """``(coords, radius, out_dtype, nchw, *levels) -> taps`` on the card:
    ``(B, P, H1, W1)`` when ``nchw`` else ``(B, H1, W1, P)``."""

    @staticmethod
    def forward(ctx, coords, radius, out_dtype, nchw, *levels):
        name = "pyramid_lookup"
        B, N = _check(name, levels, coords, radius)
        if out_dtype not in _DTYPE_CODES:
            raise ValueError(f"{name}: out_dtype {out_dtype} not in "
                             "float32/bfloat16")
        _, H1, W1, _ = coords.shape
        P = len(levels) * (2 * radius + 1) ** 2
        shape, strides = (((B, P, H1, W1), (P * N, 1, N)) if nchw
                          else ((B, H1, W1, P), (N * P, P, 1)))
        out = torch.empty(shape, dtype=out_dtype, device=coords.device)
        ptrs, hs, ws, L = _level_args(levels)
        rc = _fn("pyramid_lookup_fwd")(
            coords.device.index or 0, _DTYPE_CODES[levels[0].dtype],
            _DTYPE_CODES[out_dtype], ptrs, hs, ws, L, B, N, radius,
            coords.data_ptr(), out.data_ptr(), *strides,
            build.stream_handle(coords))
        build.check_status(name, rc)
        LAUNCHES["pyramid_lookup_fwd"] += 1
        ctx.save_for_backward(coords)
        ctx.radius, ctx.nchw = radius, nchw
        ctx.levels = [(tuple(lv.shape), lv.dtype) for lv in levels]
        return out

    @staticmethod
    def backward(ctx, g):
        (coords,) = ctx.saved_tensors
        dcoords = (torch.zeros_like(coords) if ctx.needs_input_grad[0]
                   else None)
        if not any(ctx.needs_input_grad[4:]):
            return (dcoords, None, None, None) + (None,) * len(ctx.levels)
        name = "pyramid_lookup_bwd"
        B, H1, W1, _ = coords.shape
        N = H1 * W1
        if g.dtype not in _DTYPE_CODES:
            raise ValueError(f"{name}: gradient dtype {g.dtype} not in "
                             "float32/bfloat16")
        g = g.contiguous()
        strides = ((g.shape[1] * N, 1, N) if ctx.nchw
                   else (N * g.shape[-1], g.shape[-1], 1))
        dlevels = [torch.empty(s, dtype=dt, device=coords.device)
                   for s, dt in ctx.levels]
        ptrs, hs, ws, L = _level_args(dlevels)
        rc = _fn("pyramid_lookup_bwd")(
            coords.device.index or 0, _DTYPE_CODES[dlevels[0].dtype],
            _DTYPE_CODES[g.dtype], ptrs, hs, ws, L, B, N, ctx.radius,
            coords.data_ptr(), g.data_ptr(),
            *strides, build.stream_handle(coords))
        build.check_status(name, rc)
        LAUNCHES["pyramid_lookup_bwd"] += 1
        return (dcoords, None, None, None, *dlevels)


def pyramid_lookup(pyramid: Sequence[torch.Tensor], coords: torch.Tensor,
                   radius: int, out_dtype: torch.dtype = torch.float32
                   ) -> torch.Tensor:
    """Window lookup of a materialized pyramid.

    Args:
      pyramid: levels ``(B, N, Hl, Wl)`` fp32 or bf16, ``N = H1 * W1``
        (:func:`raft_tpu_torch.ops.corr.build_corr_pyramid`).
      coords: ``(B, H1, W1, 2)`` fp32 level-0 centers, ``(x, y)`` last.
      radius: window radius r.
      out_dtype: dtype of the taps (fp32 accumulation either way).

    Returns:
      ``(B, H1, W1, L * (2r+1)^2)`` taps, x-major within a level;
      differentiable with respect to the pyramid.
    """
    if coords.device.type == "cpu":
        return pyramid_lookup_plain(pyramid, coords, radius, out_dtype)
    return PyramidLookup.apply(coords, radius, out_dtype, False, *pyramid)


def pyramid_lookup_nchw(pyramid: Sequence[torch.Tensor],
                        coords: torch.Tensor, radius: int,
                        out_dtype: torch.dtype = torch.float32
                        ) -> torch.Tensor:
    """:func:`pyramid_lookup` writing ``(B, L*(2r+1)^2, H1, W1)``, the
    layout the motion encoder's first conv reads (the model's entry)."""
    if coords.device.type == "cpu":
        return pyramid_lookup_plain(pyramid, coords, radius,
                                    out_dtype).permute(0, 3, 1,
                                                       2).contiguous()
    return PyramidLookup.apply(coords, radius, out_dtype, True, *pyramid)
