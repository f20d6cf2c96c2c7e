"""On-demand correlation lookup: the CUDA kernels' wrappers.

``csrc/corr_ondemand.cu`` replaces the TPU kernels behind
``raft_tpu.ops.pallas_corr.pallas_corr_lookup``: ``_odm_fwd_kernel``
(forward) and, in one backward kernel, ``_odm_bwd_kernel`` and the
blocked pair ``_odm_bwd_df1/df2_blocked_kernel``.  The plain version of
the forward is :func:`raft_tpu_torch.ops.corr.chunked_corr_lookup` (the
same function, blockwise in PyTorch), that of the backward
:func:`corr_lookup_ondemand_bwd_plain`.  :class:`CorrLookupOndemand` is
the ``torch.autograd.Function`` around the two kernels: it saves
``fmap1``, the pooled levels and ``coords``; gradients reach ``fmap2``
through :func:`raft_tpu_torch.ops.corr.pool_fmap_pyramid` by autograd.

``coords`` get no gradient on either device (the JAX ``custom_vjp``
returns zeros; the model detaches them every iteration): both wrappers
detach them.

A wrapper takes the plain version only for tensors on the CPU.  For any
other device it launches the kernel or raises; nothing falls back.
``LAUNCHES`` counts kernel launches, forward and backward, so a run can
show which path it took.
"""

from __future__ import annotations

import ctypes
import math
from typing import Sequence

import torch

from raft_tpu_torch.ops import build
from raft_tpu_torch.ops.corr import chunked_corr_lookup

LAUNCHES = {"corr_ondemand": 0, "corr_ondemand_bwd": 0}

_SUPPORTED_C = (32, 64, 128, 256, 512)
_MAX_LEVELS = 8
_SMEM_LIMIT = 48 * 1024
_QPB = 8   # queries per block, as in the kernels


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
            # (device, f1, coords, f2s, hs, ws, L, B, N, C, r, 1/sqrt(C),
            #  out, out strides x3, stream)
            "corr_ondemand_fwd": [ci, vp, vp, ptrs, ints, ints] + [ci] * 5
            + [ctypes.c_float, vp, ll, ll, ll, vp],
            # (device, f1, coords, f2s, df2s, hs, ws, L, B, N, C, r,
            #  1/sqrt(C), g, g strides x3, df1, stream)
            "corr_ondemand_bwd": [ci, vp, vp, ptrs, ptrs, ints, ints]
            + [ci] * 5 + [ctypes.c_float, vp, ll, ll, ll, vp, vp]}[symbol]
        fn.restype = ci
    return fn


def _level_args(tensors):
    L = len(tensors)
    return ((ctypes.c_longlong * L)(*[t.data_ptr() for t in tensors]),
            (ctypes.c_int * L)(*[t.shape[1] for t in tensors]),
            (ctypes.c_int * L)(*[t.shape[2] for t in tensors]))


def _check(fmap1, levels, coords, radius):
    """Shapes, dtypes and layouts the kernels take; returns (B, N, C)."""
    name = "corr_lookup_ondemand"
    build.check_device(name, fmap1, coords, *levels)
    B, H1, W1, C = fmap1.shape
    N = H1 * W1
    L = len(levels)
    k = 2 * radius + 1
    if C not in _SUPPORTED_C:
        raise ValueError(f"{name}: channels {C} not in {_SUPPORTED_C}")
    if not 1 <= L <= _MAX_LEVELS:
        raise ValueError(f"{name}: {L} levels, kernel takes 1..{_MAX_LEVELS}")
    if radius < 0 or _QPB * (L * k * k + (k + 1) ** 2) * 4 > _SMEM_LIMIT:
        raise ValueError(f"{name}: radius {radius} with {L} levels does not "
                         "fit the kernel's shared-memory tile")
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


class CorrLookupOndemand(torch.autograd.Function):
    """``(fmap1, coords, radius, nchw, *levels) -> taps`` on the card:
    ``(B, P, H1, W1)`` when ``nchw`` else ``(B, H1, W1, P)``, fp32;
    differentiable with respect to ``fmap1`` and the levels."""

    @staticmethod
    def forward(ctx, fmap1, coords, radius, nchw, *levels):
        B, N, C = _check(fmap1, levels, coords, radius)
        _, H1, W1, _ = fmap1.shape
        P = len(levels) * (2 * radius + 1) ** 2
        shape, strides = (((B, P, H1, W1), (P * N, 1, N)) if nchw
                          else ((B, H1, W1, P), (N * P, P, 1)))
        out = torch.empty(shape, dtype=torch.float32, device=fmap1.device)
        rc = _fn("corr_ondemand_fwd")(
            fmap1.device.index or 0, fmap1.data_ptr(), coords.data_ptr(),
            *_level_args(levels), len(levels), B, N, C, radius,
            1.0 / math.sqrt(C), out.data_ptr(), *strides,
            build.stream_handle(fmap1))
        build.check_status("corr_lookup_ondemand", rc)
        LAUNCHES["corr_ondemand"] += 1
        ctx.save_for_backward(fmap1, coords, *levels)
        ctx.radius, ctx.nchw = radius, nchw
        return out

    @staticmethod
    def backward(ctx, g):
        fmap1, coords, *levels = ctx.saved_tensors
        if not (ctx.needs_input_grad[0] or any(ctx.needs_input_grad[4:])):
            return (None,) * (4 + len(levels))
        name = "corr_lookup_ondemand_bwd"
        if g.dtype != torch.float32:
            raise ValueError(f"{name}: expected a float32 tap gradient, got "
                             f"{g.dtype}")
        B, H1, W1, C = fmap1.shape
        N, P = H1 * W1, g.shape[1 if ctx.nchw else 3]
        g = g.contiguous()              # the layout the forward wrote
        strides = (P * N, 1, N) if ctx.nchw else (N * P, P, 1)
        df1 = torch.empty_like(fmap1)
        df2 = [torch.zeros_like(lv) for lv in levels]
        ptrs, hs, ws = _level_args(levels)
        rc = _fn("corr_ondemand_bwd")(
            fmap1.device.index or 0, fmap1.data_ptr(), coords.data_ptr(),
            ptrs, _level_args(df2)[0], hs, ws, len(levels), B, N, C,
            ctx.radius, 1.0 / math.sqrt(C), g.data_ptr(), *strides,
            df1.data_ptr(), build.stream_handle(fmap1))
        build.check_status(name, rc)
        LAUNCHES["corr_ondemand_bwd"] += 1
        return (df1, None, None, None, *df2)


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
        return chunked_corr_lookup(fmap1, fmap2_pyramid, coords.detach(),
                                   radius)
    return CorrLookupOndemand.apply(fmap1, coords.detach(), radius, False,
                                    *fmap2_pyramid)


def corr_lookup_ondemand_nchw(fmap1: torch.Tensor,
                              fmap2_pyramid: Sequence[torch.Tensor],
                              coords: torch.Tensor,
                              radius: int) -> torch.Tensor:
    """:func:`corr_lookup_ondemand` writing ``(B, L*(2r+1)^2, H1, W1)``,
    the layout the motion encoder's first conv reads (the model's entry)."""
    if fmap1.device.type == "cpu":
        return chunked_corr_lookup(fmap1, fmap2_pyramid, coords.detach(),
                                   radius).permute(0, 3, 1, 2).contiguous()
    return CorrLookupOndemand.apply(fmap1, coords.detach(), radius, True,
                                    *fmap2_pyramid)
