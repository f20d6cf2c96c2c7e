"""Materialized-pyramid lookup: the CUDA kernels' wrappers and their plain
version (the port of ``raft_tpu.ops.pallas_corr.pallas_pyramid_lookup`` and
``pallas_pyramid_lookup_quantized``, ``raft_tpu/ops/pallas_corr.py:
783-924``).

``csrc/pyramid_lookup.cu`` replaces the TPU kernels
``_pyr_multi_fwd_kernel`` (forward) and ``_pyr_multi_bwd_kernel`` (its
exact transpose).  :class:`PyramidLookup` is the ``torch.autograd.Function``
around them: forward taps in ``out_dtype``; backward a dense ``dcorr`` per
level in the level's stored dtype, and no gradient for ``coords`` (the
model detaches them every iteration, as the JAX custom_vjp returns zeros).
:func:`pyramid_lookup_quantized` runs the same forward kernel on a
quantized pyramid (int8 / fp8 codes, one fp32 scale per batch element and
level, multiplied into the taps before their one store); it is primal
only, as in JAX: the codes carry no gradient and the coords are detached.

The pyramid is the port's query-major one (``ops/corr.py``), levels
``(B, N, Hl, Wl)`` fp32 or bf16, or quantized levels
(:class:`raft_tpu_torch.ops.corr.QuantizedLevel`), from
:func:`raft_tpu_torch.ops.corr.build_corr_pyramid`; the plain version is
:func:`raft_tpu_torch.ops.corr.corr_lookup` with an empty level's taps
set to zero, cast to ``out_dtype``.  Non-finite centers give what the
TPU kernels give: a NaN center NaN taps on every non-empty level (and a
dcorr row that is NaN everywhere), an infinite one zeros, an empty level
zeros whatever the center; ``corr_lookup`` itself, the twin of the JAX
package's plain lookup, gives NaN on an empty level too.

A wrapper takes the plain version only for tensors on the CPU.  For any
other device it launches the kernel or raises; nothing falls back.
``LAUNCHES`` counts kernel launches: forward, backward, and the forward on
a quantized pyramid.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from raft_tpu_torch.ops import build
from raft_tpu_torch.ops.corr import QuantizedLevel, corr_lookup

LAUNCHES = {"pyramid_lookup_fwd": 0, "pyramid_lookup_bwd": 0,
            "pyramid_lookup_quantized": 0}

# tap and gradient dtypes; levels may also hold quantized codes
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
LEVEL_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
                     torch.float8_e4m3fn: 3, torch.float8_e5m2: 4}
_MAX_LEVELS = 8
SMEM_MAX = 227 * 1024       # dynamic shared memory a block may use
_FQ, _BQ = 32, 32   # queries per block of the forward and the backward
_T_FIELDS = 7       # ints per window in the forward's window table


def _zero_empty_levels(taps: torch.Tensor, empty: Sequence[bool],
                       radius: int) -> torch.Tensor:
    """``taps`` ``(..., L*(2r+1)^2)`` with the levels flagged in ``empty``
    set to zero, as the kernels give them whatever the center."""
    if not any(empty):
        return taps
    mask = torch.tensor(empty, device=taps.device).repeat_interleave(
        (2 * radius + 1) ** 2)
    return taps.masked_fill(mask, 0.0)


def pyramid_lookup_plain(pyramid: Sequence, coords: torch.Tensor,
                         radius: int, out_dtype: torch.dtype = torch.float32
                         ) -> torch.Tensor:
    """Plain version, of plain and of quantized pyramids alike:
    ``(B, H1, W1, L*(2r+1)^2)`` taps in ``out_dtype``, accumulated in fp32
    whatever the levels' dtype; an empty level's taps are zero."""
    empty = [(lv.values if isinstance(lv, QuantizedLevel) else lv)
             .shape[2:].numel() == 0 for lv in pyramid]
    return _zero_empty_levels(corr_lookup(pyramid, coords, radius), empty,
                              radius).to(out_dtype)


def _fn(symbol: str):
    fn = getattr(build.load("pyramid_lookup"), symbol)
    if fn.argtypes is None:
        vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lvl = [ctypes.POINTER(ll), ctypes.POINTER(ci), ctypes.POINTER(ci),
               ci, ci, ci, ci]
        # the forward takes a scale pointer after the coords
        ptrs = [vp, vp, vp] if symbol.endswith("_fwd") else [vp, vp]
        fn.argtypes = [ci, ci, ci] + lvl + ptrs + [ll, ll, ll, vp]
        fn.restype = ci
    return fn


def _lookup_smem_bytes(levels: int, radius: int) -> int:
    """Shared memory of one block of the lookup kernels, the larger of
    the forward's (fp32 levels, the largest, and the tile that stages
    query-major taps) and the backward's (``csrc/pyramid_lookup.cu``:
    ``fwd_smem_bytes``, ``bwd_smem_bytes``)."""
    k, kp = 2 * radius + 1, 2 * radius + 2
    # a window row of fp32 values is kp 4-byte words
    fwd = (_FQ * (levels * kp * kp + 1) + _T_FIELDS * _FQ * levels
           + _FQ * (levels * k * k + 1))
    bwd = _BQ * (k * k + kp * kp + 8) + kp * kp
    return 4 * max(fwd, bwd)


def check_levels(name, levels, coords, radius, dtypes=DTYPE_CODES,
                 smem_bytes=_lookup_smem_bytes, smem_limit=SMEM_MAX):
    """Shapes, dtypes and layouts the kernels take; returns (B, N).
    ``smem_bytes(L, radius)`` is the shared memory a block of the kernel
    needs, held to ``smem_limit``."""
    build.check_device(name, coords, *levels)
    B, H1, W1, _ = coords.shape
    N = H1 * W1
    L = len(levels)
    if not 1 <= L <= _MAX_LEVELS:
        raise ValueError(f"{name}: {L} levels, kernel takes 1..{_MAX_LEVELS}")
    if radius < 0 or smem_bytes(L, radius) > smem_limit:
        raise ValueError(f"{name}: radius {radius} with {L} levels does not "
                         "fit the kernels' shared-memory tiles")
    if coords.dtype != torch.float32 or not coords.is_contiguous() \
            or coords.shape[-1] != 2:
        raise ValueError(f"{name}: expected contiguous float32 (B, H, W, 2) "
                         f"coords, got {coords.dtype} {tuple(coords.shape)}")
    dt = levels[0].dtype
    if dt not in dtypes:
        raise ValueError(f"{name}: level dtype {dt} not in "
                         f"{', '.join(str(d) for d in dtypes)}")
    for lv in levels:
        if lv.dim() != 4 or tuple(lv.shape[:2]) != (B, N):
            raise ValueError(f"{name}: level {tuple(lv.shape)} does not "
                             f"match (B, N, Hl, Wl) = ({B}, {N}, ., .)")
        if lv.dtype != dt or not lv.is_contiguous() \
                or lv.device != coords.device:
            raise ValueError(f"{name}: levels must be contiguous, of one "
                             "dtype and on the coords' device")
    return B, N


def level_args(levels):
    """The ctypes level arrays of a kernel call: pointers, heights,
    widths, and the level count."""
    L = len(levels)
    return ((ctypes.c_longlong * L)(*[lv.data_ptr() for lv in levels]),
            (ctypes.c_int * L)(*[lv.shape[2] for lv in levels]),
            (ctypes.c_int * L)(*[lv.shape[3] for lv in levels]), L)


def split_quantized(pyramid: Sequence):
    """``(levels, scale)``: a quantized pyramid's codes and its ``(B, L)``
    fp32 scales; a plain pyramid's levels and None."""
    if not isinstance(pyramid[0], QuantizedLevel):
        return list(pyramid), None
    B = pyramid[0].values.shape[0]
    scale = torch.cat([lv.scale.reshape(B, 1).float() for lv in pyramid], 1)
    return [lv.values for lv in pyramid], scale.contiguous()


def check_scale(name, scale, B, L):
    """A quantized pyramid's scales: contiguous fp32 ``(B, L)`` on the
    card."""
    build.check_device(name, scale)
    if (scale.shape != (B, L) or scale.dtype != torch.float32
            or not scale.is_contiguous()):
        raise ValueError(f"{name}: expected a contiguous float32 (B, L) = "
                         f"({B}, {L}) scale, got {scale.dtype} "
                         f"{tuple(scale.shape)}")


def launch_fwd(levels, coords, radius, out_dtype, nchw, scale=None):
    """One launch of the forward kernel: taps ``(B, P, H1, W1)`` when
    ``nchw`` else ``(B, H1, W1, P)``; with ``scale`` (``(B, L)`` fp32) the
    levels are codes and each level's taps are multiplied by its scale."""
    name = ("pyramid_lookup_quantized" if scale is not None
            else "pyramid_lookup_fwd")
    B, N = check_levels(name, levels, coords, radius,
                        LEVEL_DTYPE_CODES if scale is not None
                        else DTYPE_CODES)
    if out_dtype not in DTYPE_CODES:
        raise ValueError(f"{name}: out_dtype {out_dtype} not in "
                         "float32/bfloat16")
    if scale is not None:
        check_scale(name, scale, B, len(levels))
    _, H1, W1, _ = coords.shape
    P = len(levels) * (2 * radius + 1) ** 2
    shape, strides = (((B, P, H1, W1), (P * N, 1, N)) if nchw
                      else ((B, H1, W1, P), (N * P, P, 1)))
    out = torch.empty(shape, dtype=out_dtype, device=coords.device)
    ptrs, hs, ws, L = level_args(levels)
    rc = _fn("pyramid_lookup_fwd")(
        coords.device.index or 0, LEVEL_DTYPE_CODES[levels[0].dtype],
        DTYPE_CODES[out_dtype], ptrs, hs, ws, L, B, N, radius,
        coords.data_ptr(), None if scale is None else scale.data_ptr(),
        out.data_ptr(), *strides, build.stream_handle(coords))
    build.check_status(name, rc)
    LAUNCHES[name] += 1
    return out


def launch_bwd(level_specs, coords, radius, g, nchw):
    """One launch of the backward kernel: the dense ``dcorr`` of each level
    (``level_specs``: its shape and dtype) from the tap gradient ``g``."""
    name = "pyramid_lookup_bwd"
    B, H1, W1, _ = coords.shape
    N = H1 * W1
    if g.dtype not in DTYPE_CODES:
        raise ValueError(f"{name}: gradient dtype {g.dtype} not in "
                         "float32/bfloat16")
    g = g.contiguous()
    strides = ((g.shape[1] * N, 1, N) if nchw
               else (N * g.shape[-1], g.shape[-1], 1))
    dlevels = [torch.empty(s, dtype=dt, device=coords.device)
               for s, dt in level_specs]
    ptrs, hs, ws, L = level_args(dlevels)
    rc = _fn("pyramid_lookup_bwd")(
        coords.device.index or 0, DTYPE_CODES[dlevels[0].dtype],
        DTYPE_CODES[g.dtype], ptrs, hs, ws, L, B, N, radius,
        coords.data_ptr(), g.data_ptr(), *strides,
        build.stream_handle(coords))
    build.check_status(name, rc)
    LAUNCHES[name] += 1
    return dlevels


class PyramidLookup(torch.autograd.Function):
    """``(coords, radius, out_dtype, nchw, *levels) -> taps`` on the card:
    ``(B, P, H1, W1)`` when ``nchw`` else ``(B, H1, W1, P)``."""

    @staticmethod
    def forward(ctx, coords, radius, out_dtype, nchw, *levels):
        out = launch_fwd(levels, coords, radius, out_dtype, nchw)
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
        dlevels = launch_bwd(ctx.levels, coords, ctx.radius, g, ctx.nchw)
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


def pyramid_lookup_quantized(pyramid: Sequence[QuantizedLevel],
                             coords: torch.Tensor, radius: int,
                             out_dtype: torch.dtype = torch.float32
                             ) -> torch.Tensor:
    """Window lookup of a quantized pyramid (:class:`QuantizedLevel`
    levels, int8 or fp8 codes): ``(B, H1, W1, L*(2r+1)^2)`` taps in
    ``out_dtype``, the codes sampled in fp32 and each level's taps
    multiplied by its scale.  Primal only: no gradient reaches the codes,
    the scales or ``coords``."""
    if coords.device.type == "cpu":
        return pyramid_lookup_plain(pyramid, coords.detach(), radius,
                                    out_dtype)
    levels, scale = split_quantized(pyramid)
    return launch_fwd(levels, coords.detach(), radius, out_dtype, False,
                      scale)


def pyramid_lookup_quantized_nchw(pyramid: Sequence[QuantizedLevel],
                                  coords: torch.Tensor, radius: int,
                                  out_dtype: torch.dtype = torch.float32
                                  ) -> torch.Tensor:
    """:func:`pyramid_lookup_quantized` writing ``(B, L*(2r+1)^2, H1, W1)``
    (the motion encoder's layout)."""
    if coords.device.type == "cpu":
        return pyramid_lookup_plain(pyramid, coords.detach(), radius,
                                    out_dtype).permute(0, 3, 1,
                                                       2).contiguous()
    levels, scale = split_quantized(pyramid)
    return launch_fwd(levels, coords.detach(), radius, out_dtype, True,
                      scale)
