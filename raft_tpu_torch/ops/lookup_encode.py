"""Fused pyramid lookup -> motion-encoder ``convc1`` (+ bias + relu): the
CUDA kernel's wrapper, its autograd ``Function`` and its plain version
(the port of ``raft_tpu.ops.pallas_corr.pallas_pyramid_lookup_encode``,
``raft_tpu/ops/pallas_corr.py:1165-1373``).

``out = relu(taps @ W' + bias)``: ``taps`` are the raw window samples of
the stored levels (fp32 or bf16 values, or int8 / fp8 codes), ``W'`` is
``convc1``'s weight ``(F, L*k*k, 1, 1)`` viewed as ``(L*k*k, F)`` in fp32
whatever the compute dtype, and for a quantized pyramid each level's rows
of ``W'`` are multiplied by that (batch element, level)'s scale: the
conv is linear in the taps, so this is the dequantized lookup followed by
the conv.  The sum is fp32 and the result is stored once in ``out_dtype``,
NCHW ``(B, F, H1, W1)``.  Under bf16 compute it therefore differs from
the unfused bf16 conv by bf16 rounding, as JAX's fused path does.  The
taps are the lookup kernels' (``pyramid_lookup_plain``): an empty level
gives zero taps, a NaN center NaN taps on the other levels, and the relu
keeps NaN.  ``csrc/lookup_encode.cu`` replaces the TPU kernel
``_pyr_encode_kernel`` (its contraction on tensor cores in a 3xTF32
split); the ``(B, N, L*k*k)`` tap tensor never reaches device memory.
The wrapper builds ``W'`` as the kernel reads it, as JAX's caller does
outside its kernel: zero-padded to a multiple of 8 rows and of 4
columns, one matrix per batch element for a quantized pyramid.

:class:`PyramidLookupEncode` is the port of the custom VJP ``_pyr_enc_bwd``.
It saves the pyramid, the coords, the weight, the bias and ``out``; its
backward masks the gradient by ``out > 0`` (fp32), recomputes the fp32
(dequantized) taps with the lookup kernels (``ops/pyramid_kernels.py``),
takes ``dW = taps^T gm`` and ``db = sum(gm)`` as matrix products outside
any kernel, and for fp32 / bf16 levels the pyramid gradient from the
lookup's backward kernel on ``gm @ W^T``, in each level's dtype.  A
quantized pyramid and the coords get no gradient.  On the CPU the same
``Function`` runs the plain forward and the plain recomputing backward
(:func:`pyramid_lookup_encode_bwd_plain`).  The plain backward takes the
forward's ``out``: a pre-activation within rounding of 0 gets its relu
mask from the kernel's own output, so the two backwards are compared on
the same mask (two forwards may round such a value to opposite sides,
which moves ``dW`` by a whole ``g * tap``).

A wrapper takes the plain version only for tensors on the CPU.  For any
other device it launches the kernel or raises; nothing falls back.
``LAUNCHES`` counts the fused kernel's launches.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from raft_tpu_torch.obs import cost
from raft_tpu_torch.ops import build
from raft_tpu_torch.ops.corr import QuantizedLevel
from raft_tpu_torch.ops.pyramid_kernels import (DTYPE_CODES,
                                                LEVEL_DTYPE_CODES, SMEM_MAX,
                                                check_levels, check_scale,
                                                launch_bwd, launch_fwd,
                                                level_args,
                                                pyramid_lookup_plain,
                                                split_quantized)

LAUNCHES = {"lookup_encode": 0}

# the kernel's tiling (csrc/lookup_encode.cu): queries per block, warps,
# windows a warp samples at once; the largest radius it samples
_MT, _NWARPS, _PP, _MAX_RADIUS = 64, 8, 2, 5


def _kpad(levels: int, radius: int) -> int:
    return -(-levels * (2 * radius + 1) ** 2 // 8) * 8


def smem_bytes(levels: int, radius: int) -> int:
    """Dynamic shared memory of one block of the fused kernel; a radius
    the kernel does not sample counts as too large."""
    if radius > _MAX_RADIUS:
        return SMEM_MAX + 1
    return 4 * (_MT * (_kpad(levels, radius) + 4)
                + (_NWARPS * _PP + 1) * (2 * radius + 2) ** 2
                + (2 * radius + 1) ** 2)


def _weight_matrix(weight: torch.Tensor, scale, kk: int) -> torch.Tensor:
    """``W'``: ``(KK, F)`` fp32, or ``(B, KK, F)`` with each level's rows
    times its (batch, level) scale."""
    F = weight.shape[0]
    w32 = weight.float().reshape(F, -1).t()
    if scale is None:
        return w32
    B, L = scale.shape
    return (w32.reshape(L, kk, F)[None] * scale[:, :, None, None]).reshape(
        B, L * kk, F)


def pyramid_lookup_encode_plain(pyramid: Sequence, coords: torch.Tensor,
                                radius: int, weight: torch.Tensor,
                                bias: torch.Tensor,
                                out_dtype: torch.dtype = torch.float32
                                ) -> torch.Tensor:
    """Plain version, in the kernel's operation order: the raw fp32 taps of
    the stored levels, times ``W'`` (scales folded into the weights), plus
    the bias, relu, then one cast.  Returns ``(B, F, H1, W1)``."""
    levels, scale = split_quantized(pyramid)
    B, H1, W1, _ = coords.shape
    kk = (2 * radius + 1) ** 2
    taps = pyramid_lookup_plain(levels, coords, radius).reshape(
        B, H1 * W1, -1)
    out = torch.matmul(taps, _weight_matrix(weight, scale, kk))
    out = torch.relu(out + bias.float())                     # (B, N, F)
    return out.transpose(1, 2).reshape(B, -1, H1, W1).to(
        out_dtype).contiguous()


def _fn():
    fn = build.load("lookup_encode").lookup_encode_fwd
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = ([ci, ci, ci, ctypes.POINTER(ctypes.c_longlong),
                        ctypes.POINTER(ci), ctypes.POINTER(ci), ci, ci, ci,
                        ci, vp, vp, ctypes.c_longlong, vp, ci, ci, vp, vp])
        fn.restype = ci
    return fn


def _launch(levels, scale, coords, radius, weight, bias, out_dtype):
    """One launch of the fused kernel -> ``(B, F, H1, W1)``."""
    name = "lookup_encode"
    B, N = check_levels(name, levels, coords, radius, LEVEL_DTYPE_CODES,
                        smem_bytes, SMEM_MAX)
    KK = len(levels) * (2 * radius + 1) ** 2
    F = weight.shape[0]
    build.check_device(name, weight, bias)
    if weight.shape != (F, KK, 1, 1) or weight.dtype != torch.float32 \
            or not weight.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous float32 weight "
                         f"({F}, {KK}, 1, 1), got {weight.dtype} "
                         f"{tuple(weight.shape)}")
    if bias.shape != (F,) or bias.dtype != torch.float32 \
            or not bias.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous float32 bias "
                         f"({F},), got {bias.dtype} {tuple(bias.shape)}")
    if scale is not None:
        check_scale(name, scale, B, len(levels))
    if out_dtype not in DTYPE_CODES:
        raise ValueError(f"{name}: out_dtype {out_dtype} not in "
                         "float32/bfloat16")
    _, H1, W1, _ = coords.shape
    ptrs, hs, ws, L = level_args(levels)
    # W' as the kernel reads it: (1 or B, K_pad, F4), zero-padded
    f4 = -(-F // 4) * 4
    wp = torch.zeros((1 if scale is None else B, _kpad(L, radius), f4),
                     dtype=torch.float32, device=coords.device)
    wp[:, :KK, :F] = _weight_matrix(weight, scale, KK // L)
    out = torch.empty((B, F, H1, W1), dtype=out_dtype, device=coords.device)
    rc = _fn()(coords.device.index or 0, LEVEL_DTYPE_CODES[levels[0].dtype],
               DTYPE_CODES[out_dtype], ptrs, hs, ws, L, B, N, radius,
               coords.data_ptr(), wp.data_ptr(),
               0 if scale is None else wp.shape[1] * f4, bias.data_ptr(), F,
               f4, out.data_ptr(), build.stream_handle(coords))
    build.check_status(name, rc)
    LAUNCHES[name] += 1
    if cost.counting_active():
        # the JAX package's formula for its fused lookup + convc1 (a cost
        # count cannot see a ctypes launch)
        cost.note_analytic(name, *cost.analytic_lookup_encode_cost(
            B, [(lv.shape[2], lv.shape[3]) for lv in levels], N, radius, F,
            pyramid_bytes=levels[0].element_size()))
    return out


def _pyramid(levels, scale):
    if scale is None:
        return list(levels)
    return [QuantizedLevel(v, scale[:, i].reshape(-1, 1, 1, 1))
            for i, v in enumerate(levels)]


def _backward(levels, scale, coords, radius, weight, out, g, level_grads,
              taps_fn, dlevels_fn):
    """The recomputing backward in ``_pyr_enc_bwd``'s operation order:
    ``gm = g * (out > 0)`` in fp32, the fp32 (dequantized) taps from
    ``taps_fn``, ``dW = taps^T gm`` and ``db = sum(gm)`` as matrix
    products, and for plain levels (when ``level_grads``) the pyramid
    gradient of ``gm @ W^T`` from ``dlevels_fn``."""
    B, H1, W1, _ = coords.shape
    F = weight.shape[0]
    gm = (g.float() * (out > 0)).reshape(B, F, H1 * W1)
    taps = taps_fn().reshape(B, -1, H1 * W1)                 # (B, KK, N)
    dw = torch.einsum("bfn,bkn->fk", gm, taps)
    db = gm.sum(dim=(0, 2))
    dlevels = [None] * len(levels)
    if scale is None and level_grads:
        g_taps = torch.einsum("fk,bfn->bkn", weight.float().reshape(F, -1),
                              gm).reshape(B, -1, H1, W1)
        dlevels = dlevels_fn(g_taps)
    return dw.reshape(weight.shape).to(weight.dtype), db, dlevels


def pyramid_lookup_encode_bwd_plain(pyramid: Sequence, coords: torch.Tensor,
                                    radius: int, weight: torch.Tensor,
                                    out: torch.Tensor, g: torch.Tensor):
    """Plain version of the backward, given the forward's output ``out``
    (whose relu mask it applies) and its gradient ``g``: ``(dweight,
    dbias, dlevels)``, ``dlevels`` None for a quantized pyramid.  The
    taps are ``pyramid_lookup_plain``'s and the pyramid gradient is
    autograd's transpose of it, in each level's dtype."""
    levels, scale = split_quantized(pyramid)
    coords = coords.detach()

    def dlevels_fn(g_taps):
        with torch.enable_grad():
            lv = [x.detach().requires_grad_(True) for x in levels]
            taps = pyramid_lookup_plain(lv, coords, radius)
            return list(torch.autograd.grad(taps, lv,
                                            g_taps.permute(0, 2, 3, 1)))

    dw, db, dlevels = _backward(
        levels, scale, coords, radius, weight, out, g, True,
        lambda: pyramid_lookup_plain(pyramid, coords, radius).permute(
            0, 3, 1, 2),
        dlevels_fn)
    return dw, db, None if scale is not None else dlevels


class PyramidLookupEncode(torch.autograd.Function):
    """``(coords, weight, bias, scale, radius, out_dtype, *levels) ->
    relu(conv1x1(lookup))`` ``(B, F, H1, W1)``: the kernels on the card,
    the plain versions (forward and backward) on the CPU; ``scale`` is
    None for plain levels and ``(B, L)`` fp32 for codes."""

    @staticmethod
    def forward(ctx, coords, weight, bias, scale, radius, out_dtype,
                *levels):
        coords = coords.detach()
        if coords.device.type == "cpu":
            out = pyramid_lookup_encode_plain(_pyramid(levels, scale),
                                              coords, radius, weight, bias,
                                              out_dtype)
        else:
            out = _launch(levels, scale, coords, radius, weight, bias,
                          out_dtype)
        ctx.save_for_backward(coords, weight, bias, scale, out, *levels)
        ctx.radius = radius
        return out

    @staticmethod
    def backward(ctx, g):
        coords, weight, bias, scale, out, *levels = ctx.saved_tensors
        r = ctx.radius
        if coords.device.type == "cpu":
            dw, db, dlevels = pyramid_lookup_encode_bwd_plain(
                _pyramid(levels, scale), coords, r, weight, out, g)
            dlevels = dlevels or [None] * len(levels)
        else:
            dw, db, dlevels = _backward(
                levels, scale, coords, r, weight, out, g,
                any(ctx.needs_input_grad[6:]),
                lambda: launch_fwd(levels, coords, r, torch.float32, True,
                                   scale),
                lambda g_taps: launch_bwd(
                    [(tuple(x.shape), x.dtype) for x in levels], coords, r,
                    g_taps, True))
        return (None, dw, db.to(bias.dtype), None, None, None, *dlevels)


def pyramid_lookup_encode(pyramid: Sequence, coords: torch.Tensor,
                          radius: int, weight: torch.Tensor,
                          bias: torch.Tensor,
                          out_dtype: torch.dtype = torch.float32
                          ) -> torch.Tensor:
    """``relu(convc1(lookup(pyramid, coords)))`` as one kernel.

    Args:
      pyramid: levels ``(B, N, Hl, Wl)`` fp32 or bf16, or
        :class:`QuantizedLevel` levels (int8 / fp8 codes and scales), from
        :func:`raft_tpu_torch.ops.corr.build_corr_pyramid`.
      coords: ``(B, H1, W1, 2)`` fp32 level-0 centers, ``(x, y)`` last
        (detached: no gradient).
      weight: ``convc1``'s weight ``(F, L*(2r+1)^2, 1, 1)``, fp32.
      bias: ``(F,)`` fp32.
      out_dtype: dtype of the result (fp32 accumulation either way).

    Returns:
      ``(B, F, H1, W1)`` activations; differentiable with respect to
      ``weight``, ``bias`` and a plain pyramid's levels.
    """
    levels, scale = split_quantized(pyramid)
    return PyramidLookupEncode.apply(coords.contiguous(), weight, bias,
                                     scale, radius, out_dtype, *levels)
