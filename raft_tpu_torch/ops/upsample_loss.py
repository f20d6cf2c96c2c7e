"""Fused convex upsample + sequence-loss sums: the CUDA kernels' wrappers
and their plain version (the port of
``raft_tpu.ops.pallas_upsample.pallas_upsample_loss_sums``,
``raft_tpu/ops/pallas_upsample.py:187-266``).

``csrc/upsample_loss.cu`` replaces the TPU kernels
``_upsample_loss_fwd_kernel`` and ``_upsample_loss_bwd_kernel`` (the
recomputing backward).  :class:`UpsampleLossSums` is the
``torch.autograd.Function`` around them: ``(flow, mask, gt, vmask) ->
(gB, 5)`` fp32 sums ``[l1, epe, 1px, 3px, 5px]`` per folded sample, with
gradients to ``flow`` and ``mask`` from the l1 sum only.

The plain version is the chain of the model's ``'xla'`` branch
(``raft_tpu/models/raft.py:255-289``): :func:`convex_upsample_flat_nchw`,
the fp32 compare against the space-to-depth ground truth, and the sums.

Layouts: ``flow`` ``(gB, H, W, 2)`` fp32 (the model's coordinates);
``mask`` ``(gB, 576, H, W)``, fp32 or bf16, the mask head's NCHW output
(the JAX layout ``(gB, H, W, 576)`` is its ``permute(0, 2, 3, 1)``);
``gt`` ``(B, 8H, 8W, 2)`` and ``vmask`` ``(B, 8H, 8W)`` fp32 at full
resolution, shared by the ``g = gB / B`` folded iterations (sample n uses
``n % B``).

The forward kernel loads the mask P values a lane at a time (P = 4, or 8
for a bf16 mask whose channel planes are 16-byte aligned), in pieces of
the widest width that both the mask's address and the plane stride
``H*W*es`` allow (:func:`fwd_plan`: 16, 8, 4 or 2 bytes; 16 for an fp32
mask at the training grids, 8 for a bf16 one at the chairs grid, whose
planes are 5,704 bytes apart).  Each warp owns a tile of 32 groups and
an equal share of the tile's items (a sample and four subpixel planes),
the folded iterations that share a ground-truth sample consecutive so
that they share its staged copy; each item's 5 sums go to a partial
buffer (``fwd_plan``'s ``partial`` floats a sample), and a second kernel
adds each sample's partials in order.  The ground truth and valid mask
are read 16-byte aligned and the flow 8-byte aligned (:func:`aligned16`).

The backward kernel stages the mask in shared memory and stores dmask
from it in whole 32-byte sectors, 16 bytes an access; only at a channel
plane's first and last 32 bytes, which it shares with the neighbouring
planes, does it store pieces of the widest width that both base
addresses and the plane stride allow (:func:`bwd_vector_bytes`).  Each
width is a path of a kernel, not a fallback.  dmask is allocated at the
mask's address mod 16 (:func:`empty_like_mod16`) and the ground truth
16-byte aligned (:func:`aligned16`), as the kernels need.

A wrapper takes the plain version only for tensors on the CPU.  For any
other device it launches the kernel or raises; nothing falls back.
``LAUNCHES`` counts kernel launches, forward and backward.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from raft_tpu_torch.ops import build
from raft_tpu_torch.ops.upsample import (convex_upsample_flat_nchw,
                                         space_to_depth_flow)

LAUNCHES = {"upsample_loss_fwd": 0, "upsample_loss_bwd": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def abs_pos0(x: torch.Tensor) -> torch.Tensor:
    """``|x|`` whose derivative is +1 at exactly 0 (``jnp.abs``'s VJP;
    ``torch.abs`` gives ``sign(0) = 0``)."""
    return x * torch.where(x >= 0, 1.0, -1.0).to(x.dtype)


def upsample_loss_sums_plain(flow: torch.Tensor, mask: torch.Tensor,
                             gt: torch.Tensor, vmask: torch.Tensor,
                             compute_dtype: torch.dtype = torch.float32
                             ) -> torch.Tensor:
    """Plain version: the upsample chain in ``compute_dtype`` (the kernel
    computes fp32), the compare and the sums in fp32; the four metric
    sums carry no gradient."""
    gB, H, W, _ = flow.shape
    B = gt.shape[0]
    g = gB // B
    out = convex_upsample_flat_nchw(flow.permute(0, 3, 1, 2), mask,
                                    compute_dtype).float()
    out = out.reshape(g, B, 128, H, W)
    gt128 = space_to_depth_flow(gt.float()).permute(0, 3, 1, 2)[None]
    vm = space_to_depth_flow(vmask.float()[..., None]).permute(0, 3, 1,
                                                               2)[None]
    dx = out[:, :, :64] - gt128[:, :, :64]
    dy = out[:, :, 64:] - gt128[:, :, 64:]
    dims = (2, 3, 4)
    l1 = torch.sum(vm * (abs_pos0(dx) + abs_pos0(dy)), dim=dims)
    with torch.no_grad():
        epe = torch.sqrt(dx * dx + dy * dy)
        metrics = [torch.sum(vm * epe, dim=dims)] + [
            torch.sum(vm * (epe < t).float(), dim=dims)
            for t in (1.0, 3.0, 5.0)]
    return torch.stack([l1] + metrics, dim=-1).reshape(gB, 5)


def bwd_vector_bytes(mask_ptr: int, dmask_ptr: int, hw: int,
                     itemsize: int) -> int:
    """Bytes per dmask store of the backward kernel at a channel plane's
    first and last 32 bytes: the widest of 16, 8, 4 and 2 (at least one
    value) that divides both base addresses and the plane stride
    ``hw * itemsize``."""
    for vb in (16, 8, 4, 2):
        if vb >= itemsize and not (mask_ptr % vb or dmask_ptr % vb
                                   or hw * itemsize % vb):
            return vb
    raise ValueError(f"upsample_loss_bwd: addresses {mask_ptr:#x}, "
                     f"{dmask_ptr:#x} are not aligned to their "
                     f"{itemsize}-byte values")


@dataclasses.dataclass(frozen=True)
class FwdPlan:
    """How the forward kernel covers a mask: ``vec_bytes`` per load,
    ``pixels`` a lane, the sample's first group starting ``offset``
    values before its first pixel (so that every load is aligned),
    ``tiles`` of 32 groups a sample, and ``partial`` floats a sample (5
    sums for each tile and each of the 16 stages of four subpixel
    planes)."""
    vec_bytes: int
    pixels: int
    offset: int
    tiles: int
    partial: int


def fwd_plan(mask_ptr: int, hw: int, itemsize: int) -> FwdPlan:
    """The forward kernel's plan for a mask at address ``mask_ptr`` with
    ``hw`` pixels a channel plane of ``itemsize``-byte values: loads of
    the widest of 16, 8, 4 and 2 bytes (at least one value) that divides
    the address and the plane stride; 16 / itemsize pixels a lane at 16
    bytes, else 4."""
    vb = bwd_vector_bytes(mask_ptr, mask_ptr, hw, itemsize)
    pixels = 16 // itemsize if vb == 16 else 4
    offset = mask_ptr % (pixels * itemsize) // itemsize
    groups = -(-(hw + offset) // pixels)
    tiles = -(-groups // 32)
    return FwdPlan(vb, pixels, offset, tiles, tiles * 16 * 5)


def empty_like_mod16(t: torch.Tensor) -> torch.Tensor:
    """An uninitialised contiguous tensor like ``t`` whose address is
    ``t``'s mod 16 (the backward kernel stages a row of the mask and of
    dmask at one offset)."""
    off = t.data_ptr() % 16 // t.element_size()
    return torch.empty(t.numel() + off, dtype=t.dtype,
                       device=t.device)[off:].view(t.shape)


def aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it when its address is off 16 bytes (the
    kernels copy the ground truth in 16-byte pieces)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _fn(symbol: str):
    fn = getattr(build.load("upsample_loss"), symbol)
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        if symbol == "upsample_loss_fwd":
            fn.argtypes = [ci, ci, ci, vp, vp, vp, vp, ci, ci, ci, ci, vp,
                           ctypes.c_longlong, vp, vp]
        else:
            fn.argtypes = [ci, ci, ci, vp, vp, vp, vp, vp, ci, ci, ci, ci,
                           vp, vp, vp, vp]
        fn.restype = ci
    return fn


def _check(name, flow, mask, gt, vmask):
    build.check_device(name, flow, mask, gt, vmask)
    gB, H, W, _ = flow.shape
    B = gt.shape[0]
    want = {"flow": (flow, (gB, H, W, 2)), "mask": (mask, (gB, 576, H, W)),
            "gt": (gt, (B, 8 * H, 8 * W, 2)), "vmask": (vmask,
                                                        (B, 8 * H, 8 * W))}
    for key, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {key} {tuple(t.shape)}, expected "
                             f"{shape}")
        if not t.is_contiguous() or t.device != flow.device:
            raise ValueError(f"{name}: {key} must be contiguous and on "
                             f"{flow.device}")
        if t is not mask and t.dtype != torch.float32:
            raise ValueError(f"{name}: {key} must be float32, got {t.dtype}")
    if mask.dtype not in _DTYPE_CODES:
        raise ValueError(f"{name}: mask dtype {mask.dtype} not in "
                         "float32/bfloat16")
    if B < 1 or gB % B:
        raise ValueError(f"{name}: {gB} samples are not a multiple of the "
                         f"{B} ground-truth samples")
    return gB, B, H, W


class UpsampleLossSums(torch.autograd.Function):
    """``(flow, mask, gt, vmask) -> (gB, 5)`` sums on the card."""

    @staticmethod
    def forward(ctx, flow, mask, gt, vmask):
        name = "upsample_loss"
        gB, B, H, W = _check(name, flow, mask, gt, vmask)
        plan = fwd_plan(mask.data_ptr(), H * W, mask.element_size())
        dev = flow.device
        partial = torch.empty(gB * plan.partial, dtype=torch.float32,
                              device=dev)
        sums = torch.empty((gB, 5), dtype=torch.float32, device=dev)
        f16, g16, v16 = aligned16(flow), aligned16(gt), aligned16(vmask)
        rc = _fn("upsample_loss_fwd")(
            dev.index or 0, _DTYPE_CODES[mask.dtype], plan.vec_bytes,
            f16.data_ptr(), mask.data_ptr(), g16.data_ptr(),
            v16.data_ptr(), gB, B, H, W, partial.data_ptr(), partial.numel(),
            sums.data_ptr(), build.stream_handle(flow))
        build.check_status(name, rc)
        LAUNCHES["upsample_loss_fwd"] += 1
        ctx.save_for_backward(flow, mask, gt, vmask)
        return sums

    @staticmethod
    def backward(ctx, g):
        flow, mask, gt, vmask = ctx.saved_tensors
        if not (ctx.needs_input_grad[0] or ctx.needs_input_grad[1]):
            return None, None, None, None
        name = "upsample_loss_bwd"
        gB, H, W, _ = flow.shape
        B = gt.shape[0]
        dev = flow.device
        gl1 = g[:, 0].float().contiguous()
        dmask = empty_like_mod16(mask)
        scratch = torch.empty(gB * 18 * H * W, dtype=torch.float32,
                              device=dev)
        dflow = torch.empty_like(flow)
        vb = bwd_vector_bytes(mask.data_ptr(), dmask.data_ptr(), H * W,
                              mask.element_size())
        gt, vmask = aligned16(gt), aligned16(vmask)
        rc = _fn("upsample_loss_bwd")(
            dev.index or 0, _DTYPE_CODES[mask.dtype], vb, flow.data_ptr(),
            mask.data_ptr(), gt.data_ptr(), vmask.data_ptr(),
            gl1.data_ptr(), gB, B, H, W, dmask.data_ptr(),
            scratch.data_ptr(), dflow.data_ptr(), build.stream_handle(flow))
        build.check_status(name, rc)
        LAUNCHES["upsample_loss_bwd"] += 1
        return (dflow if ctx.needs_input_grad[0] else None,
                dmask if ctx.needs_input_grad[1] else None, None, None)


def upsample_loss_sums(flow: torch.Tensor, mask: torch.Tensor,
                       gt: torch.Tensor, vmask: torch.Tensor) -> torch.Tensor:
    """Fused flat convex upsample + masked L1/EPE sums (layouts in the
    module docstring): ``(gB, 5)`` fp32 ``[l1, epe, 1px, 3px, 5px]``;
    sum over the B samples of an iteration for its totals."""
    if flow.device.type == "cpu":
        return upsample_loss_sums_plain(flow, mask, gt, vmask)
    return UpsampleLossSums.apply(flow, mask, gt, vmask)
