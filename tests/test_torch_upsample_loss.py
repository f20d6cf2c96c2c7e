"""The fused upsample + loss sums of the port (the plain version of its
CUDA kernel) against the JAX package's TPU kernel
``pallas_upsample_loss_sums`` in interpret mode and against its XLA chain:
twins of ``tests/test_pallas_upsample.py:55-115``; and the flat upsample
ops against ``raft_tpu/ops/upsample.py``.

The JAX kernel takes the mask as ``(gB, H, W, 576)`` and the ground truth
in space-to-depth layout; the port takes the mask head's NCHW
``(gB, 576, H, W)`` and the ground truth at full resolution.  Tolerances:
sums rtol 1e-5 / atol 1e-3 (fp32 sums of 4096 terms per sample in another
order), gradients rtol 1e-4 / atol 1e-5, flat ops 1e-5; a bf16 mask's
gradient within one bf16 ulp (2^-7 relative): the two fp32 values
before the rounding differ in the last bits and may round apart.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.ops import upsample as jups
from raft_tpu.ops.pallas_upsample import pallas_upsample_loss_sums
from raft_tpu_torch.ops import upsample as tups
from raft_tpu_torch.ops import upsample_loss
from raft_tpu_torch.ops.upsample_loss import (upsample_loss_sums,
                                              upsample_loss_sums_plain)

B, G, H, W = 2, 2, 8, 16
GB = G * B
WEIGHTS = np.array([0.8, 1.0], np.float32)


def _inputs(seed):
    rng = np.random.default_rng(seed)
    flow = (rng.standard_normal((GB, H, W, 2)) * 3).astype(np.float32)
    mask = rng.standard_normal((GB, H, W, 576)).astype(np.float32)
    gt = (rng.standard_normal((B, 8 * H, 8 * W, 2)) * 3).astype(np.float32)
    vm = (rng.uniform(size=(B, 8 * H, 8 * W)) > 0.2).astype(np.float32)
    return flow, mask, gt, vm


def _zero_residual_inputs():
    """Zero flow and uniform softmax give an upsampled flow of exactly 0
    wherever the ground truth is 0."""
    rng = np.random.default_rng(3)
    gt = ((rng.uniform(size=(B, 8 * H, 8 * W, 2)) > 0.5) * 2.0).astype(
        np.float32)
    return (np.zeros((GB, H, W, 2), np.float32),
            np.zeros((GB, H, W, 576), np.float32), gt,
            np.ones((B, 8 * H, 8 * W), np.float32))


def _jax_sums(flow, mask, gt, vm):
    gt128 = jups.space_to_depth_flow(jnp.asarray(gt))
    vm64 = jups.space_to_depth_flow(jnp.asarray(vm)[..., None])
    return pallas_upsample_loss_sums(flow, mask, gt128, vm64,
                                     interpret=True)


@pytest.fixture(scope="module")
def jax_ref():
    """One interpreted-kernel forward and backward per case (each costs
    seconds on the CPU)."""
    out = {}
    cases = {"random": _inputs(1), "zero": _zero_residual_inputs(),
             "bf16": _inputs(2)}
    for name, (flow, mask, gt, vm) in cases.items():
        dt = jnp.bfloat16 if name == "bf16" else jnp.float32
        args = (jnp.asarray(flow), jnp.asarray(mask, dt))
        sums, vjp = jax.vjp(lambda f, m: _jax_sums(f, m, gt, vm), *args)
        ct = jnp.zeros_like(sums).at[:, 0].set(
            jnp.repeat(jnp.asarray(WEIGHTS), B))
        out[name] = (np.asarray(sums), [np.asarray(d.astype(jnp.float32))
                                        for d in vjp(ct)])
    return out


def _port(flow, mask, gt, vm, dtype=torch.float32):
    f = torch.from_numpy(flow).requires_grad_(True)
    m = torch.from_numpy(np.ascontiguousarray(mask.transpose(0, 3, 1, 2))
                         ).to(dtype).requires_grad_(True)
    sums = upsample_loss_sums(f, m, torch.from_numpy(gt),
                              torch.from_numpy(vm))
    w = torch.from_numpy(np.repeat(WEIGHTS, B))
    torch.sum(sums[:, 0] * w).backward()
    return (sums.detach().numpy(), f.grad.numpy(),
            m.grad.float().permute(0, 2, 3, 1).numpy(), m.grad.dtype)


def _flat_f64(flow, mask):
    """The flat convex upsampling in float64 numpy, ``(c, p, q)`` order."""
    m = mask.astype(np.float64)
    taps = [m[..., k * 64:(k + 1) * 64] for k in range(9)]
    e = [np.exp(t - np.max(taps, axis=0)) for t in taps]
    f8 = np.pad(8.0 * flow.astype(np.float64), ((0, 0), (1, 1), (1, 1),
                                                (0, 0)))
    out = [sum(e[k] * f8[:, k // 3:k // 3 + H, k % 3:k % 3 + W, c:c + 1]
               for k in range(9)) / sum(e) for c in (0, 1)]
    return np.concatenate(out, -1)


def test_flat_ops_match_jax():
    """fp32: each framework is first held to a float64 oracle of the same
    formula (the clean margin is ~6x inside the bound), so a failure names
    the framework that strayed: once, in a worker shared with the JAX
    package's other test files, the fp32 comparison failed by up to
    1.3e-3 (ROADMAP queue C) and could not be reproduced."""
    flow, mask, gt, _ = _inputs(0)
    ref = _flat_f64(flow, mask)
    for dt, jdt, tol in ((torch.float32, jnp.float32, 1e-5),
                         (torch.bfloat16, jnp.bfloat16, 2e-2)):
        want = np.asarray(jups.convex_upsample_flat(
            jnp.asarray(flow), jnp.asarray(mask), compute_dtype=jdt
        ).astype(jnp.float32))
        got = tups.convex_upsample_flat(torch.from_numpy(flow),
                                        torch.from_numpy(mask), dt)
        assert got.dtype == dt and got.shape == (GB, H, W, 128)
        if dt == torch.float32:
            np.testing.assert_allclose(want, ref, rtol=tol, atol=tol,
                                       err_msg="JAX vs float64")
            np.testing.assert_allclose(got.numpy(), ref, rtol=tol,
                                       atol=tol, err_msg="port vs float64")
        np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                                   atol=tol)
    up = tups.convex_upsample(torch.from_numpy(flow), torch.from_numpy(mask))
    flat = tups.convex_upsample_flat(torch.from_numpy(flow),
                                     torch.from_numpy(mask))
    np.testing.assert_allclose(tups.depth_to_space_flow(flat).numpy(),
                               up.numpy(), rtol=1e-5, atol=1e-5)
    s2d = tups.space_to_depth_flow(torch.from_numpy(gt))
    np.testing.assert_array_equal(
        s2d.numpy(), np.asarray(jups.space_to_depth_flow(jnp.asarray(gt))))
    np.testing.assert_array_equal(tups.depth_to_space_flow(s2d).numpy(), gt)


def test_fwd_matches_pallas_kernel_and_xla():
    flow, mask, gt, vm = _inputs(0)
    want = np.asarray(_jax_sums(jnp.asarray(flow), jnp.asarray(mask), gt,
                                vm))
    got, _, _, _ = _port(flow, mask, gt, vm)
    assert got.shape == (GB, 5)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)
    # the XLA chain of the model, summed over the batch per iteration
    gt128 = jups.space_to_depth_flow(jnp.asarray(gt))
    vm64 = jups.space_to_depth_flow(jnp.asarray(vm)[..., None])
    out = jups.convex_upsample_flat(jnp.asarray(flow), jnp.asarray(mask))
    out = out.reshape((G, B) + out.shape[1:])
    dx = out[..., :64] - gt128[None, ..., :64]
    dy = out[..., 64:] - gt128[None, ..., 64:]
    l1 = jnp.sum(vm64[None] * (jnp.abs(dx) + jnp.abs(dy)), axis=(1, 2, 3, 4))
    np.testing.assert_allclose(got[:, 0].reshape(G, B).sum(1),
                               np.asarray(l1), rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("case", ["random", "zero"])
def test_grads_match_pallas_kernel(jax_ref, case):
    """``zero``: the |.| subgradient is +1 at exactly-zero residuals
    (jnp.abs's VJP convention), not sign(0) = 0."""
    inputs = _inputs(1) if case == "random" else _zero_residual_inputs()
    sums, dflow, dmask, _ = _port(*inputs)
    want_sums, (want_dflow, want_dmask) = jax_ref[case]
    np.testing.assert_allclose(sums, want_sums, rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(dflow, want_dflow, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(dmask, want_dmask, rtol=1e-4, atol=1e-5)
    if case == "zero":
        assert np.abs(dflow).max() > 0


def test_bf16_mask_keeps_fp32_math(jax_ref):
    """A bf16 mask (the mask head's output under bf16 compute): the sums
    are computed in fp32 on its values, the mask gradient comes back in
    bf16."""
    flow, mask, gt, vm = _inputs(2)
    mask16 = np.asarray(jnp.asarray(mask, jnp.bfloat16).astype(jnp.float32))
    sums, dflow, dmask, dtype = _port(flow, mask16, gt, vm, torch.bfloat16)
    want_sums, (want_dflow, want_dmask) = jax_ref["bf16"]
    assert dtype == torch.bfloat16
    np.testing.assert_allclose(sums, want_sums, rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(dflow, want_dflow, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(dmask, want_dmask, rtol=2 ** -7, atol=1e-7)


def test_cpu_wrapper_is_the_plain_version():
    flow, mask, gt, vm = (torch.from_numpy(a) for a in _inputs(4))
    mask = mask.permute(0, 3, 1, 2).contiguous()
    before = dict(upsample_loss.LAUNCHES)
    got = upsample_loss_sums(flow, mask, gt, vm)
    assert torch.equal(got, upsample_loss_sums_plain(flow, mask, gt, vm))
    assert upsample_loss.LAUNCHES == before


# The backward kernel's access width for the dmask stores at a channel
# plane's edges, per grid: (H, W), fp32 bytes, bf16 bytes, for masks that
# start an allocation (the chairs, Sintel, things and KITTI training
# grids, an odd grid, and one with H*W = 2 mod 4).
@pytest.mark.parametrize("hw,fp32,bf16", [
    ((46, 62), 16, 8), ((55, 128), 16, 16), ((50, 90), 16, 8),
    ((47, 156), 16, 8), ((45, 63), 4, 2), ((5, 6), 8, 4)])
def test_bwd_access_width_per_grid(hw, fp32, bf16):
    hw = hw[0] * hw[1]
    base = 512 * 4099                       # an allocation's start
    width = upsample_loss.bwd_vector_bytes
    assert width(base, base, hw, 4) == fp32
    assert width(base, base, hw, 2) == bf16
    for vb, es in ((fp32, 4), (bf16, 2)):
        # every channel plane of every sample starts on a VB boundary
        assert all((base + c * hw * es) % vb == 0 for c in range(2 * 576))
    # a mask view one value into its allocation, or a dmask off 8 bytes
    assert width(base + 4, base, hw, 4) == 4
    assert width(base + 2, base, hw, 2) == 2
    assert width(base, base + 8, hw, 4) == min(fp32, 8)
    with pytest.raises(ValueError, match="aligned"):
        width(base + 1, base, hw, 2)


# The forward kernel's plan per grid: (H, W), then for an fp32 and a bf16
# mask that starts an allocation (bytes per load, pixels a lane, tiles of
# 32 lanes a sample): the chairs, Sintel, things and KITTI training grids,
# an odd grid, and one with H*W = 2 mod 4.
@pytest.mark.parametrize("hw,fp32,bf16", [
    ((46, 62), (16, 4, 23), (8, 4, 23)),
    ((55, 128), (16, 4, 55), (16, 8, 28)),
    ((50, 90), (16, 4, 36), (8, 4, 36)),
    ((47, 156), (16, 4, 58), (8, 4, 58)),
    ((45, 63), (4, 4, 23), (2, 4, 23)),
    ((5, 6), (8, 4, 1), (4, 4, 1))])
def test_fwd_plan_per_grid(hw, fp32, bf16):
    hw = hw[0] * hw[1]
    base = 512 * 4099                       # an allocation's start
    for es, (vb, pixels, tiles) in ((4, fp32), (2, bf16)):
        plan = upsample_loss.fwd_plan(base, hw, es)
        assert (plan.vec_bytes, plan.pixels, plan.offset, plan.tiles) == (
            vb, pixels, 0, tiles)
        # 5 sums for each tile and each of the 16 stages of 4 planes
        assert plan.partial == tiles * 16 * 5
        # the tiles cover the sample; a lane's loads are whole pieces
        assert tiles * 32 * pixels >= hw > (tiles - 1) * 32 * pixels
        assert pixels * es % vb == 0 and (hw * es) % vb == 0
    # a mask one value into its allocation: narrower loads, and its first
    # group starts a value before the sample so that every load is aligned
    for es, narrow in ((4, 4), (2, 2)):
        plan = upsample_loss.fwd_plan(base + es, hw, es)
        assert (plan.vec_bytes, plan.pixels, plan.offset) == (narrow, 4, 1)
        assert (base + es - plan.offset * es) % (4 * es) == 0
        assert plan.tiles == math.ceil(math.ceil((hw + 1) / 4) / 32)
    with pytest.raises(ValueError, match="aligned"):
        upsample_loss.fwd_plan(base + 1, hw, 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offset", [0, 1, 3, 7])
def test_bwd_buffers_keep_the_kernels_alignment(dtype, offset):
    """dmask is allocated at the mask's address mod 16 (so the kernel can
    stage a row of both at one offset), and a ground truth off 16 bytes
    is copied to an aligned one; values and shapes are kept."""
    buf = torch.arange(2 * 576 * 5 * 9 + offset, dtype=torch.float32)
    mask = buf.to(dtype)[offset:].view(2, 576, 5, 9)
    dmask = upsample_loss.empty_like_mod16(mask)
    assert dmask.shape == mask.shape and dmask.dtype == dtype
    assert dmask.is_contiguous()
    assert (dmask.data_ptr() - mask.data_ptr()) % 16 == 0
    gt = buf[offset:offset + 2 * 40 * 72 * 2].view(2, 40, 72, 2)
    g16 = upsample_loss.aligned16(gt)
    assert g16.data_ptr() % 16 == 0 and torch.equal(g16, gt)
    assert (g16 is gt) == (gt.data_ptr() % 16 == 0)
