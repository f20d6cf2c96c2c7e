"""The port's GRU gate functions against the JAX package's Pallas gate
kernels (``raft_tpu/ops/pallas_gru.py``, run in interpret mode), forward
and backward.

On the CPU the port's wrappers run their plain versions, forward and
backward; the CUDA kernels are held against the
same plain versions, and the backward kernels against
``gru_gate_*_bwd_plain``, on the card by ``chip_smoke.py`` and
``tests/test_torch_cuda.py``.  Gradient tolerances: fp32 rtol 1e-5 /
atol 1e-6 (the same fp32 formulas, sigmoid and tanh from two libraries);
bf16 one bf16 ulp (fp32 math rounded once in both) plus that fp32 atol,
since ``1 - tanh(q)^2`` cancels where |q| is large and two tanh
implementations differ there by an fp32 ulp (JAX gives 0 where torch
gives 1e-8).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.ops.pallas_gru import (gru_gate_blend as jax_blend,
                                     gru_gate_rh as jax_rh)
from raft_tpu_torch.ops import gru_gates
from raft_tpu_torch.ops.gru_gates import (gru_gate_blend,
                                          gru_gate_blend_bwd_plain,
                                          gru_gate_blend_plain, gru_gate_rh,
                                          gru_gate_rh_bwd_plain,
                                          gru_gate_rh_plain)

SHAPE = (2, 16, 6, 10)   # (B, hidden, H, W), NCHW as the model calls them


def _operands(seed, dtype):
    """z/r as the two channel halves of one conv output (views that are
    not contiguous across the batch), plus q and h."""
    rng = np.random.default_rng(seed)
    B, C, H, W = SHAPE
    zr = torch.from_numpy(
        rng.standard_normal((B, 2 * C, H, W)).astype(np.float32) * 3)
    q = torch.from_numpy(
        rng.standard_normal(SHAPE).astype(np.float32) * 3)
    h = torch.from_numpy(rng.standard_normal(SHAPE).astype(np.float32))
    z, r = torch.split(zr.to(dtype), C, dim=1)
    return z, r, q.to(dtype), h.to(dtype)


def _np(t):
    return t.float().numpy()


def _jax(t, dtype):
    return jnp.asarray(_np(t), dtype)


def _bf16_ulp(x):
    """bf16 spacing at |x| (8 significant bits)."""
    mag = np.maximum(np.abs(x), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(mag)) - 7).astype(np.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gates_match_jax_kernels(dtype):
    z, r, q, h = _operands(0, dtype)
    assert not z.is_contiguous() and not r.is_contiguous()
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    got_rh = gru_gate_rh(r, h)
    got_bl = gru_gate_blend(z, q, h)
    assert got_rh.dtype == dtype and got_bl.dtype == dtype
    want_rh = np.asarray(jax_rh(_jax(r, jdt), _jax(h, jdt), interpret=True),
                         np.float32)
    want_bl = np.asarray(jax_blend(_jax(z, jdt), _jax(q, jdt), _jax(h, jdt),
                                   interpret=True), np.float32)
    for got, want in ((got_rh, want_rh), (got_bl, want_bl)):
        if dtype == torch.float32:
            np.testing.assert_allclose(_np(got), want, rtol=0, atol=1e-6)
        else:
            # fp32 math rounded once to bf16 in both: at most one bf16 ulp
            # apart (the fp32 sigmoid/tanh may differ in the last bits)
            assert np.all(np.abs(_np(got) - want) <= _bf16_ulp(want))


def test_cpu_wrappers_take_the_plain_versions():
    z, r, q, h = _operands(1, torch.float32)
    before = dict(gru_gates.LAUNCHES)
    assert torch.equal(gru_gate_rh(r, h), gru_gate_rh_plain(r, h))
    assert torch.equal(gru_gate_blend(z, q, h),
                       gru_gate_blend_plain(z, q, h))
    assert gru_gates.LAUNCHES == before
    # the plain blend is the unfused GRU tail
    sz = torch.sigmoid(z)
    torch.testing.assert_close(gru_gate_blend_plain(z, q, h),
                               (1 - sz) * h + sz * torch.tanh(q),
                               rtol=0, atol=1e-6)


def _assert_close(got, want, dtype):
    got = _np(got)
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    else:
        assert np.all(np.abs(got - want) <= _bf16_ulp(want) + 1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gate_gradients_match_jax_kernels(dtype):
    """Twin of tests/test_pallas_fused.py's gate gradient test: z/r are
    the channel halves of one conv output, and rh's output gradient is a
    channel slice of a wider one (the gradient of ``cat([rh, x])``), as
    in the model."""
    z, r, q, h = _operands(2, dtype)
    rng = np.random.default_rng(3)
    B, C, H, W = SHAPE
    g_cat = torch.from_numpy(rng.standard_normal(
        (B, 2 * C, H, W)).astype(np.float32)).to(dtype)
    g_rh = g_cat[:, :C]
    g_bl = torch.from_numpy(rng.standard_normal(SHAPE).astype(
        np.float32)).to(dtype)
    assert not g_rh.is_contiguous()
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16

    # JAX: the Pallas custom_vjp backward kernels
    _, vjp_rh = jax.vjp(lambda a, b: jax_rh(a, b, interpret=True),
                        _jax(r, jdt), _jax(h, jdt))
    want_rh = [np.asarray(x, np.float32) for x in vjp_rh(_jax(g_rh, jdt))]
    _, vjp_bl = jax.vjp(lambda a, b, c: jax_blend(a, b, c, interpret=True),
                        _jax(z, jdt), _jax(q, jdt), _jax(h, jdt))
    want_bl = [np.asarray(x, np.float32) for x in vjp_bl(_jax(g_bl, jdt))]

    # the port: autograd through the wrappers (z/r split from one leaf)
    zr = torch.cat([z, r], dim=1).detach().requires_grad_(True)
    q_, h_ = (t.detach().requires_grad_(True) for t in (q, h))
    zs, rs = torch.split(zr, C, dim=1)
    dzr_rh, dh_rh = torch.autograd.grad(gru_gate_rh(rs, h_), (zr, h_), g_rh)
    got_rh = [dzr_rh[:, C:], dh_rh]
    assert torch.all(dzr_rh[:, :C] == 0)
    got_bl = list(torch.autograd.grad(gru_gate_blend(zs, q_, h_),
                                      (zr, q_, h_), g_bl))
    assert torch.all(got_bl[0][:, C:] == 0)
    got_bl[0] = got_bl[0][:, :C]
    plain_rh = gru_gate_rh_bwd_plain(r, h, g_rh)
    plain_bl = gru_gate_blend_bwd_plain(z, q, h, g_bl)
    for got, plain, want in zip(got_rh + got_bl, plain_rh + plain_bl,
                                want_rh + want_bl):
        assert got.dtype == plain.dtype == dtype
        assert np.isfinite(want).all() and np.abs(want).max() > 0
        _assert_close(got, want, dtype)
        _assert_close(plain, want, dtype)


def test_plain_backward_is_autograd_of_plain_forward():
    """``gru_gate_*_bwd_plain`` (what the backward kernels are held
    against on the card) against autograd of the plain forwards, fp32."""
    z, r, q, h = _operands(4, torch.float32)
    g = torch.from_numpy(np.random.default_rng(5).standard_normal(
        SHAPE).astype(np.float32))
    leaves = [t.detach().requires_grad_(True) for t in (z, r, q, h)]
    zl, rl, ql, hl = leaves
    want_rh = torch.autograd.grad(gru_gate_rh_plain(rl, hl), (rl, hl), g)
    want_bl = torch.autograd.grad(gru_gate_blend_plain(zl, ql, hl),
                                  (zl, ql, hl), g)
    got = gru_gate_rh_bwd_plain(r, h, g) + gru_gate_blend_bwd_plain(z, q, h,
                                                                    g)
    for a, b in zip(got, want_rh + want_bl):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def _rh_bwd_plan(B, C, H, W, dtype, r_channel=None, sm_count=132):
    """``rh_bwd_plan`` for the operands as the model passes them: r the
    second channel half of a (B, 2C, H, W) convzr output, h contiguous,
    g the first C channels of a (B, 3C, H, W) gradient, fresh outputs;
    ``r_channel`` moves r to start at that channel of a (B, 2C + 1, H,
    W) tensor instead."""
    zr = torch.empty(B, 2 * C + (r_channel is not None), H, W, dtype=dtype)
    start = C if r_channel is None else r_channel
    r = zr[:, start:start + C]
    ins = [gru_gates._batch_strided(t) for t in (
        r, torch.empty(B, C, H, W, dtype=dtype),
        torch.empty(B, 3 * C, H, W, dtype=dtype)[:, :C])]
    outs = [torch.empty(B, C, H, W, dtype=dtype) for _ in range(2)]
    assert all(t.data_ptr() % 16 == 0 for t in outs)
    return gru_gates.rh_bwd_plan(
        [t.data_ptr() for t, _ in ins] + [o.data_ptr() for o in outs],
        [s for _, s in ins], C * H * W, B, zr.element_size(), sm_count)


# (B, C, H, W) -> (values per access, grid) on a 132-SM H100 in fp32 and
# bf16: the chairs, Sintel, things and KITTI training grids with the
# model's 128-channel halves take 16-byte vectors at any H*W, and so does
# an odd grid; 3 channels on the odd grid take one value per access, and
# so does r starting one channel off where a channel plane is not a
# multiple of 16 bytes (bf16 at chairs, both types on the odd grid).  The
# grid is 528 blocks (one wave of 4 per SM) or one block per unit of
# 2 x 256 accesses.
@pytest.mark.parametrize("shape,r_channel,fp32,bf16", [
    ((8, 128, 46, 62), None, (4, 528), (8, 528)),
    ((1, 128, 55, 128), None, (4, 440), (8, 220)),
    ((5, 128, 50, 90), None, (4, 528), (8, 528)),
    ((1, 128, 47, 156), None, (4, 459), (8, 230)),
    ((2, 128, 45, 63), None, (4, 356), (8, 178)),
    ((2, 3, 45, 63), None, (1, 34), (1, 34)),
    ((8, 128, 46, 62), 129, (4, 528), (1, 528)),
    ((2, 128, 45, 63), 129, (1, 528), (1, 528)),
])
def test_rh_bwd_plan_per_shape(shape, r_channel, fp32, bf16):
    assert _rh_bwd_plan(*shape, torch.float32, r_channel) == fp32
    assert _rh_bwd_plan(*shape, torch.bfloat16, r_channel) == bf16
    # fewer SMs: the grid stays one wave of 4 blocks per SM
    vec, grid = _rh_bwd_plan(*shape, torch.bfloat16, r_channel, sm_count=2)
    assert (vec, grid) == (bf16[0], min(bf16[1], 8))
