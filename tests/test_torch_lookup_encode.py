"""The fused pyramid lookup + ``convc1`` (+ bias + relu) of the port (the
plain version of its CUDA kernel, inside its autograd ``Function``)
against the JAX package, on the CPU: twins of
``tests/test_pallas_fused.py:56-148,214-241``.

Size: batch 2, a 12x16 feature grid, C = 32, 3 levels, radius 3, F = 24.
Both sides sample identical stored values: the port's levels are JAX's
levels transposed to query-major (fp8 codes through ``np.uint8`` views).
JAX's TPU kernel ``pallas_pyramid_lookup_encode`` runs in interpret mode
in three cases only, each once in a module fixture (~9 s a forward, ~21 s
a gradient): forward on fp32 and on int8 levels, gradient on fp32 levels.
Every other case is held against JAX's XLA reference of the same
function, ``relu(einsum(corr_lookup(pyramid), w) + b)`` and its
``jax.vjp`` (``tests/test_pallas_fused.py`` holds that composition equal
to the kernel).

Tolerances: fp32 results 1e-5 (forward) and 1e-4 (gradients): fp32 sums
in other orders, and for a quantized pyramid the scale folded into the
weights against multiplied into the taps.  A bf16 result within one bf16
ulp of the fp32 reference plus that fp32 bound.

Non-finite centers, on a 6x10 grid whose fourth level pools to nothing
(the TPU kernel in interpret mode, once more): a NaN center gives NaN in
all F outputs of its query (the relu keeps NaN); its relu mask is then
0, so ``dW`` is NaN on the rows of the three non-empty levels only (the
empty level's taps are 0, not NaN), ``db`` is finite and the pyramid
gradient is NaN on the query's rows.  ``assert_allclose`` holds NaN to
NaN position for position.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.ops import corr as jcorr
from raft_tpu.ops.pallas_corr import pallas_pyramid_lookup_encode
from raft_tpu.ops.sampler import coords_grid
from raft_tpu_torch.config import RAFTConfig
from raft_tpu_torch.convert import flax_from_state_dict, state_dict_from_flax
from raft_tpu_torch.models.raft import RAFT
from raft_tpu_torch.ops import lookup_encode, pyramid_kernels
from raft_tpu_torch.ops import corr as tcorr
from raft_tpu_torch.ops.lookup_encode import (pyramid_lookup_encode,
                                              pyramid_lookup_encode_plain)

from test_torch_quantized import to_torch

B, H, W, C, LEVELS, R, F = 2, 12, 16, 32, 3, 3, 24
N = H * W
KK = LEVELS * (2 * R + 1) ** 2
FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)


def _setup(seed):
    rng = np.random.default_rng(seed)
    f1 = rng.standard_normal((B, H, W, C)).astype(np.float32)
    f2 = rng.standard_normal((B, H, W, C)).astype(np.float32)
    coords = (np.asarray(coords_grid(B, H, W)) + rng.uniform(
        -2, 2, (B, H, W, 2))).astype(np.float32)
    coords[1, 0, 0] = (-1e6, 3.5)                   # far off the image
    w = (rng.standard_normal((KK, F)) * KK ** -0.5).astype(np.float32)
    b = (rng.standard_normal((F,)) * 0.1).astype(np.float32)
    return f1, f2, coords, w, b


def _jax_pyramid(f1, f2, dtype, flat=False):
    if flat:
        return jcorr.build_corr_pyramid_flat(jnp.asarray(f1),
                                             jnp.asarray(f2), LEVELS,
                                             pad_q=128, out_dtype=dtype)
    return jcorr.build_corr_pyramid(jnp.asarray(f1), jnp.asarray(f2), LEVELS,
                                    out_dtype=dtype)


def _torch_pyramid(jpyr, flat=False):
    """The port's query-major levels holding JAX's stored values."""
    def major(a):
        t = to_torch(a)
        return t.permute(0, 3, 1, 2)[:, :N].contiguous() if flat else t
    return [tcorr.QuantizedLevel(major(lv.values), to_torch(lv.scale))
            if isinstance(lv, jcorr.QuantizedLevel) else major(lv)
            for lv in jpyr]


def _torch_weights(w, b):
    """convc1's parameters: ``(F, KK, 1, 1)`` from JAX's ``(KK, F)``."""
    return (torch.from_numpy(np.ascontiguousarray(w.T)).reshape(F, KK, 1, 1),
            torch.from_numpy(b))


def _nhwc(out: torch.Tensor) -> np.ndarray:
    return out.detach().float().permute(0, 2, 3, 1).numpy()


def _jax_reference(jpyr, coords, w, b):
    taps = jcorr.corr_lookup(jpyr, jnp.asarray(coords), R)
    return jax.nn.relu(jnp.einsum("bhwk,kf->bhwf", taps, w) + b)


@pytest.fixture(scope="module")
def jax_kernel():
    """JAX's fused TPU kernel in interpret mode: the forward on fp32 and
    int8 levels, and ``d(sum(sin(out)))`` by (w, b, pyramid) on fp32
    levels."""
    f1, f2, coords, w, b = _setup(0)
    out = {}
    for dtype in ("float32", "int8"):
        pyr = _jax_pyramid(f1, f2, dtype, flat=True)
        out[dtype] = (pyr, np.asarray(pallas_pyramid_lookup_encode(
            pyr, jnp.asarray(coords), jnp.asarray(w), jnp.asarray(b), R,
            128, True)))
    pyr = out["float32"][0]
    out["grads"] = jax.grad(
        lambda w_, b_, p_: jnp.sum(jnp.sin(pallas_pyramid_lookup_encode(
            p_, jnp.asarray(coords), w_, b_, R, 128, True))),
        argnums=(0, 1, 2))(jnp.asarray(w), jnp.asarray(b), pyr)
    return out


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_forward_matches_jax_kernel(jax_kernel, dtype):
    _, _, coords, w, b = _setup(0)
    jpyr, want = jax_kernel[dtype]
    tw, tb = _torch_weights(w, b)
    got = pyramid_lookup_encode(_torch_pyramid(jpyr, flat=True),
                                torch.from_numpy(coords), R, tw, tb)
    assert got.shape == (B, F, H, W) and got.dtype == torch.float32
    assert got.is_contiguous()
    np.testing.assert_allclose(_nhwc(got), want, **FWD_TOL)
    assert float(got.max()) > 0 and float(got.min()) == 0.0      # relu


def _bf16_close(got: torch.Tensor, want: np.ndarray, tol: float) -> bool:
    """Within one bf16 ulp of the fp32 reference plus the fp32 bound."""
    want = torch.from_numpy(np.array(want, np.float32))
    diff = (got.float() - want).abs()
    ulp = torch.exp2(torch.floor(torch.log2(
        want.abs().clamp_min(2.0 ** -126))) - 7)
    return bool((diff <= ulp + tol).all())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8",
                                   "float8_e4m3fn", "float8_e5m2"])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_forward_matches_jax_reference(dtype, out_dtype):
    f1, f2, coords, w, b = _setup(1)
    jpyr = _jax_pyramid(f1, f2, dtype)
    want = np.asarray(_jax_reference(jpyr, coords, jnp.asarray(w),
                                     jnp.asarray(b)))
    tw, tb = _torch_weights(w, b)
    got = pyramid_lookup_encode(_torch_pyramid(jpyr),
                                torch.from_numpy(coords), R, tw, tb,
                                out_dtype)
    assert got.dtype == out_dtype and got.shape == (B, F, H, W)
    if out_dtype == torch.float32:
        np.testing.assert_allclose(_nhwc(got), want, **FWD_TOL)
    else:
        assert _bf16_close(got.permute(0, 2, 3, 1), want,
                           1e-5 * float(np.abs(want).max()) + 1e-5)


def test_grads_match_jax_kernel(jax_kernel):
    """dW, db and the fp32 pyramid gradient of ``sum(sin(out))``: the
    port's recomputing backward against the TPU kernel's custom VJP."""
    _, _, coords, w, b = _setup(0)
    jpyr, _ = jax_kernel["float32"]
    gw, gb, gpyr = jax_kernel["grads"]
    tw, tb = (t.requires_grad_(True) for t in _torch_weights(w, b))
    tpyr = [lv.requires_grad_(True) for lv in _torch_pyramid(jpyr, True)]
    torch.sin(pyramid_lookup_encode(tpyr, torch.from_numpy(coords), R, tw,
                                    tb)).sum().backward()
    np.testing.assert_allclose(tw.grad.reshape(F, KK).numpy().T,
                               np.asarray(gw), **GRAD_TOL)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(gb), **GRAD_TOL)
    for lv, d in zip(tpyr, _torch_pyramid(gpyr, flat=True)):
        assert lv.grad.dtype == torch.float32
        np.testing.assert_allclose(lv.grad.numpy(), d.numpy(), **GRAD_TOL)


@pytest.mark.parametrize("dtype", ["bfloat16", "int8", "float8_e4m3fn"])
def test_grads_match_jax_reference(dtype):
    """The same gradients against ``jax.vjp`` of the XLA reference: a
    bf16 pyramid's gradient in bf16 (one bf16 ulp plus the fp32 bound);
    a quantized pyramid gets none, while dW and db are real."""
    f1, f2, coords, w, b = _setup(2)
    jpyr = _jax_pyramid(f1, f2, dtype)
    quantized = dtype != "bfloat16"
    if quantized:
        _, vjp = jax.vjp(lambda w_, b_: _jax_reference(jpyr, coords, w_, b_),
                         jnp.asarray(w), jnp.asarray(b))
    else:
        _, vjp = jax.vjp(lambda w_, b_, p_: _jax_reference(p_, coords, w_,
                                                           b_),
                         jnp.asarray(w), jnp.asarray(b), jpyr)
    rng = np.random.default_rng(3)
    g = rng.standard_normal((B, H, W, F)).astype(np.float32)
    want = vjp(jnp.asarray(g))
    tw, tb = (t.requires_grad_(True) for t in _torch_weights(w, b))
    tpyr = _torch_pyramid(jpyr)
    if not quantized:
        tpyr = [lv.requires_grad_(True) for lv in tpyr]
    out = pyramid_lookup_encode(tpyr, torch.from_numpy(coords), R, tw, tb)
    out.backward(torch.from_numpy(g).permute(0, 3, 1, 2))
    np.testing.assert_allclose(tw.grad.reshape(F, KK).numpy().T,
                               np.asarray(want[0]), **GRAD_TOL)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(want[1]),
                               **GRAD_TOL)
    assert float(tw.grad.abs().max()) > 0 and float(tb.grad.abs().max()) > 0
    if quantized:
        assert all(not lv.values.requires_grad for lv in tpyr)
        return
    for lv, d in zip(tpyr, want[2]):
        assert lv.grad.dtype == torch.bfloat16
        d32 = np.asarray(d, np.float32)
        assert _bf16_close(lv.grad, d32, 1e-4 * float(np.abs(d32).max())
                           + 1e-5)


def test_quantized_fused_path_gives_fnet_no_gradient():
    """Through a quantized pyramid the feature maps (fnet's output) and the
    coords get no gradient, while the conv weight and bias learn
    (test_pallas_fused.py:93)."""
    f1, f2, coords, w, b = _setup(4)
    tf1 = torch.from_numpy(f1).requires_grad_(True)
    tf2 = torch.from_numpy(f2).requires_grad_(True)
    tc = torch.from_numpy(coords).requires_grad_(True)
    tw, tb = (t.requires_grad_(True) for t in _torch_weights(w, b))
    pyr = tcorr.build_corr_pyramid(tf1, tf2, LEVELS, torch.int8)
    (pyramid_lookup_encode(pyr, tc, R, tw, tb) ** 2).sum().backward()
    assert tf1.grad is None and tf2.grad is None and tc.grad is None
    assert float(tw.grad.abs().max()) > 0 and float(tb.grad.abs().max()) > 0
    # the unfused composition on the same codes gives the same dW, db
    uw, ub = (t.detach().clone().requires_grad_(True) for t in (tw, tb))
    taps = tcorr.corr_lookup(pyr, tc.detach(), R).permute(0, 3, 1, 2)
    (torch.relu(torch.nn.functional.conv2d(taps, uw, ub)) ** 2
     ).sum().backward()
    np.testing.assert_allclose(tw.grad.numpy(), uw.grad.numpy(), **GRAD_TOL)
    np.testing.assert_allclose(tb.grad.numpy(), ub.grad.numpy(), **GRAD_TOL)


def test_plain_version_and_cpu_counters():
    f1, f2, coords, w, b = _setup(5)
    tw, tb = _torch_weights(w, b)
    pyr = tcorr.build_corr_pyramid(torch.from_numpy(f1),
                                   torch.from_numpy(f2), LEVELS,
                                   torch.float8_e4m3fn)
    tc = torch.from_numpy(coords)
    before = (dict(lookup_encode.LAUNCHES), dict(pyramid_kernels.LAUNCHES))
    got = pyramid_lookup_encode(pyr, tc, R, tw, tb, torch.bfloat16)
    assert torch.equal(got, pyramid_lookup_encode_plain(pyr, tc, R, tw, tb,
                                                        torch.bfloat16))
    assert (dict(lookup_encode.LAUNCHES),
            dict(pyramid_kernels.LAUNCHES)) == before
    assert lookup_encode.smem_bytes(4, 4) <= pyramid_kernels.SMEM_MAX


def test_fused_and_unfused_models_share_one_state_dict():
    """One state dict drives both models, and converts to the flax tree of
    the JAX package's fused model; their test-mode forwards agree
    (test_pallas_fused.py:214)."""
    base = RAFTConfig.full(corr_impl="allpairs_pallas", corr_dtype="int8")
    fused = base.replace(fused_lookup_encoder=True)
    mb, mf = RAFT(base, seed=3).eval(), RAFT(fused, seed=4).eval()
    sd = mb.state_dict()
    assert {k: v.shape for k, v in sd.items()} == {
        k: v.shape for k, v in mf.state_dict().items()}
    mf.load_state_dict(sd)
    back = state_dict_from_flax(flax_from_state_dict(sd))
    assert all(torch.equal(back[k], sd[k]) for k in sd)
    rng = np.random.default_rng(6)
    i1, i2 = (torch.from_numpy(rng.uniform(0, 255, (1, 48, 64, 3)).astype(
        np.float32)) for _ in range(2))
    with torch.no_grad():
        lo_b, up_b = mb(i1, i2, iters=2, test_mode=True)
        lo_f, up_f = mf(i1, i2, iters=2, test_mode=True)
    np.testing.assert_allclose(up_f.numpy(), up_b.numpy(), rtol=1e-4,
                               atol=1e-4)


def test_nan_center_matches_jax_kernel():
    """out, dW, db and dpyramid for a NaN center (and an infinite one) on
    a pyramid with an empty level, against ``jax.vjp`` of the TPU kernel
    from a random finite cotangent: 3 x 81 x F NaN entries of dW."""
    b_, h, w_, lv, r, f = 2, 6, 10, 4, 4, 16
    kk = lv * (2 * r + 1) ** 2
    rng = np.random.default_rng(8)
    f1, f2 = (rng.standard_normal((b_, h, w_, C)).astype(np.float32)
              for _ in range(2))
    coords = (np.asarray(coords_grid(b_, h, w_)) + rng.uniform(
        -2, 2, (b_, h, w_, 2))).astype(np.float32)
    coords[1, 1, 1] = (np.nan, 2.0)
    coords[0, 2, 3] = (np.inf, 1.0)
    w = (rng.standard_normal((kk, f)) * kk ** -0.5).astype(np.float32)
    b = (rng.standard_normal((f,)) * 0.1).astype(np.float32)
    g = rng.standard_normal((b_, h, w_, f)).astype(np.float32)
    jpyr = jcorr.build_corr_pyramid_flat(jnp.asarray(f1), jnp.asarray(f2),
                                         lv, pad_q=64)
    assert jpyr[-1].shape[1:3] == (0, 1)
    out, vjp = jax.vjp(lambda w_, b_, p_: pallas_pyramid_lookup_encode(
        p_, jnp.asarray(coords), w_, b_, r, 64, True), jnp.asarray(w),
        jnp.asarray(b), jpyr)
    gw, gb, gpyr = (np.asarray(x) if i < 2 else x
                    for i, x in enumerate(vjp(jnp.asarray(g))))
    want = np.asarray(out)

    tw = torch.from_numpy(np.ascontiguousarray(w.T)).reshape(
        f, kk, 1, 1).requires_grad_(True)
    tb = torch.from_numpy(b).requires_grad_(True)
    tpyr = [torch.from_numpy(np.array(x)).permute(0, 3, 1, 2)[:, :h * w_]
            .contiguous().requires_grad_(True) for x in jpyr]
    got = pyramid_lookup_encode(tpyr, torch.from_numpy(coords), r, tw, tb)
    np.testing.assert_allclose(_nhwc(got), want, **FWD_TOL)
    assert np.isnan(want).sum() == f and np.isnan(want[1, 1, 1]).all()
    got.backward(torch.from_numpy(g).permute(0, 3, 1, 2))
    np.testing.assert_allclose(tw.grad.reshape(f, kk).numpy().T, gw,
                               **GRAD_TOL)
    assert np.isnan(gw).sum() == 3 * 81 * f
    assert not np.isnan(gw[3 * 81:]).any()
    np.testing.assert_allclose(tb.grad.numpy(), gb, **GRAD_TOL)
    assert np.isfinite(gb).all()
    for t, d in zip(tpyr, gpyr):
        d = np.asarray(d).transpose(0, 3, 1, 2)[:, :h * w_]
        np.testing.assert_allclose(t.grad.numpy(), d, **GRAD_TOL)
        if d.size:
            assert np.isnan(d).sum() == d[0, 0].size
            assert np.isnan(d[1, w_ + 1]).all()
