"""Quantized pyramid storage of the port (int8 / fp8 codes + per-level
scales) and its lookup against the JAX package, on the CPU: twins of
``tests/test_corr.py:140-266`` and ``tests/test_pallas_corr.py:325-360``.

Size: batch 2, a 12x16 feature grid, C = 32, 3 levels, radius 3 (the
size of ``tests/test_pallas_fused.py``).  The two packages quantize the
same fp32 level to the same codes and scales, exactly.  Lookups of the
same codes agree within 1e-5 (fp32 sums in another order).  JAX's TPU
kernel ``pallas_pyramid_lookup_quantized`` runs once, in interpret mode,
on int8 (a module fixture: ~7 s); the other dtypes are held against JAX's
XLA ``corr_lookup`` on quantized levels.  JAX fp8 arrays cross to
torch as ``np.uint8`` views (``torch.from_numpy`` takes no ml_dtypes).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.ops import corr as jcorr
from raft_tpu.ops.pallas_corr import pallas_pyramid_lookup_quantized
from raft_tpu.ops.sampler import coords_grid
from raft_tpu_torch.config import RAFTConfig
from raft_tpu_torch.ops import corr as tcorr
from raft_tpu_torch.ops import pyramid_kernels
from raft_tpu_torch.ops.pyramid_kernels import (pyramid_lookup_plain,
                                                pyramid_lookup_quantized,
                                                pyramid_lookup_quantized_nchw)

B, H, W, C, LEVELS, R = 2, 12, 16, 32, 3, 3
N = H * W
QDTYPES = ("int8", "float8_e4m3fn", "float8_e5m2")
TOL = dict(rtol=1e-5, atol=1e-5)


def _setup(seed):
    rng = np.random.default_rng(seed)
    f1 = rng.standard_normal((B, H, W, C)).astype(np.float32)
    f2 = rng.standard_normal((B, H, W, C)).astype(np.float32)
    coords = np.asarray(coords_grid(B, H, W)) + rng.uniform(
        -2, 2, (B, H, W, 2)).astype(np.float32)
    coords[0, 0, 0] = (40.0, -30.0)                 # far off the image
    return f1, f2, coords.astype(np.float32)


def to_torch(a) -> torch.Tensor:
    """A JAX array as a torch tensor of the same dtype (fp8 and bf16 through
    same-width integer views)."""
    a = np.asarray(a)
    name = str(a.dtype)
    if name in ("float8_e4m3fn", "float8_e5m2"):
        return torch.from_numpy(a.view(np.uint8).copy()).view(
            getattr(torch, name))
    if name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(a.copy())


def to_torch_pyramid(jpyr):
    return [tcorr.QuantizedLevel(to_torch(lv.values), to_torch(lv.scale))
            if isinstance(lv, jcorr.QuantizedLevel) else to_torch(lv)
            for lv in jpyr]


def _codes(x: torch.Tensor) -> np.ndarray:
    return (x.numpy() if x.dtype == torch.int8
            else x.view(torch.uint8).numpy())


@pytest.fixture(scope="module")
def jax_int8_kernel():
    """JAX's TPU kernel on an int8 pyramid in interpret mode, and the
    query-major codes and scales of the flat pyramid it sampled."""
    f1, f2, coords = _setup(5)
    pyrf = jcorr.build_corr_pyramid_flat(jnp.asarray(f1), jnp.asarray(f2),
                                         LEVELS, pad_q=128, out_dtype="int8")
    taps = np.asarray(pallas_pyramid_lookup_quantized(
        pyrf, jnp.asarray(coords), R, 128, True))
    tpyr = [tcorr.QuantizedLevel(
        torch.from_numpy(np.asarray(lv.values).transpose(0, 3, 1, 2)[:, :N]
                         .copy()), to_torch(lv.scale)) for lv in pyrf]
    return taps, tpyr, coords


@pytest.mark.parametrize("name", QDTYPES)
def test_quantize_matches_jax_exactly(name):
    """Same fp32 levels in, same codes and scales out, bit for bit; an
    empty level gives zero codes and scale 1 in both."""
    f1, f2, _ = _setup(0)
    levels = jcorr.build_corr_pyramid(jnp.asarray(f1), jnp.asarray(f2),
                                      LEVELS + 2)
    assert levels[-1].size == 0
    jspec = jcorr.corr_quant_spec(name)
    tspec = tcorr.corr_quant_spec(name)
    assert tspec == tcorr.corr_quant_spec(getattr(torch, name))
    assert tspec[1] == jspec[1]
    for lv in levels:
        jq = jcorr.quantize_corr_level(lv, jspec)
        tq = tcorr.quantize_corr_level(to_torch(lv), tspec)
        assert tq.values.dtype == getattr(torch, name)
        assert tq.scale.shape == (B, 1, 1, 1) and tq.scale.dtype == \
            torch.float32
        np.testing.assert_array_equal(_codes(tq.values),
                                      _codes(to_torch(jq.values)))
        np.testing.assert_array_equal(tq.scale.numpy(), np.asarray(jq.scale))
    assert tcorr.corr_quant_spec("bfloat16") is None
    assert tcorr.corr_quant_spec(torch.float32) is None


def test_quantize_is_detached_and_pyramid_structure():
    f1, f2, _ = _setup(1)
    tf1 = torch.from_numpy(f1).requires_grad_(True)
    pyr = tcorr.build_corr_pyramid(tf1, torch.from_numpy(f2), LEVELS,
                                   torch.int8)
    ref = tcorr.build_corr_pyramid(tf1, torch.from_numpy(f2), LEVELS)
    for q, lv in zip(pyr, ref):
        assert isinstance(q, tcorr.QuantizedLevel)
        assert q.values.dtype == torch.int8 and not q.values.requires_grad
        assert not q.scale.requires_grad
        assert q.values.shape == lv.shape
        # dequantized within half a code step (test_corr.py:140)
        err = (tcorr.dequantize_level(q) - lv.detach()).abs()
        assert bool((err <= 0.5 * q.scale + 1e-6).all())
    named = tcorr.build_corr_pyramid(tf1, torch.from_numpy(f2), LEVELS,
                                     "int8")
    assert all(torch.equal(a.values, b.values) for a, b in zip(named, pyr))


@pytest.mark.parametrize("name", QDTYPES)
def test_plain_lookup_matches_jax_on_the_same_codes(name):
    f1, f2, coords = _setup(2)
    jpyr = jcorr.build_corr_pyramid(jnp.asarray(f1), jnp.asarray(f2),
                                    LEVELS, out_dtype=name)
    want = np.asarray(jcorr.corr_lookup(jpyr, jnp.asarray(coords), R))
    tpyr = to_torch_pyramid(jpyr)
    tc = torch.from_numpy(coords)
    got = tcorr.corr_lookup(tpyr, tc, R)
    assert got.dtype == torch.float32 and got.shape == (B, H, W,
                                                        LEVELS * 49)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert torch.all(got[0, 0, 0] == 0.0)
    # the port's own quantization gives the same codes, hence the same taps
    own = tcorr.build_corr_pyramid(torch.from_numpy(f1),
                                   torch.from_numpy(f2), LEVELS, name)
    np.testing.assert_allclose(tcorr.corr_lookup(own, tc, R).numpy(), want,
                               **TOL)


def test_plain_lookup_matches_jax_int8_kernel(jax_int8_kernel):
    """The wrapper's plain version against JAX's TPU kernel (interpret
    mode) on the same int8 codes."""
    want, tpyr, coords = jax_int8_kernel
    got = pyramid_lookup_quantized(tpyr, torch.from_numpy(coords), R)
    assert got.shape == want.shape == (B, H, W, LEVELS * 49)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_int8_lookup_within_scale_bound_of_fp32():
    """Each code is off by <= scale / 2 and the bilinear weights of a tap
    sum to <= 1: every tap is within half the largest scale of the fp32
    lookup (test_corr.py:154)."""
    f1, f2, coords = _setup(3)
    tf1, tf2, tc = (torch.from_numpy(a) for a in (f1, f2, coords))
    want = tcorr.corr_lookup(tcorr.build_corr_pyramid(tf1, tf2, LEVELS),
                             tc, R)
    pyr8 = tcorr.build_corr_pyramid(tf1, tf2, LEVELS, torch.int8)
    got = pyramid_lookup_quantized(pyr8, tc, R)
    max_scale = max(float(q.scale.max()) for q in pyr8)
    assert float((got - want).abs().max()) <= 0.5 * max_scale * 1.05


@pytest.mark.parametrize("name", ["float8_e4m3fn", "float8_e5m2"])
def test_fp8_lookup_within_its_step_of_fp32(name):
    """fp8 keeps 3 (e4m3) or 2 (e5m2) mantissa bits: taps stay within
    |corr|max / 8 (e4m3, test_corr.py:168) or / 4 (e5m2) of the fp32
    lookup."""
    f1, f2, coords = _setup(12)
    tf1, tf2, tc = (torch.from_numpy(a) for a in (f1, f2, coords))
    want = tcorr.corr_lookup(tcorr.build_corr_pyramid(tf1, tf2, LEVELS),
                             tc, R)
    pyr8 = tcorr.build_corr_pyramid(tf1, tf2, LEVELS, getattr(torch, name))
    got = pyramid_lookup_quantized(pyr8, tc, R)
    qmax = tcorr.corr_quant_spec(name)[1]
    amax = max(float(q.scale.max()) * qmax for q in pyr8)
    assert float((got - want).abs().max()) <= amax / (
        8.0 if name == "float8_e4m3fn" else 4.0)


def test_quantized_lookup_is_primal_only():
    """No gradient through the codes to the feature maps, none to the
    coords through the quantized wrapper (test_pallas_corr.py:347); the
    plain lookup still differentiates the coords, as JAX's does."""
    f1, f2, coords = _setup(6)
    tf1 = torch.from_numpy(f1).requires_grad_(True)
    tf2 = torch.from_numpy(f2).requires_grad_(True)
    tc = torch.from_numpy(coords).requires_grad_(True)
    pyr = tcorr.build_corr_pyramid(tf1, tf2, LEVELS, torch.int8)
    out = pyramid_lookup_quantized(pyr, tc, R)
    assert not out.requires_grad
    plain = tcorr.corr_lookup(pyr, tc, R)
    (plain ** 2).sum().backward()
    assert tf1.grad is None and tf2.grad is None
    assert torch.isfinite(tc.grad).all()


def test_cpu_wrappers_are_the_plain_version():
    f1, f2, coords = _setup(7)
    pyr = tcorr.build_corr_pyramid(torch.from_numpy(f1),
                                   torch.from_numpy(f2), LEVELS, torch.int8)
    tc = torch.from_numpy(coords)
    before = dict(pyramid_kernels.LAUNCHES)
    taps = pyramid_lookup_quantized(pyr, tc, R, torch.bfloat16)
    assert taps.dtype == torch.bfloat16
    assert torch.equal(taps, pyramid_lookup_plain(pyr, tc, R,
                                                  torch.bfloat16))
    nchw = pyramid_lookup_quantized_nchw(pyr, tc, R)
    assert nchw.is_contiguous() and torch.equal(
        nchw, tcorr.corr_lookup(pyr, tc, R).permute(0, 3, 1, 2))
    assert pyramid_kernels.LAUNCHES == before


def test_config_storage_rule_and_refusals():
    """``corr_torch_dtype`` is the code dtype; a quantized pyramid on an
    on-demand lookup and the fused encoder off ``allpairs_pallas`` raise
    when the config is built (JAX raises the first at init and warns and
    runs unfused for the second)."""
    for name in QDTYPES:
        cfg = RAFTConfig.full(corr_impl="allpairs_pallas", corr_dtype=name)
        assert cfg.corr_dtype_is_quantized
        assert cfg.corr_torch_dtype == getattr(torch, name)
        for impl in ("chunked", "pallas"):
            with pytest.raises(ValueError, match="materialized"):
                RAFTConfig(corr_dtype=name, corr_impl=impl)
    assert RAFTConfig(compute_dtype="bfloat16").corr_torch_dtype == \
        torch.bfloat16
    assert not RAFTConfig().corr_dtype_is_quantized
    for impl in ("allpairs", "chunked", "pallas"):
        with pytest.raises(ValueError, match="allpairs_pallas"):
            RAFTConfig(fused_lookup_encoder=True, corr_impl=impl)
    assert RAFTConfig(fused_lookup_encoder=True,
                      corr_impl="allpairs_pallas").fused_lookup_encoder


def test_inference_maps_the_fused_slice_to_allpairs():
    """The one inference override: ``allpairs_pallas`` maps to
    ``allpairs`` and the fused encoder goes with it, so a quantized pyramid
    is sampled by the plain ``corr_lookup``, as the JAX package does."""
    from raft_tpu_torch.evaluate import make_eval_fn, make_inference_model
    from raft_tpu_torch.models.raft import RAFT

    cfg = RAFTConfig.full(corr_impl="allpairs_pallas", corr_dtype="int8",
                          fused_lookup_encoder=True)
    model = make_inference_model(cfg, device="cpu")
    assert model.config == cfg.replace(corr_impl="allpairs",
                                       fused_lookup_encoder=False)
    img = np.random.default_rng(8).uniform(0, 255, (1, 32, 48, 3)).astype(
        np.float32)
    sd = RAFT(RAFTConfig.full()).state_dict()
    _, up = make_eval_fn(cfg, 2, device="cpu")(sd, img, img)
    _, up_u = make_eval_fn(RAFTConfig.full(corr_dtype="int8"), 2,
                           device="cpu")(sd, img, img)
    assert torch.equal(up, up_u) and torch.isfinite(up).all()
