"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: they skip without a CUDA device (the kernels have no
CPU or interpret mode).  This file imports only torch and the port, so on
a machine without JAX it runs without the repository's conftest:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from raft_tpu_torch import config
from raft_tpu_torch.config import RAFTConfig
from raft_tpu_torch.evaluate import make_eval_fn
from raft_tpu_torch.models.raft import RAFT
from raft_tpu_torch.ops import corr as corr_ops
from raft_tpu_torch.ops import (corr_kernels, gru_gates, lookup_encode,
                                pyramid_kernels, upsample_loss)
from raft_tpu_torch.ops.corr import pool_fmap_pyramid
from raft_tpu_torch.ops.upsample import (convex_upsample_flat_nchw,
                                         depth_to_space_flow)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the entry points set cuDNN TF32 from this for each call: off, so
    # that fp32 kernel and plain configurations compare at fp32
    config.CONV_TF32 = False
    return torch.device("cuda")


def _corr_case(seed, B, H, W, C, dev):
    g = torch.Generator().manual_seed(seed)
    f1 = torch.randn(B, H, W, C, generator=g)
    f2 = torch.randn(B, H, W, C, generator=g)
    ys, xs = torch.meshgrid(torch.arange(H), torch.arange(W), indexing="ij")
    coords = torch.stack([xs, ys], -1).float()[None].repeat(B, 1, 1, 1)
    coords += torch.rand(B, H, W, 2, generator=g) * torch.tensor(
        [9.0, 5.0]) - torch.tensor([3.0, 1.5])      # asymmetric x / y
    coords[0, 0, 0] = torch.tensor([1e6, -2.5])
    coords[-1, -1, -1] = torch.tensor([-7.25, float(H) - 0.5])
    return f1.to(dev), f2.to(dev), coords.to(dev)


def _centers(dist, B, H, W, seed, dev):
    """``corr_kernels.sample_centers`` on the card, plus +inf and -inf
    centers (zeros on both sides) when they are spread."""
    c = torch.from_numpy(corr_kernels.sample_centers(dist, B, H, W, seed))
    if dist in ("spread", "mixed"):
        c[0, H - 1, W - 1] = torch.tensor([float("inf"), 2.0])
        c[-1, 0, W - 1] = torch.tensor([3.0, float("-inf")])
    return c.to(dev)


def _check_paths(dist, counts):
    """The (tile, level) pairs of each kernel path: near-grid and smooth
    centers take the box path, spread ones meet the per-query path, mixed
    ones take both in one launch."""
    box, per_query = counts
    if dist == "near":
        assert box > 0 and per_query == 0
    elif dist == "spread":
        assert per_query > 0
    elif dist == "mixed":
        assert box > 0 and per_query > 0
    else:
        assert box > 0


# "offsets": the grid + asymmetric offsets, one far and one off-level
# center (_corr_case); the other distributions are
# corr_kernels.sample_centers'.  Grid sides that are not multiples of the
# kernels' 4 x 8 query tile give ragged tiles; 7 x 13 has an empty level;
# 46 x 62 (the chairs grid) runs boxes of several slabs in many blocks.
@pytest.mark.parametrize("radius,C,hw,dist", [
    (4, 256, (7, 13), "offsets"), (3, 128, (6, 8), "offsets"),
    (4, 32, (13, 5), "offsets"), (4, 256, (30, 44), "spread"),
    (4, 256, (30, 44), "smooth"), (4, 256, (30, 44), "near"),
    (4, 32, (27, 45), "mixed"), (4, 512, (13, 21), "near"),
    (4, 256, (7, 13), "near"), (4, 256, (46, 62), "smooth")])
def test_corr_kernel_matches_plain(dev, radius, C, hw, dist):
    """The forward kernel against its plain version (``chunked_corr_lookup``
    with an empty level's taps zero, what the wrapper runs on the CPU),
    NaN centers included: NaN taps on the non-empty levels."""
    f1, f2, coords = _corr_case(radius + C, 2, *hw, C, dev)
    if dist != "offsets":
        coords = _centers(dist, 2, *hw, radius + C, dev)
    coords[1, 1, 1] = float("nan")
    coords[0, 1, 2, 0] = float("nan")
    pyr = pool_fmap_pyramid(f2, 4)
    with torch.no_grad():
        got = corr_kernels.corr_lookup_ondemand(f1, pyr, coords, radius)
        nchw = corr_kernels.corr_lookup_ondemand_nchw(f1, pyr, coords,
                                                      radius)
        want = corr_kernels._plain(f1, pyr, coords, radius)
    torch.cuda.synchronize()
    _close(got, want)
    assert torch.equal(nchw.isnan(), got.permute(0, 3, 1, 2).isnan())
    assert torch.equal(nchw.nan_to_num(), got.permute(0, 3, 1, 2)
                       .nan_to_num())
    kk = (2 * radius + 1) ** 2
    nonempty = sum(1 for p in pyr if p.shape[1] * p.shape[2]) * kk
    assert torch.isnan(got[1, 1, 1, :nonempty]).all()
    assert torch.isnan(got[0, 1, 2, :nonempty]).all()
    assert int(torch.isnan(got).sum()) == 2 * nonempty
    if hw == (7, 13):
        assert not got[..., 3 * kk:].any()
    if dist != "offsets":
        _check_paths(dist, corr_kernels.kernel_path_counts(
            f1, pyr, coords, radius)["fwd"])


@pytest.mark.parametrize("nchw,hw,spread,dist,C", [
    (False, (7, 13), 0.0, "offsets", 64), (True, (7, 13), 0.0, "offsets", 64),
    (True, (24, 40), 20.0, "offsets", 64), (False, (30, 44), 0.0, "spread", 256),
    (True, (30, 44), 0.0, "smooth", 256), (False, (30, 44), 0.0, "near", 32),
    (True, (27, 45), 0.0, "mixed", 256), (False, (13, 21), 0.0, "near", 512),
    (True, (7, 13), 0.0, "near", 256)])
def test_corr_kernel_gradients_match_plain(dev, nchw, hw, spread, dist, C):
    """The backward kernel against ``corr_lookup_ondemand_bwd_plain``, per
    level; ``coords`` get no gradient.  The 7 x 13 grid has an empty
    level; on the 24 x 40 grid, centers spread by U(-20, 20) px put
    windows partly and wholly off the levels; the other distributions
    send (tile, level) pairs down the box path, the per-query path or
    both in one launch.  With the NCHW layout a NaN center sits at
    (1, 1, 1): its df1 row and all of df2_l[1] are NaN on each non-empty
    level, on both sides.  df2 comes from atomic adds whose order varies
    between runs, so it is held to the tolerance, never compared bit for
    bit."""
    f1, f2, coords = _corr_case(9, 2, *hw, C, dev)
    if dist == "offsets":
        coords += (torch.rand(coords.shape, generator=torch.Generator()
                              .manual_seed(12)).to(dev) * 2 - 1) * spread
    else:
        coords = _centers(dist, 2, *hw, 9, dev)
    if nchw:
        coords[1, 1, 1, 0] = float("nan")
    f1.requires_grad_(True)
    coords.requires_grad_(True)
    pyr = [lv.requires_grad_(True) for lv in pool_fmap_pyramid(f2, 4)]
    assert (pyr[-1].numel() == 0) == (hw == (7, 13))
    before = dict(corr_kernels.LAUNCHES)
    lookup = (corr_kernels.corr_lookup_ondemand_nchw if nchw
              else corr_kernels.corr_lookup_ondemand)
    out = lookup(f1, pyr, coords, 4)
    g = torch.randn(2, *hw, 4 * 81,
                    generator=torch.Generator().manual_seed(10)).to(dev)
    cot = g.permute(0, 3, 1, 2) if nchw else g
    got = list(torch.autograd.grad(out, [f1, coords, *pyr], cot,
                                   allow_unused=True))
    dc = got.pop(1)
    df1, df2 = corr_kernels.corr_lookup_ondemand_bwd_plain(f1, pyr, coords,
                                                           4, g)
    torch.cuda.synchronize()
    assert corr_kernels.LAUNCHES == {
        "corr_ondemand": before["corr_ondemand"] + 1,
        "corr_ondemand_bwd": before["corr_ondemand_bwd"] + 1}
    assert dc is None
    for a, b in zip(got, [df1, *df2]):
        assert a.dtype == torch.float32
        _close(a, b)
    assert float(df1.nan_to_num().abs().max()) > 0
    if nchw:
        assert torch.isnan(got[0][1, 1, 1]).all()
        assert int(torch.isnan(got[0]).sum()) == C
        for d in got[1:]:
            assert torch.isnan(d[1]).all() and not torch.isnan(d[0]).any()
    if dist != "offsets":
        with torch.no_grad():
            _check_paths(dist, corr_kernels.kernel_path_counts(
                f1.detach(), [lv.detach() for lv in pyr], coords, 4,
                g)["bwd"])


# Operand layouts of the vectorized gates (the two forwards and the rh
# backward), each on one access path: "model" (z/r halves of one tensor,
# rh's gradient a channel slice, as in the model: 16-byte vectors),
# "chairs" (the chairs step's shape: more units than one wave of blocks,
# so blocks walk several), "odd" (3 channels on a 5 x 7 grid: one value
# per access) and "offset" (r one channel off, so z's batch stride is off
# too, and a gradient whose batch stride is odd: one value per access).
GATE_LAYOUTS = {"model": (3, 32, (5, 7), 0, 0, 16),
                "chairs": (8, 128, (46, 62), 0, 0, 16),
                "odd": (2, 3, (5, 7), 0, 0, 1),
                "offset": (3, 32, (5, 7), 1, 1, 1)}


def _gate_vec_bytes(kernel, ins, C, H, W, B):
    """What an access of ``kernel`` moves on inputs ``ins`` (outputs are
    fresh, so aligned), as ``gate_plan`` picks it: 16 (bytes, the vector
    path) or 1 (value)."""
    strides = [gru_gates._batch_strided(t)[1] for t in ins]
    es = ins[0].element_size()
    vec, _ = gru_gates.gate_plan(kernel, [t.data_ptr() for t in ins],
                                 strides, C * H * W, B, es, 132)
    return 1 if vec == 1 else vec * es


@pytest.mark.parametrize("layout", list(GATE_LAYOUTS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gate_kernels_match_plain(dev, dtype, layout):
    """The forward kernels of ``gru_gate_rh`` and ``gru_gate_blend``
    against their plain versions on each layout of ``GATE_LAYOUTS`` (z/r
    channel views of one tensor), each on the access path ``gate_plan``
    predicts, one launch each: within 1e-6 in fp32, and in bf16 within
    one bf16 ulp of the plain value plus 1e-6."""
    B, C, (H, W), r_off, _, vec_bytes = GATE_LAYOUTS[layout]
    g = torch.Generator().manual_seed(1)
    zr = (torch.randn(B, 2 * C + r_off, H, W, generator=g) * 3).to(dev, dtype)
    z, r = zr[:, :C], zr[:, C + r_off:2 * C + r_off]   # non-contiguous views
    q = (torch.randn(B, C, H, W, generator=g) * 3).to(dev, dtype)
    h = torch.randn(B, C, H, W, generator=g).to(dev, dtype)
    for kernel, ins in (("gru_gate_rh", (r, h)),
                        ("gru_gate_blend", (z, q, h))):
        assert _gate_vec_bytes(kernel, ins, C, H, W, B) == vec_bytes
    before = dict(gru_gates.LAUNCHES)
    with torch.no_grad():
        pairs = [(gru_gates.gru_gate_rh(r, h),
                  gru_gates.gru_gate_rh_plain(r, h)),
                 (gru_gates.gru_gate_blend(z, q, h),
                  gru_gates.gru_gate_blend_plain(z, q, h))]
    torch.cuda.synchronize()
    assert gru_gates.LAUNCHES == {
        k: v + (k in ("gru_gate_rh", "gru_gate_blend"))
        for k, v in before.items()}
    for got, want in pairs:
        assert got.dtype == dtype and got.is_contiguous()
        diff = (got.float() - want.float()).abs()
        if dtype == torch.float32:
            assert float(diff.max()) <= 1e-6
        else:
            # one bf16 ulp, plus the fp32 bound for results that are tiny
            # because (1-s)h and s*tanh(q) cancel
            mag = want.float().abs().clamp_min(2.0 ** -126)
            ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
            assert bool((diff <= ulp + 1e-6).all())


@pytest.mark.parametrize("layout", list(GATE_LAYOUTS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gate_backward_kernels_match_plain(dev, dtype, layout):
    """``GruGateRh`` / ``GruGateBlend`` backward kernels against
    ``gru_gate_*_bwd_plain``: z/r channel halves of one tensor and rh's
    gradient a channel slice of a wider one, as in the model, on each
    access path of the rh backward (``GATE_LAYOUTS``); within
    1e-4 * max|plain| + 1e-5, plus one bf16 ulp for bf16 results."""
    B, C, (H, W), r_off, g_pad, vec_bytes = GATE_LAYOUTS[layout]
    g = torch.Generator().manual_seed(11)
    zr = (torch.randn(B, 2 * C + r_off, H, W, generator=g) * 3).to(dev, dtype)
    q = (torch.randn(B, C, H, W, generator=g) * 3).to(dev, dtype)
    h = torch.randn(B, C, H, W, generator=g).to(dev, dtype)
    g_cat = torch.randn(B, 3 * C + g_pad, H, W, generator=g).to(dev, dtype)
    g_rh, g_bl = g_cat[:, :C], g_cat[:, C:2 * C]
    zr.requires_grad_(True)
    q.requires_grad_(True)
    h.requires_grad_(True)
    z, r = zr[:, :C], zr[:, C + r_off:2 * C + r_off]
    assert _gate_vec_bytes("gru_gate_rh_bwd", (r, h, g_rh), C, H, W,
                           B) == vec_bytes
    before = dict(gru_gates.LAUNCHES)
    d_rh = torch.autograd.grad(gru_gates.gru_gate_rh(r, h), (zr, h), g_rh)
    d_bl = torch.autograd.grad(gru_gates.gru_gate_blend(z, q, h), (zr, q, h),
                               g_bl)
    torch.cuda.synchronize()
    assert gru_gates.LAUNCHES == {k: v + 1 for k, v in before.items()}
    got = [d_rh[0][:, C + r_off:2 * C + r_off], d_rh[1], d_bl[0][:, :C],
           d_bl[1], d_bl[2]]
    assert not d_rh[0][:, :C + r_off].any() and not d_bl[0][:, C:].any()
    want = list(gru_gates.gru_gate_rh_bwd_plain(r, h, g_rh)) + list(
        gru_gates.gru_gate_blend_bwd_plain(z, q, h, g_bl))
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == dtype
        tol = 1e-4 * float(b.float().abs().max()) + 1e-5
        if dtype == torch.float32:
            assert float((a - b).abs().max()) <= tol
        else:
            assert _bf16_close(a, b, tol)


def test_model_kernel_path_counts_and_matches_plain(dev):
    sd = RAFT(RAFTConfig.full()).state_dict()
    rng = np.random.default_rng(2)
    i1, i2 = (rng.uniform(0, 255, (2, 48, 64, 3)).astype(np.float32)
              for _ in range(2))
    kernel = make_eval_fn(RAFTConfig.full(corr_impl="pallas",
                                          fused_gru=True), 3)
    plain = make_eval_fn(RAFTConfig.full(corr_impl="chunked"), 3)
    for d in (corr_kernels.LAUNCHES, gru_gates.LAUNCHES):
        for key in d:
            d[key] = 0
    _, up_k = kernel(sd, i1, i2)
    assert corr_kernels.LAUNCHES == {"corr_ondemand": 3,
                                     "corr_ondemand_bwd": 0}
    assert gru_gates.LAUNCHES == {"gru_gate_rh": 6, "gru_gate_blend": 6,
                                  "gru_gate_rh_bwd": 0,
                                  "gru_gate_blend_bwd": 0}
    _, up_p = plain(sd, i1, i2)
    assert float((up_k - up_p).abs().max()) <= 1e-3


def _bf16_close(got, want, fp32_tol):
    """Within one bf16 ulp of the plain value plus the fp32 bound."""
    diff = (got.float() - want.float()).abs()
    mag = want.float().abs().clamp_min(2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return bool((diff <= ulp + fp32_tol).all())


# NaN centers of _pyramid_case: NaN taps on every non-empty level
NAN_QUERIES = ((1, 3, 4), (0, 5, 6))


def _pyramid_case(seed, dev, dtype, grad=True, B=2, hw=(7, 13), levels=4):
    """A 7 x 13 grid (level 3 pools to 0 x 1; row lengths 91, 18, 3 not
    multiples of 8, and odd, so bf16 and one-byte rows start off 4-byte
    boundaries) or another one, with centers spread by U(-4, 4) px, one
    far off, one integer, one on the last row, two infinite ones and two
    NaN ones (a NaN x and a NaN y); ``levels`` levels in ``dtype``
    (quantized ones as codes and scales)."""
    g = torch.Generator().manual_seed(seed)
    (H, W), C = hw, 64
    f1, f2 = (torch.randn(B, H, W, C, generator=g) for _ in range(2))
    ys, xs = torch.meshgrid(torch.arange(H), torch.arange(W), indexing="ij")
    coords = torch.stack([xs, ys], -1).float()[None].repeat(B, 1, 1, 1)
    coords += torch.rand(B, H, W, 2, generator=g) * 8 - 4
    coords[0, 0, 0] = torch.tensor([1e6, -2.5])
    coords[1, 2, 3] = torch.tensor([5.0, 3.0])          # integer center
    coords[-1, -1, -1] = torch.tensor([-7.25, float(H) - 0.5])
    coords[NAN_QUERIES[0]] = torch.tensor([float("nan"), 2.0])
    coords[NAN_QUERIES[1]] = torch.tensor([1.0, float("nan")])
    coords[1, 4, 9] = torch.tensor([float("inf"), 2.0])     # zero taps
    coords[0, 6, 1] = torch.tensor([1.0, float("-inf")])
    pyr = corr_ops.build_corr_pyramid(f1.to(dev), f2.to(dev), levels, dtype)
    if grad and dtype.is_floating_point and dtype.itemsize > 1:
        pyr = [lv.requires_grad_(True) for lv in pyr]
    return pyr, coords.to(dev)


def _check_nan_taps(taps, levels, kk=81):
    """Taps (B, H, W, P): the NaN queries' taps NaN on the ``levels``
    non-empty levels (``kk`` taps each), nothing else NaN."""
    for q in NAN_QUERIES:
        assert torch.isnan(taps[q][:levels * kk]).all()
    assert int(torch.isnan(taps).sum()) == len(NAN_QUERIES) * levels * kk


# (radius, levels) of the lookup cases: the full model's 4 and 4, the
# small model's radius 3, radius 2 (the forward's runtime-radius
# instantiation), and 3 and 5 levels
LOOKUP_SHAPES = [(4, 4), (3, 4), (2, 4), (4, 3), (4, 5)]
LOOKUP_IDS = [f"r{r}L{n}" for r, n in LOOKUP_SHAPES]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nchw", [False, True])
@pytest.mark.parametrize("B,hw", [(2, (7, 13)), (8, (46, 62))],
                         ids=["7x13", "chairs"])
@pytest.mark.parametrize("radius,n_levels", LOOKUP_SHAPES, ids=LOOKUP_IDS)
def test_pyramid_lookup_kernels_match_plain(dev, dtype, nchw, B, hw, radius,
                                            n_levels):
    """The forward and the backward kernel against the plain version and
    its autograd, in both tap layouts: a ragged grid with an empty level
    and the chairs grid (B = 8, 46 x 62), at each radius and level count
    of ``LOOKUP_SHAPES``.  Neither query count (91, 2852) is a multiple of
    the forward's 32-query tile.  The backward's dense rows are written
    flat with 16-byte stores, so row lengths that are not multiples of 8
    and the NaN queries' all-NaN rows test its head, tail and straddling
    vectors."""
    pyr, coords = _pyramid_case(3, dev, dtype, B=B, hw=hw, levels=n_levels)
    kk = (2 * radius + 1) ** 2
    levels = sum(1 for lv in pyr if lv.numel())
    assert levels == (3 if hw == (7, 13) else n_levels)
    lookup = (pyramid_kernels.pyramid_lookup_nchw if nchw
              else pyramid_kernels.pyramid_lookup)
    before = dict(pyramid_kernels.LAUNCHES)
    got = lookup(pyr, coords, radius, dtype)
    want = pyramid_kernels.pyramid_lookup_plain(pyr, coords, radius, dtype)
    if nchw:
        want = want.permute(0, 3, 1, 2)
    g = torch.randn(got.shape, generator=torch.Generator().manual_seed(4)
                    ).to(dev)
    dgot = torch.autograd.grad(got, pyr, g.to(got.dtype))
    dwant = torch.autograd.grad(want, pyr, g.to(want.dtype))
    torch.cuda.synchronize()
    assert pyramid_kernels.LAUNCHES == dict(
        before, pyramid_lookup_fwd=before["pyramid_lookup_fwd"] + 1,
        pyramid_lookup_bwd=before["pyramid_lookup_bwd"] + 1)
    assert got.dtype == dtype and got.shape == want.shape
    # every comparison on the scale of the plain taps
    scale = float(want.detach().float().nan_to_num().abs().max())
    for a, b in [(got, want)] + list(zip(dgot, dwant)):
        _close(a, b, scale)
    taps = got if not nchw else got.permute(0, 2, 3, 1)
    assert taps.shape[-1] == n_levels * kk
    assert float(taps.detach().float().nan_to_num().abs().max()) > 0
    assert torch.all(taps[..., levels * kk:] == 0)
    assert torch.all(taps[0, 0, 0] == 0) and torch.all(taps[1, 4, 9] == 0)
    _check_nan_taps(taps, levels, kk)
    for d in dgot:                  # the NaN queries' whole rows
        if d.numel():
            assert int(torch.isnan(d).sum()) == 2 * d[0, 0].numel()


def test_pyramid_lookup_refuses_what_does_not_fit(dev):
    """A radius whose blocks need more shared memory than the card has, or
    more levels than the kernels' tables hold, raises before any launch:
    no kernel runs and nothing falls back to the plain version."""
    pyr, coords = _pyramid_case(3, dev, torch.float32, grad=False)
    qpyr, _ = _pyramid_case(3, dev, torch.int8)
    before = dict(pyramid_kernels.LAUNCHES)
    assert pyramid_kernels._lookup_smem_bytes(4, 6) <= pyramid_kernels.SMEM_MAX
    assert pyramid_kernels._lookup_smem_bytes(4, 7) > pyramid_kernels.SMEM_MAX
    for fn, levels in ((pyramid_kernels.pyramid_lookup_nchw, pyr),
                       (pyramid_kernels.pyramid_lookup_quantized, qpyr)):
        with pytest.raises(ValueError, match="shared-memory"):
            fn(levels, coords, 7)
        with pytest.raises(ValueError, match="levels"):
            fn(list(levels) * 3, coords, 4)
    assert pyramid_kernels.LAUNCHES == before


# Grids of the upsample-loss case, each on one access path of the
# backward kernel: (H, W), offset of the mask in values from the start of
# its allocation, and the bytes per dmask store at a plane's edges in fp32
# and bf16, which are also the forward kernel's bytes per mask load (8
# pixels a lane for "hw256" in bf16, 4 otherwise).  All but
# "hw45" span two or three of the kernel's 128-pixel runs, with channel
# planes off 32-byte boundaries (except "hw256"), so the runs' shared
# sectors and the last partial run are exercised; the forward's tiles (32
# lanes' pixels) leave lanes past the sample's end on every grid but
# "hw256", and the offset grid starts its first group a value before the
# sample.
UL_GRIDS = {"odd": ((13, 21), 0, 4, 2), "hw256": ((16, 16), 0, 16, 16),
            "hw276": ((12, 23), 0, 16, 8), "hw270": ((10, 27), 0, 8, 4),
            "hw45": ((5, 9), 0, 4, 2), "offset": ((12, 23), 1, 4, 2)}


@pytest.mark.parametrize("grid", list(UL_GRIDS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_upsample_loss_kernels_match_plain(dev, dtype, grid):
    (H, W), offset, vb32, vb16 = UL_GRIDS[grid]
    g = torch.Generator().manual_seed(5)
    B, G = 2, 3
    # Residuals are kept at least 0.5 from 0 (|8 * flow| <= 8, |gt| >= 8.5)
    # except where both are exactly 0: two fp32 orders of one sum may give
    # a near-zero residual opposite signs, and the |.| subgradient with it.
    flow = (torch.rand(G * B, H, W, 2, generator=g) * 2 - 1).to(dev)
    mask = torch.randn(G * B, 576, H, W, generator=g).to(dev, dtype)
    gt = (torch.rand(B, 8 * H, 8 * W, 2, generator=g) * 15.5 + 8.5) * (
        torch.randint(0, 2, (B, 8 * H, 8 * W, 2), generator=g) * 2 - 1)
    gt = gt.to(dev)
    gt[0, :8] = 0.0
    flow[0::B] = 0.0                            # exact-zero residuals
    vm = (torch.rand(B, 8 * H, 8 * W, generator=g) > 0.2).float().to(dev)
    w = torch.rand(G * B, 5, generator=g).to(dev)

    def leaf_mask(n):
        """The first n samples of the mask as a leaf, and the view of it
        that the functions take: ``offset`` values into the leaf."""
        leaf = torch.zeros(n * 576 * H * W + offset, dtype=dtype, device=dev)
        m = leaf[offset:].view(n, 576, H, W)
        with torch.no_grad():
            m.copy_(mask[:n])
        leaf.requires_grad_(True)
        return leaf, leaf[offset:].view(n, 576, H, W)

    def both(flow, gt, exact_counts=False):
        outs = []
        for fn in (upsample_loss.upsample_loss_sums,
                   upsample_loss.upsample_loss_sums_plain):
            f = flow.clone().requires_grad_(True)
            leaf, m = leaf_mask(flow.shape[0])
            sums = fn(f, m, gt, vm)
            (sums * w[:flow.shape[0]]).sum().backward()
            outs.append((sums.detach(), f.grad,
                         leaf.grad[offset:].view(m.shape)))
        torch.cuda.synchronize()
        (sk, *gk), (sp, *gp) = outs
        # each sum column on its own scale: the pixel counts are not held
        # to the L1 column's tolerance
        tols = 1e-4 * sp.abs().amax(dim=0) + 1e-5
        assert bool(((sk - sp).abs().amax(dim=0) <= tols).all())
        if exact_counts:        # squared EPE against 1, 9, 25 in the kernel
            assert torch.equal(sk[:, 2:], sp[:, 2:])
        for a, b in zip(gk, gp):
            tol = 1e-4 * float(b.float().abs().max()) + 1e-5
            if a.dtype == torch.bfloat16:
                assert _bf16_close(a, b, tol)
            else:
                assert float((a - b).abs().max()) <= tol
        assert gk[1].dtype == dtype
        return sp

    _, m = leaf_mask(G * B)
    vb = vb32 if dtype == torch.float32 else vb16
    assert upsample_loss.bwd_vector_bytes(
        m.data_ptr(), torch.empty_like(m).data_ptr(), H * W,
        m.element_size()) == vb
    plan = upsample_loss.fwd_plan(m.data_ptr(), H * W, m.element_size())
    assert (plan.vec_bytes, plan.pixels, plan.offset) == (
        vb, 8 if vb == 16 and dtype == torch.bfloat16 else 4, offset)
    sp = both(flow, gt)
    # the forward's sums are the same run to run (a fixed order, no
    # atomics)
    with torch.no_grad():
        again = [upsample_loss.upsample_loss_sums(flow, m, gt, vm)
                 for _ in range(2)]
    assert torch.equal(again[0], again[1])
    assert bool(((again[0] - sp).abs().amax(dim=0)
                 <= 1e-4 * sp.abs().amax(dim=0) + 1e-5).all())
    # residuals spanning the 1/3/5 px thresholds: one iteration, ground
    # truth = the plain upsampled flow + offsets whose end-point error is
    # U(0.75, 7) px (>= 1e-3 from a threshold) with both components >= 0.5
    # px from 0
    shape = (B, 8 * H, 8 * W)
    r = torch.rand(shape, generator=g) * 6.25 + 0.75
    near = torch.stack([(r - t).abs() for t in (1.0, 3.0, 5.0)]).amin(0)
    r = torch.where(near < 1e-3, r * 1.01, r)
    lo, hi = torch.asin(0.5 / r), torch.acos(0.5 / r)
    theta = lo + torch.rand(shape, generator=g) * (hi - lo)
    off = torch.stack([r * torch.cos(theta), r * torch.sin(theta)], -1) * (
        torch.randint(0, 2, shape + (2,), generator=g) * 2 - 1)
    f1 = flow[B:2 * B]
    with torch.no_grad():
        up = convex_upsample_flat_nchw(f1.permute(0, 3, 1, 2), mask[:B])
        gt_s = (depth_to_space_flow(up.permute(0, 2, 3, 1)) + off.to(dev)
                ).contiguous()
    counts = both(f1.contiguous(), gt_s, exact_counts=True)[:, 2:].sum(
        dim=0).tolist()
    assert 0 < counts[0] < counts[1] < counts[2] < float(vm.sum())


# Row-halo grids (``halo=1``: the flow carries a row of each neighbouring
# shard): (H, W) of a shard, the mask's offset in values into its
# allocation.  "chairs" is one of two shards of the chairs grid (46 x 62);
# "odd" an odd grid; "offset" a mask off 16 bytes.
UL_HALO_GRIDS = {"chairs": ((23, 62), 0), "odd": ((13, 21), 0),
                 "offset": ((12, 23), 1)}


def _ul_halo_inputs(dev, dtype, H, W, offset, B=2, G=3, seed=7):
    """A shard's inputs (residuals >= 0.5 from 0, as above), the flow with
    ``H + 2`` rows; the mask ``offset`` values into its allocation."""
    g = torch.Generator().manual_seed(seed)
    flow = (torch.rand(G * B, H + 2, W, 2, generator=g) * 2 - 1).to(dev)
    leaf = torch.zeros(G * B * 576 * H * W + offset, dtype=dtype)
    leaf[offset:] = torch.randn(G * B * 576 * H * W, generator=g).to(dtype)
    mask = leaf.to(dev)[offset:].view(G * B, 576, H, W)
    gt = ((torch.rand(B, 8 * H, 8 * W, 2, generator=g) * 15.5 + 8.5) * (
        torch.randint(0, 2, (B, 8 * H, 8 * W, 2), generator=g) * 2 - 1)
    ).to(dev)
    vm = (torch.rand(B, 8 * H, 8 * W, generator=g) > 0.2).float().to(dev)
    w = torch.rand(G * B, 5, generator=g).to(dev)
    return flow, mask, gt, vm, w


def _ul_run(fn, flow, mask, gt, vm, w, halo):
    """``fn``'s sums and its flow and mask gradients of the weighted
    sums."""
    f = flow.clone().requires_grad_(True)
    m = mask.detach().requires_grad_(True)   # at the mask's address
    sums = fn(f, m, gt, vm, halo=halo)
    (sums * w).sum().backward()
    torch.cuda.synchronize()
    return sums.detach(), f.grad, m.grad


@pytest.mark.parametrize("grid", list(UL_HALO_GRIDS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_upsample_loss_halo_kernels_match_plain(dev, dtype, grid):
    """The halo form of both kernels against the plain version with the
    same halo: sums (each column on its own scale), dflow over all
    ``H + 2`` rows and dmask, within the tolerances of the unsharded
    check above; a wrong halo or a flow without its rows is refused."""
    (H, W), offset = UL_HALO_GRIDS[grid]
    flow, mask, gt, vm, w = _ul_halo_inputs(dev, dtype, H, W, offset)
    before = dict(upsample_loss.LAUNCHES)
    sk, *gk = _ul_run(upsample_loss.upsample_loss_sums, flow, mask, gt, vm,
                      w, 1)
    assert upsample_loss.LAUNCHES["upsample_loss_fwd"] == \
        before["upsample_loss_fwd"] + 1
    assert upsample_loss.LAUNCHES["upsample_loss_bwd"] == \
        before["upsample_loss_bwd"] + 1
    sp, *gp = _ul_run(upsample_loss.upsample_loss_sums_plain, flow, mask,
                      gt, vm, w, 1)
    tols = 1e-4 * sp.abs().amax(dim=0) + 1e-5
    assert bool(((sk - sp).abs().amax(dim=0) <= tols).all())
    assert gk[0].shape == (flow.shape[0], H + 2, W, 2)
    # the halo rows take gradient (they feed the first and last rows)
    assert float(gk[0][:, 0].abs().max()) > 0
    assert float(gk[0][:, -1].abs().max()) > 0
    for a, b in zip(gk, gp):
        tol = 1e-4 * float(b.float().abs().max()) + 1e-5
        if a.dtype == torch.bfloat16:
            assert _bf16_close(a, b.to(a.dtype), tol)
        else:
            assert float((a - b).abs().max()) <= tol
    with pytest.raises(ValueError, match="halo 2"):
        upsample_loss.upsample_loss_sums(flow, mask, gt, vm, halo=2)
    with pytest.raises(ValueError, match="flow"):
        upsample_loss.upsample_loss_sums(flow[:, 1:-1].contiguous(), mask,
                                         gt, vm, halo=1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_upsample_loss_zero_halo_is_the_unsharded_kernel(dev, dtype):
    """The whole image as one shard, its halo rows zero: the halo
    kernels give the unsharded kernels' sums, dmask and, on the image's
    rows, dflow bit for bit (the edge rows read zeros either way)."""
    (H, W), offset = UL_HALO_GRIDS["chairs"]
    flow, mask, gt, vm, w = _ul_halo_inputs(dev, dtype, H, W, offset)
    with torch.no_grad():
        flow[:, 0] = 0.0
        flow[:, -1] = 0.0
    s1, f1, m1 = _ul_run(upsample_loss.upsample_loss_sums, flow, mask, gt,
                         vm, w, 1)
    s0, f0, m0 = _ul_run(upsample_loss.upsample_loss_sums,
                         flow[:, 1:-1].contiguous(), mask, gt, vm, w, 0)
    assert torch.equal(s1, s0)
    assert torch.equal(m1, m0)
    assert torch.equal(f1[:, 1:-1], f0)


KERNEL_KW = dict(corr_impl="allpairs_pallas", upsample_loss_kernel="pallas")
ONDEMAND_KW = dict(corr_impl="pallas", fused_gru=True,
                   upsample_loss_kernel="pallas")
ONDEMAND_PLAIN_KW = dict(corr_impl="chunked", fused_gru=False,
                         upsample_loss_kernel="xla")


def _train_step_both(dev, dtype, kernel_kw=KERNEL_KW, plain_kw=None,
                     mk=RAFTConfig.full):
    """One train step of the kernel and the plain configuration (of the
    model preset ``mk``) from the same weights, the clip out of reach:
    metrics, launch counts and the unclipped gradients the optimizer
    saw."""
    from raft_tpu_torch.config import TrainConfig
    from raft_tpu_torch.train.step import init_state, make_train_step

    rng = np.random.default_rng(6)
    B, H, W = 2, 48, 64
    batch = {"image1": rng.uniform(0, 255, (B, H, W, 3)).astype(np.float32),
             "image2": rng.uniform(0, 255, (B, H, W, 3)).astype(np.float32),
             "flow": rng.standard_normal((B, H, W, 2)).astype(np.float32),
             "valid": np.ones((B, H, W), np.float32)}
    cfg = TrainConfig(lr=1e-4, num_steps=10, batch_size=B,
                      image_size=(H, W), iters=3, clip=1e9)
    sd = RAFT(mk()).state_dict()
    counters = (corr_kernels.LAUNCHES, gru_gates.LAUNCHES,
                pyramid_kernels.LAUNCHES, upsample_loss.LAUNCHES,
                lookup_encode.LAUNCHES)
    out = {}
    for name, kw in (("kernel", kernel_kw), ("plain", plain_kw or {})):
        state = init_state(mk(compute_dtype=dtype, **kw), cfg,
                           device=dev, state_dict=sd)
        grads = {}
        opt_step = state.optimizer.step

        def hooked(*a, _grads=grads, _model=state.model, _step=opt_step,
                   **k):
            _grads.update({n: p.grad.detach().clone()
                           for n, p in _model.named_parameters()})
            return _step(*a, **k)

        state.optimizer.step = hooked
        for d in counters:
            for key in d:
                d[key] = 0
        state, met = make_train_step(cfg, device=dev)(state, batch)
        launches = {k: v for d in counters for k, v in d.items() if v}
        out[name] = (met, launches, grads)
    return out["kernel"], out["plain"]


def _grad_bounds(gp):
    """The model's largest gradient entry and global gradient norm: the
    floors' scale.  A conv bias that a normalization follows has a zero
    gradient in exact arithmetic and rounding noise in practice, which no
    relative bound on the bias alone can hold."""
    gmax = max(float(g.abs().max()) for g in gp.values())
    gnorm = float(torch.sqrt(sum(g.double().square().sum()
                                 for g in gp.values())))
    return gmax, gnorm


def _check_fp32(mk, gk, mp, gp):
    for k in ("loss", "epe", "grad_norm"):
        assert abs(float(mk[k]) - float(mp[k])) <= 1e-4 * abs(float(mp[k]))
    assert set(gk) == set(gp) and gp
    gmax, _ = _grad_bounds(gp)
    for n, g in gp.items():
        assert float((gk[n] - g).abs().max()) <= (
            1e-3 * float(g.abs().max()) + 1e-6 * gmax), n


def _check_bf16(mk, gk, mp, gp):
    assert abs(float(mk["loss"]) - float(mp["loss"])) <= 2e-3 * abs(
        float(mp["loss"]))
    assert set(gk) == set(gp) and gp
    _, gnorm = _grad_bounds(gp)
    for n, g in gp.items():
        assert float((gk[n] - g).norm()) <= (0.1 * float(g.norm())
                                             + 2e-4 * gnorm), n


TRAIN_LAUNCHES = {"pyramid_lookup_fwd": 3, "pyramid_lookup_bwd": 3,
                  "upsample_loss_fwd": 1, "upsample_loss_bwd": 1}
ONDEMAND_LAUNCHES = {"corr_ondemand": 3, "corr_ondemand_bwd": 3,
                     "gru_gate_rh": 6, "gru_gate_rh_bwd": 6,
                     "gru_gate_blend": 6, "gru_gate_blend_bwd": 6,
                     "upsample_loss_fwd": 1, "upsample_loss_bwd": 1}


def test_train_step_kernel_config_counts_and_matches_plain(dev):
    """fp32: metrics within 1e-4 relative, and each parameter's gradient
    within 1e-3 of its largest entry plus 1e-6 of the model's."""
    (mk, lk, gk), (mp, lp, gp) = _train_step_both(dev, "float32")
    assert lk == TRAIN_LAUNCHES and lp == {}
    _check_fp32(mk, gk, mp, gp)


def test_train_step_kernel_config_matches_plain_bf16(dev):
    """bf16: the plain chain upsamples in bf16 and the kernel in fp32, so
    they differ by bf16 rounding: the loss within 2e-3 relative, each
    parameter's gradient within 0.1 of its norm plus 2e-4 of the model's
    global gradient norm (the bounds of chip_smoke.py's chairs check)."""
    (mk, lk, gk), (mp, _, gp) = _train_step_both(dev, "bfloat16")
    assert lk == TRAIN_LAUNCHES
    _check_bf16(mk, gk, mp, gp)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_step_ondemand_config_counts_and_matches_plain(dev, dtype):
    """The on-demand kernel configuration (lookup + fused gates, forward
    and backward kernels, upsample-loss kernels) against its plain one
    (``chunked``, unfused gates, ``'xla'``), under the bounds above."""
    (mk, lk, gk), (mp, lp, gp) = _train_step_both(
        dev, dtype, ONDEMAND_KW, ONDEMAND_PLAIN_KW)
    assert lk == ONDEMAND_LAUNCHES and lp == {}
    (_check_fp32 if dtype == "float32" else _check_bf16)(mk, gk, mp, gp)


def _close(a, b, scale=None):
    """The same NaN entries, position for position; the others within
    1e-4 * scale + 1e-5, plus one bf16 ulp for bf16 results; ``scale``
    defaults to max|plain| over the plain version's finite entries."""
    a, b = a.detach(), b.detach()
    assert a.dtype == b.dtype and a.shape == b.shape
    nan = torch.isnan(b)
    assert torch.equal(torch.isnan(a), nan)
    if not b.numel():
        return
    a, b = a.masked_fill(nan, 0.0), b.masked_fill(nan, 0.0)
    if scale is None:
        scale = float(b.float().abs().max())
    tol = 1e-4 * scale + 1e-5
    if a.dtype == torch.bfloat16:
        assert _bf16_close(a, b, tol)
    else:
        assert float((a - b).abs().max()) <= tol


QDTYPES = [torch.int8, torch.float8_e4m3fn, torch.float8_e5m2]


@pytest.mark.parametrize("qdtype", QDTYPES)
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("radius,n_levels", LOOKUP_SHAPES, ids=LOOKUP_IDS)
def test_quantized_lookup_kernel_matches_plain(dev, qdtype, out_dtype, radius,
                                               n_levels):
    """The lookup kernel on int8 / fp8 codes, each level's taps times its
    scale, against the plain version fed the same codes, in both tap
    layouts, at each radius and level count of ``LOOKUP_SHAPES``; primal
    only.  The 7 x 13 grid's one-byte rows (91, 18, 3 codes) start at
    every offset within a 4-byte word."""
    pyr, coords = _pyramid_case(13, dev, qdtype, levels=n_levels)
    kk = (2 * radius + 1) ** 2
    assert isinstance(pyr[0], corr_ops.QuantizedLevel)
    assert all(lv.values.numel() == 0 for lv in pyr[3:])
    coords.requires_grad_(True)
    before = dict(pyramid_kernels.LAUNCHES)
    got = pyramid_kernels.pyramid_lookup_quantized(pyr, coords, radius,
                                                   out_dtype)
    nchw = pyramid_kernels.pyramid_lookup_quantized_nchw(pyr, coords, radius,
                                                         out_dtype)
    torch.cuda.synchronize()
    assert pyramid_kernels.LAUNCHES == dict(
        before, pyramid_lookup_quantized=before["pyramid_lookup_quantized"]
        + 2)
    want = pyramid_kernels.pyramid_lookup_plain(pyr, coords.detach(), radius,
                                                out_dtype)
    assert got.dtype == out_dtype and not got.requires_grad
    assert got.shape[-1] == n_levels * kk
    _close(got, want)
    assert torch.equal(nchw.isnan(), got.permute(0, 3, 1, 2).isnan())
    assert torch.equal(nchw.nan_to_num(), got.permute(0, 3, 1, 2)
                       .nan_to_num())
    assert float(got.float().nan_to_num().abs().max()) > 0
    assert torch.all(got[..., 3 * kk:] == 0) and torch.all(got[0, 0, 0] == 0)
    assert torch.all(got[1, 4, 9] == 0) and torch.all(got[0, 6, 1] == 0)
    _check_nan_taps(got, 3, kk)


# (level dtype, output dtype, F, B, grid): F = 300 runs two feature
# passes of 256, F = 40 and 300 leave mma tiles past F; the 7 x 13 grid
# (N = 91) leaves a ragged 64-query tile and has an empty level; the
# chairs grid is the training shape
CHAIRS = (8, (46, 62))
ENCODE_CASES = [(torch.float32, torch.float32, 300, 2, (7, 13)),
                (torch.bfloat16, torch.bfloat16, 256, 2, (7, 13)),
                (torch.int8, torch.bfloat16, 40, 2, (7, 13)),
                (torch.float8_e4m3fn, torch.float32, 256, 2, (7, 13)),
                (torch.float32, torch.float32, 256, *CHAIRS),
                (torch.bfloat16, torch.bfloat16, 256, *CHAIRS),
                (torch.int8, torch.float32, 256, *CHAIRS),
                (torch.float8_e4m3fn, torch.bfloat16, 40, *CHAIRS)]


@pytest.mark.parametrize("dtype,out_dtype,F,B,hw", ENCODE_CASES)
def test_lookup_encode_kernel_matches_plain(dev, dtype, out_dtype, F, B, hw):
    """The fused lookup + convc1 kernel and its backward (dW, db and, for
    fp32 / bf16 levels, dpyramid) against the plain forward and the plain
    backward on the kernel's output (one relu mask for both), with the
    launches of the fused kernel and of the lookup kernels its backward
    recomputes the taps with.  Twice: with the NaN centers replaced by
    finite ones, where every value is compared, and with them, where they
    give NaN in all F outputs of their queries and make dW's rows of the
    non-empty levels NaN (their relu mask is 0, their taps NaN)."""
    pyr, coords = _pyramid_case(14, dev, dtype, B=B, hw=hw)
    levels = 3 if hw == (7, 13) else 4
    quantized = isinstance(pyr[0], corr_ops.QuantizedLevel)
    g = torch.Generator().manual_seed(15)
    w = (torch.randn(F, 4 * 81, 1, 1, generator=g) / 18).to(dev)
    b = (torch.randn(F, generator=g) * 0.1).to(dev)
    w.requires_grad_(True)
    b.requires_grad_(True)
    leaves = [w, b] + ([] if quantized else list(pyr))
    cot = torch.randn((B, F, *hw), generator=g).to(dev, out_dtype)
    finite = coords.clone()
    for q in NAN_QUERIES:
        finite[q] = finite[q].nan_to_num(3.5)
    for c in (finite, coords):
        before = (dict(lookup_encode.LAUNCHES),
                  dict(pyramid_kernels.LAUNCHES))
        got = lookup_encode.pyramid_lookup_encode(pyr, c, 4, w, b, out_dtype)
        with torch.no_grad():
            want = lookup_encode.pyramid_lookup_encode_plain(pyr, c, 4, w, b,
                                                             out_dtype)
        dgot = torch.autograd.grad(got, leaves, cot)
        dw, db, dl = lookup_encode.pyramid_lookup_encode_bwd_plain(
            pyr, c, 4, w, got.detach(), cot)
        dwant = [dw, db] + (dl or [])
        torch.cuda.synchronize()
        recompute = ({"pyramid_lookup_quantized": 1} if quantized else
                     {"pyramid_lookup_fwd": 1, "pyramid_lookup_bwd": 1})
        assert lookup_encode.LAUNCHES == {
            "lookup_encode": before[0]["lookup_encode"] + 1}
        assert pyramid_kernels.LAUNCHES == {
            k: v + recompute.get(k, 0) for k, v in before[1].items()}
        assert got.shape == (B, F, *hw) and got.is_contiguous()
        _close(got, want)
        fin = got.detach().float().nan_to_num()
        assert float(fin.max()) > 0 and float(fin.min()) == 0
        for a, d in zip(dgot, dwant):
            _close(a, d)
        assert float(dgot[1].abs().max()) > 0
        if c is finite:
            assert not torch.isnan(got).any()
            assert float(dgot[0].abs().max()) > 0
            continue
        for bq, y, x in NAN_QUERIES:
            assert torch.isnan(got[bq, :, y, x]).all()
        assert int(torch.isnan(got).sum()) == len(NAN_QUERIES) * F
        dw_nan = torch.isnan(dgot[0].reshape(F, -1))
        assert dw_nan[:, :levels * 81].all()
        assert not dw_nan[:, levels * 81:].any()
        assert not torch.isnan(dgot[1]).any()


INT8_FUSED_KW = dict(corr_impl="allpairs_pallas", corr_dtype="int8",
                     fused_lookup_encoder=True, upsample_loss_kernel="pallas")
AUTO_FUSED_KW = dict(corr_impl="allpairs_pallas", fused_lookup_encoder=True,
                     upsample_loss_kernel="pallas")
INT8_KW = dict(corr_impl="allpairs_pallas", corr_dtype="int8",
               upsample_loss_kernel="pallas")
INT8_PLAIN_KW = dict(corr_impl="allpairs", corr_dtype="int8",
                     upsample_loss_kernel="xla")
LOSS_LAUNCHES = {"upsample_loss_fwd": 1, "upsample_loss_bwd": 1}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kernel_kw,plain_kw,launches", [
    (INT8_FUSED_KW, INT8_PLAIN_KW,
     {"lookup_encode": 3, "pyramid_lookup_quantized": 3, **LOSS_LAUNCHES}),
    (AUTO_FUSED_KW, {}, {"lookup_encode": 3, "pyramid_lookup_fwd": 3,
                         "pyramid_lookup_bwd": 3, **LOSS_LAUNCHES}),
    (INT8_KW, INT8_PLAIN_KW,
     {"pyramid_lookup_quantized": 3, **LOSS_LAUNCHES})],
    ids=["int8_fused", "auto_fused", "int8"])
def test_train_step_quantized_and_fused_configs_match_plain(
        dev, dtype, kernel_kw, plain_kw, launches):
    """The slice's kernel configurations against their plain ones (the
    same ``corr_dtype``, ``allpairs``, unfused, ``'xla'``), under the
    bounds above, with exact launch counts; under int8 ``fnet`` gets
    exactly zero gradient on both sides."""
    (mk, lk, gk), (mp, lp, gp) = _train_step_both(dev, dtype, kernel_kw,
                                                  plain_kw)
    assert lk == launches and lp == {}
    (_check_fp32 if dtype == "float32" else _check_bf16)(mk, gk, mp, gp)
    if kernel_kw.get("corr_dtype") == "int8":
        for grads in (gk, gp):
            fnet = [g for n, g in grads.items() if n.startswith("fnet.")]
            assert fnet and not any(bool(g.any()) for g in fnet)


# ---------------------------------------------------------------------------
# the training input side and checkpoints on the card
# ---------------------------------------------------------------------------

def _host_batches(n, B=2, H=64, W=96):
    rng = np.random.default_rng(8)
    for _ in range(n):
        img1 = rng.uniform(0, 255, (B, H, W, 3)).astype(np.float32)
        yield {"image1": img1, "image2": np.roll(img1, 2, axis=2),
               "flow": rng.normal(0, 2, (B, H, W, 2)).astype(np.float32),
               "valid": np.ones((B, H, W), np.float32)}


def test_prefetch_on_card_matches_serial(dev):
    """``CudaBatchPut`` through a depth-2 pipeline (pinned ring, side
    stream, event wait, ``record_stream``) against depth 0: the batches the
    step reads are bit-equal to the host batches, and three steps of the
    kernel configuration give equal losses (cuDNN deterministic)."""
    from raft_tpu_torch.config import TrainConfig
    from raft_tpu_torch.data.prefetch import CudaBatchPut, DevicePipeline
    from raft_tpu_torch.train.loop import noise_prep
    from raft_tpu_torch.train.step import init_state, make_train_step

    torch.backends.cudnn.deterministic = True
    try:
        host = list(_host_batches(3))
        prep = noise_prep(5, 0)              # one generator, stream order
        noisy = [prep(b) for b in host]
        cfg = TrainConfig(num_steps=10, batch_size=2, image_size=(64, 96),
                          iters=3, lr=1e-4)
        mcfg = RAFTConfig.full(corr_impl="allpairs_pallas",
                               upsample_loss_kernel="pallas")
        sd = RAFT(mcfg, seed=0).state_dict()
        losses = {}
        for depth in (0, 2):
            put = CudaBatchPut(dev, depth + 1)
            pipe = DevicePipeline(iter(host), put_fn=put.put,
                                  ready_fn=put.ready,
                                  prep_fn=noise_prep(5, 0), depth=depth)
            state = init_state(mcfg, cfg, device=dev, state_dict=sd)
            step_fn = make_train_step(cfg, device=dev)
            out = []
            for want in noisy:
                batch = next(pipe)
                for k in ("image1", "image2", "flow", "valid"):
                    assert batch[k].is_cuda
                    assert torch.equal(batch[k].cpu(),
                                       torch.from_numpy(want[k]))
                state, met = step_fn(state, batch)
                out.append(float(met["loss"]))
            pipe.close()
            losses[depth] = out
        assert losses[0] == losses[2], losses
    finally:
        torch.backends.cudnn.deterministic = False


def test_checkpoint_snapshot_of_cuda_state_restores_bit_for_bit(dev,
                                                               tmp_path):
    """``save_async`` copies the CUDA state to host before it returns: a
    step taken right after it (which changes the parameters in place) does
    not reach the checkpoint, and a fresh CUDA state restores to exactly
    the saved one, the CUDA dropout generator included."""
    from raft_tpu_torch.config import TrainConfig
    from raft_tpu_torch.train.checkpoint import CheckpointManager
    from raft_tpu_torch.train.step import init_state, make_train_step

    cfg = TrainConfig(num_steps=10, batch_size=2, image_size=(64, 96),
                      iters=2, lr=1e-4)
    mcfg = RAFTConfig.full(dropout=0.1, corr_impl="allpairs_pallas")
    state = init_state(mcfg, cfg, device=dev)
    step_fn = make_train_step(cfg, device=dev)
    batches = _host_batches(2)
    state, _ = step_fn(state, next(batches))
    want = ({k: v.clone() for k, v in state.model.state_dict().items()},
            [{k: v.clone() for k, v in s.items()}
             for s in state.optimizer.state_dict()["state"].values()],
            state.generator.get_state())
    mgr = CheckpointManager(str(tmp_path / "run"))
    mgr.save_async(1, state)
    state, _ = step_fn(state, next(batches))      # overwrites in place
    mgr.wait()
    fresh = init_state(mcfg, dataclasses.replace(cfg, seed=7), device=dev)
    mgr.restore_latest(fresh)
    assert fresh.step == 1 and fresh.generator.device.type == "cuda"
    for k, v in fresh.model.state_dict().items():
        assert v.is_cuda and torch.equal(v, want[0][k]), k
    got_opt = list(fresh.optimizer.state_dict()["state"].values())
    for g, w in zip(got_opt, want[1]):
        for k in w:
            assert torch.equal(g[k].to(w[k].device), w[k]), k
    assert torch.equal(fresh.generator.get_state(), want[2])
    assert not torch.equal(state.generator.get_state(), want[2])
    mgr.close()


# --- the small model's shapes: radius 3 (K = 196 taps), C = 128 features,
# F = 96 outputs of the fused lookup + convc1, 96-channel GRU gates ---

SMALL_ENCODE_CASES = [(torch.float32, torch.float32, *CHAIRS),
                      (torch.bfloat16, torch.bfloat16, *CHAIRS),
                      (torch.int8, torch.float32, *CHAIRS),
                      (torch.float32, torch.float32, 2, (7, 13))]


@pytest.mark.parametrize("dtype,out_dtype,B,hw", SMALL_ENCODE_CASES)
def test_lookup_encode_small_shapes_match_plain(dev, dtype, out_dtype, B,
                                                 hw):
    """The fused lookup + convc1 at radius 3 with F = 96 (the kernel's
    fixed 256-column pass computes zeros past F): exactly F channels,
    forward and backward against the plain versions, one launch."""
    pyr, coords = _pyramid_case(21, dev, dtype, B=B, hw=hw)
    coords = coords.nan_to_num(3.5)
    quantized = isinstance(pyr[0], corr_ops.QuantizedLevel)
    F, K = 96, 4 * 49
    assert lookup_encode._kpad(4, 3) == 200
    g = torch.Generator().manual_seed(22)
    w = (torch.randn(F, K, 1, 1, generator=g) / 14).to(dev)
    b = (torch.randn(F, generator=g) * 0.1).to(dev)
    w.requires_grad_(True)
    b.requires_grad_(True)
    leaves = [w, b] + ([] if quantized else list(pyr))
    cot = torch.randn((B, F, *hw), generator=g).to(dev, out_dtype)
    before = lookup_encode.LAUNCHES["lookup_encode"]
    got = lookup_encode.pyramid_lookup_encode(pyr, coords, 3, w, b,
                                              out_dtype)
    with torch.no_grad():
        want = lookup_encode.pyramid_lookup_encode_plain(pyr, coords, 3, w,
                                                         b, out_dtype)
    dgot = torch.autograd.grad(got, leaves, cot)
    dw, db, dl = lookup_encode.pyramid_lookup_encode_bwd_plain(
        pyr, coords, 3, w, got.detach(), cot)
    torch.cuda.synchronize()
    assert lookup_encode.LAUNCHES["lookup_encode"] == before + 1
    assert got.shape == (B, F, *hw) and got.is_contiguous()
    _close(got, want)
    assert float(got.float().max()) > 0
    for a, d in zip(dgot, [dw, db] + (dl or [])):
        _close(a, d)


@pytest.mark.parametrize("hw,B,dist", [((46, 62), 8, "smooth"),
                                       ((46, 62), 8, "near"),
                                       ((46, 62), 8, "spread"),
                                       ((55, 128), 1, "mixed")])
def test_corr_kernels_small_shapes_match_plain(dev, hw, B, dist):
    """The on-demand forward and backward at C = 128, radius 3 (a 7 x 7
    window): the chairs grid under three center distributions and the
    Sintel grid, against the plain versions; the shared-memory plan is
    sized for these shapes."""
    C, r = 128, 3
    f1, f2, _ = _corr_case(31, B, *hw, C, dev)
    coords = _centers(dist, B, *hw, 32, dev)
    f1.requires_grad_(True)
    pyr = [lv.contiguous().requires_grad_(True)
           for lv in pool_fmap_pyramid(f2, 4)]
    got = corr_kernels.corr_lookup_ondemand_nchw(f1, pyr, coords, r)
    with torch.no_grad():
        want = corr_kernels._plain(f1, pyr, coords, r)
    _close(got.permute(0, 2, 3, 1), want)
    gt = torch.randn(got.shape, generator=torch.Generator().manual_seed(33)
                     ).to(dev)
    dk = torch.autograd.grad(got, [f1, *pyr], gt)
    df1, df2 = corr_kernels.corr_lookup_ondemand_bwd_plain(
        f1, pyr, coords, r, gt.permute(0, 2, 3, 1))
    for a, d in zip(dk, [df1, *df2]):
        _close(a, d)
    _check_paths(dist, corr_kernels.kernel_path_counts(
        f1.detach(), [p.detach() for p in pyr], coords, r)["fwd"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gate_kernels_96_channels_match_plain(dev, dtype):
    """The four gate kernels on the small model's 96-channel halves of one
    (8, 192, 46, 62) conv output: r = zr[:, 96:] starts 96 * H * W values
    in, 16-byte aligned, so the reset-gate backward takes its vector
    path."""
    B, C, H, W = 8, 96, 46, 62
    g = torch.Generator().manual_seed(41)
    zr = (torch.randn(B, 2 * C, H, W, generator=g) * 3).to(dev, dtype)
    q = (torch.randn(B, C, H, W, generator=g) * 3).to(dev, dtype)
    h = torch.randn(B, C, H, W, generator=g).to(dev, dtype)
    g_cat = torch.randn(B, 2 * C + 146, H, W, generator=g).to(dev, dtype)
    g_rh, g_bl = g_cat[:, :C], g_cat[:, C:2 * C]
    for t in (zr, q, h):
        t.requires_grad_(True)
    z, r = torch.split(zr, C, dim=1)
    for kernel, ins in (("gru_gate_rh", (r, h)),
                        ("gru_gate_blend", (z, q, h)),
                        ("gru_gate_rh_bwd", (r, h, g_rh))):
        assert _gate_vec_bytes(kernel, ins, C, H, W, B) == 16
    before = dict(gru_gates.LAUNCHES)
    rh, bl = gru_gates.gru_gate_rh(r, h), gru_gates.gru_gate_blend(z, q, h)
    with torch.no_grad():
        _close(rh, gru_gates.gru_gate_rh_plain(r, h))
        _close(bl, gru_gates.gru_gate_blend_plain(z, q, h))
    d_rh = torch.autograd.grad(rh, (zr, h), g_rh)
    d_bl = torch.autograd.grad(bl, (zr, q, h), g_bl)
    torch.cuda.synchronize()
    assert gru_gates.LAUNCHES == {k: v + 1 for k, v in before.items()}
    want = list(gru_gates.gru_gate_rh_bwd_plain(r, h, g_rh)) + list(
        gru_gates.gru_gate_blend_bwd_plain(z, q, h, g_bl))
    got = [d_rh[0][:, C:], d_rh[1], d_bl[0][:, :C], d_bl[1], d_bl[2]]
    for a, b_ in zip(got, want):
        _close(a, b_)


def _reset_all():
    for d in (corr_kernels.LAUNCHES, gru_gates.LAUNCHES,
              pyramid_kernels.LAUNCHES, upsample_loss.LAUNCHES,
              lookup_encode.LAUNCHES):
        for key in d:
            d[key] = 0


def _all_counts():
    return {k: v for d in (corr_kernels.LAUNCHES, gru_gates.LAUNCHES,
                           pyramid_kernels.LAUNCHES, upsample_loss.LAUNCHES,
                           lookup_encode.LAUNCHES) for k, v in d.items() if v}


def test_small_model_kernel_configs_match_plain_on_the_card(dev):
    """The small model in test mode at 64x96, 3 iterations, in both kernel
    configurations against the plain one: the on-demand lookup + fused
    gates (one ConvGRU pass an iteration: 3 + 3 gate launches) and the
    pyramid lookup + fused convc1 (F = 96); no upsample-loss launch."""
    sd = RAFT(RAFTConfig.small_model()).state_dict()
    rng = np.random.default_rng(3)
    i1, i2 = (torch.from_numpy(rng.uniform(0, 255, (2, 64, 96, 3)).astype(
        np.float32)).to(dev) for _ in range(2))
    outs = {}
    for name, kw, launches in (
            ("plain", dict(corr_impl="chunked"), {}),
            ("ondemand", dict(corr_impl="pallas", fused_gru=True),
             {"corr_ondemand": 3, "gru_gate_rh": 3, "gru_gate_blend": 3}),
            ("fused", dict(corr_impl="allpairs_pallas",
                           fused_lookup_encoder=True,
                           upsample_loss_kernel="pallas"),
             {"lookup_encode": 3})):
        model = RAFT(RAFTConfig.small_model(**kw))
        model.load_state_dict(sd)
        model = model.to(dev).eval()
        _reset_all()
        with torch.no_grad():
            outs[name] = model(i1, i2, iters=3, test_mode=True)[1]
        torch.cuda.synchronize()
        assert _all_counts() == launches, name
    for name in ("ondemand", "fused"):
        assert float((outs[name] - outs["plain"]).abs().max()) <= 1e-3


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kernel_kw,plain_kw,launches", [
    (KERNEL_KW, {}, {"pyramid_lookup_fwd": 3, "pyramid_lookup_bwd": 3}),
    (ONDEMAND_KW, ONDEMAND_PLAIN_KW,
     {"corr_ondemand": 3, "corr_ondemand_bwd": 3, "gru_gate_rh": 3,
      "gru_gate_rh_bwd": 3, "gru_gate_blend": 3, "gru_gate_blend_bwd": 3})],
    ids=["kernel", "ondemand"])
def test_small_train_step_kernel_configs_match_plain(dev, dtype, kernel_kw,
                                                     plain_kw, launches):
    """One small-model train step of each kernel configuration against
    its plain one, under the bounds of the full model's; no upsample-loss
    launch (the small model has no mask head)."""
    (mk, lk, gk), (mp, lp, gp) = _train_step_both(
        dev, dtype, kernel_kw, plain_kw, mk=RAFTConfig.small_model)
    assert lk == launches and lp == {}
    (_check_fp32 if dtype == "float32" else _check_bf16)(mk, gk, mp, gp)


# ---------------------------------------------------------------------
# captured CUDA graphs (utils/graphs.py): the test-mode forward and the
# train step, against the same calls run eagerly
# ---------------------------------------------------------------------

def _frames(seed, B=2, H=48, W=64):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.uniform(0, 255, (B, H, W, 3)).astype(
        np.float32)).cuda() for _ in range(2)]


def test_graph_forward_matches_eager_bit_for_bit(dev):
    """The kernel configuration's test-mode forward with and without
    ``flow_init``, three calls each: graph outputs equal eager's bit for
    bit, one capture per key, the eager launch counts per call, results
    that survive the next call, and a weight reload that reaches the
    graph."""
    cfg = RAFTConfig.full(corr_impl="pallas", fused_gru=True)
    sd = RAFT(cfg, seed=0).state_dict()
    graph = make_eval_fn(cfg, 3)
    eager = make_eval_fn(cfg, 3, graphs=False)
    inputs = [_frames(s) for s in (1, 2, 3)]
    init = torch.randn(2, 6, 8, 2, generator=torch.Generator().manual_seed(
        4)).cuda()
    kept = []
    for im1, im2 in inputs:
        for flow_init in (None, init):
            _reset_all()
            got = graph(sd, im1, im2, flow_init)
            assert _all_counts() == {"corr_ondemand": 3, "gru_gate_rh": 6,
                                     "gru_gate_blend": 6}
            want = eager(sd, im1, im2, flow_init)
            assert all(torch.equal(g, w) for g, w in zip(got, want))
            kept.append((got, want))
    assert all(torch.equal(g, w) for got, want in kept
               for g, w in zip(got, want))
    counts = graph.captures.counts()
    assert len(counts) == 2 and set(counts.values()) == {1}
    assert eager.captures.total() == 0
    sd2 = RAFT(cfg, seed=1).state_dict()
    got = graph(sd2, *inputs[0])
    assert not torch.equal(got[1], kept[0][0][1])
    assert torch.equal(got[1], eager(sd2, *inputs[0])[1])
    assert graph.captures.total() == 2


def test_capture_survives_a_dead_graph_cycle(dev):
    """A reference cycle that holds another program's CUDA graph dies
    inside a capture, with the collector set to run at every allocation:
    no collection runs before the capture ends (destroying a graph while
    a stream captures is refused and invalidates the capture), and the
    program replays."""
    import gc

    from raft_tpu_torch.utils import graphs

    class Holder:
        def __init__(self, a):
            self.me = self
            self.prog = graphs.CapturedProgram(lambda x: x * 2, [a], [],
                                               side)

    def fn(x):
        keep.clear()                           # the cycle is dead now
        junk = [[i] for i in range(100)]       # tracked allocations
        return x * 3 + len(junk)

    side = torch.cuda.Stream()
    a = torch.arange(1024, dtype=torch.float32, device=dev)
    keep = [Holder(a)]
    threshold = gc.get_threshold()
    gc.set_threshold(1, 1, 1)
    try:
        prog = graphs.CapturedProgram(fn, [a], [], side)
    finally:
        gc.set_threshold(*threshold)
    assert torch.equal(prog([a + 1]), (a + 1) * 3 + 100)


def _graph_train_cfgs():
    from raft_tpu_torch.config import TrainConfig

    return TrainConfig(lr=1e-4, num_steps=10, batch_size=2,
                       image_size=(64, 96), iters=3)


def test_graph_train_step_matches_eager(dev):
    """Three steps of the kernel configuration captured and eager from the
    same weights (cuDNN deterministic): equal losses and parameters, one
    capture, and the eager launch counts per step."""
    from raft_tpu_torch.train.step import init_state, make_train_step

    cfg = _graph_train_cfgs()
    mcfg = RAFTConfig.full(**KERNEL_KW)
    sd = RAFT(mcfg, seed=0).state_dict()
    batches = list(_host_batches(3))
    torch.backends.cudnn.deterministic = True
    try:
        out = {}
        for graphs in (True, False):
            state = init_state(mcfg, cfg, device=dev, state_dict=sd)
            step_fn = make_train_step(cfg, device=dev, graphs=graphs)
            losses = []
            for b in batches:
                _reset_all()
                state, met = step_fn(state, b)
                assert _all_counts() == TRAIN_LAUNCHES
                losses.append(float(met["loss"]))
            out[graphs] = (losses, state.model.state_dict(),
                           state.programs.counter.total())
        assert out[True][0] == out[False][0]
        assert all(torch.equal(v, out[False][1][k])
                   for k, v in out[True][1].items())
        assert (out[True][2], out[False][2]) == (1, 0)
    finally:
        torch.backends.cudnn.deterministic = False


@pytest.mark.parametrize("graphs", [True, False])
def test_guard_reads_nothing_back_on_the_card(dev, graphs):
    """A poisoned batch under ``torch.cuda.set_sync_debug_mode("error")``
    (after the warm-up and the capture): the state stays bit for bit, the
    counter reads 1, and nothing synchronized; the next good step
    trains."""
    from raft_tpu_torch.train.step import init_state, make_train_step

    cfg = _graph_train_cfgs()
    state = init_state(RAFTConfig.full(**KERNEL_KW), cfg, device=dev)
    step_fn = make_train_step(cfg, device=dev, graphs=graphs)
    good = [{k: torch.from_numpy(v).cuda() for k, v in b.items()}
            for b in _host_batches(3)]
    bad = {k: v.clone() for k, v in good[2].items()}
    bad["image1"][1, 4, 4, 1] = float("nan")
    for b in good[:2]:
        state, _ = step_fn(state, b)
    torch.cuda.synchronize()
    params = {k: v.clone() for k, v in state.model.state_dict().items()}
    opt = [{k: v.clone() for k, v in s.items()}
           for s in state.optimizer.state.values()]
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, met = step_fn(state, bad)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert float(met["nonfinite"]) == 1.0 and int(state.nonfinite_steps) == 1
    assert all(torch.equal(v, params[k])
               for k, v in state.model.state_dict().items())
    for now, was in zip(state.optimizer.state.values(), opt):
        assert all(torch.equal(now[k], v) for k, v in was.items())
    state, met = step_fn(state, good[2])
    assert float(met["nonfinite"]) == 0.0 and state.step == 4
    assert not torch.equal(state.model.state_dict()["fnet.conv1.weight"],
                           params["fnet.conv1.weight"])


def _telemetry_records(directory):
    import json

    (f,) = directory.glob("telemetry-p*.jsonl")
    return [json.loads(line) for line in f.read_text().splitlines()]


def test_telemetry_adds_no_sync_to_the_captured_steps(dev, tmp_path):
    """``train()`` with telemetry, health, tracing at rate 1 and the
    watchdog on, the serial pipeline and ``log_freq`` beyond the run:
    the steady steps after the eager call and the capture (steps 2..5)
    run under ``torch.cuda.set_sync_debug_mode("error")``, which the batch
    iterator turns on before step 2's batch and off when asked for the
    batch after the last step."""
    from raft_tpu_torch.obs import trace
    from raft_tpu_torch.train import loop

    cfg = dataclasses.replace(_graph_train_cfgs(), num_steps=6,
                              log_freq=100, val_freq=100, device_prefetch=0,
                              trace_sample_rate=1.0, watchdog_timeout=120.0,
                              ckpt_dir=str(tmp_path / "ck"))
    seen = []

    def batches():
        for i, b in enumerate(_host_batches(cfg.num_steps)):
            if i == 2:
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")
            seen.append(i)
            yield b
        torch.cuda.set_sync_debug_mode("default")

    try:
        state = loop.train(RAFTConfig.full(**KERNEL_KW), cfg, batches(),
                           device=dev, telemetry_dir=str(tmp_path / "tel"))
    finally:
        torch.cuda.set_sync_debug_mode("default")
        trace.reset_default_tracer()
    assert state.step == 6 and seen == list(range(6))
    assert state.programs.counter.total() == 1
    recs = _telemetry_records(tmp_path / "tel")
    events = [r["event"] for r in recs]
    assert events.count("train_step") == 6 and "stall" not in events
    hbm = next(r for r in recs if r["event"] == "hbm_usage")
    assert 0 < hbm["peak_hbm_gb"] < 80
    rep = next(r for r in recs if r["event"] == "cost_report")
    assert rep["flops_per_pair"] > 0 and rep["source"] == "counted"
    roots = [r for r in recs if r["event"] == "trace_span"
             and r["name"] == "train_step"]
    assert len(roots) == 6


def test_nonfinite_batch_bundle_on_the_card(dev, tmp_path):
    """A NaN in step 3's flow on the card: its forensic bundle (the host
    batch that step consumed) and a ``nonfinite_step`` event; the
    parameters after step 3 are those after step 2, bit for bit."""
    import numpy as np

    from raft_tpu_torch.obs.health import load_forensic_bundle
    from raft_tpu_torch.train import loop

    batches = list(_host_batches(5))
    batches[3]["flow"][1, 5, 7, 0] = np.nan
    kept = []

    def grab(sd):
        kept.append({k: v.detach().clone() for k, v in sd.items()})
        return {}

    cfg = dataclasses.replace(_graph_train_cfgs(), num_steps=5, log_freq=5,
                              val_freq=1, device_prefetch=2,
                              forensic_keep=8, ckpt_dir=str(tmp_path / "ck"))
    loop.train(RAFTConfig.full(**KERNEL_KW), cfg, iter(batches),
               validators={"grab": grab}, device=dev,
               telemetry_dir=str(tmp_path / "tel"))
    assert all(torch.equal(kept[2][k], v) for k, v in kept[3].items())
    assert not all(torch.equal(kept[3][k], v) for k, v in kept[4].items())
    (path,) = (tmp_path / "tel" / "forensics").glob("*.npz")
    got, meta = load_forensic_bundle(str(path))
    assert meta["step"] == 3 and meta["batch_captured"]
    np.testing.assert_array_equal(got["flow"], batches[3]["flow"])
    assert meta["rng"]["generator_state"]
    ev = [r for r in _telemetry_records(tmp_path / "tel")
          if r["event"] == "nonfinite_step"]
    assert len(ev) == 1 and ev[0]["step"] == 3


def test_resume_into_a_captured_step(dev, tmp_path):
    """Checkpoint restores into a state whose step is captured (dropout on,
    so the registered generator is restored too), past a torn newest
    step: the next replay equals the step taken from the saved state the
    first time, bit for bit."""
    from raft_tpu_torch import chaos
    from raft_tpu_torch.train.checkpoint import CheckpointManager
    from raft_tpu_torch.train.step import init_state, make_train_step

    cfg = _graph_train_cfgs()
    mcfg = RAFTConfig.full(dropout=0.1, **KERNEL_KW)
    batches = list(_host_batches(4))
    torch.backends.cudnn.deterministic = True
    try:
        state = init_state(mcfg, cfg, device=dev)
        step_fn = make_train_step(cfg, device=dev)
        mgr = CheckpointManager(str(tmp_path / "run"))
        for b in batches[:2]:
            state, _ = step_fn(state, b)
        mgr.save(2, state)
        losses = []
        for b in batches[2:]:
            state, met = step_fn(state, b)
            losses.append(float(met["loss"]))
        want = {k: v.clone() for k, v in state.model.state_dict().items()}
        mgr.save(4, state)
        chaos.tear_files(str(tmp_path / "run" / "4"))
        mgr.restore_latest(state)
        assert state.step == 2 and state.programs.counter.total() == 1
        again = []
        for b in batches[2:]:
            state, met = step_fn(state, b)
            again.append(float(met["loss"]))
        assert again == losses
        assert all(torch.equal(v, want[k])
                   for k, v in state.model.state_dict().items())
        assert state.programs.counter.total() == 1
        mgr.close()
    finally:
        torch.backends.cudnn.deterministic = False


def test_autotune_two_point_sweep_on_the_card(dev, tmp_path):
    """``run_sweep`` of two train points on the card (the kernel
    configuration, unfused and fused gates): an entry keyed by the card's
    device kind, each point's kernels counted, the pallas pair in both,
    the gates only in the fused one, and the same sweep again a hit."""
    from raft_tpu_torch import tuning
    from raft_tpu_torch.cli import autotune

    out = str(tmp_path / "tuning.json")
    kw = dict(hw=(64, 96), batch_per_chip=2, iters=3, steps=2, warmup=2,
              time_box=600.0, seed=0, out=out, device=dev,
              grid={"corr_impl": ["allpairs_pallas"],
                    "upsample_loss_kernel": ["pallas"],
                    "fused_gru": [False, True]})
    rec = autotune.run_sweep("train", **kw)
    name = torch.cuda.get_device_name(0)
    cfg = rec["config"]
    assert cfg["key"] == f"train|{name}|64x96|b2"
    assert cfg["card"]["device_kind"] == name
    key, entry, exact = tuning.lookup("train", (64, 96), 2, device=name,
                                      path=out)
    assert exact and key == cfg["key"] and entry["device_kind"] == name
    assert len(cfg["results"]) == 2
    for r in cfg["results"]:
        n = r["launches"]
        assert r["value"] > 0 and r["reserved_gib"] is not None
        for k in ("pyramid_lookup_fwd", "pyramid_lookup_bwd",
                  "upsample_loss_fwd", "upsample_loss_bwd"):
            assert n.get(k, 0) > 0, (r["knobs"], n)
        gates = ("gru_gate_rh", "gru_gate_blend", "gru_gate_rh_bwd",
                 "gru_gate_blend_bwd")
        assert all((n.get(k, 0) > 0) == r["knobs"]["fused_gru"]
                   for k in gates), (r["knobs"], n)
    assert autotune.run_sweep("train", **kw)["config"]["cache_hit"]


def test_replay_restores_a_cuda_generator(dev, tmp_path):
    """The loop on the card with dropout on and step 2's image poisoned:
    its bundle holds the CUDA generator's state before the step.  A clean
    bundle of step 1 with that step's generator state, replayed on the
    card from the step-1 checkpoint, gives the loop's own loss at step 1
    (so the same dropout masks); the generator a step later does not; the
    poisoned bundle reproduces; the CPU refuses the CUDA generator, and
    the card's checkpoint."""
    import json
    import shutil

    from raft_tpu_torch.cli import replay_step
    from raft_tpu_torch.obs import health
    from raft_tpu_torch.train import loop
    from raft_tpu_torch.train.checkpoint import CheckpointRestoreError

    batches = list(_host_batches(3))
    batches[2]["image1"][0, 3, 4, 1] = np.inf
    states = []
    real_note = health.HealthMonitor.note_batch

    def note(self, step, host_batch, rng_state=None):
        states.append(rng_state)
        real_note(self, step, host_batch, rng_state)

    cfg = dataclasses.replace(_graph_train_cfgs(), num_steps=3, log_freq=1,
                              val_freq=1, device_prefetch=1,
                              forensic_keep=4, ckpt_dir=str(tmp_path / "ck"))
    timings = []
    health.HealthMonitor.note_batch = note
    try:
        loop.train(RAFTConfig.full(dropout=0.1, **KERNEL_KW), cfg,
                   iter(batches), device=dev, timings=timings,
                   telemetry_dir=str(tmp_path / "tel"))
    finally:
        health.HealthMonitor.note_batch = real_note
    (path,) = (tmp_path / "tel" / "forensics").glob("*.npz")
    _, meta = health.load_forensic_bundle(str(path))
    assert meta["rng"]["device"] == "cuda"
    assert len(bytes.fromhex(meta["rng"]["generator_state"])) == 16
    ck = tmp_path / "ck" / cfg.name
    step1 = tmp_path / "ck1"
    step1.mkdir()
    shutil.copytree(ck / "1", step1 / "1")
    shutil.copy(ck / "topology.json", step1)
    rep = replay_step.replay(str(path), ckpt=str(ck), device=dev)
    assert rep["reproduced"] and rep["restored_step"] == 3

    def clean(tag, rng_state):
        m = {k: v for k, v in meta.items()
             if k not in ("step", "batch_captured")}
        m["rng"] = dict(m["rng"], generator_state=bytes(rng_state).hex())
        return health.write_forensic_bundle(str(tmp_path / tag), 1,
                                            batches[1], m)

    want = float(timings[1]["loss"])
    got = replay_step.replay(clean("c1", states[1]), ckpt=str(step1),
                             device=dev)
    assert not got["reproduced"]
    assert abs(got["loss"] - want) <= 1e-4 * abs(want), (got["loss"], want)
    other = replay_step.replay(clean("c2", states[2]), ckpt=str(step1),
                               device=dev)["loss"]
    assert abs(other - want) > 1e-3 * abs(want), (other, want)
    # on the CPU: the seeded init draws no substitute mask either, and
    # the card's checkpoint (a CUDA generator's state) does not restore
    with pytest.raises(SystemExit, match="cuda generator.*runs on cpu"):
        replay_step.replay(clean("c3", states[1]), random_init=True,
                           device="cpu")
    with pytest.raises(CheckpointRestoreError,
                       match="saved on another device type"):
        replay_step.replay(clean("c4", states[1]), ckpt=str(step1),
                           device="cpu")
    assert json.dumps(rep)


def test_capture_with_the_prefetch_thread_running(dev):
    """The step captured while ``DevicePipeline``'s producer thread copies
    the next batches on its own stream (depth 2): one capture, and the
    losses of four steps equal the eager serial run's."""
    from raft_tpu_torch.data.prefetch import CudaBatchPut, DevicePipeline
    from raft_tpu_torch.train.step import init_state, make_train_step

    cfg = _graph_train_cfgs()
    mcfg = RAFTConfig.full(**KERNEL_KW)
    sd = RAFT(mcfg, seed=0).state_dict()
    host = list(_host_batches(4))
    torch.backends.cudnn.deterministic = True
    try:
        losses = {}
        for graphs, depth in ((True, 2), (False, 0)):
            put = CudaBatchPut(dev, depth + 1)
            pipe = DevicePipeline(iter(host), put_fn=put.put,
                                  ready_fn=put.ready, depth=depth)
            state = init_state(mcfg, cfg, device=dev, state_dict=sd)
            step_fn = make_train_step(cfg, device=dev, graphs=graphs)
            out = []
            for _ in host:
                state, met = step_fn(state, next(pipe))
                out.append(met["loss"])
            pipe.close()
            losses[graphs] = [float(x) for x in out]
            assert state.programs.counter.total() == int(graphs)
        assert losses[True] == losses[False], losses
    finally:
        torch.backends.cudnn.deterministic = False


@pytest.mark.parametrize("precision", ["high", "default"])
def test_corr_precision_runs_tf32_on_the_card(dev, precision):
    """``corr_precision`` 'high' / 'default' run the all-pairs product and
    its backward in TF32: close to 'highest' (TF32's 10-bit mantissa),
    not equal to it, and the process's cuBLAS TF32 flag is as it was."""
    g = torch.Generator().manual_seed(5)
    f1, f2 = (torch.randn(2, 12, 16, 256, generator=g).to(dev)
              .requires_grad_(True) for _ in range(2))
    out = {}
    for prec in ("highest", precision):
        corr = corr_ops.all_pairs_correlation(f1, f2, prec)
        g1, g2 = torch.autograd.grad(corr.square().sum(), (f1, f2))
        out[prec] = (corr.detach(), g1, g2)
    assert torch.backends.cuda.matmul.allow_tf32 is False
    for want, got in zip(out["highest"], out[precision]):
        scale = float(want.abs().max())
        err = float((got - want).abs().max())
        assert 0 < err <= 1e-2 * scale, (err, scale)


def test_graph_caches_do_not_grow_memory(dev):
    """Three train states and three ``allpairs`` eval functions, each
    through its graph and then dropped: the allocated memory after each is
    the same.  (cuBLAS keeps a workspace for every stream it ran on, so
    the caches share one side stream per device.)"""
    import gc

    from raft_tpu_torch.train.step import init_state, make_train_step

    cfg = _graph_train_cfgs()
    batch = next(_host_batches(1))
    sd = RAFT(RAFTConfig.full(), seed=0).state_dict()
    frames = _frames(9, H=64, W=96)
    after = []
    for _ in range(3):
        state = init_state(RAFTConfig.full(**KERNEL_KW), cfg, device=dev)
        step_fn = make_train_step(cfg, device=dev)
        fn = make_eval_fn(RAFTConfig.full(), 2)
        for _ in range(3):
            step_fn(state, batch)
            fn(sd, *frames)
        assert state.programs.counter.total() == fn.captures.total() == 1
        del state, step_fn, fn
        gc.collect()
        torch.cuda.synchronize()
        after.append(torch.cuda.memory_allocated())
    assert after[0] == after[1] == after[2], after


# --- the serving engine on the card ------------------------------------


def _serve_pairs(n, hw=(60, 92), seed=0):
    rng = np.random.default_rng(seed)
    return [tuple(rng.uniform(0, 255, hw + (3,)).astype(np.float32)
                  for _ in range(2)) for _ in range(n)]


@pytest.mark.parametrize("cfg_kw,launches", [
    ({}, {}),
    ({"corr_impl": "pallas", "fused_gru": True},
     {"corr_ondemand": 1, "gru_gate_rh": 2, "gru_gate_blend": 2})])
def test_serve_slot_matches_request_on_the_card(dev, cfg_kw, launches):
    """fp32, 4 lanes, 6 iterations: request mode within the fp32 bound of
    ``make_eval_fn``; slot mode with staggered arrivals bit for bit
    request mode; one capture a program; an ``iter`` replay launches
    exactly the configuration's kernels, ``enc`` and ``up`` none."""
    from raft_tpu_torch import ops
    from raft_tpu_torch.ops.pad import InputPadder
    from raft_tpu_torch.serve import InferenceEngine, ServeConfig

    cfg = RAFTConfig.full(**cfg_kw)
    sd = RAFT(RAFTConfig.full(), seed=0).state_dict()
    pairs = _serve_pairs(4)
    req = InferenceEngine(sd, cfg, ServeConfig(
        iters=6, max_batch=4, batch_sizes=(4,), max_wait_ms=200)).start()
    req.warmup([(60, 92)])
    want = [f.result(120) for f in [req.submit(a, b) for a, b in pairs]]
    progs = req._get_programs((64, 96), 4)
    zeros = np.zeros((4, 64, 96, 3), np.float32)
    for name, fn in (("enc", lambda: progs.encode(
            zeros, zeros, progs.admit_none, np.zeros(4, np.int32))),
            ("iter", lambda: progs.iterate(0.0)),
            ("up", progs.upsample)):
        before = ops.launch_counts()
        req._device_pool.submit(fn).result()
        after = ops.launch_counts()
        got = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        assert got == (launches if name == "iter" else {}), (name, got)
    assert set(req.capture_counter.counts().values()) == {1}
    req.stop()
    pad = InputPadder((60, 92), target=(64, 96))
    _, up = make_eval_fn(cfg, 6)(sd, np.stack([pad.pad_np(a) for a, _ in
                                               pairs]),
                                 np.stack([pad.pad_np(b) for _, b in pairs]))
    for j, w in enumerate(want):
        np.testing.assert_allclose(w, pad.unpad(up[j].cpu().numpy()),
                                   rtol=1e-4, atol=1e-3)
    slot = InferenceEngine(sd, cfg, ServeConfig(
        iters=6, batching="slot", slots=4)).start()
    first = slot.submit(*pairs[0])
    rest = [slot.submit(*p) for p in pairs[1:]]
    got = [first.result(120)] + [f.result(120) for f in rest]
    assert set(slot.capture_counter.counts().values()) == {1}
    slot.stop()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_serve_stream_and_retry_on_the_card(dev):
    """An 8-frame session: the first pair bit for bit a stateless request,
    the rest warm and finite, 8 / 7 / 6; an injected ``device_err``
    retried to the same bits; ``forward_warp_flow`` repeats bit for bit
    and matches the CPU's."""
    from raft_tpu_torch import chaos
    from raft_tpu_torch.ops.sampler import forward_warp_flow
    from raft_tpu_torch.serve import InferenceEngine, ServeConfig

    flow = torch.randn(2, 8, 12, 2, generator=torch.Generator(
        ).manual_seed(0)) * 4
    a, b = forward_warp_flow(flow.to(dev)), forward_warp_flow(flow.to(dev))
    assert torch.equal(a, b)
    torch.testing.assert_close(a.cpu(), forward_warp_flow(flow),
                               rtol=0, atol=1e-5)
    sd = RAFT(RAFTConfig.small_model(), seed=0).state_dict()
    frames = [f for p in _serve_pairs(4, seed=3) for f in p]
    eng = InferenceEngine(sd, RAFTConfig.small_model(), ServeConfig(
        iters=4, batching="slot", slots=2, retry_backoff_s=0.0,
        retry_jitter=0.0)).start()
    try:
        ref = eng.infer(frames[0], frames[1], timeout=120)
        chaos.install(chaos.FaultPlan.parse(
            f"device_err@batch={eng._batch_seq + 3}"))
        try:
            assert np.array_equal(eng.infer(frames[0], frames[1],
                                            timeout=120), ref)
        finally:
            chaos.uninstall()
        assert eng.stats()["retries"] == 1
        eng.stream_open("s", frames[0])
        outs = [eng.stream_ingest("s", f, timeout=120) for f in frames[1:]]
        assert eng.stream_close("s") == {"session": "s", "frames": 8,
                                         "pairs": 7, "warm_pairs": 6}
    finally:
        eng.stop()
    np.testing.assert_array_equal(outs[0]["flow"], ref)
    assert [o["warm"] for o in outs] == [False] + [True] * 6
    assert all(np.isfinite(o["flow"]).all() for o in outs)


def test_serve_tracing_adds_no_sync_to_replayed_slot_cycles(dev):
    """Slot mode, the kernel configuration, every program captured: the
    same requests one after another with tracing off, at rate 1 (each
    under a root span), and off again.  Under
    ``torch.cuda.set_sync_debug_mode("warn")`` every synchronization is
    counted by the source line that made it: the engine's own (the
    pageable input copies of an admission, the status read a cycle, the
    upsample read at retirement; ``"error"`` would stop the cycle
    itself).  The traced arm makes none that an untraced arm does not
    make as often, and none from the tracing or cost modules: spans,
    the cost book's observation and the MFU add no sync.  It records an
    ``iter_step`` an iteration, with an MFU."""
    import collections
    import os
    import warnings

    from raft_tpu_torch.obs import trace
    from raft_tpu_torch.serve import InferenceEngine, ServeConfig

    class Sink:
        def __init__(self):
            self.spans = []

        def emit(self, event, **fields):
            self.spans.append(fields)

    cfg = RAFTConfig.full(corr_impl="pallas", fused_gru=True)
    sd = RAFT(RAFTConfig.full(), seed=0).state_dict()
    pairs = _serve_pairs(2)
    eng = InferenceEngine(sd, cfg, ServeConfig(
        iters=4, batching="slot", slots=2)).start()
    sink = Sink()
    tracer = trace.Tracer(sink=sink, sample_rate=1.0)
    try:
        eng.warmup([(60, 92)])
        eng.infer(*pairs[0], timeout=120)
        torch.cuda.synchronize()
        syncs = {}
        for arm in ("off", "on", "off_again"):
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    for a, b in pairs:
                        root = (tracer.start_trace("req") if arm == "on"
                                else trace.NOOP_SPAN)
                        with trace.use_context(root):
                            fut = eng.submit(a, b)
                        fut.result(timeout=120)
                        root.end()
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            syncs[arm] = collections.Counter(
                (os.path.basename(w.filename), w.lineno) for w in caught
                if "synchroniz" in str(w.message))
        captures = eng.capture_counter.counts()
    finally:
        eng.stop()
    assert set(captures.values()) == {1}
    assert syncs["on"] and syncs["off"], syncs
    for where, n in syncs["on"].items():
        assert where[0] not in ("trace.py", "cost.py"), syncs
        assert n <= max(syncs["off"][where], syncs["off_again"][where]), \
            syncs
    iters = [r for r in sink.spans if r["name"] == "iter_step"]
    assert len(iters) == 2 * 4
    assert all(0 < r["mfu"] < 1 and r["flops"] > 0 for r in iters)


# --- the serving fleet's engines on the card -------------------------------


def test_serve_manifest_replay_on_the_card(dev, tmp_path):
    """An engine built with a warm-start manifest captures its keys in
    ``start()``: its first request captures nothing, and its flows are
    the writer's bits (both on the shared device worker)."""
    from raft_tpu_torch.serve import InferenceEngine, ServeConfig

    cfg = RAFTConfig.full(corr_impl="pallas", fused_gru=True)
    sd = RAFT(RAFTConfig.full(), seed=0).state_dict()
    pairs = _serve_pairs(2)
    scfg = ServeConfig(iters=4, max_batch=2, batch_sizes=(2,),
                       max_wait_ms=5)
    writer = InferenceEngine(sd, cfg, scfg).start()
    try:
        writer.warmup([(60, 92)])
        writer.export_aot(str(tmp_path))
        want = [writer.infer(a, b, timeout=120) for a, b in pairs]
    finally:
        writer.stop()
    reader = InferenceEngine(sd, cfg, dataclasses.replace(
        scfg, aot_dir=str(tmp_path))).start()
    try:
        assert reader.aot_info["ok"] and reader.aot_info["replayed"] == 3
        at_start = reader.capture_counter.counts()
        assert set(at_start.values()) == {1} and len(at_start) == 3
        got = [reader.infer(a, b, timeout=120) for a, b in pairs]
        assert reader.capture_counter.counts() == at_start
    finally:
        reader.stop()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_serve_slow_engine_spares_its_sibling_on_the_card(dev):
    """Two engines share the card's device worker; ``replica_slow`` on one
    sleeps on its own host thread, so the other's requests finish well
    inside the slow time and its ``health()`` stays ready."""
    import time

    from raft_tpu_torch import chaos
    from raft_tpu_torch.serve import InferenceEngine, ServeConfig

    cfg = RAFTConfig.small_model()
    sd = RAFT(cfg, seed=0).state_dict()
    scfg = ServeConfig(iters=4, max_batch=1, batch_sizes=(1,),
                       max_wait_ms=1, chaos_slow_s=2.0, stall_timeout_s=1.0)
    slow = InferenceEngine(sd, cfg, scfg).start()
    fast = InferenceEngine(sd, cfg, scfg).start()
    pairs = _serve_pairs(4, seed=5)
    try:
        for eng in (slow, fast):
            eng.warmup([(60, 92)])
        chaos.install(chaos.FaultPlan.parse(
            f"replica_slow@batch={slow._batch_seq + 1}"))
        t0 = time.perf_counter()
        held = slow.submit(*pairs[0])
        time.sleep(0.1)
        futs = [fast.submit(a, b) for a, b in pairs]
        ready = []
        while not all(f.done() for f in futs):
            ready.append(fast.health()["ready"])
            time.sleep(0.005)
        dt = time.perf_counter() - t0
        assert all(np.isfinite(f.result()).all() for f in futs)
        assert dt < 1.0 and all(ready) and not held.done(), dt
        assert np.isfinite(held.result(timeout=60)).all()
    finally:
        chaos.uninstall()
        slow.stop()
        fast.stop()


# --- data parallel (raft_tpu_torch/parallel, the train step's all-reduce) --

def test_ddp_world_one_nccl_step_is_the_plain_captured_step(dev,
                                                           monkeypatch):
    """A mesh of one NCCL rank: three captured steps of the kernel
    configuration, the all-reduce inside the graph, bit for bit the plain
    captured step (cuDNN deterministic); one capture each and the eager
    launch counts per step."""
    import socket

    from raft_tpu_torch.parallel import init_from_env, shutdown
    from raft_tpu_torch.train.step import init_state, make_train_step

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    for k, v in dict(RANK=0, WORLD_SIZE=1, LOCAL_RANK=0,
                     MASTER_ADDR="localhost", MASTER_PORT=port).items():
        monkeypatch.setenv(k, str(v))
    cfg = _graph_train_cfgs()
    mcfg = RAFTConfig.full(**KERNEL_KW)
    sd = RAFT(mcfg, seed=0).state_dict()
    batches = list(_host_batches(3))
    mesh = init_from_env("cuda")
    torch.backends.cudnn.deterministic = True
    try:
        assert (mesh.backend, mesh.world) == ("nccl", 1)
        out = {}
        for m in (None, mesh):
            state = init_state(mcfg, cfg, device=dev, state_dict=sd)
            step_fn = make_train_step(cfg, device=dev, mesh=m)
            losses = []
            for b in batches:
                _reset_all()
                state, met = step_fn(state, b)
                assert _all_counts() == TRAIN_LAUNCHES
                losses.append(float(met["loss"]))
            out[m is None] = (losses, state.model.state_dict(),
                              state.programs.counter.total())
        assert out[True][0] == out[False][0]
        assert all(torch.equal(v, out[False][1][k])
                   for k, v in out[True][1].items())
        assert (out[True][2], out[False][2]) == (1, 1)
    finally:
        torch.backends.cudnn.deterministic = False
        shutdown()


def test_ddp_two_gloo_ranks_share_the_card(dev, tmp_path):
    """Two gloo ranks on the one card (``tests/_torch_ddp_child.py
    ... cuda``), the kernel configuration (pyramid lookup, upsample loss,
    fused gates), 2 pairs a rank at 32x48: the ranks bit for bit each
    other, every kernel counted on each rank each step, and two steps
    against the straight eager run on the global batch of 4 (fp32, TF32
    off): loss and metrics rtol 1e-4, batch-norm statistics within 1e-5
    plus 1e-4 relative; per parameter by norm
    (``_torch_ddp_child.leaf_agreement``, the straight run's twin on the
    reversed rows as the noise floor) the global gradient (Adam's first
    moment after step 1) within rtol 1e-4 and 1e-5 of the global norm,
    each step's change within rtol 1e-2 and 2e-3 of the global change,
    and twice the change or none outside that bound."""
    import os
    import socket
    import subprocess
    import sys
    import time

    from raft_tpu_torch.config import TrainConfig
    from raft_tpu_torch.train.step import init_state, make_train_step

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, os.path.join(repo, "tests"))
    import _torch_ddp_child as child

    b, world = child.B, 2
    sd = RAFT(RAFTConfig.full(), seed=0).state_dict()
    weights = str(tmp_path / "w.pt")
    torch.save(sd, weights)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=repo)
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(repo, "tests", "_torch_ddp_child.py"),
         str(tmp_path), weights, str(r), str(world), str(port), "cuda"],
        cwd=repo, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]
    try:
        # a rank that fails leaves its peer waiting in a collective
        deadline = time.monotonic() + 300
        while any(p.poll() is None for p in procs):
            assert all(p.poll() in (None, 0) for p in procs) and \
                time.monotonic() < deadline, \
                [p.poll() for p in procs]
            time.sleep(0.2)
        for p in procs:
            out, _ = p.communicate()
            assert p.returncode == 0, out[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    ranks = [torch.load(str(tmp_path / f"rank{r}.pt"), weights_only=False)
             for r in range(world)]
    (s0, m0, l0), (s1, _, l1) = ranks[0]["split"], ranks[1]["split"]
    for a, c in zip(s0, s1):
        assert all(torch.equal(a["model"][k], c["model"][k])
                   for k in a["model"])
    per_step = {"pyramid_lookup_fwd": 2, "pyramid_lookup_bwd": 2,
                "upsample_loss_fwd": 1, "upsample_loss_bwd": 1,
                "gru_gate_rh": 4, "gru_gate_rh_bwd": 4,
                "gru_gate_blend": 4, "gru_gate_blend_bwd": 4}
    assert l0 == l1 == [per_step] * 2

    cfg = TrainConfig(batch_size=world * b, **child.TRAIN_KW)
    straight = {}
    for label, order in (("straight", slice(None)),
                         ("reversed", slice(None, None, -1))):
        state = init_state(RAFTConfig.full(**child.CUDA_KW), cfg,
                           device=dev, state_dict=sd)
        step_fn = make_train_step(cfg, device=dev, graphs=False)
        snaps, mets = [], []
        for seed in (0, 1):
            batch = {k: v[order].copy() for k, v in
                     child.global_batch(seed, world, b).items()}
            state, met = step_fn(state, batch)
            snaps.append(child.snapshot(state))
            mets.append({k: v.cpu() for k, v in met.items()})
        straight[label] = (snaps, mets)
    (want, wmets), (twin, _) = straight["straight"], straight["reversed"]
    names = child.param_names()
    for i in range(2):
        for k in ("loss", "epe", "1px", "3px", "5px", "loss_iter",
                  "epe_iter"):
            np.testing.assert_allclose(m0[i][k].numpy(), wmets[i][k].numpy(),
                                       rtol=1e-4, atol=1e-7, err_msg=k)
        for k, v in want[i]["model"].items():
            if "running" in k:
                np.testing.assert_allclose(
                    s0[i]["model"][k].numpy(), v.numpy(), rtol=1e-4,
                    atol=1e-5, err_msg=f"step {i}: {k}")
    checks = [(child.first_moments(s0[0], names),
               child.first_moments(want[0], names),
               child.first_moments(twin[0], names), (1e-4, 1e-5))]
    checks += [(child.changes(s0[i]["model"], sd, names),
                child.changes(want[i]["model"], sd, names),
                child.changes(twin[i]["model"], sd, names), (1e-2, 2e-3))
               for i in range(2)]
    for got, ref, other, tol in checks:
        noise = child.noise_of(other, ref)
        ratio, name = child.leaf_agreement(got, ref, *tol, noise=noise)
        assert ratio <= 1.0, (name, ratio)
        for wrong in (2.0, 0.0):
            assert child.leaf_agreement(
                {n: wrong * v for n, v in ref.items()}, ref, *tol,
                noise=noise)[0] > 1.0


def test_spatial_two_gloo_ranks_share_the_card(dev, tmp_path):
    """Two gloo ranks on the one card split each image's rows
    (``tests/_torch_spatial_child.py ... cuda``: ``data 1 x spatial 2``),
    the kernel configuration (pyramid lookup on local queries, the halo
    form of the upsample-loss kernels, fused gates), 2 pairs at 32x48:
    the ranks bit for bit each other, every kernel counted on each rank
    each step, and two steps against the straight eager run on the same
    2 pairs (fp32, TF32 off), with the bounds of the data-parallel test
    above.  The noise floor of each parameter is the larger of the
    straight run's differences from its twin on the reversed rows and
    from its twin that sums instance norm's moments over the two row
    shards (``chip_smoke.instance_norm_over_row_shards``, the
    sharded step's order): with these weights several gradients are
    sums that cancel to a small part of their terms, and that
    reordering alone moves ``fnet``'s by ~1.2% (the CPU test holds the
    sharded encoder to the whole image's in fp64,
    ``tests/test_torch_spatial.py``).  The first step again with
    ``remat`` (``full``) and ``remat_upsample``, whose recompute runs on
    autograd's device thread, gives each rank the gradient of the step
    without remat (rtol 1e-4, floor 1e-5 of the global norm)."""
    import os
    import socket
    import subprocess
    import sys
    import time

    from raft_tpu_torch.config import TrainConfig
    from raft_tpu_torch.train.step import init_state, make_train_step

    import contextlib

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, os.path.join(repo, "tests"))
    import _torch_ddp_child as ddp
    import _torch_spatial_child as child

    sd = RAFT(RAFTConfig.full(), seed=0).state_dict()
    weights = str(tmp_path / "w.pt")
    torch.save(sd, weights)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=repo)
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(repo, "tests",
                                      "_torch_spatial_child.py"),
         str(tmp_path), weights, str(r), "2", str(port), "cuda"],
        cwd=repo, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(2)]
    try:
        deadline = time.monotonic() + 300
        while any(p.poll() is None for p in procs):
            assert all(p.poll() in (None, 0) for p in procs) and \
                time.monotonic() < deadline, \
                [p.poll() for p in procs]
            time.sleep(0.2)
        for p in procs:
            out, _ = p.communicate()
            assert p.returncode == 0, out[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    ranks = [torch.load(str(tmp_path / f"rank{r}.pt"), weights_only=False)
             for r in range(2)]
    assert ranks[0]["mesh_shape"] == {"data": 1, "spatial": 2}
    (s0, m0, l0), (s1, _, l1) = ranks[0]["split"], ranks[1]["split"]
    for a, c in zip(s0, s1):
        assert all(torch.equal(a["model"][k], c["model"][k])
                   for k in a["model"])
    per_step = {"pyramid_lookup_fwd": 2, "pyramid_lookup_bwd": 2,
                "upsample_loss_fwd": 1, "upsample_loss_bwd": 1,
                "gru_gate_rh": 4, "gru_gate_rh_bwd": 4,
                "gru_gate_blend": 4, "gru_gate_blend_bwd": 4}
    assert l0 == l1 == [per_step] * 2
    # remat: the first step with every region recomputed in backward, on
    # autograd's device thread, gives the same gradient as without
    names = ddp.param_names()
    for r in ranks:
        ratio, name = ddp.leaf_agreement(
            ddp.first_moments(r["split_remat"][0][0], names),
            ddp.first_moments(r["split"][0][0], names), 1e-4, 1e-5)
        assert ratio <= 1.0, ("remat", name, ratio)

    cfg = TrainConfig(batch_size=child.B, **ddp.TRAIN_KW)
    straight = {}
    for label, order, shards in (("straight", slice(None), False),
                                 ("reversed", slice(None, None, -1), False),
                                 ("row_shards", slice(None), True)):
        state = init_state(RAFTConfig.full(**child.CUDA_KW), cfg,
                           device=dev, state_dict=sd)
        step_fn = make_train_step(cfg, device=dev, graphs=False)
        snaps, mets = [], []
        with (child.instance_norm_over_row_shards() if shards
              else contextlib.nullcontext()):
            for seed in (0, 1):
                batch = {k: v[order].copy() for k, v in
                         ddp.global_batch(seed, 1).items()}
                state, met = step_fn(state, batch)
                snaps.append(ddp.snapshot(state))
                mets.append({k: v.cpu() for k, v in met.items()})
        straight[label] = (snaps, mets)
    want, wmets = straight["straight"]
    twins = [straight["reversed"][0], straight["row_shards"][0]]
    for i in range(2):
        for k in ("loss", "epe", "1px", "3px", "5px", "loss_iter",
                  "epe_iter"):
            np.testing.assert_allclose(m0[i][k].numpy(), wmets[i][k].numpy(),
                                       rtol=1e-4, atol=1e-7, err_msg=k)
        for k, v in want[i]["model"].items():
            if "running" in k:
                np.testing.assert_allclose(
                    s0[i]["model"][k].numpy(), v.numpy(), rtol=1e-4,
                    atol=1e-5, err_msg=f"step {i}: {k}")
    checks = [(ddp.first_moments(s0[0], names),
               ddp.first_moments(want[0], names),
               [ddp.first_moments(t[0], names) for t in twins],
               (1e-4, 1e-5))]
    checks += [(ddp.changes(s0[i]["model"], sd, names),
                ddp.changes(want[i]["model"], sd, names),
                [ddp.changes(t[i]["model"], sd, names) for t in twins],
                (1e-2, 2e-3)) for i in range(2)]
    for got, ref, others, tol in checks:
        noises = [ddp.noise_of(o, ref) for o in others]
        noise = {n: max(x[n] for x in noises) for n in ref}
        ratio, name = ddp.leaf_agreement(got, ref, *tol, noise=noise)
        assert ratio <= 1.0, (name, ratio)
        for wrong in (2.0, 0.0):
            assert ddp.leaf_agreement(
                {n: wrong * v for n, v in ref.items()}, ref, *tol,
                noise=noise)[0] > 1.0
