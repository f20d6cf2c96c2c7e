"""The port's native host library and augmentors against the JAX
package's.

- ``FlowAugmentor`` and ``SparseFlowAugmentor``: the port's native path
  against JAX's native path, and the port's NumPy / cv2 fallback against
  JAX's fallback, bit for bit over 8 seeds each (the same C source and
  the same cv2 calls, the generator consumed in the same order);
- twins of ``tests/test_native_aug.py`` on the port's library, under that
  file's tolerances (the C ops against cv2 / NumPy);
- the PNG row filter: rows of all five filter types decoded by the C
  filter and by the NumPy fallback, each bit-equal to JAX's decoder;
- the library's build: keyed by a source hash under
  ``build/raft_tpu_torch/``, the environment switch of the augmentors.
"""

import os

import numpy as np
import pytest

from raft_tpu.data import augment as JA
from raft_tpu.data import png16 as jpng
from raft_tpu.native.build import load as jax_native
from raft_tpu_torch.data import augment as A
from raft_tpu_torch.data import png16 as tpng
from raft_tpu_torch.native import build

from test_torch_frame_utils import _encode_filtered

JAX_SWITCH = "RAFT_TPU_NO_NATIVE_AUG"


@pytest.fixture
def lib():
    lib = build.load()
    if lib is None or jax_native() is None:
        pytest.skip(f"native library unavailable: {build.status()}")
    return lib


@pytest.fixture
def fallback(monkeypatch):
    """Both packages' augmentors on their NumPy / cv2 fallback."""
    monkeypatch.setenv(build.NO_NATIVE_AUG_ENV, "1")
    monkeypatch.setenv(JAX_SWITCH, "1")


def _rand_imgs(seed=0, h=120, w=160):
    rng = np.random.default_rng(seed)
    img1 = rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
    img2 = rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
    flow = (rng.standard_normal((h, w, 2)) * 5).astype(np.float32)
    return img1, img2, flow


def _fallback(fn, *args, **kw):
    os.environ[build.NO_NATIVE_AUG_ENV] = "1"
    try:
        return fn(*args, **kw)
    finally:
        del os.environ[build.NO_NATIVE_AUG_ENV]


def _bit_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# the port against the JAX package, per backend
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(8))
def test_dense_augmentor_matches_jax_native(lib, seed):
    img1, img2, flow = _rand_imgs(h=160, w=200)
    kw = dict(crop_size=(96, 128), min_scale=-0.2, max_scale=0.6)
    _bit_equal(A.FlowAugmentor(**kw)(np.random.default_rng(seed),
                                     img1, img2, flow),
               JA.FlowAugmentor(**kw)(np.random.default_rng(seed),
                                      img1, img2, flow))


@pytest.mark.parametrize("seed", range(8))
def test_dense_augmentor_matches_jax_fallback(fallback, seed):
    img1, img2, flow = _rand_imgs(h=160, w=200)
    kw = dict(crop_size=(96, 128), min_scale=-0.2, max_scale=0.6)
    _bit_equal(A.FlowAugmentor(**kw)(np.random.default_rng(seed),
                                     img1, img2, flow),
               JA.FlowAugmentor(**kw)(np.random.default_rng(seed),
                                      img1, img2, flow))


def _sparse_case():
    img1, img2, flow = _rand_imgs(h=160, w=200)
    valid = (np.random.default_rng(1).random((160, 200)) < 0.4) \
        .astype(np.float32)
    return img1, img2, flow, valid


@pytest.mark.parametrize("seed", range(8))
def test_sparse_augmentor_matches_jax_native(lib, seed):
    case = _sparse_case()
    kw = dict(crop_size=(96, 128), do_flip=True)
    _bit_equal(A.SparseFlowAugmentor(**kw)(np.random.default_rng(seed),
                                           *case),
               JA.SparseFlowAugmentor(**kw)(np.random.default_rng(seed),
                                            *case))


@pytest.mark.parametrize("seed", range(8))
def test_sparse_augmentor_matches_jax_fallback(fallback, seed):
    case = _sparse_case()
    kw = dict(crop_size=(96, 128), do_flip=True)
    _bit_equal(A.SparseFlowAugmentor(**kw)(np.random.default_rng(seed),
                                           *case),
               JA.SparseFlowAugmentor(**kw)(np.random.default_rng(seed),
                                            *case))


def test_resize_sparse_flow_map_matches_jax():
    img1, img2, flow, valid = _sparse_case()
    for fx, fy in ((0.7, 0.7), (1.3, 1.3), (1.0, 1.0)):
        _bit_equal(A.resize_sparse_flow_map(flow, valid, fx, fy),
                   JA.resize_sparse_flow_map(flow, valid, fx, fy))


# ---------------------------------------------------------------------------
# twins of tests/test_native_aug.py on the port's library
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sx,sy,hflip,vflip", [
    (1.0, 1.0, False, False),   # pure crop must be exact
    (1.0, 1.0, True, True),     # pure flip+crop must be exact
    (0.7, 0.9, False, False),
    (1.4, 1.2, True, False),
    (2.0, 0.6, False, True),
    (0.73, 1.17, True, False),  # cvRound-based output size
])
def test_warp_u8_matches_cv2(lib, sx, sy, hflip, vflip):
    import cv2

    img = _rand_imgs()[0]
    if sx == 1.0 and sy == 1.0:
        ref = img
    else:
        ref = cv2.resize(img, None, fx=sx, fy=sy,
                         interpolation=cv2.INTER_LINEAR)
    if hflip:
        ref = ref[:, ::-1]
    if vflip:
        ref = ref[::-1, :]
    rh, rw = ref.shape[:2]
    y0, x0 = 3, 5
    crop = (rh - 7, rw - 9)
    ref = ref[y0:y0 + crop[0], x0:x0 + crop[1]]

    got = A._warp_native(lib, img, crop, sx, sy, rh, rw, hflip, vflip,
                         x0, y0)
    diff = np.abs(got.astype(np.int16) - ref.astype(np.int16))
    if sx == 1.0 and sy == 1.0:
        assert diff.max() == 0  # integer coordinates: exact
    else:
        assert diff.max() <= 1  # cv2's fixed point against float


def test_warp_f32_chan_scale_and_flip_sign(lib):
    import cv2

    flow = _rand_imgs()[2]
    sx, sy = 1.3, 0.8
    ref = cv2.resize(flow, None, fx=sx, fy=sy,
                     interpolation=cv2.INTER_LINEAR) * [sx, sy]
    ref = ref[:, ::-1] * [-1.0, 1.0]
    rh, rw = ref.shape[:2]
    crop = (rh - 4, rw - 6)
    ref = ref[2:2 + crop[0], 1:1 + crop[1]]
    cs = np.array([-sx, sy], np.float32)
    got = A._warp_native(lib, flow, crop, sx, sy, rh, rw, True, False,
                         1, 2, cs)
    assert np.allclose(got, ref, atol=2e-3)


def test_color_ops_match_numpy(lib):
    img = _rand_imgs()[0]
    for fn, arg in [(A._adjust_brightness, 1.37),
                    (A._adjust_brightness, 0.62),
                    (A._adjust_contrast, 0.73),
                    (A._adjust_contrast, 1.31),
                    (A._adjust_saturation, 1.21),
                    (A._adjust_saturation, 0.4)]:
        native = fn(img, arg)
        ref = _fallback(fn, img, arg)
        diff = np.abs(native.astype(np.int16) - ref.astype(np.int16))
        assert diff.max() <= 1, (fn.__name__, arg, diff.max())
        if fn is not A._adjust_saturation:   # the same float math
            assert diff.max() == 0, (fn.__name__, arg)


def test_dense_pipeline_parity_same_seed(lib):
    img1, img2, flow = _rand_imgs(h=160, w=200)
    aug = A.FlowAugmentor(crop_size=(96, 128), min_scale=-0.2,
                          max_scale=0.6)
    for seed in range(8):
        n1, n2, nf = aug(np.random.default_rng(seed), img1, img2, flow)
        c1, c2, cf = _fallback(aug, np.random.default_rng(seed),
                               img1, img2, flow)
        assert n1.shape == c1.shape and nf.shape == cf.shape
        # photometric rounding compounds through up to 4 ops: bound the
        # share of pixels more than one level off, not the maximum
        d = np.abs(n1.astype(np.int16) - c1.astype(np.int16))
        assert (d > 1).mean() < 0.01 and d.mean() < 0.5
        scale = max(1.0, float(np.abs(cf).max()))
        assert np.abs(nf - cf).max() <= 0.005 * scale


def test_sparse_pipeline_parity_same_seed(lib):
    img1, img2, flow, valid = _sparse_case()
    aug = A.SparseFlowAugmentor(crop_size=(96, 128))
    for seed in range(8):
        n = aug(np.random.default_rng(seed), img1, img2, flow, valid)
        c = _fallback(aug, np.random.default_rng(seed),
                      img1, img2, flow, valid)
        d = np.abs(n[0].astype(np.int16) - c[0].astype(np.int16))
        assert (d > 1).mean() < 0.01
        # the sparse flow and valid mask take the same NumPy scatter
        np.testing.assert_array_equal(n[2], c[2])
        np.testing.assert_array_equal(n[3], c[3])


def test_dense_augmentor_exact_crop_size(lib):
    """Images exactly crop-sized must not crash when the no-resize branch
    is drawn; every output has the crop's shape."""
    img1, img2, flow = _rand_imgs(h=96, w=128)
    aug = A.FlowAugmentor(crop_size=(96, 128))
    for seed in range(40):
        for run in (aug, lambda *a: _fallback(aug, *a)):
            o1, o2, of = run(np.random.default_rng(seed), img1, img2, flow)
            assert o1.shape == (96, 128, 3) and of.shape == (96, 128, 2)


def test_hue_shift_matches_cv2(lib):
    """The fused RGB->HSV->shift->RGB against cv2's two conversions:
    within one level everywhere, off by one on a minority of pixels."""
    import cv2

    rng = np.random.default_rng(5)
    img = rng.integers(0, 255, (80, 120, 3), dtype=np.uint8)
    for shift in (-0.12, 0.0, 0.07, 0.159):
        got = np.array(img)
        lib.aug_hue_shift(got.ctypes.data, got.size // 3,
                          int(round(shift * 180.0)))
        hsv = cv2.cvtColor(img, cv2.COLOR_RGB2HSV)
        h = (hsv[..., 0].astype(np.int16) + int(round(shift * 180.0))) % 180
        hsv[..., 0] = h.astype(np.uint8)
        want = cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB)
        d = np.abs(got.astype(np.int16) - want.astype(np.int16))
        assert d.max() <= 1 and (d > 0).mean() < 0.15


def test_eraser_matches_numpy(lib):
    """The C channel sums and rectangle fill against the NumPy eraser
    under the same generator stream (the same truncating mean)."""
    img1, img2, _ = _rand_imgs(seed=7)
    aug = A.FlowAugmentor(crop_size=(64, 96), eraser_aug_prob=1.0)
    _, got = aug.eraser_transform(np.random.default_rng(3), img1, img2)
    _, want = _fallback(aug.eraser_transform, np.random.default_rng(3),
                        img1, img2)
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert d.max() <= 1  # float64 sum order can flip the truncated mean
    assert (d > 0).mean() < 0.5


# ---------------------------------------------------------------------------
# the PNG row filter, and the build
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["native", "numpy"])
@pytest.mark.parametrize("ftypes", [(0, 1, 2, 3, 4, 4, 3, 2, 1), (4,), (3,),
                                    (1,), (2,), (0,)])
def test_png_rows_every_filter_type_match_jax(lib, tmp_path, monkeypatch,
                                              backend, ftypes):
    """Rows of each filter type, through the C row filter and through the
    NumPy fallback (rows or anti-diagonals), bit-equal to JAX's decoder
    and to the pixels written."""
    if backend == "numpy":
        monkeypatch.setattr(tpng, "native_lib", lambda: None)
    rng = np.random.RandomState(11)
    for dtype, hi, nch in ((np.uint8, 255, 3), (np.uint16, 65535, 3),
                           (np.uint16, 65535, 1), (np.uint8, 255, 4)):
        for hw in ((15, 13), (4, 29)):
            img = rng.randint(0, hi + 1, size=hw + ((nch,) if nch > 1
                                                    else ())).astype(dtype)
            p = str(tmp_path / "f.png")
            _encode_filtered(p, img, list(ftypes))
            got = tpng.read_png(p)
            want = jpng.read_png(p)
            assert got.dtype == want.dtype and got.shape == want.shape
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(got, img)


def test_native_build_is_keyed_and_switchable(lib, monkeypatch):
    path = build.library_path()
    assert path.parent == build.BUILD_DIR
    assert path.name.startswith("raftnative-") and path.suffix == ".so"
    assert path.is_file() and build.status()["loaded"]
    assert build.aug_lib() is lib
    monkeypatch.setenv(build.NO_NATIVE_AUG_ENV, "1")
    assert build.aug_lib() is None and build.load() is lib
