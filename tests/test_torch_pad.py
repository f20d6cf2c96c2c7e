"""The port's padder and bucket policy against the JAX package's (twins of
tests/test_pad.py): the same buckets, and equal padded arrays from
``pad``, ``pad_np`` and ``unpad`` in both modes, with and without a
``target`` bucket."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.ops import pad as jpad
from raft_tpu_torch.ops import pad as tpad


def test_ceil_and_bucket_hw_match_jax():
    ladder = ((440, 1024), (720, 1280))
    for hw in [(436, 1024), (440, 1024), (375, 1242), (64, 96), (441, 1024),
               (1440, 2560), (1, 1)]:
        assert tpad.bucket_hw(*hw) == jpad.bucket_hw(*hw)
        assert tpad.bucket_hw(*hw, ladder=ladder) == \
            jpad.bucket_hw(*hw, ladder=ladder)
        assert tpad.ceil_to_multiple(hw[0]) == jpad.ceil_to_multiple(hw[0])
    assert tpad.bucket_hw(441, 1024, ladder=ladder) == (720, 1280)
    assert tpad.ceil_to_multiple(370, 2) == 370


def test_max_bucket_hw_matches_jax():
    shapes = [(375, 1242), (370, 1224), (374, 1238), (376, 1241)]
    assert tpad.max_bucket_hw(shapes) == jpad.max_bucket_hw(shapes) == \
        (376, 1248)


@pytest.mark.parametrize("mode", ["sintel", "kitti"])
@pytest.mark.parametrize("hw,target", [((37, 53), None), ((42, 58), (48, 64)),
                                       ((48, 64), (48, 64)),
                                       ((375, 1242), (376, 1248)),
                                       ((370, 1224), (376, 1248))])
def test_padder_matches_jax(mode, hw, target):
    rng = np.random.default_rng(5)
    x = rng.uniform(0, 255, (2,) + hw + (3,)).astype(np.float32)
    for dims in (x.shape, hw):
        jp = jpad.InputPadder(dims, mode, target=target)
        tp = tpad.InputPadder(dims, mode, target=target)
        assert tp._pad == jp._pad
        want = np.asarray(jp.pad(jnp.asarray(x)))
        got = tp.pad(torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(got, want)
        if target is not None:
            assert got.shape[1:3] == target
        np.testing.assert_array_equal(tp.pad_np(x[0]), jp.pad_np(x[0]))
        np.testing.assert_array_equal(tp.pad_np(x[0]), want[0])
        a, b = tp.pad_np(x[0], x[1])
        np.testing.assert_array_equal(b, want[1])
        np.testing.assert_array_equal(tp.unpad(want), x)
        np.testing.assert_array_equal(tp.unpad(want[0]), x[0])


def test_target_smaller_than_image_raises():
    with pytest.raises(AssertionError):
        jpad.InputPadder((50, 64), "kitti", target=(48, 64))
    with pytest.raises(ValueError, match="smaller than image"):
        tpad.InputPadder((50, 64), "kitti", target=(48, 64))
    with pytest.raises(ValueError, match="smaller than image"):
        tpad.InputPadder((1, 48, 70, 3), "sintel", target=(48, 64))
