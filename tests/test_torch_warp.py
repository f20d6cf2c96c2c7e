"""The port's ``forward_interpolate`` against the JAX package's on the
cases of tests/test_warp.py, plus a Sintel-shaped 1/8 flow."""

import numpy as np
import pytest

from raft_tpu.utils.warp import forward_interpolate as jax_fi
from raft_tpu_torch.utils.warp import forward_interpolate


@pytest.mark.parametrize("case", ["random", "constant", "out_of_bounds",
                                  "sintel_low"])
def test_matches_jax(case):
    rng = np.random.RandomState(0)
    flow = {"random": rng.randn(14, 19, 2) * 3,
            "constant": np.full((12, 12, 2), 2.0),
            "out_of_bounds": np.full((6, 6, 2), 100.0),
            "sintel_low": rng.randn(55, 128, 2) * 4}[case].astype(np.float32)
    got = forward_interpolate(flow)
    want = jax_fi(flow)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    if case == "constant":
        np.testing.assert_array_equal(got, flow)
    if case == "out_of_bounds":
        assert not got.any()


def test_rejects_a_bad_shape():
    with pytest.raises(ValueError, match=r"\(H, W, 2\)"):
        forward_interpolate(np.zeros((4, 4, 3), np.float32))
