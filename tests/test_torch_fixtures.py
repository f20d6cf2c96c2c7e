"""Shared inputs for the PyTorch port's parity tests, and a check of them.

The port is held against the JAX package on identical weights: a full
(or small) RAFT variables tree built from ``jax.eval_shape`` of
``RAFT.init`` (the tree structure and shapes, no compile) and filled from
a numpy seed, then converted with
``raft_tpu_torch.convert.state_dict_from_flax``.  Conv
kernels get torch's default init scale (``U(+-1/sqrt(fan_in))``), biases
small uniform values, batch-norm statistics and scales values near the
identity but not equal to it, so every mapped tensor matters.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np

from raft_tpu.config import RAFTConfig as JaxRAFTConfig
from raft_tpu.models.raft import RAFT as JaxRAFT
from raft_tpu_torch.config import RAFTConfig
from raft_tpu_torch.convert import state_dict_from_flax


def _fill(rng, path, s):
    name = jax.tree_util.keystr(path)
    if "'mean'" in name:
        return rng.uniform(-0.1, 0.1, s.shape).astype(np.float32)
    if "'var'" in name:
        return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
    if "'scale'" in name:
        return rng.uniform(0.8, 1.2, s.shape).astype(np.float32)
    if "'kernel'" in name:
        bound = 1.0 / np.sqrt(np.prod(s.shape[:-1]))
        return rng.uniform(-bound, bound, s.shape).astype(np.float32)
    return rng.uniform(-0.1, 0.1, s.shape).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _cached(seed, small=False):
    model = JaxRAFT(JaxRAFTConfig.small_model() if small
                    else JaxRAFTConfig.full())
    img = jnp.zeros((1, 48, 64, 3))
    shapes = jax.eval_shape(
        lambda k: model.init({"params": k, "dropout": k}, img, img, iters=1),
        jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    tree = jax.tree_util.tree_map_with_path(
        lambda p, s: _fill(rng, p, s), shapes)
    variables = {"params": tree["params"],
                 "batch_stats": tree.get("batch_stats", {})}
    return variables, state_dict_from_flax(
        variables, RAFTConfig.small_model() if small else RAFTConfig.full())


def full_raft_variables(seed: int = 0):
    """``(flax variables, port state_dict)`` of one full RAFT, seeded.
    Cached per seed: callers must not mutate the result."""
    return _cached(seed)


def small_raft_variables(seed: int = 0):
    """``(flax variables, port state_dict)`` of one small RAFT, seeded (no
    batch statistics: its norms are instance and none).  Cached per
    seed: callers must not mutate the result."""
    return _cached(seed, True)


def images(seed: int, h: int, w: int, batch: int = 1):
    rng = np.random.default_rng(seed)
    return tuple(rng.uniform(0, 255, (batch, h, w, 3)).astype(np.float32)
                 for _ in range(2))


def test_fixture_weights_are_seeded_and_complete():
    v0, sd0 = full_raft_variables(0)
    leaves = jax.tree_util.tree_leaves(v0)
    assert len(leaves) == len(sd0) == 150
    assert all(np.isfinite(x).all() for x in leaves)
    v1, _ = full_raft_variables(1)
    k0 = v0["params"]["fnet"]["conv1"]["kernel"]
    k1 = v1["params"]["fnet"]["conv1"]["kernel"]
    assert k0.shape == (7, 7, 3, 64) and not np.array_equal(k0, k1)


def test_small_fixture_weights_are_seeded_and_complete():
    v0, sd0 = small_raft_variables(0)
    leaves = jax.tree_util.tree_leaves(v0)
    assert len(leaves) == len(sd0) == 104 and not v0["batch_stats"]
    assert sum(x.size for x in leaves) == 990162
    k0 = v0["params"]["cnet"]["conv2"]["kernel"]
    assert k0.shape == (1, 1, 96, 160) and np.isfinite(k0).all()
