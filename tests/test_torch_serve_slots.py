"""The port's slot programs against the JAX package's (twins of the program
parts of tests/test_serve_slots.py and tests/test_serve_stream.py): the
same seeded inputs through ``raft_tpu.serve.slots`` and
``raft_tpu_torch.serve.slots`` on weights converted with ``convert.py``.

- each program: ``encode_admit`` (one lane admitted, the other kept),
  ``iter_step`` with a lane that retires (its upsampled flow: JAX's
  in-graph ``lax.cond``, the port's ``up`` program), ``stash_carry`` and
  ``encode_warm`` (the forward-warped init), for the full model at
  40x56 in fp32 and in bf16 (the serve CLI's default precision, the
  correlation state stored bf16) and the small model at 64x96, 2 lanes.
  Each program writes into the state it is given, as on the card: the
  port's state is read after the call;
- ``forward_warp_flow``: the constant-flow and out-of-frame cases of
  tests/test_serve_stream.py on the port, and a random flow against JAX;
- ``EarlyExitRunner``: flows and ``iters_used`` per threshold, and the
  monotone iteration counts of the JAX test on the port;
- ``evaluate_early_exit_delta``: the record and the printed lines;
- the evaluate CLI's ``--early_exit_threshold`` parsing.

Bounds: fp32 at rtol 1e-4, atol 1e-3, bf16 at 2e-2
(tests/test_torch_raft.py); the masks, budgets and iteration counts
exactly.  Net and inp are NHWC in
JAX and NCHW in the port.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu import evaluate as jev
from raft_tpu.config import RAFTConfig as JaxRAFTConfig
from raft_tpu.ops.sampler import forward_warp_flow as jax_warp
from raft_tpu.serve import slots as jslots
from raft_tpu_torch import evaluate as tev
from raft_tpu_torch.cli import evaluate as tcli
from raft_tpu_torch.config import RAFTConfig
from raft_tpu_torch.evaluate import make_inference_model
from raft_tpu_torch.ops.sampler import forward_warp_flow
from raft_tpu_torch.serve import slots

from test_torch_fixtures import full_raft_variables, small_raft_variables

TOL = dict(rtol=1e-4, atol=1e-3)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
CASES = {"full": ((40, 56), full_raft_variables),
         "full_bf16": ((40, 56), full_raft_variables),
         "small": ((64, 96), small_raft_variables)}


@pytest.fixture(autouse=True)
def one_torch_thread(monkeypatch):
    """One intra-op thread (the test runner runs several workers), no
    tuning registry or telemetry on the JAX side."""
    monkeypatch.setenv("RAFT_TUNING", "0")
    monkeypatch.delenv("RAFT_TELEMETRY_DIR", raising=False)
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _cfgs(name):
    if name == "small":
        return JaxRAFTConfig.small_model(), RAFTConfig.small_model()
    if name == "full_bf16":
        return (JaxRAFTConfig.full(compute_dtype="bfloat16"),
                RAFTConfig.full(compute_dtype="bfloat16"))
    return JaxRAFTConfig.full(), RAFTConfig.full()


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    """Per model: JAX variables, the port's model, the bucket and seeded
    frames for 2 lanes plus a third frame for the warm encode."""
    name = request.param
    hw, make = CASES[name]
    variables, sd = make(0)
    jcfg, cfg = _cfgs(name)
    model = make_inference_model(cfg, sd, device="cpu")
    rng = np.random.default_rng(3)
    frames = [rng.uniform(0, 255, (2,) + hw + (3,)).astype(np.float32)
              for _ in range(3)]
    return dict(name=name, hw=hw, variables=variables, jcfg=jcfg,
                model=model, frames=frames,
                tol=BF16_TOL if name == "full_bf16" else TOL)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _f32(x):
    """A port tensor or a JAX array (bf16 included) as fp32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _nchw(x):
    return _f32(x).transpose(0, 3, 1, 2)


def _assert_state(got: dict, want: dict, tol=TOL):
    """Port state against JAX's: exact on the lane leaves, ``tol`` on the
    tensors, and every leaf JAX's dtype."""
    for key in ("active", "budget", "converged", "iters_done"):
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]), err_msg=key)
    for key in ("coords0", "coords1", "delta_max"):
        np.testing.assert_allclose(_f32(got[key]), _f32(want[key]),
                                   err_msg=key, **tol)
    for key in ("net", "inp"):
        np.testing.assert_allclose(_f32(got[key]), _nchw(want[key]),
                                   err_msg=key, **tol)
    assert len(got["corr"]) == len(want["corr"])
    for g, w in zip(got["corr"], want["corr"]):
        g, w = _f32(g), _f32(w)
        # bf16: the two feature maps differ by bf16 roundings, which a
        # correlation that cancels keeps in absolute terms (~1 bf16 ulp of
        # the level's largest value on average, 1.4% of it at most in the
        # full_bf16 case): the bound is taken of the level's scale
        scale = np.abs(w).max(initial=1.0) if tol is BF16_TOL else 1.0
        np.testing.assert_allclose(g, w, rtol=tol["rtol"],
                                   atol=tol["atol"] * scale)
    for g, w in zip(slots._leaves(got, slots.STATE_KEYS),
                    jax.tree_util.tree_leaves(
                        [want[k] for k in slots.STATE_KEYS])):
        assert str(g.dtype) == f"torch.{np.dtype(w.dtype).name}"


def _jax_state(case, encode=True):
    """JAX's zero template at (2, bucket) and, with ``encode``, the state
    after admitting lane 0 with budget 1 and lane 1 with budget 3."""
    v, jcfg, hw = case["variables"], case["jcfg"], case["hw"]
    state = jax.tree_util.tree_map(
        jnp.asarray, jslots.state_template(jcfg, v, 2, hw))
    if not encode:
        return state
    f = case["frames"]
    return jax.jit(jslots.make_encode_fn(jcfg))(
        v, f[0], f[1], state, jnp.asarray([True, True]),
        jnp.asarray([1, 3], jnp.int32))


def _port_state(case, encode=True):
    """A fresh zero template and, with ``encode``, the admit of
    :func:`_jax_state` written into it."""
    model, hw = case["model"], case["hw"]
    state = slots.state_template(model.config, 2, hw)
    if encode:
        f = case["frames"]
        with torch.no_grad():
            slots.make_encode_fn(model)(
                _t(f[0]), _t(f[1]), state, torch.tensor([True, True]),
                torch.tensor([1, 3], dtype=torch.int32))
    return state


def test_state_template_matches_jax(case):
    """Same keys, lane leaves equal, and each tensor leaf the shape and
    dtype of JAX's (NCHW for net / inp)."""
    got, want = _port_state(case, False), _jax_state(case, False)
    assert sorted(got) == sorted(want) == sorted(slots.STATE_KEYS)
    _assert_state(got, want)
    assert got["net"].shape == _nchw(want["net"]).shape
    assert [tuple(c.shape) for c in got["corr"]] == \
        [tuple(c.shape) for c in want["corr"]]


def test_encode_admit_matches_jax(case):
    """Admitting lane 1 only: lane 1 holds the encoder's outputs as JAX's
    does, lane 0 keeps its previous (zero) state bit for bit."""
    v, jcfg, f = case["variables"], case["jcfg"], case["frames"]
    admit = [False, True]
    want = jax.jit(jslots.make_encode_fn(jcfg))(
        v, f[0], f[1], _jax_state(case, False), jnp.asarray(admit),
        jnp.asarray([5, 7], jnp.int32))
    zero, got = _port_state(case, False), _port_state(case, False)
    with torch.no_grad():
        slots.make_encode_fn(case["model"])(
            _t(f[0]), _t(f[1]), got, torch.tensor(admit),
            torch.tensor([5, 7], dtype=torch.int32))
    _assert_state(got, want, case["tol"])
    assert got["active"].tolist() == [False, True]
    assert got["budget"].tolist() == [0, 7]
    for k in ("net", "inp", "coords1"):
        assert torch.equal(got[k][0], zero[k][0])
    assert got["delta_max"].tolist() == [-1.0, -1.0]


def test_iter_step_with_retiring_lane_matches_jax(case):
    """One iteration from the same state: lane 0 (budget 1) retires, lane
    1 goes on; the state and lane 0's upsampled flow (JAX's in-graph
    upsample, the port's ``up`` program) agree."""
    v, jcfg = case["variables"], case["jcfg"]
    want, want_up = jax.jit(jslots.make_iter_fn(jcfg))(
        v, _jax_state(case), jnp.float32(0.0))
    model = case["model"]
    got = _port_state(case)
    with torch.no_grad():
        slots.make_iter_fn(model)(got, torch.tensor(0.0))
        got_up = slots.make_upsample_fn(model)(got)
    _assert_state(got, want, case["tol"])
    assert got["active"].tolist() == [False, True]
    assert got["iters_done"].tolist() == [1, 1]
    assert (got["delta_max"] >= 0).all()
    np.testing.assert_allclose(_f32(got_up[0]), _f32(want_up)[0],
                               **case["tol"])


def test_stash_and_warm_encode_match_jax(case):
    """The streaming pair: frame 2's features stashed into lane 1's carry,
    then the warm admit of frame 3 into lane 1 from the carry and the
    lane's flow after one iteration, warped forward."""
    v, jcfg, f, hw = (case["variables"], case["jcfg"], case["frames"],
                      case["hw"])
    model = case["model"]
    admit = [False, True]
    jit_stash = jax.jit(jslots.make_stash_fn(jcfg))
    jit_warm = jax.jit(jslots.make_warm_encode_fn(jcfg))
    jcarry = jax.tree_util.tree_map(
        jnp.asarray, jslots.carry_template(jcfg, v, 2, hw))
    jcarry = jit_stash(v, f[1], jcarry, jnp.asarray(admit))
    jstate, _ = jax.jit(jslots.make_iter_fn(jcfg))(
        v, _jax_state(case), jnp.float32(0.0))
    want_state, want_carry = jit_warm(v, f[2], jcarry, jstate,
                                      jnp.asarray(admit),
                                      jnp.asarray([4, 4], jnp.int32))
    carry = slots.carry_template(model.config, 2, hw)
    assert sorted(carry) == sorted(jcarry) == list(slots.CARRY_KEYS)
    state = _port_state(case)
    with torch.no_grad():
        slots.make_stash_fn(model)(_t(f[1]), carry, torch.tensor(admit))
        stashed = {k: v.clone() for k, v in carry.items()}
        slots.make_iter_fn(model)(state, torch.tensor(0.0))
        slots.make_warm_encode_fn(model)(
            _t(f[2]), carry, state, torch.tensor(admit),
            torch.tensor([4, 4], dtype=torch.int32))
    for carry_got, carry_want, frame in ((stashed, jcarry, f[1]),
                                         (carry, want_carry, f[2])):
        if case["name"] == "full_bf16":
            # fnet's bf16 output is 1.6% (relative norm) off its fp32
            # output in both packages, by roundings of its whole bf16
            # chain that differ between them, so 1.9% off JAX's (the
            # correlation and the flows average it out): the carried
            # fmap is held to the port's own encoder, lane by lane
            with torch.no_grad():
                own = model.frame_features(_t(frame))[0]
            assert torch.equal(carry_got["fmap"][1], own[1])
            assert not carry_got["fmap"][0].any()
        else:
            np.testing.assert_allclose(_f32(carry_got["fmap"]),
                                       _f32(carry_want["fmap"]),
                                       **case["tol"])
        np.testing.assert_allclose(_f32(carry_got["ctx"]),
                                   _nchw(carry_want["ctx"]), **case["tol"])
        assert str(carry_got["ctx"].dtype) == \
            f"torch.{np.dtype(carry_want['ctx'].dtype).name}"
    _assert_state(state, want_state, case["tol"])
    assert state["iters_done"].tolist() == [1, 0]


def test_forward_warp_flow_constant_and_zero():
    """A constant integer flow warps to the same constant where it lands;
    the vacated strip is the cold zero init; zero flow is the identity
    (tests/test_serve_stream.py)."""
    H, W = 10, 12
    np.testing.assert_array_equal(
        forward_warp_flow(torch.zeros(1, H, W, 2)).numpy(), 0.0)
    const = torch.tensor([2.0, 1.0]).expand(1, H, W, 2).contiguous()
    warped = forward_warp_flow(const)[0].numpy()
    np.testing.assert_allclose(
        warped[1:, 2:], np.broadcast_to([2.0, 1.0], warped[1:, 2:].shape),
        atol=1e-5)
    np.testing.assert_array_equal(warped[0, :], 0.0)
    np.testing.assert_array_equal(warped[:, :2][1:], 0.0)


def test_forward_warp_flow_out_of_frame_drops():
    """Flow pointing entirely out of frame leaves zeros, not NaNs."""
    flow = torch.tensor([1e4, 1e4]).expand(1, 6, 8, 2).contiguous()
    np.testing.assert_array_equal(forward_warp_flow(flow).numpy(), 0.0)


@pytest.mark.parametrize("scale", [0.5, 3.0, 20.0])
def test_forward_warp_flow_matches_jax(scale):
    """Random flows (collisions, fractional landings, some out of frame)
    against JAX's scatter-add, within 1e-5; the port repeats bit for
    bit."""
    rng = np.random.default_rng(int(scale * 10))
    flow = (rng.standard_normal((2, 11, 16, 2)) * scale).astype(np.float32)
    want = np.asarray(jax_warp(jnp.asarray(flow)))
    got = forward_warp_flow(_t(flow))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert torch.equal(got, forward_warp_flow(_t(flow)))


def test_early_exit_runner_matches_jax():
    """The offline runner (small model, 2 lanes, 4 iterations): flows and
    ``iters_used`` against JAX's at threshold 0 (the full budget) and
    1e9 (every lane retires on its first iteration); on the port, a
    looser threshold never raises a lane's count, and threshold 0
    reproduces the full-budget flows bit for bit."""
    variables, sd = small_raft_variables(0)
    rng = np.random.default_rng(3)
    im1, im2 = (rng.uniform(0, 255, (2, 40, 56, 3)).astype(np.float32)
                for _ in range(2))
    jrunner = jslots.EarlyExitRunner(JaxRAFTConfig.small_model())
    runner = slots.EarlyExitRunner(RAFTConfig.small_model(), device="cpu")
    iters = 4
    base, base_used = runner.run(sd, im1, im2, iters, threshold=0.0)
    prev = None
    for thr in (0.0, 0.01, 0.3, 1e9):
        flow, used, resid = runner.run(sd, im1, im2, iters, thr,
                                       return_residuals=True)
        assert np.isfinite(flow).all() and (resid >= 0).all()
        assert ((1 <= used) & (used <= iters)).all()
        if thr == 0.0:
            np.testing.assert_array_equal(flow, base)
        if prev is not None:
            assert (used <= prev).all(), (thr, used, prev)
        prev = used
        if thr in (0.0, 1e9):
            jflow, jused, jresid = jrunner.run(variables, im1, im2, iters,
                                               thr, return_residuals=True)
            np.testing.assert_array_equal(used, np.asarray(jused))
            np.testing.assert_allclose(flow, np.asarray(jflow), **TOL)
            np.testing.assert_allclose(resid, np.asarray(jresid), **TOL)
    assert base_used.tolist() == [iters, iters]
    assert prev.tolist() == [1, 1]
    assert runner.programs.counter.counts() == {
        ((40, 56), 2, p): 1 for p in ("enc", "iter", "up")}


class _SynthDataset:
    """Three pairs with a known flow, standing in for FlyingChairs through
    the ``EARLY_EXIT_DATASETS`` seam (tests/test_serve_slots.py)."""

    def __init__(self, n=3, seed=21):
        rng = np.random.default_rng(seed)
        self.samples = [
            {"image1": rng.uniform(0, 255, (36, 52, 3)).astype(np.float32),
             "image2": rng.uniform(0, 255, (36, 52, 3)).astype(np.float32),
             "flow": rng.normal(0, 2, (36, 52, 2)).astype(np.float32)}
            for _ in range(n)]

    def __len__(self):
        return len(self.samples)

    def load(self, i):
        return self.samples[i]


def test_evaluate_early_exit_delta_matches_jax(monkeypatch, capsys):
    """The early-exit record of both packages on the same weights and
    samples: the same keys and thresholds, EPE within 1e-3, the
    iteration statistics equal, and the same printed lines up to the
    last digit of an EPE."""
    variables, sd = small_raft_variables(0)
    monkeypatch.setitem(jev.EARLY_EXIT_DATASETS, "chairs",
                        lambda **kw: _SynthDataset())
    monkeypatch.setitem(tev.EARLY_EXIT_DATASETS, "chairs",
                        lambda **kw: _SynthDataset())
    kw = dict(dataset="chairs", iters=3, batch_size=2, bucket=False)
    want = jev.evaluate_early_exit_delta(
        variables, JaxRAFTConfig.small_model(), [0.01, 1e9], **kw)
    jax_out = capsys.readouterr().out
    got = tev.evaluate_early_exit_delta(
        sd, RAFTConfig.small_model(), [0.01, 1e9], device="cpu", **kw)
    out = capsys.readouterr().out
    assert got["thresholds"] == want["thresholds"] == ["0", "0.01", "1e+09"]
    assert set(got) == set(want) and set(got["delta_vs_full"]) == \
        set(want["delta_vs_full"]) == {"0.01", "1e+09"}
    for thr, arm in got["per_threshold"].items():
        ref = want["per_threshold"][thr]
        assert set(arm) == set(ref)
        for k in ("iters_mean", "iters_p50", "iters_p95"):
            assert arm[k] == ref[k], (thr, k)
        for k in ("epe", "epe_delta", "residual_mean", "residual_p50"):
            assert abs(arm[k] - ref[k]) <= 1e-3, (thr, k, arm[k], ref[k])
    assert got["per_threshold"]["0"]["iters_p50"] == 3.0
    assert got["per_threshold"]["1e+09"]["iters_p50"] == 1.0
    mask = lambda s: re.sub(r"\d", "#", s)  # noqa: E731
    assert mask(out) == mask(jax_out)
    for bad in ([], [-0.1]):
        with pytest.raises(ValueError):
            tev.evaluate_early_exit_delta(sd, RAFTConfig.small_model(), bad,
                                          dataset="chairs", device="cpu")
    with pytest.raises(ValueError):
        tev.evaluate_early_exit_delta(sd, RAFTConfig.small_model(), [0.1],
                                      dataset="nope", device="cpu")


def test_cli_early_exit_threshold_flag():
    """The evaluate CLI parses the flag as the JAX CLI does."""
    from raft_tpu.cli import evaluate as jcli

    argv = ["--model", "m", "--dataset", "chairs",
            "--early_exit_threshold", "0.05, 0.2"]
    assert tcli.parse_args(argv).early_exit_threshold == \
        jcli.parse_args(argv).early_exit_threshold == [0.05, 0.2]
    for bad in ["", "a,b", "-0.1", "0.1,,-2"]:
        with pytest.raises(SystemExit):
            tcli.parse_args(["--model", "m", "--dataset", "chairs",
                             "--early_exit_threshold", bad])
