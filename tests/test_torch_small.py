"""The small model of the port against the JAX package's, on the CPU, on
converted weights: its blocks, ``upflow8``, the whole model in test mode
and with ``loss_targets`` under every ``corr_impl``, and one train step.

Tolerances: fp32 ``rtol=1e-4, atol=1e-3`` for the whole model and
``1e-4`` for a block, as in ``test_torch_raft.py`` and
``test_torch_modules.py`` (the two packages sum in other orders);
``upflow8`` is the same two products on both sides (1e-6).  The JAX side
of ``'pallas'`` and ``'allpairs_pallas'`` runs its Pallas kernels in
interpret mode (``pallas_offtpu='interpret'``); the port's run their
plain versions on the CPU (no kernel launches).  Inputs stay at 64x96
or smaller and 2 iterations.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from raft_tpu.config import RAFTConfig as JaxRAFTConfig
from raft_tpu.config import TrainConfig as JaxTrainConfig
from raft_tpu.models import extractor as jext
from raft_tpu.models import layers as jlayers
from raft_tpu.models import update as jupd
from raft_tpu.models.raft import RAFT as JaxRAFT
from raft_tpu.ops import corr as jcorr
from raft_tpu.ops import sampler as jsampler
from raft_tpu.train import optim as joptim
from raft_tpu.train.step import make_loss_fn as jax_make_loss_fn
from raft_tpu_torch.config import RAFTConfig, TrainConfig
from raft_tpu_torch.convert import state_dict_from_flax
from raft_tpu_torch.models.extractor import SmallEncoder
from raft_tpu_torch.models.layers import BottleneckBlock
from raft_tpu_torch.models.raft import RAFT
from raft_tpu_torch.models.update import (ConvGRU, FusedCorrLookup,
                                          SmallMotionEncoder,
                                          SmallUpdateBlock)
from raft_tpu_torch.ops import (corr_kernels, gru_gates, lookup_encode,
                                pyramid_kernels, upsample_loss)
from raft_tpu_torch.ops.corr import build_corr_pyramid
from raft_tpu_torch.ops.sampler import resize_bilinear_align_corners, upflow8
from raft_tpu_torch.train import optim
from raft_tpu_torch.train.step import init_state, make_train_step

from test_torch_fixtures import images, small_raft_variables

TOL = dict(rtol=1e-4, atol=1e-4)
MODEL_TOL = dict(rtol=1e-4, atol=1e-3)
ITERS = 2
P = 4 * 7 * 7                      # levels * (2r+1)^2 at radius 3


@pytest.fixture(autouse=True)
def _one_thread():
    """One torch thread a test: tier-1 runs the files in parallel
    workers, whose threads would otherwise wait on each other."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _load(module, sd, prefix):
    module.load_state_dict({k[len(prefix):]: v for k, v in sd.items()
                            if k.startswith(prefix)})
    return module.eval()


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _counters():
    return [dict(c) for c in (corr_kernels.LAUNCHES, gru_gates.LAUNCHES,
                              pyramid_kernels.LAUNCHES, upsample_loss.LAUNCHES,
                              lookup_encode.LAUNCHES)]


@pytest.mark.parametrize("layer,cin,planes,stride",
                         [("layer1_0", 32, 32, 1), ("layer2_0", 32, 64, 2)])
def test_bottleneck_block(layer, cin, planes, stride):
    variables, sd = small_raft_variables(0)
    rng = np.random.default_rng(1)
    x = np.maximum(_rand(rng, 2, 12, 16, cin), 0)
    jv = {"params": variables["params"]["fnet"][layer]}
    want = np.asarray(jlayers.BottleneckBlock(planes, "instance", stride,
                                              jnp.float32).apply(jv, x))
    blk = _load(BottleneckBlock(cin, planes, "instance", stride), sd,
                f"fnet.{layer}.")
    with torch.inference_mode():
        got = _nhwc(blk(_nchw(x)))
    assert got.shape == want.shape == (2, 12 // stride, 16 // stride, planes)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("name,norm,width",
                         [("fnet", "instance", 128), ("cnet", "none", 160)])
def test_small_encoder(name, norm, width):
    variables, sd = small_raft_variables(0)
    rng = np.random.default_rng(2)
    x = rng.uniform(-1, 1, (2, 32, 48, 3)).astype(np.float32)
    want = np.asarray(jext.SmallEncoder(width, norm, 0.0, jnp.float32)
                      .apply({"params": variables["params"][name]}, x,
                             False, False))
    enc = _load(SmallEncoder(width, norm), sd, name + ".")
    with torch.inference_mode():
        got = _nhwc(enc(_nchw(x)))
    assert got.shape == want.shape == (2, 4, 6, width)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("fused", [False, True])
def test_conv_gru(fused):
    """One 3x3 pass; with ``fused`` the gates go through the wrappers of
    the gate kernels (their plain versions here), ``r`` a channel slice
    of the z/r conv's output."""
    variables, sd = small_raft_variables(0)
    rng = np.random.default_rng(3)
    h = np.tanh(_rand(rng, 2, 6, 10, 96))
    x = _rand(rng, 2, 6, 10, 146)
    jv = {"params": variables["params"]["refine"]["update_block"]["gru"]}
    want = np.asarray(jupd.ConvGRU(96, jnp.float32, fused=fused)
                      .apply(jv, h, x))
    gru = _load(ConvGRU(96, 146, fused=fused), sd,
                "refine.update_block.gru.")
    before = _counters()
    with torch.inference_mode():
        got = _nhwc(gru(_nchw(h), _nchw(x)))
    assert _counters() == before
    np.testing.assert_allclose(got, want, **TOL)


def _jax_taps(rng, B, h, w):
    """A radius-3 lookup of a random pyramid: JAX's taps and pyramid, the
    port's pyramid and the centers."""
    f1, f2 = _rand(rng, B, h, w, 32), _rand(rng, B, h, w, 32)
    coords = (np.stack(np.meshgrid(np.arange(w), np.arange(h)), -1)[None]
              + rng.uniform(-3, 3, (B, h, w, 2))).astype(np.float32)
    jpyr = jcorr.build_corr_pyramid(jnp.asarray(f1), jnp.asarray(f2), 4)
    taps = np.asarray(jcorr.corr_lookup(jpyr, jnp.asarray(coords), 3))
    tpyr = build_corr_pyramid(torch.from_numpy(f1), torch.from_numpy(f2), 4,
                              torch.float32)
    return taps, tpyr, torch.from_numpy(coords)


@pytest.mark.parametrize("fused", [False, True])
def test_small_motion_encoder(fused):
    """The unfused encoder on JAX's taps; the fused path (lookup +
    ``convc1`` with 96 outputs through ``FusedCorrLookup``) on the port's
    pyramid and the same centers, against the same JAX encoder."""
    variables, sd = small_raft_variables(0)
    rng = np.random.default_rng(4)
    taps, tpyr, coords = _jax_taps(rng, 1, 6, 10)
    flow = _rand(rng, 1, 6, 10, 2, scale=3.0)
    jv = {"params": variables["params"]["refine"]["update_block"]["encoder"]}
    want = np.asarray(jupd.SmallMotionEncoder(jnp.float32)
                      .apply(jv, flow, taps))
    enc = _load(SmallMotionEncoder(P), sd, "refine.update_block.encoder.")
    corr = (FusedCorrLookup(tpyr, coords, 3, torch.float32) if fused
            else _nchw(taps))
    with torch.inference_mode():
        got = _nhwc(enc(_nchw(flow), corr))
    assert got.shape == want.shape == (1, 6, 10, 82)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("fused", [False, True])
def test_small_update_block(fused):
    variables, sd = small_raft_variables(0)
    rng = np.random.default_rng(5)
    net = np.tanh(_rand(rng, 1, 6, 10, 96))
    inp = np.maximum(_rand(rng, 1, 6, 10, 64), 0)
    corr = _rand(rng, 1, 6, 10, P)
    flow = _rand(rng, 1, 6, 10, 2, scale=3.0)
    jv = {"params": variables["params"]["refine"]["update_block"]}
    jnet, jdelta = jupd.SmallUpdateBlock(96, jnp.float32, fused_gru=fused) \
        .apply(jv, net, inp, corr, flow)
    blk = _load(SmallUpdateBlock(P, 96, 64, fused_gru=fused), sd,
                "refine.update_block.")
    with torch.inference_mode():
        tnet, tdelta = blk(_nchw(net), _nchw(inp), _nchw(corr), _nchw(flow))
    np.testing.assert_allclose(_nhwc(tnet), np.asarray(jnet), **TOL)
    np.testing.assert_allclose(_nhwc(tdelta), np.asarray(jdelta), **TOL)


@pytest.mark.parametrize("src,dst", [((6, 10), (48, 80)), ((1, 7), (5, 9)),
                                     ((5, 3), (5, 3))])
def test_resize_bilinear_align_corners(src, dst):
    rng = np.random.default_rng(6)
    x = _rand(rng, 2, *src, 3)
    want = np.asarray(jsampler.resize_bilinear_align_corners(
        jnp.asarray(x), dst))
    got = resize_bilinear_align_corners(torch.from_numpy(x), dst).numpy()
    assert got.shape == want.shape == (2, *dst, 3)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    # the reference's F.interpolate(..., align_corners=True)
    ref = torch.nn.functional.interpolate(
        _nchw(x), size=dst, mode="bilinear", align_corners=True)
    np.testing.assert_allclose(got, _nhwc(ref), rtol=1e-5, atol=1e-5)


def test_upflow8():
    rng = np.random.default_rng(7)
    flow = _rand(rng, 2, 8, 12, 2, scale=4.0)
    want = np.asarray(jsampler.upflow8(jnp.asarray(flow)))
    got = upflow8(torch.from_numpy(flow)).numpy()
    assert got.shape == (2, 64, 96, 2)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(got[:, ::63, ::95], 8 * flow[:, ::7, ::11],
                               rtol=1e-6, atol=1e-5)


def _jax_cfg(impl, **kw):
    extra = ({"pallas_offtpu": "interpret"}
             if impl in ("pallas", "allpairs_pallas") else {})
    return JaxRAFTConfig.small_model(corr_impl=impl, **extra, **kw)


def _targets(seed, b, h, w):
    rng = np.random.default_rng(seed)
    gt = (3 * rng.standard_normal((b, h, w, 2))).astype(np.float32)
    gt[0, :2, :3] = 500.0                       # beyond max_flow
    valid = (rng.random((b, h, w)) > 0.1).astype(np.float32)
    return gt, valid


@functools.lru_cache(maxsize=None)
def _jax_outputs(impl, hw, loss):
    """JAX's test-mode ``(flow_low, flow_up)`` and, with ``loss``, its
    loss-mode ``(per_iter, metrics)`` and stacked flows, in one jit."""
    variables, _ = small_raft_variables(0)
    i1, i2 = images(11, *hw)
    gt, valid = _targets(12, 1, *hw)
    model = JaxRAFT(_jax_cfg(impl, remat=False))

    def run(v, a, b, g, va):
        out = {"test": model.apply(v, a, b, iters=ITERS, test_mode=True)}
        if loss:
            out["loss"] = model.apply(v, a, b, iters=ITERS,
                                      loss_targets=(g, va, 400.0))
            out["stacked"] = model.apply(v, a, b, iters=ITERS)
        return out

    out = jax.jit(run)(variables, i1, i2, gt, valid)
    return jax.tree_util.tree_map(np.asarray, out)


def _port_outputs(impl, hw):
    _, sd = small_raft_variables(0)
    i1, i2 = images(11, *hw)
    gt, valid = _targets(12, 1, *hw)
    model = RAFT(RAFTConfig.small_model(corr_impl=impl,
                                        upsample_loss_kernel="pallas"))
    model.load_state_dict(sd)
    model.eval()
    before = _counters()
    t1, t2 = torch.from_numpy(i1), torch.from_numpy(i2)
    with torch.inference_mode():
        out = {"test": model(t1, t2, iters=ITERS, test_mode=True),
               "loss": model(t1, t2, iters=ITERS, loss_targets=(
                   torch.from_numpy(gt), torch.from_numpy(valid), 400.0)),
               "stacked": model(t1, t2, iters=ITERS)}
    assert _counters() == before
    return jax.tree_util.tree_map(lambda t: t.numpy(), out)


# (port corr_impl, JAX corr_impl of its loss-mode reference, the size of
# the JAX test-mode comparison)
IMPLS = {"allpairs": ("allpairs", (64, 96)),
         "chunked": ("chunked", (64, 96)),
         "pallas": ("chunked", (32, 48)),
         "allpairs_pallas": ("allpairs", (32, 48))}


@pytest.mark.parametrize("impl", list(IMPLS))
def test_small_raft_matches_jax(impl):
    """The small model under each ``corr_impl``: test mode (``(flow_low,
    flow_up)``) against JAX's same ``corr_impl``, whose Pallas kernels
    run in interpret mode (at 32x48, where level 3 pools to nothing);
    loss mode (per-iteration losses, metrics, ``epe_iter``) and the
    stacked flows at 64x96 against JAX's plain lookup of the same
    function (``chunked`` for the on-demand kernel, ``allpairs`` for the
    pyramid kernel).  The port's kernel configurations run their plain
    versions here, and no upsample-loss launch counts even with
    ``upsample_loss_kernel='pallas'`` (the small model has no mask
    head)."""
    plain, hw = IMPLS[impl]
    got = _port_outputs(impl, (64, 96))
    want = _jax_outputs(plain, (64, 96), True)
    if hw != (64, 96):
        np.testing.assert_allclose(got["test"][1], want["test"][1],
                                   **MODEL_TOL)
        got["test"] = _port_outputs(impl, hw)["test"]
        want = dict(want, test=_jax_outputs(impl, hw, False)["test"])
    lo, up = got["test"]
    assert up.shape == (1, *hw, 2) and lo.shape == (1, hw[0] // 8,
                                                    hw[1] // 8, 2)
    for g, w in zip(got["test"], want["test"]):
        np.testing.assert_allclose(g, w, **MODEL_TOL)
    per, met = got["loss"]
    jper, jmet = want["loss"]
    np.testing.assert_allclose(per, jper, rtol=1e-4)
    assert set(met) == set(jmet)
    for k in met:
        np.testing.assert_allclose(met[k], jmet[k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    assert got["stacked"].shape == (ITERS, 1, 64, 96, 2)
    np.testing.assert_allclose(got["stacked"], want["stacked"], **MODEL_TOL)


@functools.lru_cache(maxsize=None)
def _jax_small_step():
    """JAX's loss, metrics, gradients and one optax update of the small
    model at its default remat (``save_corr``, remat_upsample on), one
    jit of ``value_and_grad``.

    At 64x64 (an 8x8 grid, every pyramid level even).  At 48x64 XLA:CPU's
    compiled gradient of the small model, with the batch as an argument,
    puts fnet's lower layers 1.5% (relative norm) away from JAX's own
    op-by-op gradient, from its compiled gradient with the batch folded in
    as a constant, and from the port; those three agree within 6e-6."""
    variables, _ = small_raft_variables(0)
    jcfg = JaxTrainConfig(**STEP_KW)
    loss_fn = jax_make_loss_fn(JaxRAFT(_jax_cfg("allpairs")), jcfg)
    (lval, (jmet, _)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"], variables["batch_stats"],
        {k: jnp.asarray(v) for k, v in _step_batch().items()},
        jax.random.PRNGKey(0))
    tx = joptim.make_optimizer(jcfg.lr, jcfg.num_steps, jcfg.wdecay,
                               jcfg.epsilon, jcfg.clip)

    @jax.jit
    def update(params, grads):
        upd, _ = tx.update(grads, tx.init(params), params)
        return optax.apply_updates(params, upd), optax.global_norm(grads)

    after, gnorm = update(variables["params"], grads)
    small = RAFTConfig.small_model()
    return dict(
        loss=float(lval), metrics={k: np.asarray(v) for k, v in jmet.items()},
        grad_norm=float(gnorm),
        grads=state_dict_from_flax({"params": grads}, small),
        after=state_dict_from_flax({"params": after}, small))


STEP_KW = dict(lr=2e-4, num_steps=100, batch_size=2, image_size=(64, 64),
               iters=ITERS)


def _step_batch():
    B, (H, W) = STEP_KW["batch_size"], STEP_KW["image_size"]
    rng = np.random.default_rng(14)
    return {"image1": rng.uniform(0, 255, (B, H, W, 3)).astype(np.float32),
            "image2": rng.uniform(0, 255, (B, H, W, 3)).astype(np.float32),
            "flow": (3 * rng.standard_normal((B, H, W, 2))).astype(
                np.float32),
            "valid": (rng.random((B, H, W)) > 0.1).astype(np.float32)}


@pytest.mark.parametrize("remat", ["none", "save_corr"])
def test_small_train_step_matches_jax(remat):
    """One train step (64x64, batch 2, 2 iterations, fp32) of the port's
    small model, without remat and under ``save_corr``, against JAX's
    ``make_loss_fn`` + ``make_optimizer`` at its default ``save_corr``
    from the same weights: loss, metrics, every gradient (rtol 1e-3 plus
    1e-4 of the largest entry, the bound of ``test_torch_train.py``) and
    the update over the first step's learning rate (rtol 1e-3)."""
    want = _jax_small_step()
    _, sd = small_raft_variables(0)
    cfg = TrainConfig(**STEP_KW)
    model_cfg = RAFTConfig.small_model(remat=remat != "none",
                                       remat_upsample=remat != "none")
    state = init_state(model_cfg, cfg, device="cpu", state_dict=sd)
    seen = {}
    opt_step = state.optimizer.step

    def hooked(*a, **k):
        seen.update({n: p.grad.detach().clone()
                     for n, p in state.model.named_parameters()})
        return opt_step(*a, **k)

    state.optimizer.step = hooked
    state, met = make_train_step(cfg, device="cpu")(state, _step_batch())
    np.testing.assert_allclose(float(met["loss"]), want["loss"], rtol=1e-4)
    for k, w in want["metrics"].items():
        np.testing.assert_allclose(met[k].numpy(), w, rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(float(met["grad_norm"]), want["grad_norm"],
                               rtol=1e-4)
    clip = min(1.0, 1.0 / want["grad_norm"])
    gmax = max(float(g.abs().max()) for g in want["grads"].values())
    assert set(seen) == set(want["grads"]) == set(sd)
    for k, g in seen.items():
        np.testing.assert_allclose(g.numpy() / clip,
                                   want["grads"][k].numpy(), rtol=1e-3,
                                   atol=1e-4 * gmax, err_msg=k)
    # Adam's first step moves an entry by lr0 * g / (|g| + eps) plus the
    # weight decay, so the update over lr0 is held at rtol 1e-3 plus the
    # fp32 rounding of after - before: a step of the wrong size or sign
    # fails by about 1.  Entries with 0 < |g| <= 100 eps are left out:
    # there the step turns on differences in g that the gradient bound
    # above allows (about 18% of the entries at this seed; the 15% whose
    # gradient is exactly 0 on both sides are held).
    lr0 = optim.onecycle_lr(cfg.lr, cfg.num_steps + 100)(0)
    after = state.model.state_dict()
    n_out = n_all = 0
    for k, w in want["after"].items():
        before = sd[k].numpy()
        g = np.abs(want["grads"][k].numpy()) * clip
        held = ((g == 0) & (seen[k].numpy() == 0)) | (g > 100 * cfg.epsilon)
        got = (after[k].numpy() - before) / lr0
        ref = (w.numpy() - before) / lr0
        bound = 1e-3 * np.abs(ref) + 2 * np.spacing(np.abs(before)) / lr0
        bad = held & (np.abs(got - ref) > bound)
        assert not bad.any(), (k, got[bad][:4], ref[bad][:4])
        n_out += int((~held).sum())
        n_all += held.size
    assert n_out <= 0.25 * n_all, (n_out, n_all)
