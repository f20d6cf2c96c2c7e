"""The port's training slice against the JAX package's, on the CPU.

- ``sequence_loss`` and ``onecycle_lr`` are twins of
  ``tests/test_train.py:18,57``, held against the JAX functions (and the
  schedule also against torch's own ``OneCycleLR``), fp32 rtol 1e-5;
- batch norm in train mode (flax semantics: momentum 0.9, biased batch
  variance) against flax ``BatchNorm``, twin of ``:127``;
- fused vs stacked loss through the port's step, twin of ``:169``;
- one full-model train step (64x64, batch 2, 2 iterations, fp32) from the
  same converted weights against JAX ``make_loss_fn`` + ``make_optimizer``
  (one jit of the JAX step per JAX configuration, ~35 s on the CPU, shared
  by the module): the plain, the materialized-kernel and the on-demand
  kernel configurations (``corr_impl='pallas'`` + fused gates);
- the non-finite guard, ``accum_steps`` and the reduced loop.

Tolerances of the full step: loss and metrics rtol 1e-4; each parameter's
gradient within rtol 1e-3 plus atol 1e-4 of the largest gradient entry of
the model.  Their reason is the encoder: JAX runs the stem and ``layer1``
in its folded-width layout (the same math summed in another order, a few
1e-5 relative in the activations, see test_torch_modules.py), and the
backward carries that noise, largest relative to the near-zero gradients
of conv biases that a norm follows.  After the update, each parameter is
within ``2 * lr`` of JAX's: Adam's first step moves an entry by
``lr * g / (|g| + eps)``, so a gradient entry within noise of zero can land
on either sign; where the gradient is not near zero (at least 1e-4 of
the largest entry) the parameters agree to 1e-3 of ``lr`` plus two fp32
ulps of the parameter.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from raft_tpu.config import RAFTConfig as JaxRAFTConfig
from raft_tpu.config import TrainConfig as JaxTrainConfig
from raft_tpu.models.raft import RAFT as JaxRAFT
from raft_tpu.train import loss as jloss
from raft_tpu.train import optim as joptim
from raft_tpu.train.step import make_loss_fn as jax_make_loss_fn
from raft_tpu_torch.config import RAFTConfig, TrainConfig
from raft_tpu_torch.convert import flax_from_state_dict, state_dict_from_flax
from raft_tpu_torch.models.layers import Norm, channel_dropout
from raft_tpu_torch.ops import (corr_kernels, gru_gates, pyramid_kernels,
                                upsample_loss)
from raft_tpu_torch.train import loop, loss, optim
from raft_tpu_torch.train.step import init_state, make_train_step

from test_torch_fixtures import full_raft_variables

B, H, W, ITERS = 2, 64, 64, 2
KW = dict(lr=2e-4, num_steps=100, batch_size=B, image_size=(H, W),
          iters=ITERS)


def _batch(seed, b=B, h=H, w=W):
    rng = np.random.default_rng(seed)
    return {"image1": rng.uniform(0, 255, (b, h, w, 3)).astype(np.float32),
            "image2": rng.uniform(0, 255, (b, h, w, 3)).astype(np.float32),
            "flow": (3 * rng.standard_normal((b, h, w, 2))).astype(
                np.float32),
            "valid": (rng.random((b, h, w)) > 0.1).astype(np.float32)}


def _params(state):
    return {k: v.detach().clone() for k, v in
            state.model.state_dict().items()}


def _capture_grads(state):
    """Record the gradients the optimizer sees (after the clip)."""
    seen = {}
    step = state.optimizer.step

    def hooked(*a, **k):
        seen.update({n: p.grad.detach().clone()
                     for n, p in state.model.named_parameters()})
        return step(*a, **k)

    state.optimizer.step = hooked
    return seen


def test_sequence_loss_matches_jax():
    rng = np.random.default_rng(0)
    iters, b, h, w = 5, 2, 16, 24
    preds = rng.normal(size=(iters, b, h, w, 2)).astype(np.float32)
    gt = rng.normal(scale=3, size=(b, h, w, 2)).astype(np.float32)
    gt[0, :2] = 500.0                        # beyond max_flow
    preds[-1, 1, 3, :4] = gt[1, 3, :4]       # exactly-zero residuals
    valid = (rng.random((b, h, w)) < 0.8).astype(np.float32)
    valid[1, 3, :4] = 1.0

    def jax_loss(p):
        return jloss.sequence_loss(p, jnp.asarray(gt), jnp.asarray(valid),
                                   gamma=0.8, max_flow=400.0)

    (want, wmet), wgrad = jax.value_and_grad(jax_loss, has_aux=True)(
        jnp.asarray(preds))
    tp = torch.from_numpy(preds).requires_grad_(True)
    got, met = loss.sequence_loss(tp, torch.from_numpy(gt),
                                  torch.from_numpy(valid), gamma=0.8,
                                  max_flow=400.0)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    assert set(met) == set(wmet)
    for k in met:
        np.testing.assert_allclose(met[k].numpy(), np.asarray(wmet[k]),
                                   rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(wgrad),
                               rtol=1e-5, atol=1e-9)
    assert tp.grad[-1, 1, 3, :4].abs().min() > 0     # +1 at exact zero


def test_onecycle_matches_jax_and_torch():
    peak, steps = 4e-4, 400
    ours = optim.onecycle_lr(peak, steps, pct_start=0.05)
    jsched = joptim.onecycle_lr(peak, steps, pct_start=0.05)
    got = np.array([ours(i) for i in range(steps + 5)])
    want = np.array([float(jsched(i)) for i in range(steps + 5)])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-12)

    m = torch.nn.Linear(2, 2)
    opt = torch.optim.AdamW(m.parameters(), lr=peak)
    tsched = torch.optim.lr_scheduler.OneCycleLR(
        opt, peak, steps, pct_start=0.05, cycle_momentum=False,
        anneal_strategy="linear")
    torch_lrs = []
    for _ in range(steps):
        torch_lrs.append(tsched.get_last_lr()[0])
        opt.step()
        tsched.step()
    np.testing.assert_allclose(got[:steps], torch_lrs, atol=peak * 0.01)


def test_optimizer_update_matches_optax():
    """Clip + AdamW + schedule on identical gradients: the port's update
    against optax's, two steps, a clipped and an unclipped one."""
    rng = np.random.default_rng(1)
    shapes = [(4, 3, 3, 3), (4,), (7, 5)]
    p0 = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    gs = [[(scale * rng.standard_normal(s)).astype(np.float32)
           for s in shapes] for scale in (3.0, 0.01)]
    tx = joptim.make_optimizer(1e-3, 50, 1e-4, 1e-8, 1.0)
    jp = [jnp.asarray(p) for p in p0]
    opt_state = tx.init(jp)
    params = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in p0]
    opt, sched = optim.make_optimizer(params, 1e-3, 50, 1e-4, 1e-8)
    for step, g in enumerate(gs):
        upd, opt_state = tx.update([jnp.asarray(x) for x in g], opt_state,
                                   jp)
        jp = optax.apply_updates(jp, upd)
        grads = [torch.from_numpy(x.copy()) for x in g]
        norm = optim.global_norm(grads)
        np.testing.assert_allclose(float(norm), float(optax.global_norm(g)),
                                   rtol=1e-6)
        optim.clip_by_global_norm_(grads, 1.0, norm)
        for p, x in zip(params, grads):
            p.grad = x
        for group in opt.param_groups:
            group["lr"] = sched(step)
        opt.step()
        for p, want in zip(params, jp):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(want),
                                       rtol=1e-6, atol=1e-8)


def test_batch_norm_train_stats_match_flax():
    """Batch statistics in train mode, running statistics moved with
    momentum 0.9 and the biased variance, as flax ``BatchNorm``; pinned
    under ``freeze_bn`` and in eval mode."""
    import flax.linen as fnn

    rng = np.random.default_rng(2)
    x = (rng.standard_normal((3, 6, 5, 8)) * 2 + 0.5).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 8).astype(np.float32)
    bias = rng.uniform(-0.2, 0.2, 8).astype(np.float32)
    mean0 = rng.uniform(-0.1, 0.1, 8).astype(np.float32)
    var0 = rng.uniform(0.5, 1.5, 8).astype(np.float32)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                       epsilon=1e-5)
    want, upd = bn.apply({"params": {"scale": scale, "bias": bias},
                          "batch_stats": {"mean": mean0, "var": var0}},
                         x, mutable=["batch_stats"])

    norm = Norm("batch", 8)
    with torch.no_grad():
        norm.weight.copy_(torch.from_numpy(scale))
        norm.bias.copy_(torch.from_numpy(bias))
        norm.running_mean.copy_(torch.from_numpy(mean0))
        norm.running_var.copy_(torch.from_numpy(var0))
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))
    got = norm.train()(xt)
    np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), rtol=1e-5, atol=1e-5)
    for key, buf in (("mean", norm.running_mean), ("var", norm.running_var)):
        np.testing.assert_allclose(buf.numpy(),
                                   np.asarray(upd["batch_stats"][key]),
                                   rtol=1e-5, atol=1e-6, err_msg=key)
    biased = x.reshape(-1, 8).var(0)
    np.testing.assert_allclose(norm.running_var.numpy(),
                               0.9 * var0 + 0.1 * biased, rtol=1e-5)
    before = norm.running_var.clone()
    norm(xt, freeze_bn=True)
    norm.eval()(xt)
    assert torch.equal(norm.running_var, before)


def _jax_step(**model_kw):
    """JAX's loss, gradients, batch statistics and one optax update from
    the fixture weights on ``_batch(0)``."""
    variables, _ = full_raft_variables(0)
    jcfg = JaxTrainConfig(**KW)
    # remat changes what JAX recomputes, not what it computes; off, the
    # one CPU compile is ~10 s shorter
    jmodel = JaxRAFT(JaxRAFTConfig.full(remat=False, remat_upsample=False,
                                        **model_kw))
    loss_fn = jax_make_loss_fn(jmodel, jcfg)
    batch = {k: jnp.asarray(v) for k, v in _batch(0).items()}
    (lval, (met, new_bs)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"], variables["batch_stats"], batch,
        jax.random.PRNGKey(0))
    tx = joptim.make_optimizer(jcfg.lr, jcfg.num_steps, jcfg.wdecay,
                               jcfg.epsilon, jcfg.clip)
    upd, _ = tx.update(grads, tx.init(variables["params"]),
                       variables["params"])
    new_params = optax.apply_updates(variables["params"], upd)
    return dict(loss=float(lval), metrics={k: np.asarray(v)
                                           for k, v in met.items()},
                grads=state_dict_from_flax({"params": grads,
                                            "batch_stats": new_bs}),
                after=state_dict_from_flax({"params": new_params,
                                            "batch_stats": new_bs}),
                grad_norm=float(optax.global_norm(grads)))


@pytest.fixture(scope="module")
def jax_step():
    return _jax_step()


@pytest.fixture(scope="module")
def jax_step_ondemand():
    """The JAX step of the on-demand configuration; on the CPU the JAX
    package resolves it to its own plain reference (``chunked`` lookup,
    unfused gates)."""
    return _jax_step(corr_impl="pallas", fused_gru=True)


@pytest.mark.parametrize("model_kw,reference", [
    ({}, "jax_step"),
    ({"corr_impl": "allpairs_pallas", "upsample_loss_kernel": "pallas"},
     "jax_step"),
    ({"corr_impl": "pallas", "fused_gru": True,
      "upsample_loss_kernel": "pallas"}, "jax_step_ondemand")],
    ids=["model_kw0", "model_kw1", "model_kw2"])
def test_train_step_matches_jax(request, model_kw, reference):
    """Each configuration (on the CPU the kernel ones run the plain
    versions of their kernels, forward and backward) against the JAX
    step of the same configuration."""
    jax_step = request.getfixturevalue(reference)
    _, sd = full_raft_variables(0)
    cfg = TrainConfig(**KW)
    state = init_state(RAFTConfig.full(**model_kw), cfg, device="cpu",
                       state_dict=sd)
    seen = _capture_grads(state)
    counters = (corr_kernels.LAUNCHES, gru_gates.LAUNCHES,
                pyramid_kernels.LAUNCHES, upsample_loss.LAUNCHES)
    before = [dict(c) for c in counters]
    state, met = make_train_step(cfg, device="cpu")(state, _batch(0))
    assert [dict(c) for c in counters] == before
    assert state.step == 1 and state.nonfinite_steps == 0

    np.testing.assert_allclose(float(met["loss"]), jax_step["loss"],
                               rtol=1e-4)
    for k, want in jax_step["metrics"].items():
        np.testing.assert_allclose(met[k].numpy(), want, rtol=1e-4,
                                   err_msg=k)
    np.testing.assert_allclose(float(met["grad_norm"]),
                               jax_step["grad_norm"], rtol=1e-4)
    clip = min(1.0, 1.0 / float(met["grad_norm"]))
    gmax = max(float(np.abs(g.numpy()).max())
               for k, g in jax_step["grads"].items() if k in seen)
    assert set(seen) == {k for k in sd if "running" not in k}
    for k, g in seen.items():
        np.testing.assert_allclose(g.numpy() / clip,
                                   jax_step["grads"][k].numpy(), rtol=1e-3,
                                   atol=1e-4 * gmax, err_msg=k)

    lr0 = optim.onecycle_lr(cfg.lr, cfg.num_steps + 100)(0)
    after = state.model.state_dict()
    for k, want in jax_step["after"].items():
        tol = 1e-5 if "running" in k else 2 * lr0 + 1e-6
        np.testing.assert_allclose(after[k].numpy(), want.numpy(), rtol=0,
                                   atol=tol, err_msg=k)
        if "running" not in k:                 # the update really moved
            assert not torch.equal(after[k], sd[k]), k
            big = np.abs(jax_step["grads"][k].numpy()) >= 1e-4 * gmax
            w = want.numpy()[big]
            np.testing.assert_allclose(
                after[k].numpy()[big], w, rtol=0,
                atol=1e-3 * lr0 + 2 * float(np.spacing(np.abs(w)).max(
                    initial=0.0)), err_msg=k)
    # the trained state converts to the flax tree and back
    tree = flax_from_state_dict(after)
    back = state_dict_from_flax(tree)
    assert all(torch.equal(back[k], after[k]) for k in after)
    np.testing.assert_array_equal(
        tree["batch_stats"]["cnet"]["norm1"]["BatchNorm_0"]["var"],
        after["cnet.norm1.running_var"].numpy())


def test_fused_loss_matches_stacked():
    _, sd = full_raft_variables(0)
    out = {}
    for fused in (True, False):
        cfg = TrainConfig(**KW, fused_loss=fused)
        state = init_state(RAFTConfig.full(), cfg, device="cpu",
                           state_dict=sd)
        state, met = make_train_step(cfg, device="cpu")(state, _batch(3))
        out[fused] = (met, state.model.state_dict())
    (mf, pf), (ms, ps) = out[True], out[False]
    for k in ("loss", "epe", "1px", "3px", "5px", "grad_norm", "loss_iter",
              "epe_iter"):
        np.testing.assert_allclose(mf[k].numpy(), ms[k].numpy(), rtol=1e-5,
                                   err_msg=k)
    for k in pf:
        np.testing.assert_allclose(pf[k].numpy(), ps[k].numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=k)


def test_nonfinite_guard_leaves_state_bit_identical():
    cfg = TrainConfig(**KW)
    state = init_state(RAFTConfig.full(), cfg, device="cpu")
    step_fn = make_train_step(cfg, device="cpu")
    state, _ = step_fn(state, _batch(4))          # optimizer state exists
    params = _params(state)
    opt = {k: v.clone() for s in state.optimizer.state.values()
           for k, v in s.items() if torch.is_tensor(v)}
    bad = _batch(5)
    bad["image1"][0, 3, 3, 0] = np.nan
    state, met = step_fn(state, bad)
    assert float(met["nonfinite"]) == 1.0
    assert state.step == 2 and state.nonfinite_steps == 1
    after = state.model.state_dict()
    assert all(torch.equal(after[k], v) for k, v in params.items())
    opt_after = {k: v for s in state.optimizer.state.values()
                 for k, v in s.items() if torch.is_tensor(v)}
    assert all(torch.equal(opt_after[k], v) for k, v in opt.items())
    state, met = step_fn(state, _batch(6))        # and it trains on
    assert float(met["nonfinite"]) == 0.0 and state.step == 3
    assert not torch.equal(state.model.state_dict()["fnet.conv1.weight"],
                           params["fnet.conv1.weight"])


def test_accum_steps_matches_full_batch():
    """accum_steps=2 == the full batch of 4 (frozen batch norm, whose batch
    statistics would otherwise couple only within a microbatch).  With the
    clip out of reach the optimizer sees the mean gradient itself, so the
    comparison is a direct fp32 gradient comparison (Adam's first step is
    sign-like and would turn reduction noise on near-zero entries into
    full-size flips)."""
    _, sd = full_raft_variables(0)
    out = {}
    for accum in (1, 2):
        cfg = TrainConfig(**{**KW, "batch_size": 4}, accum_steps=accum,
                          freeze_bn=True, clip=1e9)
        state = init_state(RAFTConfig.full(), cfg, device="cpu",
                           state_dict=sd)
        seen = _capture_grads(state)
        state, met = make_train_step(cfg, device="cpu")(
            state, _batch(7, b=4, h=32, w=48))
        out[accum] = (met, seen)
    (m1, g1), (m2, g2) = out[1], out[2]
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m1["grad_norm"]),
                               float(m2["grad_norm"]), rtol=1e-4)
    assert set(g1) == set(g2) == {k for k in sd if "running" not in k}
    for k in g1:
        np.testing.assert_allclose(g1[k].numpy(), g2[k].numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    with pytest.raises(ValueError, match="accum_steps=3 must divide"):
        cfg = dataclasses.replace(TrainConfig(**KW), accum_steps=3)
        make_train_step(cfg, device="cpu")(
            init_state(RAFTConfig.full(), cfg, device="cpu"),
            _batch(7, b=4, h=32, w=48))


def test_train_loop_logs_and_adds_noise():
    cfg = TrainConfig(**{**KW, "num_steps": 3, "image_size": (32, 48)},
                      log_freq=2, add_noise=True)
    lines = []
    batches = (_batch(10 + i, h=32, w=48) for i in range(5))
    state = loop.train(RAFTConfig.full(), cfg, batches, device="cpu",
                       log=lines.append)
    assert state.step == 3 and state.nonfinite_steps == 0
    assert len(lines) == 1 and lines[0].startswith("step 2 ")
    rng = np.random.default_rng(0)
    b = _batch(1, h=8, w=8)
    noisy = loop.add_image_noise(rng, b)
    assert noisy["image1"].min() >= 0 and noisy["image1"].max() <= 255
    assert not np.array_equal(noisy["image1"], b["image1"])
    assert np.array_equal(noisy["flow"], b["flow"])


def test_channel_dropout_is_channelwise_and_seeded():
    x = torch.ones(4, 64, 5, 7)
    gen = torch.Generator().manual_seed(3)
    y = channel_dropout(x, 0.25, gen)
    per_channel = y[:, :, 0, 0]
    assert torch.equal(y, per_channel[:, :, None, None].expand_as(y))
    kept = per_channel > 0
    assert torch.allclose(per_channel[kept], torch.tensor(1 / 0.75))
    assert 0.6 < kept.float().mean() < 0.9
    again = channel_dropout(x, 0.25, torch.Generator().manual_seed(3))
    assert torch.equal(y, again)
    cfg = TrainConfig(**{**KW, "image_size": (32, 48)})
    state = init_state(RAFTConfig.full(dropout=0.2), cfg, device="cpu")
    _, met = make_train_step(cfg, device="cpu")(state, _batch(8, h=32, w=48))
    assert np.isfinite(float(met["loss"]))
