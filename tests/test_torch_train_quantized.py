"""The model and the train step of the port's quantized / fused-encoder
slice against the JAX package, on the CPU.

- the train-mode forward of ``corr_dtype='int8'`` + ``fused_lookup_encoder``
  against JAX's ``RAFT.apply`` with ``pallas_offtpu='interpret'``, so that
  the JAX side runs its fused TPU kernel in interpret mode (batch 2,
  32x48, 2 iterations: ~13 s); flows within 1e-4 px;
- one train step of ``corr_dtype='int8'`` with the unfused
  ``allpairs_pallas`` lookup against JAX's step of the same configuration
  (on the CPU it resolves to its own ``allpairs`` int8 reference), under the
  bounds of ``tests/test_torch_train.py``, with a weight decay large enough
  (0.5) that the decay of a parameter without gradient moves it: ``fnet``,
  whose features reach the loss only through the codes, must take JAX's
  update exactly (its gradient is zero in both packages);
- AdamW on a parameter that gets no gradient: two steps decay it as optax
  decays it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from raft_tpu.config import RAFTConfig as JaxRAFTConfig
from raft_tpu.models.raft import RAFT as JaxRAFT
from raft_tpu.train import optim as joptim
from raft_tpu_torch.config import RAFTConfig, TrainConfig
from raft_tpu_torch.models.raft import RAFT
from raft_tpu_torch.train import optim
from raft_tpu_torch.train.step import init_state, make_train_step

from test_torch_fixtures import full_raft_variables, images
from test_torch_train import KW, _batch, _jax_step, check_step_matches_jax

INT8_FUSED = dict(corr_impl="allpairs_pallas", corr_dtype="int8",
                  fused_lookup_encoder=True)


def test_int8_fused_train_forward_matches_jax_kernel():
    variables, sd = full_raft_variables(0)
    i1, i2 = images(20, 32, 48, batch=2)
    cfg = JaxRAFTConfig.full(**INT8_FUSED, pallas_offtpu="interpret",
                             remat=False, remat_upsample=False)
    assert cfg.resolved_fused_lookup_encoder
    want, _ = jax.jit(lambda v, a, b: JaxRAFT(cfg).apply(
        v, a, b, iters=2, train=True, mutable=["batch_stats"]))(
        variables, jnp.asarray(i1), jnp.asarray(i2))
    model = RAFT(RAFTConfig.full(**INT8_FUSED))
    model.load_state_dict(sd)
    got = model.train()(torch.from_numpy(i1), torch.from_numpy(i2), iters=2)
    assert got.shape == want.shape == (2, 2, 32, 48, 2)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-4)


def test_int8_train_step_matches_jax_and_decays_fnet():
    train_kw = dict(KW, wdecay=0.5)
    model_kw = dict(corr_impl="allpairs_pallas", corr_dtype="int8",
                    upsample_loss_kernel="pallas")
    jax_step = _jax_step(train_kw, **model_kw)
    fnet = [k for k in jax_step["grads"] if k.startswith("fnet.")]
    assert fnet and all(not jax_step["grads"][k].any() for k in fnet)
    _, seen = check_step_matches_jax(jax_step, model_kw, train_kw)
    assert all(not seen[k].any() for k in fnet if k in seen)
    assert any(seen[k].any() for k in seen if k.startswith("cnet."))


def test_param_without_gradient_decays_as_optax():
    """Two int8 steps: ``fnet`` gets no gradient, the step gives it zeros,
    and AdamW moves it as optax's AdamW moves a parameter whose gradient is
    zero (weight decay only; moments stay zero).  torch multiplies by the
    fp32-rounded factor ``1 - lr * wd``, optax subtracts ``lr * wd * p``:
    each step may differ by an ulp or two, hence rtol 5e-7 after two."""
    cfg = TrainConfig(lr=1e-3, num_steps=10, batch_size=1,
                      image_size=(32, 48), iters=1, wdecay=0.2)
    state = init_state(RAFTConfig.full(corr_dtype="int8"), cfg,
                       device="cpu")
    p = state.model.fnet.conv1.weight
    p0 = p.detach().clone()
    step_fn = make_train_step(cfg, device="cpu")
    for seed in (30, 31):
        state, _ = step_fn(state, _batch(seed, b=1, h=32, w=48))
    st = state.optimizer.state[p]
    assert int(st["step"]) == 2
    assert not st["exp_avg"].any() and not st["exp_avg_sq"].any()

    tx = joptim.make_optimizer(cfg.lr, cfg.num_steps, cfg.wdecay,
                               cfg.epsilon, cfg.clip)
    jp = jnp.asarray(p0.numpy())
    opt_state = tx.init(jp)
    for _ in range(2):
        upd, opt_state = tx.update(jnp.zeros_like(jp), opt_state, jp)
        jp = optax.apply_updates(jp, upd)
    assert not torch.equal(p.detach(), p0)
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp),
                               rtol=5e-7, atol=0)
    lrs = [float(optim.onecycle_lr(cfg.lr, cfg.num_steps + 100)(i))
           for i in range(2)]
    decay = (1 - lrs[0] * cfg.wdecay) * (1 - lrs[1] * cfg.wdecay)
    np.testing.assert_allclose(p.detach().numpy(), p0.numpy() * decay,
                               rtol=5e-7, atol=0)
