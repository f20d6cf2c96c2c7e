"""The training step (the port of ``raft_tpu/train/step.py:31-216``):
forward in train mode + γ-weighted sequence loss + backward + global-norm
clip + AdamW/OneCycle update, on one device.

- ``cfg.fused_loss`` (default): the model returns the per-iteration loss
  terms from its flat upsample + loss chain; otherwise it returns stacked
  flows and :func:`raft_tpu_torch.train.loss.sequence_loss` weighs them.
- ``cfg.accum_steps > 1`` splits the batch into equal microbatches, runs
  forward and backward on each and sums the gradients in fp32; the update
  sees their mean.  Batch-norm statistics move microbatch by microbatch.
- ``cfg.nonfinite_guard``: a step whose loss or gradient norm is not
  finite leaves the parameters, the optimizer state and the batch-norm
  statistics as they were (bit for bit), bumps ``nonfinite_steps``, and
  still advances ``step`` and with it the schedule.  The check reads one
  flag back to the host per step.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional

import torch

from raft_tpu_torch.config import RAFTConfig, TrainConfig
from raft_tpu_torch.evaluate import DeviceLike, resolve_device
from raft_tpu_torch.models.raft import RAFT
from raft_tpu_torch.train.loss import sequence_loss
from raft_tpu_torch.train.optim import (clip_by_global_norm_, global_norm,
                                        make_optimizer)
from raft_tpu_torch.train.state import TrainState

BATCH_KEYS = ("image1", "image2", "flow", "valid")


def init_state(model_cfg: RAFTConfig, cfg: TrainConfig,
               device: DeviceLike = "cuda",
               state_dict: Optional[Mapping] = None) -> TrainState:
    """A fresh state on ``device``: the model seeded from ``cfg.seed`` (or
    holding ``state_dict``) in train mode, AdamW + OneCycle from
    :func:`make_optimizer`, and a dropout generator seeded from
    ``cfg.seed``."""
    dev = resolve_device(device)
    model = RAFT(model_cfg, seed=cfg.seed)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    model = model.to(dev).train()
    opt, sched = make_optimizer(model.parameters(), cfg.lr, cfg.num_steps,
                                cfg.wdecay, cfg.epsilon)
    gen = torch.Generator(device=dev).manual_seed(cfg.seed)
    return TrainState(model=model, optimizer=opt, schedule=sched,
                      generator=gen)


def make_loss_fn(cfg: TrainConfig) -> Callable:
    """``loss_fn(model, batch, generator) -> (loss, metrics)``: the
    differentiated core of the step.  ``batch`` holds tensors on the
    model's device; the metrics are detached."""

    def loss_fn(model: RAFT, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None):
        kwargs = dict(iters=cfg.iters, freeze_bn=cfg.freeze_bn,
                      generator=generator)
        if cfg.fused_loss:
            per_iter, metrics = model(
                batch["image1"], batch["image2"],
                loss_targets=(batch["flow"], batch["valid"], cfg.max_flow),
                **kwargs)
            i = torch.arange(cfg.iters, dtype=torch.float32,
                             device=per_iter.device)
            weights = cfg.gamma ** (cfg.iters - i - 1.0)
            loss = torch.sum(weights * per_iter)
            metrics = dict(metrics, loss_iter=per_iter)
        else:
            flows = model(batch["image1"], batch["image2"], **kwargs)
            loss, metrics = sequence_loss(flows, batch["flow"],
                                          batch["valid"], gamma=cfg.gamma,
                                          max_flow=cfg.max_flow)
        return loss, {k: v.detach() for k, v in metrics.items()}

    return loss_fn


def _to_device(batch: Mapping, dev: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(batch[k], dtype=torch.float32, device=dev)
            for k in BATCH_KEYS}


def make_train_step(cfg: TrainConfig, device: DeviceLike = "cuda"
                    ) -> Callable:
    """``step_fn(state, batch) -> (state, metrics)``: one update of
    ``state`` in place.  ``batch`` holds ``image1``/``image2``
    ``(B, H, W, 3)`` in [0, 255], ``flow`` ``(B, H, W, 2)`` and ``valid``
    ``(B, H, W)`` as arrays or tensors (moved to ``device``).  Metrics are
    device tensors: ``loss``, ``epe``, ``1px``, ``3px``, ``5px``,
    ``loss_iter``, ``epe_iter``, ``grad_norm`` and ``nonfinite``."""
    dev = resolve_device(device)
    loss_fn = make_loss_fn(cfg)
    accum = max(int(cfg.accum_steps), 1)

    def step_fn(state: TrainState, batch: Mapping):
        model = state.model
        batch = _to_device(batch, dev)
        B = batch["image1"].shape[0]
        if B % accum:
            raise ValueError(
                f"accum_steps={accum} must divide the batch size {B} evenly "
                f"(remainder {B % accum})")
        params = list(model.parameters())
        stats = ({k: v.clone() for k, v in model.named_buffers()}
                 if cfg.nonfinite_guard else None)
        model.train()
        model.zero_grad(set_to_none=True)
        if accum == 1:
            loss, metrics = loss_fn(model, batch, state.generator)
            loss.backward()
            grads = [p.grad for p in params]
        else:
            m = B // accum
            acc = [torch.zeros_like(p, dtype=torch.float32) for p in params]
            losses, parts = [], []
            for i in range(accum):
                micro = {k: v[i * m:(i + 1) * m] for k, v in batch.items()}
                model.zero_grad(set_to_none=True)
                loss_i, metrics_i = loss_fn(model, micro, state.generator)
                loss_i.backward()
                torch._foreach_add_(acc, [p.grad.float() for p in params])
                losses.append(loss_i.detach())
                parts.append(metrics_i)
            grads = [a / accum for a in acc]
            loss = torch.stack(losses).mean()
            metrics = {k: torch.stack([p[k] for p in parts]).mean(dim=0)
                       for k in parts[0]}
        gnorm = global_norm(grads)
        ok = True
        if cfg.nonfinite_guard:
            ok = bool(torch.isfinite(loss) & torch.isfinite(gnorm))
        if ok:
            clip_by_global_norm_(grads, cfg.clip, gnorm)
            for p, g in zip(params, grads):
                p.grad = g.to(p.dtype)
            for group in state.optimizer.param_groups:
                group["lr"] = state.schedule(state.step)
            state.optimizer.step()
        else:
            with torch.no_grad():
                for k, v in model.named_buffers():
                    v.copy_(stats[k])
            state.nonfinite_steps += 1
        state.step += 1
        model.zero_grad(set_to_none=True)
        metrics = dict(metrics, loss=loss.detach(), grad_norm=gnorm,
                       nonfinite=torch.tensor(0.0 if ok else 1.0))
        return state, metrics

    return step_fn
