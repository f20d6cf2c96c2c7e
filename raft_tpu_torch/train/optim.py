"""Optimizer and learning-rate schedule (the port of
``raft_tpu/train/optim.py:16-52``): AdamW (b1 0.9, b2 0.999, weight decay
on every parameter) under a OneCycle schedule over ``num_steps + 100``
steps, after a global-norm gradient clip with optax's rule.

The update runs on the device with nothing read back, so that the train
step can be captured as one CUDA graph: torch's fused AdamW
(``capturable`` on the card), its state made at construction, and a 0-dim
learning-rate tensor that :func:`set_scheduled_lr_` fills from the
optimizer's own update count before each update.  That count is optax's:
a step that the non-finite guard skips does not advance it, so the
schedule and the bias correction stand still with it, as in the JAX
package.
"""

from __future__ import annotations

from typing import Callable, Iterable, List, Tuple, Union

import torch


def onecycle_lr(peak_lr: float, total_steps: int, pct_start: float = 0.05,
                div_factor: float = 25.0, final_div_factor: float = 1e4
                ) -> Callable[[Union[int, torch.Tensor]], torch.Tensor]:
    """torch ``OneCycleLR(anneal_strategy='linear')`` as the JAX package
    writes it: warm up from ``peak/div_factor`` until step
    ``pct_start*total - 1``, then anneal linearly to
    ``peak/(div_factor*final_div_factor)`` at step ``total - 1`` (optax
    ``linear_schedule`` pieces).  Returns ``count -> lr``, torch ops on a
    0-dim count computed in fp64: the train step evaluates it on the
    optimizer's device count, the logger on ``step`` and reads it with
    ``float``."""
    initial = peak_lr / div_factor
    final = initial / final_div_factor
    warm_end = max(int(round(pct_start * total_steps)) - 1, 1)
    anneal = total_steps - 1 - warm_end

    def linear(init: float, end: float, steps: int,
               n: torch.Tensor) -> torch.Tensor:
        if steps <= 0:
            return torch.full_like(n, init)
        return (init - end) * (1.0 - n.clamp(0, steps) / steps) + end

    def schedule(count: Union[int, torch.Tensor]) -> torch.Tensor:
        c = torch.as_tensor(count).double()
        return torch.where(c < warm_end, linear(initial, peak_lr, warm_end, c),
                           linear(peak_lr, final, anneal, c - warm_end))

    return schedule


def make_optimizer(params: Iterable[torch.nn.Parameter], lr: float,
                   num_steps: int, wdecay: float = 1e-4,
                   epsilon: float = 1e-8, pct_start: float = 0.05
                   ) -> Tuple[torch.optim.Optimizer, Callable]:
    """``(AdamW, schedule)``: the fused AdamW with its state made now on
    the parameters' device (``capturable`` on the card) and a 0-dim
    learning-rate tensor; the train step fills it with
    :func:`set_scheduled_lr_` and clips the gradients first
    (:func:`clip_by_global_norm_`)."""
    params = list(params)
    dev = params[0].device
    schedule = onecycle_lr(lr, num_steps + 100, pct_start)
    opt = torch.optim.AdamW(
        params, lr=schedule(0).float().to(dev),
        betas=(0.9, 0.999), eps=epsilon, weight_decay=wdecay, fused=True,
        capturable=dev.type == "cuda")
    for p in params:
        opt.state[p] = {
            "step": torch.zeros((), dtype=torch.float32, device=dev),
            "exp_avg": torch.zeros_like(p, memory_format=torch.preserve_format),
            "exp_avg_sq": torch.zeros_like(
                p, memory_format=torch.preserve_format)}
    return opt, schedule


def update_count(opt: torch.optim.Optimizer) -> torch.Tensor:
    """The optimizer's update count (optax's ``count``): a 0-dim device
    tensor, the same for every parameter."""
    return opt.state[opt.param_groups[0]["params"][0]]["step"]


def set_scheduled_lr_(opt: torch.optim.Optimizer,
                      schedule: Callable) -> None:
    """Fill every group's learning-rate tensor with ``schedule`` at the
    optimizer's update count, on the device."""
    lr = schedule(update_count(opt))
    for group in opt.param_groups:
        group["lr"].copy_(lr)


def load_optimizer_state_(opt: torch.optim.Optimizer, saved: dict) -> None:
    """Copy the saved moments and update count of each parameter
    (``opt.state_dict()`` layout) into the tensors ``opt`` holds, whose
    groups stay as they are: a captured graph that reads them stays valid,
    and a state saved by another AdamW (plain, not capturable, a float
    learning rate) loads into this one.  A parameter the saved state has
    no entry for (never updated) keeps its zeros."""
    ids = [i for g in saved["param_groups"] for i in g["params"]]
    params = [p for g in opt.param_groups for p in g["params"]]
    for i, p in zip(ids, params):
        for k, v in saved["state"].get(i, {}).items():
            opt.state[p][k].copy_(v)


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """``sqrt(sum of squares)`` over every element of every tensor."""
    return torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(t.float()) for t in tensors]))


def clip_by_global_norm_(grads: List[torch.Tensor], clip: float,
                         norm: torch.Tensor) -> None:
    """Scale ``grads`` in place by ``clip / max(norm, clip)``: optax's
    ``clip_by_global_norm``, not ``clip_grad_norm_``'s
    ``clip / (norm + 1e-6)``.  Stays on the device (no host sync)."""
    factor = torch.where(norm < clip, torch.ones_like(norm), clip / norm)
    torch._foreach_mul_(grads, factor)
