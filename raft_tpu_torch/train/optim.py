"""Optimizer and learning-rate schedule (the port of
``raft_tpu/train/optim.py:16-52``): AdamW (b1 0.9, b2 0.999, weight decay
on every parameter) under a OneCycle schedule over ``num_steps + 100``
steps, after a global-norm gradient clip with optax's rule.
"""

from __future__ import annotations

from typing import Callable, Iterable, List, Tuple

import torch


def _linear(init: float, end: float, steps: int, count: int) -> float:
    """optax ``linear_schedule``: ``init`` to ``end`` over ``steps``."""
    if steps <= 0:
        return init
    count = min(max(count, 0), steps)
    return (init - end) * (1.0 - count / steps) + end


def onecycle_lr(peak_lr: float, total_steps: int, pct_start: float = 0.05,
                div_factor: float = 25.0, final_div_factor: float = 1e4
                ) -> Callable[[int], float]:
    """torch ``OneCycleLR(anneal_strategy='linear')`` as the JAX package
    writes it: warm up from ``peak/div_factor`` until step
    ``pct_start*total - 1``, then anneal linearly to
    ``peak/(div_factor*final_div_factor)`` at step ``total - 1``.
    Returns ``step -> lr``."""
    initial = peak_lr / div_factor
    final = initial / final_div_factor
    warm_end = max(int(round(pct_start * total_steps)) - 1, 1)

    def schedule(step: int) -> float:
        if step < warm_end:
            return _linear(initial, peak_lr, warm_end, step)
        return _linear(peak_lr, final, total_steps - 1 - warm_end,
                       step - warm_end)

    return schedule


def make_optimizer(params: Iterable[torch.nn.Parameter], lr: float,
                   num_steps: int, wdecay: float = 1e-4,
                   epsilon: float = 1e-8, pct_start: float = 0.05
                   ) -> Tuple[torch.optim.Optimizer, Callable[[int], float]]:
    """``(AdamW, schedule)``; the train step sets each update's learning
    rate from the schedule and clips the gradients first
    (:func:`clip_by_global_norm_`)."""
    schedule = onecycle_lr(lr, num_steps + 100, pct_start)
    opt = torch.optim.AdamW(params, lr=schedule(0), betas=(0.9, 0.999),
                            eps=epsilon, weight_decay=wdecay)
    return opt, schedule


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
