"""Train state (the port of ``raft_tpu/train/state.py``): everything a step
reads and changes, in one object.  Unlike the JAX pytree it is mutable:
the step updates the model's parameters and batch-norm statistics (its
buffers) and the optimizer's state in place and advances the counters."""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from raft_tpu_torch.models.raft import RAFT


@dataclasses.dataclass
class TrainState:
    model: RAFT
    optimizer: torch.optim.Optimizer
    schedule: Callable[[int], float]     # step -> learning rate
    generator: torch.Generator           # dropout draws, on the device
    step: int = 0
    # steps whose loss or gradients were not finite and whose update the
    # guard skipped
    nonfinite_steps: int = 0
