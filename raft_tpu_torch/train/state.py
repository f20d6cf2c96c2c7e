"""Train state (the port of ``raft_tpu/train/state.py``): everything a step
reads and changes, in one object.  Unlike the JAX pytree it is mutable:
the step updates the model's parameters and batch-norm statistics (its
buffers), the optimizer's state and the non-finite counter in place on
the device, and advances ``step`` on the host.  ``programs`` holds the
step's captured graphs (``utils/graphs.py``), which read and write those
tensors where they are: whatever replaces the state's values (a
checkpoint restore) copies into them."""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from raft_tpu_torch.models.raft import RAFT
from raft_tpu_torch.utils.graphs import GraphCache


@dataclasses.dataclass
class TrainState:
    model: RAFT
    optimizer: torch.optim.Optimizer
    schedule: Callable                   # count -> learning rate
    generator: torch.Generator           # dropout draws, on the device
    # steps whose loss or gradients were not finite and whose update the
    # guard skipped: a 0-dim int64 tensor on the model's device
    nonfinite_steps: torch.Tensor
    step: int = 0
    programs: GraphCache = dataclasses.field(default_factory=GraphCache)
