"""RAFT inference and training in PyTorch with hand-written CUDA kernels
for Hopper.

The PyTorch port of the JAX package ``raft_tpu``; it imports neither JAX
nor ``raft_tpu``.  Entry points: :func:`raft_tpu_torch.evaluate.
make_eval_fn`, ``python -m raft_tpu_torch.cli.demo``,
:func:`raft_tpu_torch.train.step.make_train_step` and
:func:`raft_tpu_torch.train.loop.train`.
"""

from raft_tpu_torch.config import RAFTConfig
from raft_tpu_torch.models.raft import RAFT

__all__ = ["RAFT", "RAFTConfig"]
