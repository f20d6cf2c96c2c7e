"""Training of the port (the port of ``raft_tpu/train/``): the sequence
loss, AdamW + OneCycle with the global-norm clip, the train state and
step, checkpoints, the logger and the loop.  Entry points:
:func:`raft_tpu_torch.train.step.make_train_step`,
:func:`raft_tpu_torch.train.loop.train` and ``python -m raft_tpu_torch
train``."""
