"""Frozen model and training configuration for the PyTorch port.

Subsets of the JAX package's ``RAFTConfig`` and ``TrainConfig``
(``raft_tpu/config.py``), kept as the port's own copies.  The ``corr_impl``
vocabulary is the same, so a configuration means the same thing in both
packages:

- ``'allpairs'``: materialize the all-pairs volume and its pooled
  pyramid, sample windows with dense interpolation weights (plain
  PyTorch, ``ops/corr.py``);
- ``'chunked'``: on-demand lookup, blockwise over queries, never
  materializing the volume (plain PyTorch, ``ops/corr.py``);
- ``'pallas'``: the same on-demand lookup as one hand-written CUDA
  kernel (``ops/corr_kernels.py``); on a CPU tensor it runs the
  ``'chunked'`` plain version;
- ``'allpairs_pallas'``: the same materialized pyramid as ``'allpairs'``,
  sampled by the hand-written pyramid-lookup CUDA kernel and its
  backward (``ops/pyramid_kernels.py``); on a CPU tensor it runs the
  ``'allpairs'`` lookup.

TPU-tuned knobs of the JAX package (``scan_unroll``, ``upsample_group``,
``remat*``, ``lookup_block_q``, ``corr_precision``) have no counterpart.
Nothing here asks a backend anything: the device is an explicit argument
of the entry points.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

CORR_IMPLS = ("allpairs", "chunked", "pallas", "allpairs_pallas")
COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# Storage dtypes of the materialized pyramid; the quantized ones belong to
# a later slice of the port (the quantized-lookup kernel).
CORR_DTYPES = ("auto", "float32", "bfloat16", "int8", "float8_e4m3fn",
               "float8_e5m2")
QUANTIZED_CORR_DTYPES = ("int8", "float8_e4m3fn", "float8_e5m2")
UPSAMPLE_LOSS_KERNELS = ("xla", "pallas")


@dataclasses.dataclass(frozen=True)
class RAFTConfig:
    """Model hyperparameters: the full model (hidden 128 / context 128 /
    radius 4) and the small model (hidden 96 / context 64 / radius 3)."""

    small: bool = False
    hidden_dim: int = 128
    context_dim: int = 128
    corr_levels: int = 4
    corr_radius: int = 4
    # Channel-wise dropout after each encoder's output conv (train mode).
    dropout: float = 0.0
    corr_impl: str = "allpairs"
    # Query pixels per block of the plain on-demand lookup ('chunked').
    corr_block_size: int = 256
    # Storage dtype of the materialized pyramid ('allpairs' and
    # 'allpairs_pallas'): 'auto' is bf16 under bf16 compute, fp32
    # otherwise.  The correlation and its pooling are computed in fp32 and
    # the lookups accumulate in fp32; only the stored levels round.
    corr_dtype: str = "auto"
    # Encoders and update block compute in this dtype; parameters stay
    # fp32 and are cast at each conv.  Correlation and coordinates stay
    # fp32.
    compute_dtype: str = "float32"
    # Training upsample + loss chain: 'xla' is the plain PyTorch chain,
    # computed in the compute dtype (the JAX package's default
    # upsample_dtype='auto'); 'pallas' the fused CUDA kernel
    # (ops/upsample_loss.py), fp32 inside whatever the compute dtype.
    upsample_loss_kernel: str = "xla"
    # Fused GRU gate chains (ops/gru_gates.py): sigmoid(r)*h and the
    # blend each become one kernel launch on CUDA (forward only).
    fused_gru: bool = False

    def __post_init__(self):
        for name, value, allowed in (
                ("corr_impl", self.corr_impl, CORR_IMPLS),
                ("compute_dtype", self.compute_dtype, COMPUTE_DTYPES),
                ("corr_dtype", self.corr_dtype, CORR_DTYPES),
                ("upsample_loss_kernel", self.upsample_loss_kernel,
                 UPSAMPLE_LOSS_KERNELS)):
            if value not in allowed:
                raise ValueError(f"unknown {name} {value!r}; "
                                 f"allowed: {', '.join(allowed)}")

    @classmethod
    def full(cls, **kw) -> "RAFTConfig":
        base = dict(small=False, hidden_dim=128, context_dim=128,
                    corr_levels=4, corr_radius=4)
        return cls(**{**base, **kw})

    @classmethod
    def small_model(cls, **kw) -> "RAFTConfig":
        base = dict(small=True, hidden_dim=96, context_dim=64,
                    corr_levels=4, corr_radius=3)
        return cls(**{**base, **kw})

    @property
    def corr_planes(self) -> int:
        """levels * (2r+1)^2: the motion encoder's corr fan-in."""
        return self.corr_levels * (2 * self.corr_radius + 1) ** 2

    @property
    def dtype(self) -> torch.dtype:
        return COMPUTE_DTYPES[self.compute_dtype]

    @property
    def resolved_corr_dtype(self) -> str:
        """JAX's ``'auto'`` rule: bf16 under bf16 compute, else fp32."""
        if self.corr_dtype == "auto":
            return self.compute_dtype
        return self.corr_dtype

    @property
    def corr_torch_dtype(self) -> torch.dtype:
        """The pyramid's storage dtype; a quantized one raises."""
        name = self.resolved_corr_dtype
        if name in QUANTIZED_CORR_DTYPES:
            raise NotImplementedError(
                f"corr_dtype={name!r} (quantized pyramid storage) belongs to "
                "a later slice of the port, with the quantized lookup kernel")
        return COMPUTE_DTYPES[name]

    def replace(self, **kw) -> "RAFTConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training hyperparameters: the subset of the JAX package's
    ``TrainConfig`` that the port's step and reduced loop read."""

    lr: float = 4e-4
    num_steps: int = 100000
    batch_size: int = 6
    image_size: Tuple[int, int] = (384, 512)
    iters: int = 12
    wdecay: float = 1e-4
    epsilon: float = 1e-8
    clip: float = 1.0
    gamma: float = 0.8          # exponential weight of the sequence loss
    max_flow: float = 400.0     # pixels with |gt| >= max_flow are excluded
    add_noise: bool = False
    seed: int = 1234
    log_freq: int = 100
    freeze_bn: bool = False     # every stage but chairs
    # Sequence loss inside the upsample stage (space-to-depth sums, the
    # full-resolution per-iteration flows never exist); False returns the
    # stacked flows and applies sequence_loss to them.
    fused_loss: bool = True
    # Microbatches per step, gradients accumulated in fp32.
    accum_steps: int = 1
    # A step whose loss or gradients are not finite leaves parameters,
    # optimizer state and batch-norm statistics as they were.
    nonfinite_guard: bool = True
