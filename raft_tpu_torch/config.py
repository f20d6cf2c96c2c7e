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
  ``'allpairs'`` lookup.  With ``fused_lookup_encoder`` the lookup and the
  motion encoder's first 1x1 conv run as one kernel
  (``ops/lookup_encode.py``).

A materialized pyramid may be stored quantized (``corr_dtype`` ``'int8'``,
``'float8_e4m3fn'``, ``'float8_e5m2'``): codes plus one fp32 scale per
(batch element, level), ``ops/corr.py``.

Rematerialization (``remat``, ``remat_policy``, ``remat_upsample``) takes
the JAX package's vocabulary and runs through ``torch.utils.checkpoint``
(``models/raft.py``); its default here is off, the choice measured on the
H100 (PERF.md).  TPU-tuned knobs of the JAX package (``scan_unroll``,
``upsample_group``, ``lookup_block_q``) have no counterpart: a captured
graph (``utils/graphs.py``) already holds every iteration, so there is no
scan to unroll.  Nothing here asks a backend anything: the device is an
explicit argument of the entry points.

Precision.  ``corr_precision`` takes the JAX vocabulary (``'auto'`` is
``'highest'``) and sets the precision of the correlation's matrix
products (``ops/corr.py``) as XLA runs them on a GPU: ``'highest'`` is
full fp32, ``'high'`` and ``'default'`` are TF32.  The convolutions'
precision is not a configuration field: :func:`entry_precision` sets it
for every entry point's call from :data:`CONV_TF32`, so that no entry
point inherits it from the process.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional, Tuple

import torch

from raft_tpu_torch.ops.corr import (CORR_PRECISIONS, corr_quant_spec,
                                     validate_corr_precision)

CORR_IMPLS = ("allpairs", "chunked", "pallas", "allpairs_pallas")
COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# Storage dtypes of the materialized pyramid.
CORR_DTYPES = ("auto", "float32", "bfloat16", "int8", "float8_e4m3fn",
               "float8_e5m2")
QUANTIZED_CORR_DTYPES = ("int8", "float8_e4m3fn", "float8_e5m2")
UPSAMPLE_LOSS_KERNELS = ("xla", "pallas")
UPSAMPLE_DTYPES = ("auto", "float32", "bfloat16")
REMAT_POLICIES = ("full", "dots", "save_corr", "save_corr_upsample")

# TF32 for the fp32 convolutions of every entry point (cuDNN), the choice
# measured on the H100 (PERF.md, the TF32 measurement): XLA's default on a
# GPU, and what JAX runs.  The kernels compute in fp32 whatever it is.
CONV_TF32 = True


def validate_corr_dtype(value: str, flag: str = "corr_dtype") -> str:
    """``value`` if it names a correlation storage dtype, else a
    ``ValueError`` naming the allowed set (for the CLI's edge)."""
    if value not in CORR_DTYPES:
        raise ValueError(
            f"invalid {flag}={value!r}; allowed: {', '.join(CORR_DTYPES)}")
    return value


def backend_flags() -> Tuple[bool, bool, bool, bool]:
    """``(cuDNN TF32, cuBLAS TF32, cuDNN deterministic, cuDNN benchmark)``
    as the process has them now: part of a captured graph's key, since a
    capture bakes in the kernels they choose."""
    return (bool(torch.backends.cudnn.allow_tf32),
            bool(torch.backends.cuda.matmul.allow_tf32),
            bool(torch.backends.cudnn.deterministic),
            bool(torch.backends.cudnn.benchmark))


@contextlib.contextmanager
def entry_precision():
    """The TF32 state of one entry-point call, restored on exit: cuDNN
    TF32 is :data:`CONV_TF32` (read at each call) and cuBLAS TF32 is off,
    so that a matrix product runs TF32 only where ``corr_precision`` asks
    for it (``ops/corr.py``)."""
    before = (torch.backends.cudnn.allow_tf32,
              torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = CONV_TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = before


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
    # otherwise; 'int8' / 'float8_e4m3fn' / 'float8_e5m2' store codes and
    # a per-level scale, with no gradient through the volume (fnet then
    # learns nothing from it).  The correlation and its pooling are
    # computed in fp32 and the lookups accumulate in fp32; only the
    # stored levels round.
    corr_dtype: str = "auto"
    # Precision of the correlation's matrix products (the all-pairs
    # volume and the plain window sampling), JAX's vocabulary: 'highest'
    # (and 'auto') full fp32, 'high' and 'default' TF32 on the card, as
    # XLA runs them on a GPU; fp32 on the CPU.  The CUDA kernels compute
    # in fp32 whatever it is.
    corr_precision: str = "auto"
    # Encoders and update block compute in this dtype; parameters stay
    # fp32 and are cast at each conv.  Correlation and coordinates stay
    # fp32.
    compute_dtype: str = "float32"
    # Training upsample + loss chain: 'xla' is the plain PyTorch chain,
    # computed in upsample_dtype; 'pallas' the fused CUDA kernel
    # (ops/upsample_loss.py), fp32 inside whatever the compute dtype.
    upsample_loss_kernel: str = "xla"
    # Dtype of the plain upsample chain of the fused-loss training path
    # (the convex combination before the compare; evaluation always
    # upsamples fp32, and the compare and the sums are fp32): 'auto' is
    # bf16 under bf16 compute, fp32 otherwise, as in JAX.
    upsample_dtype: str = "auto"
    # Fused GRU gate chains (ops/gru_gates.py): sigmoid(r)*h and the
    # blend each become one kernel launch on CUDA (forward only).
    fused_gru: bool = False
    # Pyramid lookup + the motion encoder's convc1 (+ bias + relu) as one
    # CUDA kernel (ops/lookup_encode.py): the tap tensor never reaches
    # device memory.  Only with corr_impl='allpairs_pallas'.
    fused_lookup_encoder: bool = False
    # Recompute the refinement step in backward instead of keeping its
    # activations (torch.utils.checkpoint).  Policies, as in JAX:
    # 'save_corr' keeps the lookup taps (or the fused lookup + convc1
    # output) and the motion encoder's output and recomputes the rest of
    # the step; 'full' recomputes the lookup too; 'dots' keeps every conv
    # output; 'save_corr_upsample' keeps what 'save_corr' keeps (the mask
    # head never runs inside the step here).
    remat: bool = False
    remat_policy: str = "save_corr"
    # Recompute the mask head (and the upsample-loss forward) over the
    # folded iterations in backward: only the stacked GRU states stay.
    remat_upsample: bool = False

    def __post_init__(self):
        for name, value, allowed in (
                ("corr_impl", self.corr_impl, CORR_IMPLS),
                ("compute_dtype", self.compute_dtype, COMPUTE_DTYPES),
                ("corr_dtype", self.corr_dtype, CORR_DTYPES),
                ("upsample_loss_kernel", self.upsample_loss_kernel,
                 UPSAMPLE_LOSS_KERNELS),
                ("upsample_dtype", self.upsample_dtype, UPSAMPLE_DTYPES)):
            if value not in allowed:
                raise ValueError(f"unknown {name} {value!r}; "
                                 f"allowed: {', '.join(allowed)}")
        validate_corr_precision(self.corr_precision)
        if self.remat_policy not in REMAT_POLICIES:
            raise ValueError(f"unknown remat_policy: {self.remat_policy!r} "
                             "(expected 'full', 'dots', 'save_corr' or "
                             "'save_corr_upsample')")
        if self.corr_dtype_is_quantized and self.corr_impl in ("chunked",
                                                               "pallas"):
            raise ValueError(
                f"corr_dtype={self.corr_dtype!r} requires a materialized "
                "pyramid (corr_impl 'allpairs' or 'allpairs_pallas'); the "
                f"on-demand {self.corr_impl!r} path never stores the volume, "
                "so there is nothing to quantize")
        if self.fused_lookup_encoder and self.corr_impl != "allpairs_pallas":
            raise ValueError(
                "fused_lookup_encoder=True requires corr_impl="
                f"'allpairs_pallas' (got {self.corr_impl!r}): the fused "
                "kernel samples the materialized pyramid")

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
    def resolved_upsample_dtype(self) -> str:
        """JAX's ``'auto'`` rule: bf16 under bf16 compute, else fp32."""
        if self.upsample_dtype == "auto":
            return ("bfloat16" if self.compute_dtype == "bfloat16"
                    else "float32")
        return self.upsample_dtype

    @property
    def resolved_corr_precision(self) -> str:
        """JAX's ``'auto'`` rule: ``'highest'``."""
        return ("highest" if self.corr_precision == "auto"
                else self.corr_precision)

    @property
    def corr_dtype_is_quantized(self) -> bool:
        """True for int8 / fp8 storage (codes + a per-level scale)."""
        return self.resolved_corr_dtype in QUANTIZED_CORR_DTYPES

    @property
    def corr_torch_dtype(self) -> torch.dtype:
        """The pyramid's storage dtype: fp32 or bf16 for plain levels,
        ``torch.int8`` / ``torch.float8_e4m3fn`` / ``torch.float8_e5m2``
        for the codes of quantized ones."""
        spec = corr_quant_spec(self.resolved_corr_dtype)
        return spec[0] if spec else COMPUTE_DTYPES[self.resolved_corr_dtype]

    def replace(self, **kw) -> "RAFTConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training hyperparameters: the subset of the JAX package's
    ``TrainConfig`` that the port's step, loop and train CLI read, under
    its names and defaults."""

    name: str = "raft"
    stage: str = "chairs"
    restore_ckpt: Optional[str] = None
    validation: Tuple[str, ...] = ()
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
    val_freq: int = 5000        # checkpoint + validation cadence in steps
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
    # Loader decode window in batches (0: max(2 * batch, 2 * workers)
    # samples).
    prefetch_batches: int = 0
    # Batches prepared and copied to the device ahead of the step on a
    # background thread (0: the serial fetch -> prep -> copy -> step path;
    # the batch stream is the same either way).
    device_prefetch: int = 2
    ckpt_dir: str = "checkpoints"
    # Background checkpoint commits in flight before save_async waits.
    ckpt_commit_window: int = 2
    # Host batches kept in the forensics ring (obs/health.py); 0 keeps no
    # batch in a non-finite step's bundle.
    forensic_keep: int = 8
    # Stall watchdog (obs/watchdog.py): seconds without a loop heartbeat
    # before a stack dump and a `stall` event (0 = off); hard exit (code
    # 42) when it fires.
    watchdog_timeout: float = 0.0
    watchdog_exit: bool = False
    # Fraction of steps traced as a `train_step` tree (obs/trace.py).
    trace_sample_rate: float = 0.0
    # Absolute steps [A, B) of the torch.profiler window, or None.
    profile_steps: Optional[Tuple[int, int]] = None
