"""Tensor ops of the port: plain PyTorch versions and CUDA kernel
wrappers (``corr_kernels``, ``gru_gates``, ``pyramid_kernels``,
``lookup_encode``, ``upsample_loss``; built by ``build``)."""

from __future__ import annotations

from typing import Dict, Tuple


def launch_counters() -> Tuple[Dict[str, int], ...]:
    """Every kernel wrapper's ``LAUNCHES`` dict (name -> launches), the
    live objects: a wrapper adds one where it launches its kernel."""
    from raft_tpu_torch.ops import (corr_kernels, gru_gates, lookup_encode,
                                    pyramid_kernels, upsample_loss)

    return (corr_kernels.LAUNCHES, gru_gates.LAUNCHES,
            pyramid_kernels.LAUNCHES, upsample_loss.LAUNCHES,
            lookup_encode.LAUNCHES)


def launch_counts() -> Dict[str, int]:
    """A copy of every kernel's launch count, by kernel name."""
    return {k: v for d in launch_counters() for k, v in d.items()}


def add_launches(delta: Dict[str, int]) -> None:
    """Add ``delta`` (kernel name -> launches) to the counters."""
    for d in launch_counters():
        for k in d:
            d[k] += delta.get(k, 0)
