"""Feature / context encoders (the port of
``raft_tpu/models/extractor.py:31-116``, unfolded path), 1/8 resolution,
then channel-wise dropout in train mode when ``dropout > 0``:

- ``BasicEncoder``: 7x7/s2 stem (64) -> residual stages 64, 96/s2,
  128/s2 -> 1x1 projection;
- ``SmallEncoder``: 7x7/s2 stem (32) -> bottleneck stages 32, 64/s2,
  96/s2 -> 1x1 projection.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from raft_tpu_torch.models.layers import (BottleneckBlock, Conv, Norm,
                                         ResidualBlock, channel_dropout)


class BasicEncoder(nn.Module):
    """``(B, 3, H, W)`` -> ``(B, output_dim, H/8, W/8)``, in the input's
    dtype."""

    STEM, STAGES, BLOCK = 64, (64, 96, 128), ResidualBlock

    def __init__(self, output_dim: int = 128, norm: str = "batch",
                 dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        stem = self.STEM
        self.conv1 = Conv(3, stem, 7, 2, "kaiming_out")
        self.norm1 = Norm(norm, stem, stem // 8)
        cin = stem
        for i, planes in enumerate(self.STAGES):
            for j in range(2):
                stride = 2 if i and not j else 1
                self.add_module(f"layer{i + 1}_{j}",
                                self.BLOCK(cin, planes, norm, stride))
                cin = planes
        self.conv2 = Conv(cin, output_dim, 1, 1, "kaiming_out")

    def forward(self, x: torch.Tensor, freeze_bn: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = torch.relu(self.norm1(self.conv1(x), freeze_bn))
        for name in ("layer1_0", "layer1_1", "layer2_0", "layer2_1",
                     "layer3_0", "layer3_1"):
            x = getattr(self, name)(x, freeze_bn)
        x = self.conv2(x)
        if self.training and self.dropout > 0:
            if generator is None:
                raise ValueError("dropout in train mode needs an explicit "
                                 "torch.Generator")
            x = channel_dropout(x, self.dropout, generator)
        return x


class SmallEncoder(BasicEncoder):
    """The small model's encoder: the same stem, stages and projection
    with bottleneck blocks, 32 / 64 / 96 channels."""

    STEM, STAGES, BLOCK = 32, (32, 64, 96), BottleneckBlock
