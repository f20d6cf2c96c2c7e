"""Building blocks: conv, norm, residual and bottleneck blocks (NCHW
inside the model).

The port of ``raft_tpu/models/layers.py:51-137`` and ``:405-443``.  Parameters are fp32;
a conv casts its weights to the dtype of its input, so under bf16 compute
the convs run in bf16 with fp32 parameters, as flax does.  Norms compute
in fp32 and return the input's dtype.  The JAX package's ``Folded*``
classes are a TPU lane-packing layout of the same math and parameters and
have no counterpart here.

Train mode (``module.train()``) switches batch norm to batch statistics
unless the caller passes ``freeze_bn``, as the JAX modules' ``train`` and
``freeze_bn`` arguments do.

Across data-parallel ranks (a mesh active for the train step,
``parallel/mesh.py``), train-mode batch norm takes its statistics over
the global batch and channel dropout draws the global batch's mask and
keeps the rank's rows, as the JAX package's ``data``-sharded batch does.

Initialization is explicit: :meth:`Conv.init_` and :meth:`Norm.init_`
draw from a ``torch.Generator`` on the CPU, so one seed gives the same
weights on every device.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from raft_tpu_torch.parallel import mesh as mesh_mod

NORM_KINDS = ("batch", "instance", "none")


class Conv(nn.Module):
    """Conv with torch-style symmetric ``(k-1)//2`` padding per axis
    (including the ``(1, 5)`` / ``(5, 1)`` GRU kernels).

    ``init='kaiming_out'`` is the encoders' kaiming-normal fan-out init;
    ``'torch_default'`` is torch's default Conv2d init.  Biases are
    ``U(-1/sqrt(fan_in), 1/sqrt(fan_in))`` either way, as in the JAX
    package."""

    def __init__(self, cin: int, cout: int,
                 kernel: Union[int, Tuple[int, int]], stride: int = 1,
                 init: str = "torch_default"):
        super().__init__()
        kh, kw = (kernel, kernel) if isinstance(kernel, int) else kernel
        self.stride = stride
        self.padding = ((kh - 1) // 2, (kw - 1) // 2)
        self.init = init
        self.weight = nn.Parameter(torch.empty(cout, cin, kh, kw))
        self.bias = nn.Parameter(torch.empty(cout))

    def init_(self, gen: torch.Generator) -> None:
        cout, cin, kh, kw = self.weight.shape
        bound = 1.0 / math.sqrt(cin * kh * kw)
        if self.init == "kaiming_out":
            w = torch.randn(self.weight.shape, generator=gen) \
                * math.sqrt(2.0 / (cout * kh * kw))
        else:
            w = (torch.rand(self.weight.shape, generator=gen) * 2 - 1) * bound
        b = (torch.rand(self.bias.shape, generator=gen) * 2 - 1) * bound
        with torch.no_grad():
            self.weight.copy_(w)
            self.bias.copy_(b)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.weight.to(x.dtype), self.bias.to(x.dtype),
                        self.stride, self.padding)


class Norm(nn.Module):
    """The encoders' norm modes (eps 1e-5):

    - 'batch': BatchNorm with flax semantics.  In train mode (and not
      ``freeze_bn``) it normalizes with the batch statistics and moves the
      running ones with momentum 0.9 (torch's 0.1), the *biased* batch
      variance in both places (``F.batch_norm(training=True)`` would put
      the unbiased one into ``running_var``); otherwise it uses the
      running statistics.  Under an active mesh of more than one rank
      the batch statistics are the global batch's: the per-channel sum
      is all-reduced for the mean, then the sum of squared deviations
      for the variance (two passes, as exact as ``torch.var_mean``), with
      gradients through both reductions, so the running statistics stay
      the same on every rank;
    - 'instance': per-sample, per-channel spatial norm, no affine;
    - 'none': identity.

    Statistics and normalization are fp32; the result has the input's
    dtype.  ``num_groups`` is the JAX module's argument of its ``'group'``
    mode; these three modes ignore it.
    """

    def __init__(self, kind: str, channels: int,
                 num_groups: Optional[int] = None):
        super().__init__()
        if kind not in NORM_KINDS:
            raise ValueError(f"unknown norm kind: {kind!r}")
        self.kind = kind
        if kind == "batch":
            self.weight = nn.Parameter(torch.empty(channels))
            self.bias = nn.Parameter(torch.empty(channels))
            self.register_buffer("running_mean", torch.empty(channels))
            self.register_buffer("running_var", torch.empty(channels))

    def init_(self, gen: torch.Generator) -> None:
        if self.kind == "batch":
            with torch.no_grad():
                self.weight.fill_(1.0)
                self.bias.zero_()
                self.running_mean.zero_()
                self.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor, freeze_bn: bool = False
                ) -> torch.Tensor:
        if self.kind == "none":
            return x
        if self.kind == "instance":
            y = F.instance_norm(x.float(), eps=1e-5)
        elif self.training and not freeze_bn:
            xf = x.float()
            mesh = mesh_mod.active()
            if mesh is None:
                var, mean = torch.var_mean(xf, dim=(0, 2, 3), correction=0)
            else:
                mean, var = _global_moments(xf, mesh)
            with torch.no_grad():
                self.running_mean.mul_(0.9).add_(0.1 * mean)
                self.running_var.mul_(0.9).add_(0.1 * var)
            scale = torch.rsqrt(var + 1e-5) * self.weight
            y = (xf - mean[:, None, None]) * scale[:, None, None] \
                + self.bias[:, None, None]
        else:
            y = F.batch_norm(x.float(), self.running_mean, self.running_var,
                             self.weight, self.bias, training=False,
                             eps=1e-5)
        return y.to(x.dtype)


def _global_moments(xf: torch.Tensor, mesh) -> Tuple[torch.Tensor,
                                                      torch.Tensor]:
    """Per-channel mean and biased variance of ``xf`` ``(B, C, H, W)``
    over the batches of every rank of ``mesh`` (equal shapes)."""
    n = xf.shape[0] * xf.shape[2] * xf.shape[3] * mesh.world
    mean = mesh_mod.all_reduce_sum(xf.sum(dim=(0, 2, 3)), mesh) / n
    d = xf - mean[:, None, None]
    var = mesh_mod.all_reduce_sum((d * d).sum(dim=(0, 2, 3)), mesh) / n
    return mean, var


def channel_dropout(x: torch.Tensor, rate: float,
                    generator: torch.Generator) -> torch.Tensor:
    """Channel-wise dropout of ``(B, C, H, W)`` (flax ``Dropout`` with
    ``broadcast_dims=(1, 2)`` on NHWC): each (sample, channel) is kept with
    probability ``1 - rate`` and scaled by ``1 / (1 - rate)``.  The draw
    comes from ``generator``, which must live on ``x``'s device.  Under an
    active mesh the mask is drawn for the global batch (``B * world``
    rows) and the rank keeps its rows, ``rank::world`` (the global row
    order of ``parallel/mesh.py``), so a split run drops what the
    straight run over the same samples drops."""
    if rate <= 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    mesh = mesh_mod.active()
    world = 1 if mesh is None else mesh.world
    keep = torch.rand((x.shape[0] * world, x.shape[1], 1, 1),
                      generator=generator, device=x.device) < 1.0 - rate
    if mesh is not None:
        keep = keep[mesh.rank::world]
    return x * keep.to(x.dtype) / (1.0 - rate)


class ResidualBlock(nn.Module):
    """Two 3x3 convs + skip; a strided block adds a 1x1 downsample conv
    and its norm (``norm3``)."""

    def __init__(self, cin: int, planes: int, norm: str, stride: int = 1):
        super().__init__()
        self.conv1 = Conv(cin, planes, 3, stride, "kaiming_out")
        self.norm1 = Norm(norm, planes)
        self.conv2 = Conv(planes, planes, 3, 1, "kaiming_out")
        self.norm2 = Norm(norm, planes)
        self.stride = stride
        if stride != 1:
            self.downsample_conv = Conv(cin, planes, 1, stride, "kaiming_out")
            self.norm3 = Norm(norm, planes)

    def forward(self, x: torch.Tensor, freeze_bn: bool = False
                ) -> torch.Tensor:
        y = torch.relu(self.norm1(self.conv1(x), freeze_bn))
        y = torch.relu(self.norm2(self.conv2(y), freeze_bn))
        if self.stride != 1:
            x = self.norm3(self.downsample_conv(x), freeze_bn)
        return torch.relu(x + y)


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 (strided) -> 1x1 with a skip; a strided block adds a 1x1
    downsample conv and its norm (``norm4``).  The group count is
    ``planes // 8`` even for the ``planes // 4``-channel inner norms, the
    reference's quirk the JAX package keeps (it matters only to a
    ``'group'`` norm)."""

    def __init__(self, cin: int, planes: int, norm: str, stride: int = 1):
        super().__init__()
        p4, groups = planes // 4, planes // 8
        self.conv1 = Conv(cin, p4, 1, 1, "kaiming_out")
        self.norm1 = Norm(norm, p4, groups)
        self.conv2 = Conv(p4, p4, 3, stride, "kaiming_out")
        self.norm2 = Norm(norm, p4, groups)
        self.conv3 = Conv(p4, planes, 1, 1, "kaiming_out")
        self.norm3 = Norm(norm, planes, groups)
        self.stride = stride
        if stride != 1:
            self.downsample_conv = Conv(cin, planes, 1, stride, "kaiming_out")
            self.norm4 = Norm(norm, planes, groups)

    def forward(self, x: torch.Tensor, freeze_bn: bool = False
                ) -> torch.Tensor:
        y = torch.relu(self.norm1(self.conv1(x), freeze_bn))
        y = torch.relu(self.norm2(self.conv2(y), freeze_bn))
        y = torch.relu(self.norm3(self.conv3(y), freeze_bn))
        if self.stride != 1:
            x = self.norm4(self.downsample_conv(x), freeze_bn)
        return torch.relu(x + y)
