"""Recurrent update blocks (the port of ``raft_tpu/models/update.py:99-274``):
motion encoder + GRU + flow head, and the mask head of the convex
upsample.  NCHW inside; every conv keeps torch's default init, as in the
reference.

- ``BasicMotionEncoder`` (full model) emits 126 channels and appends the
  raw 2-channel flow -> 128; ``SmallMotionEncoder`` emits 80 + 2 -> 82.
- ``SepConvGRU`` (full model) runs a horizontal (1x5) then a vertical
  (5x1) pass; ``ConvGRU`` (small model) one 3x3 pass.  The z and r gate
  convs of a pass are one double-width conv (``convzr*``, z first), as
  in the JAX package.  With ``fused=True`` the two gate chains run
  through ``ops/gru_gates.py`` (one CUDA kernel each on the card).
- The mask head output is scaled by 0.25.
- With ``fused_lookup_encoder`` the refinement step hands the motion
  encoder a :class:`FusedCorrLookup` in place of the tap tensor, and the
  encoder runs the pyramid lookup and ``convc1`` (+ bias + relu) as one
  kernel (``ops/lookup_encode.py``) with ``convc1``'s own parameters, so
  both paths share one state dict.
- A motion encoder splits into :meth:`corr_input` (the taps, or the fused
  lookup + ``convc1`` output: what ``remat_policy='save_corr'`` keeps)
  and :meth:`motion` (the rest); an update block into its encoder and
  :meth:`gru_head`.  ``models/raft.py`` checkpoints those pieces.
"""

from __future__ import annotations

import dataclasses
from typing import List

import torch
import torch.nn as nn

from raft_tpu_torch.models.layers import Conv
from raft_tpu_torch.ops.gru_gates import gru_gate_blend, gru_gate_rh
from raft_tpu_torch.ops.lookup_encode import pyramid_lookup_encode


@dataclasses.dataclass
class FusedCorrLookup:
    """A correlation lookup deferred into the motion encoder: the
    materialized pyramid (plain or quantized levels), the ``(B, H, W, 2)``
    fp32 lookup centers, the window radius and the dtype of the fused
    output (the compute dtype)."""

    pyramid: List
    coords: torch.Tensor
    radius: int
    dtype: torch.dtype


class FlowHead(nn.Module):
    def __init__(self, cin: int = 128, hidden_dim: int = 256):
        super().__init__()
        self.conv1 = Conv(cin, hidden_dim, 3)
        self.conv2 = Conv(hidden_dim, 2, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(torch.relu(self.conv1(x)))


def _gru_pass(h, x, convzr, convq, hidden_dim: int, fused: bool):
    """One ConvGRU pass over ``cat([h, x])``."""
    zr_raw = convzr(torch.cat([h, x], dim=1))
    if fused:
        z_raw, r_raw = torch.split(zr_raw, hidden_dim, dim=1)
        q_raw = convq(torch.cat([gru_gate_rh(r_raw, h), x], dim=1))
        return gru_gate_blend(z_raw, q_raw, h)
    z, r = torch.split(torch.sigmoid(zr_raw), hidden_dim, dim=1)
    q = torch.tanh(convq(torch.cat([r * h, x], dim=1)))
    return (1 - z) * h + z * q


class ConvGRU(nn.Module):
    """The small model's GRU: one 3x3 pass."""

    def __init__(self, hidden_dim: int = 96, input_dim: int = 146,
                 fused: bool = False):
        super().__init__()
        cin = hidden_dim + input_dim
        self.hidden_dim = hidden_dim
        self.fused = fused
        self.convzr = Conv(cin, 2 * hidden_dim, 3)
        self.convq = Conv(cin, hidden_dim, 3)

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        return _gru_pass(h, x, self.convzr, self.convq, self.hidden_dim,
                         self.fused)


class SepConvGRU(nn.Module):
    def __init__(self, hidden_dim: int = 128, input_dim: int = 256,
                 fused: bool = False):
        super().__init__()
        cin = hidden_dim + input_dim
        self.hidden_dim = hidden_dim
        self.fused = fused
        self.convzr1 = Conv(cin, 2 * hidden_dim, (1, 5))
        self.convq1 = Conv(cin, hidden_dim, (1, 5))
        self.convzr2 = Conv(cin, 2 * hidden_dim, (5, 1))
        self.convq2 = Conv(cin, hidden_dim, (5, 1))

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        h = _gru_pass(h, x, self.convzr1, self.convq1, self.hidden_dim,
                      self.fused)
        return _gru_pass(h, x, self.convzr2, self.convq2, self.hidden_dim,
                         self.fused)


class _MotionEncoder(nn.Module):
    """``convc1`` on the correlation features, two convs on the flow, one
    conv on both; the raw flow appended."""

    def corr_input(self, corr) -> torch.Tensor:
        """The taps as given, or on the fused path the fused lookup +
        ``convc1`` (+ bias + relu) output."""
        if isinstance(corr, FusedCorrLookup):
            return pyramid_lookup_encode(corr.pyramid, corr.coords,
                                         corr.radius, self.convc1.weight,
                                         self.convc1.bias, corr.dtype)
        return corr

    def _corr_features(self, cor: torch.Tensor) -> torch.Tensor:
        return cor

    def motion(self, flow: torch.Tensor, cor: torch.Tensor,
               encoded: bool) -> torch.Tensor:
        """The encoder after :meth:`corr_input`; ``encoded``: ``cor`` is
        the fused output, ``convc1`` already applied."""
        if not encoded:
            cor = torch.relu(self.convc1(cor))
        cor = self._corr_features(cor)
        flo = torch.relu(self.convf1(flow))
        flo = torch.relu(self.convf2(flo))
        out = torch.relu(self.conv(torch.cat([cor, flo], dim=1)))
        return torch.cat([out, flow], dim=1)

    def forward(self, flow: torch.Tensor, corr) -> torch.Tensor:
        return self.motion(flow, self.corr_input(corr),
                           isinstance(corr, FusedCorrLookup))


class BasicMotionEncoder(_MotionEncoder):
    def __init__(self, corr_planes: int):
        super().__init__()
        self.convc1 = Conv(corr_planes, 256, 1)
        self.convc2 = Conv(256, 192, 3)
        self.convf1 = Conv(2, 128, 7)
        self.convf2 = Conv(128, 64, 3)
        self.conv = Conv(64 + 192, 126, 3)

    def _corr_features(self, cor: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.convc2(cor))


class SmallMotionEncoder(_MotionEncoder):
    def __init__(self, corr_planes: int):
        super().__init__()
        self.convc1 = Conv(corr_planes, 96, 1)
        self.convf1 = Conv(2, 64, 7)
        self.convf2 = Conv(64, 32, 3)
        self.conv = Conv(128, 80, 3)


class _UpdateBlock(nn.Module):
    def gru_head(self, net, inp, motion):
        """GRU on ``cat([inp, motion])``, then the flow head."""
        net = self.gru(net, torch.cat([inp, motion], dim=1))
        return net, self.flow_head(net)

    def forward(self, net, inp, corr, flow):
        return self.gru_head(net, inp, self.encoder(flow, corr))


class SmallUpdateBlock(_UpdateBlock):
    """Small motion encoder (82 channels) + ConvGRU + flow head (128)."""

    def __init__(self, corr_planes: int, hidden_dim: int = 96,
                 context_dim: int = 64, fused_gru: bool = False):
        super().__init__()
        self.encoder = SmallMotionEncoder(corr_planes)
        self.gru = ConvGRU(hidden_dim, context_dim + 82, fused_gru)
        self.flow_head = FlowHead(hidden_dim, 128)


class BasicUpdateBlock(_UpdateBlock):
    """GRU update without the mask head (the mask depends only on ``net``
    and runs once after the last iteration, :class:`MaskHead`)."""

    def __init__(self, corr_planes: int, hidden_dim: int = 128,
                 context_dim: int = 128, fused_gru: bool = False):
        super().__init__()
        self.encoder = BasicMotionEncoder(corr_planes)
        # GRU input: context features + the 128 motion channels
        self.gru = SepConvGRU(hidden_dim, context_dim + 128, fused_gru)
        self.flow_head = FlowHead(hidden_dim, 256)


class MaskHead(nn.Module):
    """Convex-upsample mask head, scaled by 0.25."""

    def __init__(self, hidden_dim: int = 128):
        super().__init__()
        self.mask_conv1 = Conv(hidden_dim, 256, 3)
        self.mask_conv2 = Conv(256, 64 * 9, 1)

    def forward(self, net: torch.Tensor) -> torch.Tensor:
        return 0.25 * self.mask_conv2(torch.relu(self.mask_conv1(net)))
