"""Sequence loss and flow metrics (the port of ``raft_tpu/train/loss.py``).

Predictions arrive stacked, ``(iters, B, H, W, 2)``; the weighted sum is
one contraction.  The L1 terms use ``|x|`` with derivative +1 at exactly 0,
as ``jnp.abs`` does, so the port's gradients match the JAX package's even
on exactly-zero residuals.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from raft_tpu_torch.ops.upsample_loss import abs_pos0


def flow_metrics(flow_pred: torch.Tensor, flow_gt: torch.Tensor,
                 valid: torch.Tensor) -> Dict[str, torch.Tensor]:
    """End-point-error statistics over valid pixels: ``flow_pred`` and
    ``flow_gt`` ``(B, H, W, 2)``, ``valid`` ``(B, H, W)`` in {0, 1}."""
    epe = torch.sqrt(torch.sum((flow_pred - flow_gt) ** 2, dim=-1))
    mask = valid > 0.5
    n = torch.clamp(mask.sum(), min=1)

    def vmean(x):
        return torch.sum(torch.where(mask, x, 0.0)) / n

    return {"epe": vmean(epe),
            "1px": vmean((epe < 1.0).float()),
            "3px": vmean((epe < 3.0).float()),
            "5px": vmean((epe < 5.0).float())}


def combined_valid(flow_gt: torch.Tensor, valid: torch.Tensor,
                   max_flow: float) -> torch.Tensor:
    """Loss/metric mask: valid and ``|flow_gt| < max_flow``, as float
    {0, 1}."""
    mag = torch.sqrt(torch.sum(flow_gt.float() ** 2, dim=-1))
    return ((valid > 0.5) & (mag < max_flow)).float()


def sequence_loss(flow_preds: torch.Tensor, flow_gt: torch.Tensor,
                  valid: torch.Tensor, gamma: float = 0.8,
                  max_flow: float = 400.0
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Exponentially weighted L1 over the prediction sequence.

    Prediction i weighs ``gamma ** (iters - i - 1)``; pixels with
    ``|flow_gt| >= max_flow`` or invalid are zeroed, and each term is the
    mean over all pixels.  The metrics are the final iteration's, plus the
    per-iteration ``loss_iter`` and ``epe_iter`` curves; they carry no
    gradient.
    """
    n = flow_preds.shape[0]
    per_iter, metrics = sequence_terms(
        flow_preds, flow_gt, combined_valid(flow_gt, valid, max_flow))
    i = torch.arange(n, dtype=torch.float32, device=flow_preds.device)
    weights = gamma ** (n - i - 1.0)
    loss = torch.sum(weights * per_iter)
    return loss, dict(metrics, loss_iter=per_iter.detach())


def sequence_terms(flow_preds: torch.Tensor, flow_gt: torch.Tensor,
                   vmask: torch.Tensor
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The unweighted terms of :func:`sequence_loss` under the combined
    mask ``vmask``: the per-iteration mean L1 ``(iters,)`` and the final
    iteration's metrics plus ``epe_iter``, which carry no gradient."""
    per_iter = torch.mean(vmask[None, ..., None]
                          * abs_pos0(flow_preds - flow_gt[None]),
                          dim=(1, 2, 3, 4))
    with torch.no_grad():
        diff = flow_preds - flow_gt[None]
        epe_all = torch.sqrt(torch.sum(diff ** 2, dim=-1))
        n_valid = torch.clamp(vmask.sum(), min=1.0)
        epe_iter = torch.sum(vmask[None] * epe_all, dim=(1, 2, 3)) / n_valid
        metrics = flow_metrics(flow_preds[-1], flow_gt, vmask)
    return per_iter, dict(metrics, epe_iter=epe_iter)
