"""The RAFT model (the port of ``raft_tpu/models/raft.py``:
``RefinementStep`` 96-191, ``UpsampleStep`` 194-210, ``UpsampleLossStep``
213-289, the encode half 292-372 and ``RAFT`` 375-510), full model.

normalize -> shared-weight ``fnet`` on both frames + ``cnet`` on the
first -> correlation state -> ``iters`` refinement steps (a Python loop;
``coords1`` is detached at the start of each) -> mask head + convex 8x
upsample.  Three outputs, as in the JAX package:

- ``test_mode=True``: ``(flow_low, flow_up)`` of the last iteration only;
- ``loss_targets=(flow_gt, valid, max_flow)``: ``(per_iter (iters,),
  metrics)``, the sequence-loss terms from the flat upsample + loss chain
  (``upsample_loss_kernel``: the plain chain or the CUDA kernel) applied
  to every iteration, all iterations folded into one batch;
- otherwise the stacked upsampled flows ``(iters, B, H, W, 2)``.

Train mode is ``model.train()``: batch norm uses batch statistics unless
``freeze_bn``, and encoder dropout draws from the ``generator`` passed in.

Dtype casts sit where the JAX model puts them: images are normalized in
fp32 and cast to the compute dtype; the feature maps, the correlation
and the coordinates are fp32; the materialized pyramid is stored in
``corr_dtype`` (bf16 under bf16 compute by default, as in JAX; int8 or
fp8 codes with per-level scales when quantized, with no gradient through
the volume); the lookup taps (or, with ``fused_lookup_encoder``, the
fused lookup + ``convc1`` output) and the flow enter the update block in
the compute dtype;
the flow update returns to fp32; the mask stays in the compute dtype for
the loss chain and is fp32 for the returned flows.

Images are NHWC float in [0, 255]; flows are ``(B, H, W, 2)``, ``(x, y)``
last.  Parameter names follow the flax paths (``fnet.layer1_0.conv1.
weight``, ``refine.update_block.gru.convzr1.weight``, ``upsampler.
mask_head.mask_conv1.weight``) so ``convert.py`` maps them mechanically.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn as nn

from raft_tpu_torch.config import RAFTConfig
from raft_tpu_torch.models.extractor import BasicEncoder
from raft_tpu_torch.models.layers import Conv, Norm
from raft_tpu_torch.models.update import (BasicUpdateBlock, FusedCorrLookup,
                                          MaskHead)
from raft_tpu_torch.ops.corr import (build_corr_pyramid, chunked_corr_lookup,
                                     corr_lookup, pool_fmap_pyramid)
from raft_tpu_torch.ops.corr_kernels import corr_lookup_ondemand_nchw
from raft_tpu_torch.ops.pyramid_kernels import (pyramid_lookup_nchw,
                                                pyramid_lookup_quantized_nchw)
from raft_tpu_torch.ops.sampler import coords_grid
from raft_tpu_torch.ops.upsample import convex_upsample_nchw
from raft_tpu_torch.ops.upsample_loss import (upsample_loss_sums,
                                              upsample_loss_sums_plain)
from raft_tpu_torch.train.loss import combined_valid


class RAFT(nn.Module):
    """Full RAFT on the CPU; ``.to(device)`` moves it.  Weights are drawn
    from ``seed`` at construction, except when it is built under
    ``torch.device("meta")``, which only describes shapes."""

    def __init__(self, config: RAFTConfig = RAFTConfig(), seed: int = 0):
        super().__init__()
        if config.small:
            raise NotImplementedError(
                "the small model (SmallEncoder, ConvGRU, upflow8) is a later "
                "slice of the port")
        self.config = config
        hdim, cdim = config.hidden_dim, config.context_dim
        self.fnet = BasicEncoder(256, "instance", config.dropout)
        self.cnet = BasicEncoder(hdim + cdim, "batch", config.dropout)
        self.refine = nn.ModuleDict({"update_block": BasicUpdateBlock(
            config.corr_planes, hdim, cdim, config.fused_gru)})
        self.upsampler = nn.ModuleDict({"mask_head": MaskHead(hdim)})
        if not self.fnet.conv1.weight.is_meta:
            self.init_weights(seed)

    def init_weights(self, seed: int) -> None:
        """Seeded init: kaiming-normal fan-out encoder convs, torch-default
        update-block convs, identity norms."""
        gen = torch.Generator().manual_seed(seed)
        for m in self.modules():
            if isinstance(m, (Conv, Norm)):
                m.init_(gen)

    def _lookup_fn(self, fmap1: torch.Tensor,
                   fmap2: torch.Tensor) -> Callable:
        """Correlation state for one pair -> ``coords -> (B, P, H, W)``
        taps, dispatched on ``corr_impl`` (a :class:`FusedCorrLookup` for
        the motion encoder with ``fused_lookup_encoder``)."""
        cfg = self.config
        r, L = cfg.corr_radius, cfg.corr_levels
        if cfg.corr_impl in ("allpairs", "allpairs_pallas"):
            pyramid = build_corr_pyramid(fmap1, fmap2, L,
                                         cfg.corr_torch_dtype)
            if cfg.fused_lookup_encoder:
                return lambda c: FusedCorrLookup(pyramid, c.contiguous(), r,
                                                 cfg.dtype)
            if cfg.corr_impl == "allpairs_pallas":
                # the kernels emit the taps in the compute dtype directly
                lookup = (pyramid_lookup_quantized_nchw
                          if cfg.corr_dtype_is_quantized
                          else pyramid_lookup_nchw)
                return lambda c: lookup(pyramid, c, r, cfg.dtype)
            return lambda c: corr_lookup(pyramid, c, r).permute(
                0, 3, 1, 2).contiguous()
        f2_pyramid = pool_fmap_pyramid(fmap2, L)
        if cfg.corr_impl == "chunked":
            return lambda c: chunked_corr_lookup(
                fmap1, f2_pyramid, c, r, cfg.corr_block_size
            ).permute(0, 3, 1, 2).contiguous()
        # 'pallas': the on-demand kernels; their backward reaches fmap2
        # through the pooling by autograd
        f2_pyramid = [f2.contiguous() for f2 in f2_pyramid]
        return lambda c: corr_lookup_ondemand_nchw(
            fmap1, f2_pyramid, c.contiguous(), r)

    def forward(self, image1: torch.Tensor, image2: torch.Tensor,
                iters: int = 12, flow_init: Optional[torch.Tensor] = None,
                test_mode: bool = False, freeze_bn: bool = False,
                loss_targets: Optional[tuple] = None,
                generator: Optional[torch.Generator] = None):
        """``(B, H, W, 3)`` frames -> one of the three outputs of the
        module docstring; ``flow_init`` is ``(B, H/8, W/8, 2)``."""
        cfg = self.config
        dt = cfg.dtype
        hdim = cfg.hidden_dim
        image1 = 2.0 * (image1.float() / 255.0) - 1.0
        image2 = 2.0 * (image2.float() / 255.0) - 1.0
        # NCHW-contiguous throughout: a permuted NHWC view would make the
        # convs emit channels-last outputs
        x1 = image1.permute(0, 3, 1, 2).contiguous()
        x2 = image2.permute(0, 3, 1, 2).contiguous()
        B = x1.shape[0]

        fmaps = self.fnet(torch.cat([x1, x2], dim=0).to(dt), freeze_bn,
                          generator)
        fmaps = fmaps.float().permute(0, 2, 3, 1).contiguous()   # NHWC
        _, H8, W8, _ = fmaps.shape
        lookup = self._lookup_fn(fmaps[:B], fmaps[B:])
        # From here the lookup state alone holds the features: a quantized
        # pyramid holds no graph, so fnet's saved activations are freed now
        # rather than when the forward returns
        del fmaps

        ctx = self.cnet(x1.to(dt), freeze_bn, generator)
        net = torch.tanh(ctx[:, :hdim])
        inp = torch.relu(ctx[:, hdim:])

        coords0 = coords_grid(B, H8, W8, device=x1.device)
        coords1 = coords0 if flow_init is None else coords0 + flow_init
        update_block = self.refine["update_block"]
        nets, flows = [], []
        for _ in range(iters):
            coords1 = coords1.detach()
            corr = lookup(coords1)
            if not isinstance(corr, FusedCorrLookup):
                corr = corr.to(dt)
            flow = (coords1 - coords0).permute(0, 3, 1, 2).contiguous().to(dt)
            net, delta_flow = update_block(net, inp, corr, flow)
            coords1 = coords1 + delta_flow.float().permute(0, 2, 3, 1)
            if not test_mode:
                nets.append(net)
                flows.append(coords1 - coords0)

        mask_head = self.upsampler["mask_head"]
        if test_mode:
            flow_low = coords1 - coords0
            mask = mask_head(net).float()
            flow_up = convex_upsample_nchw(flow_low.permute(0, 3, 1, 2), mask)
            return flow_low, flow_up.permute(0, 2, 3, 1)

        # every iteration folded into one batch, iteration-major
        flows = torch.stack(flows, dim=0).reshape(iters * B, H8, W8, 2)
        mask = mask_head(torch.cat(nets, dim=0))
        if loss_targets is not None:
            return self._loss_outputs(flows, mask.contiguous(), loss_targets,
                                      iters, B)
        up = convex_upsample_nchw(flows.permute(0, 3, 1, 2), mask.float())
        return up.permute(0, 2, 3, 1).reshape(iters, B, 8 * H8, 8 * W8, 2)

    def _loss_outputs(self, flows, mask, loss_targets, iters, B):
        """Per-iteration mean L1 (over all ``B*H*W*2`` elements, invalid
        ones zeroed) and final-iteration metrics over the valid pixels,
        plus the per-iteration ``epe_iter`` (``raft_tpu/models/raft.py:
        452-510``)."""
        cfg = self.config
        flow_gt, valid, max_flow = loss_targets
        vmask = combined_valid(flow_gt, valid, max_flow)
        gt = flow_gt.float().contiguous()
        if cfg.upsample_loss_kernel == "pallas":
            sums = upsample_loss_sums(flows, mask, gt, vmask)
        else:
            sums = upsample_loss_sums_plain(flows, mask, gt, vmask,
                                            cfg.dtype)
        sums = sums.reshape(iters, B, 5).sum(dim=1)        # (iters, 5)
        n_all = gt.numel()
        n_valid = torch.clamp(vmask.sum(), min=1.0)
        per_iter = sums[:, 0] / n_all
        metrics = {"epe": sums[-1, 1] / n_valid,
                   "1px": sums[-1, 2] / n_valid,
                   "3px": sums[-1, 3] / n_valid,
                   "5px": sums[-1, 4] / n_valid,
                   "epe_iter": sums[:, 1] / n_valid}
        return per_iter, metrics
