"""The RAFT model (the port of ``raft_tpu/models/raft.py``:
``_remat_wrap`` 63-93, ``RefinementStep`` 96-191, ``UpsampleStep``
194-210, ``UpsampleLossStep`` 213-289, the encode half 292-372 and
``RAFT`` 375-576), full and small model.

normalize -> shared-weight ``fnet`` on both frames + ``cnet`` on the
first -> correlation state -> ``iters`` refinement steps (a Python loop;
``coords1`` is detached at the start of each) -> mask head + convex 8x
upsample (full model) or the parameter-free bilinear ``upflow8`` (small
model, which has no mask head and never reaches the upsample-loss
kernel).  Three outputs, as in the JAX package:

- ``test_mode=True``: ``(flow_low, flow_up)`` of the last iteration only;
- ``loss_targets=(flow_gt, valid, max_flow)``: ``(per_iter (iters,),
  metrics)``, the sequence-loss terms from the flat upsample + loss chain
  (``upsample_loss_kernel``: the plain chain or the CUDA kernel) applied
  to every iteration, all iterations folded into one batch (small model:
  ``upflow8`` of every iteration and the plain L1, metrics without
  gradient);
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

Rematerialization (``remat``, when gradients are recorded) wraps each
refinement step in ``torch.utils.checkpoint`` (non-reentrant):

- ``'save_corr'`` / ``'save_corr_upsample'``: the lookup runs outside any
  checkpoint and its taps (on the fused path, the fused lookup +
  ``convc1`` output) stay; the rest of the motion encoder is one
  checkpointed region (its output stays) and the GRU and flow head
  another, so backward recomputes those two and never the lookup;
- ``'full'``: the whole step, lookup included, is one region;
- ``'dots'``: the whole step, keeping every convolution's output.

``remat_upsample`` checkpoints the mask head together with the upsample
(+ loss) over the folded iterations: backward keeps the stacked GRU
states and recomputes the two mask convs and the upsample's forward.

Images are NHWC float in [0, 255]; flows are ``(B, H, W, 2)``, ``(x, y)``
last.  Parameter names follow the flax paths (``fnet.layer1_0.conv1.
weight``, ``refine.update_block.gru.convzr1.weight``, ``upsampler.
mask_head.mask_conv1.weight``) so ``convert.py`` maps them mechanically.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import torch
import torch.nn as nn
import torch.utils.checkpoint

from raft_tpu_torch.config import RAFTConfig
from raft_tpu_torch.models.extractor import BasicEncoder, SmallEncoder
from raft_tpu_torch.models.layers import Conv, Norm
from raft_tpu_torch.models.update import (BasicUpdateBlock, FusedCorrLookup,
                                          MaskHead, SmallUpdateBlock)
from raft_tpu_torch.ops.corr import (build_corr_pyramid, chunked_corr_lookup,
                                     corr_lookup, pool_fmap_pyramid)
from raft_tpu_torch.ops.corr_kernels import corr_lookup_ondemand_nchw
from raft_tpu_torch.ops.pyramid_kernels import (pyramid_lookup_nchw,
                                                pyramid_lookup_quantized_nchw)
from raft_tpu_torch.ops.sampler import coords_grid, upflow8
from raft_tpu_torch.ops.upsample import convex_upsample_nchw
from raft_tpu_torch.ops.upsample_loss import (upsample_loss_sums,
                                              upsample_loss_sums_plain)
from raft_tpu_torch.train.loss import combined_valid, sequence_terms


def _checkpoint(fn, *args, context_fn=None):
    """``fn(*args)`` under non-reentrant ``torch.utils.checkpoint``: its
    tensor arguments are kept, everything else it saves is recomputed in
    backward (no random op runs inside, so no RNG state is kept)."""
    kw = {} if context_fn is None else {"context_fn": context_fn}
    return torch.utils.checkpoint.checkpoint(
        fn, *args, use_reentrant=False, preserve_rng_state=False, **kw)


def _dots_context():
    """Selective checkpoint contexts that keep the output of every
    convolution and matrix product (JAX's ``dots_saveable``)."""
    from torch.utils.checkpoint import (CheckpointPolicy,
                                        create_selective_checkpoint_contexts)

    aten = torch.ops.aten
    saved = {aten.convolution.default, aten.mm.default, aten.addmm.default,
             aten.bmm.default}

    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in saved
                else CheckpointPolicy.PREFER_RECOMPUTE)

    return create_selective_checkpoint_contexts(policy)


class RAFT(nn.Module):
    """Full or small RAFT on the CPU; ``.to(device)`` moves it.  Weights are
    drawn from ``seed`` at construction, except when it is built under
    ``torch.device("meta")``, which only describes shapes."""

    def __init__(self, config: RAFTConfig = RAFTConfig(), seed: int = 0):
        super().__init__()
        self.config = config
        hdim, cdim = config.hidden_dim, config.context_dim
        if config.small:
            self.fnet = SmallEncoder(128, "instance", config.dropout)
            self.cnet = SmallEncoder(hdim + cdim, "none", config.dropout)
            block = SmallUpdateBlock(config.corr_planes, hdim, cdim,
                                     config.fused_gru)
        else:
            self.fnet = BasicEncoder(256, "instance", config.dropout)
            self.cnet = BasicEncoder(hdim + cdim, "batch", config.dropout)
            block = BasicUpdateBlock(config.corr_planes, hdim, cdim,
                                     config.fused_gru)
        self.refine = nn.ModuleDict({"update_block": block})
        if not config.small:
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
        the motion encoder with ``fused_lookup_encoder``).  The volume and
        the plain lookups run at ``corr_precision``; the kernels compute
        in fp32."""
        cfg = self.config
        r, L = cfg.corr_radius, cfg.corr_levels
        prec = cfg.resolved_corr_precision
        if cfg.corr_impl in ("allpairs", "allpairs_pallas"):
            pyramid = build_corr_pyramid(fmap1, fmap2, L,
                                         cfg.corr_torch_dtype, prec)
            if cfg.fused_lookup_encoder:
                return lambda c: FusedCorrLookup(pyramid, c.contiguous(), r,
                                                 cfg.dtype)
            if cfg.corr_impl == "allpairs_pallas":
                # the kernels emit the taps in the compute dtype directly
                lookup = (pyramid_lookup_quantized_nchw
                          if cfg.corr_dtype_is_quantized
                          else pyramid_lookup_nchw)
                return lambda c: lookup(pyramid, c, r, cfg.dtype)
            return lambda c: corr_lookup(pyramid, c, r, prec).permute(
                0, 3, 1, 2).contiguous()
        f2_pyramid = pool_fmap_pyramid(fmap2, L)
        if cfg.corr_impl == "chunked":
            return lambda c: chunked_corr_lookup(
                fmap1, f2_pyramid, c, r, cfg.corr_block_size, prec
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
        nets, flows = [], []
        for _ in range(iters):
            net, coords1 = self._refine(lookup, net, inp, coords0,
                                        coords1.detach())
            if not test_mode:
                nets.append(net)
                flows.append(coords1 - coords0)

        if cfg.small:
            return self._small_outputs(flows, coords1 - coords0, test_mode,
                                       loss_targets)
        mask_head = self.upsampler["mask_head"]
        if test_mode:
            flow_low = coords1 - coords0
            mask = mask_head(net).float()
            flow_up = convex_upsample_nchw(flow_low.permute(0, 3, 1, 2), mask)
            return flow_low, flow_up.permute(0, 2, 3, 1)

        # every iteration folded into one batch, iteration-major
        flows = torch.stack(flows, dim=0).reshape(iters * B, H8, W8, 2)
        nets = torch.cat(nets, dim=0)
        remat_up = cfg.remat_upsample and torch.is_grad_enabled()
        if loss_targets is not None:
            flow_gt, valid, max_flow = loss_targets
            vmask = combined_valid(flow_gt, valid, max_flow)
            gt = flow_gt.float().contiguous()
            sums = (_checkpoint(self._upsample_loss_sums, nets, flows, gt,
                                vmask) if remat_up
                    else self._upsample_loss_sums(nets, flows, gt, vmask))
            return self._loss_outputs(sums, gt, vmask, iters, B)

        def upsample(nets, flows):
            mask = mask_head(nets)
            return convex_upsample_nchw(flows.permute(0, 3, 1, 2),
                                        mask.float())

        up = (_checkpoint(upsample, nets, flows) if remat_up
              else upsample(nets, flows))
        return up.permute(0, 2, 3, 1).reshape(iters, B, 8 * H8, 8 * W8, 2)

    def _refine(self, lookup: Callable, net, inp, coords0, coords1):
        """One refinement iteration -> ``(net, coords1)``, under the remat
        policy when gradients are recorded (see the module docstring)."""
        cfg = self.config
        dt = cfg.dtype
        block = self.refine["update_block"]

        def taps(c):
            corr = lookup(c)
            return corr if isinstance(corr, FusedCorrLookup) else corr.to(dt)

        def flow_of(coords0, coords1):
            return (coords1 - coords0).permute(0, 3, 1, 2).contiguous().to(dt)

        def step(net, inp, coords0, coords1):
            return block(net, inp, taps(coords1), flow_of(coords0, coords1))

        if not (cfg.remat and torch.is_grad_enabled()):
            net, delta = step(net, inp, coords0, coords1)
        elif cfg.remat_policy in ("save_corr", "save_corr_upsample"):
            corr = taps(coords1)
            motion = _checkpoint(
                functools.partial(block.encoder.motion,
                                  encoded=isinstance(corr, FusedCorrLookup)),
                flow_of(coords0, coords1), block.encoder.corr_input(corr))
            net, delta = _checkpoint(block.gru_head, net, inp, motion)
        else:
            net, delta = _checkpoint(
                step, net, inp, coords0, coords1,
                context_fn=_dots_context if cfg.remat_policy == "dots"
                else None)
        return net, coords1 + delta.float().permute(0, 2, 3, 1)

    def _upsample_loss_sums(self, nets, flows, gt, vmask):
        """Mask head on the folded GRU states, then the flat upsample +
        loss sums ``(iters * B, 5)``."""
        cfg = self.config
        mask = self.upsampler["mask_head"](nets).contiguous()
        if cfg.upsample_loss_kernel == "pallas":
            return upsample_loss_sums(flows, mask, gt, vmask)
        return upsample_loss_sums_plain(flows, mask, gt, vmask, cfg.dtype)

    def _small_outputs(self, flows, flow_low, test_mode, loss_targets):
        """Small-model upsampling: ``upflow8`` of the last flow (test
        mode) or of every iteration's, and with ``loss_targets`` the
        sequence-loss terms on them (``raft_tpu/models/raft.py:548-576``)."""
        if test_mode:
            return flow_low, upflow8(flow_low)
        iters = len(flows)
        B, H8, W8, _ = flow_low.shape
        up = upflow8(torch.cat(flows, dim=0)).reshape(
            iters, B, 8 * H8, 8 * W8, 2)
        if loss_targets is None:
            return up
        flow_gt, valid, max_flow = loss_targets
        return sequence_terms(up, flow_gt.float(),
                              combined_valid(flow_gt, valid, max_flow))

    @staticmethod
    def _loss_outputs(sums, gt, vmask, iters, B):
        """Per-iteration mean L1 (over all ``B*H*W*2`` elements, invalid
        ones zeroed) and final-iteration metrics over the valid pixels,
        plus the per-iteration ``epe_iter`` (``raft_tpu/models/raft.py:
        452-510``)."""
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
