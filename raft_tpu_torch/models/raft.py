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

Spatial sharding (a mesh that splits rows active for the train step,
``parallel/mesh.py``): each rank holds rows ``[s*H/N, (s+1)*H/N)`` of
its samples.  The convolutions and instance norm read across shards
(``models/layers.py``); :meth:`RAFT.corr_state` gathers ``fmap2``'s rows
over the spatial group, so the shard's queries (local) look up the whole
image's targets with the same kernels; the coordinate grid holds the
image's own rows; the upsample + loss reads one row of flow from each
neighbouring shard (a row halo of the flow, ``halo=1``); the small
model's ``upflow8`` interpolates the shard's rows from the gathered
flow.  The result is the unsharded model's on the same samples, each
rank holding its rows' terms.

Images are NHWC float in [0, 255]; flows are ``(B, H, W, 2)``, ``(x, y)``
last.  Parameter names follow the flax paths (``fnet.layer1_0.conv1.
weight``, ``refine.update_block.gru.convzr1.weight``, ``upsampler.
mask_head.mask_conv1.weight``) so ``convert.py`` maps them mechanically.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.utils.checkpoint

from raft_tpu_torch.config import COMPUTE_DTYPES, RAFTConfig
from raft_tpu_torch.models.extractor import BasicEncoder, SmallEncoder
from raft_tpu_torch.models.layers import Conv, Norm
from raft_tpu_torch.models.update import (BasicUpdateBlock, FusedCorrLookup,
                                          MaskHead, SmallUpdateBlock)
from raft_tpu_torch.ops.corr import (QuantizedLevel, build_corr_pyramid,
                                     chunked_corr_lookup, corr_lookup,
                                     pool_fmap_pyramid)
from raft_tpu_torch.ops.corr_kernels import corr_lookup_ondemand_nchw
from raft_tpu_torch.ops.pyramid_kernels import (pyramid_lookup_nchw,
                                                pyramid_lookup_quantized_nchw)
from raft_tpu_torch.ops.sampler import coords_grid, upflow8
from raft_tpu_torch.ops.upsample import convex_upsample_nchw
from raft_tpu_torch.ops.upsample_loss import (upsample_loss_sums,
                                              upsample_loss_sums_plain)
from raft_tpu_torch.parallel import mesh as mesh_mod
from raft_tpu_torch.train.loss import combined_valid, sequence_terms


def _checkpoint(fn, *args, context_fn=None):
    """``fn(*args)`` under non-reentrant ``torch.utils.checkpoint``: its
    tensor arguments are kept, everything else it saves is recomputed in
    backward (no random op runs inside, so no RNG state is kept).  The
    recompute runs under the caller's mesh: autograd runs a CUDA
    backward on a thread of its own, where no mesh is active, and there
    the convolutions would pad the shard's edges with zeros."""
    mesh = mesh_mod.active()

    def under_mesh(*a):
        with mesh_mod.use(mesh):
            return fn(*a)

    kw = {} if context_fn is None else {"context_fn": context_fn}
    return torch.utils.checkpoint.checkpoint(
        under_mesh, *args, use_reentrant=False, preserve_rng_state=False,
        **kw)


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

    # RAFTConfig fields that shape the module tree: reconfigure() keeps
    # them, every other field is read at call time.
    _ARCH_FIELDS = ("small", "hidden_dim", "context_dim", "corr_levels",
                    "corr_radius", "dropout")

    def reconfigure(self, config: RAFTConfig) -> None:
        """Run with ``config`` from the next call on (the tuning
        registry's performance knobs, ``tuning.py``): the parameters stay,
        so only fields outside :attr:`_ARCH_FIELDS` may differ."""
        changed = [f for f in self._ARCH_FIELDS
                   if getattr(config, f) != getattr(self.config, f)]
        if changed:
            raise ValueError(f"reconfigure cannot change {changed}: they "
                             "shape the parameters")
        self.config = config
        self.refine["update_block"].gru.fused = config.fused_gru

    def init_weights(self, seed: int) -> None:
        """Seeded init: kaiming-normal fan-out encoder convs, torch-default
        update-block convs, identity norms."""
        gen = torch.Generator().manual_seed(seed)
        for m in self.modules():
            if isinstance(m, (Conv, Norm)):
                m.init_(gen)

    def corr_state(self, fmap1: torch.Tensor,
                   fmap2: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """The correlation state of a pair of fp32 NHWC feature maps as a
        flat tuple of tensors (the counterpart of JAX's
        ``_build_corr_state``), what :meth:`corr_lookup` reads:

        - ``allpairs`` / ``allpairs_pallas``: the pyramid levels, each a
          ``(B, H*W, Hl, Wl)`` tensor in ``corr_dtype``, or for a
          quantized dtype each level's codes and ``(B, 1, 1, 1)`` scale;
        - ``chunked`` / ``pallas``: ``fmap1`` and the pooled ``fmap2``
          levels.

        Every tensor has the batch first, so a serving slot keeps one
        lane's state in row ``i`` of each.  Under a mesh that splits rows
        ``fmap1`` holds the shard's queries and ``fmap2``'s rows are
        gathered over the spatial group first: the queries' targets are
        the whole image's."""
        cfg = self.config
        L = cfg.corr_levels
        mesh = mesh_mod.active_spatial()
        if mesh is not None:
            fmap2 = mesh_mod.all_gather_rows(fmap2, mesh, dim=1)
        if cfg.corr_impl in ("allpairs", "allpairs_pallas"):
            pyramid = build_corr_pyramid(fmap1, fmap2, L,
                                         cfg.corr_torch_dtype,
                                         cfg.resolved_corr_precision)
            return tuple(t for lv in pyramid for t in (
                lv if isinstance(lv, QuantizedLevel) else (lv,)))
        f2_pyramid = pool_fmap_pyramid(fmap2, L)
        if cfg.corr_impl == "pallas":
            # the on-demand kernels read contiguous levels; their backward
            # reaches fmap2 through the pooling by autograd
            f2_pyramid = [f2.contiguous() for f2 in f2_pyramid]
        return (fmap1, *f2_pyramid)

    def corr_lookup(self, state: Sequence[torch.Tensor],
                    coords: torch.Tensor):
        """``coords -> (B, P, H, W)`` taps from a :meth:`corr_state`,
        dispatched on ``corr_impl`` (a :class:`FusedCorrLookup` for the
        motion encoder with ``fused_lookup_encoder``).  The plain lookups
        run at ``corr_precision``; the kernels compute in fp32."""
        cfg = self.config
        r = cfg.corr_radius
        prec = cfg.resolved_corr_precision
        if cfg.corr_impl in ("allpairs", "allpairs_pallas"):
            pyramid = ([QuantizedLevel(state[i], state[i + 1])
                        for i in range(0, len(state), 2)]
                       if cfg.corr_dtype_is_quantized else list(state))
            if cfg.fused_lookup_encoder:
                return FusedCorrLookup(pyramid, coords.contiguous(), r,
                                       cfg.dtype)
            if cfg.corr_impl == "allpairs_pallas":
                # the kernels emit the taps in the compute dtype directly
                lookup = (pyramid_lookup_quantized_nchw
                          if cfg.corr_dtype_is_quantized
                          else pyramid_lookup_nchw)
                return lookup(pyramid, coords, r, cfg.dtype)
            return corr_lookup(pyramid, coords, r, prec).permute(
                0, 3, 1, 2).contiguous()
        fmap1, f2_pyramid = state[0], list(state[1:])
        if cfg.corr_impl == "chunked":
            return chunked_corr_lookup(
                fmap1, f2_pyramid, coords, r, cfg.corr_block_size, prec
            ).permute(0, 3, 1, 2).contiguous()
        return corr_lookup_ondemand_nchw(fmap1, f2_pyramid,
                                         coords.contiguous(), r)

    @staticmethod
    def _nchw(image: torch.Tensor) -> torch.Tensor:
        """NHWC frames in [0, 255] -> NCHW-contiguous fp32 in [-1, 1] (a
        permuted NHWC view would make the convs emit channels-last
        outputs)."""
        image = 2.0 * (image.float() / 255.0) - 1.0
        return image.permute(0, 3, 1, 2).contiguous()

    def _split_context(self, ctx: torch.Tensor):
        """``cnet``'s output -> ``(net, inp)``: tanh of the first
        ``hidden_dim`` channels, relu of the rest."""
        hdim = self.config.hidden_dim
        return torch.tanh(ctx[:, :hdim]), torch.relu(ctx[:, hdim:])

    def encode(self, image1: torch.Tensor, image2: torch.Tensor,
               flow_init: Optional[torch.Tensor] = None,
               freeze_bn: bool = False,
               generator: Optional[torch.Generator] = None):
        """The half of the forward before the refinement loop (JAX's
        ``_encode_state``, and as a serving program ``RAFTEncode``):
        ``(B, H, W, 3)`` frames -> ``(net, inp, coords0, coords1,
        corr_state)``; ``net`` and ``inp`` are NCHW in the compute dtype,
        the coordinates ``(B, H/8, W/8, 2)`` fp32.  Per sample
        independent in eval mode (instance norm; batch norm on stored
        statistics), so serving lanes encode together."""
        dt = self.config.dtype
        x1, x2 = self._nchw(image1), self._nchw(image2)
        B = x1.shape[0]
        fmaps = self.fnet(torch.cat([x1, x2], dim=0).to(dt), freeze_bn,
                          generator)
        fmaps = fmaps.float().permute(0, 2, 3, 1).contiguous()   # NHWC
        _, H8, W8, _ = fmaps.shape
        corr = self.corr_state(fmaps[:B], fmaps[B:])
        # From here the correlation state alone holds the features: a
        # quantized pyramid holds no graph, so fnet's saved activations
        # are freed now rather than when the forward returns
        del fmaps
        net, inp = self._split_context(self.cnet(x1.to(dt), freeze_bn,
                                                 generator))
        # a shard's coordinates are the image's rows, which the lookups
        # of the whole image's targets need
        mesh = mesh_mod.active_spatial()
        row0 = 0 if mesh is None else mesh.spatial_index * H8
        coords0 = coords_grid(B, H8, W8, device=x1.device, row0=row0)
        coords1 = coords0 if flow_init is None else coords0 + flow_init
        return net, inp, coords0, coords1, corr

    def frame_features(self, image: torch.Tensor):
        """One frame's features for a streaming session (JAX's
        ``RAFTFrameFeatures``): ``(B, H, W, 3) -> (fmap (B, H/8, W/8, C)
        fp32, ctx (B, hidden + context, H/8, W/8) compute dtype)``, eval
        mode, normalized as :meth:`encode` normalizes."""
        x = self._nchw(image).to(self.config.dtype)
        fmap = self.fnet(x, False, None).float().permute(0, 2, 3, 1)
        return fmap.contiguous(), self.cnet(x, False, None)

    def encode_warm(self, image2: torch.Tensor, fmap1: torch.Tensor,
                    ctx1: torch.Tensor, flow_init: torch.Tensor):
        """The warm encode of streamed frame N+1 (JAX's
        ``RAFTEncodeWarm``): only the new frame runs through the
        encoders; the carried ``fmap1`` / ``ctx1`` of the previous frame
        stand in for frame 1, and ``flow_init`` (the previous flow warped
        forward) starts ``coords1``.  Returns ``(net, inp, coords0,
        coords1, corr_state, fmap2, ctx2)``, the last two the next
        carry."""
        fmap2, ctx2 = self.frame_features(image2)
        corr = self.corr_state(fmap1, fmap2)
        net, inp = self._split_context(ctx1)
        B, H8, W8, _ = fmap1.shape
        coords0 = coords_grid(B, H8, W8, device=fmap1.device)
        return net, inp, coords0, coords0 + flow_init, corr, fmap2, ctx2

    def iter_step(self, net, coords1, inp, coords0, corr):
        """One refinement iteration from a correlation state (JAX's
        ``RAFTIterStep``): the loop body of :meth:`forward`, under the
        same remat policy -> ``(net, coords1)``."""
        return self._refine(functools.partial(self.corr_lookup, corr), net,
                            inp, coords0, coords1)

    def upsample(self, net: torch.Tensor,
                 flow_low: torch.Tensor) -> torch.Tensor:
        """``(net, flow_low (B, H/8, W/8, 2)) -> flow_up (B, H, W, 2)``
        (JAX's ``RAFTUpsample``): the mask head and the convex upsample,
        or the small model's ``upflow8``."""
        if self.config.small:
            return upflow8(flow_low)
        mask = self.upsampler["mask_head"](net).float()
        flow_up = convex_upsample_nchw(flow_low.permute(0, 3, 1, 2), mask)
        return flow_up.permute(0, 2, 3, 1)

    def forward(self, image1: torch.Tensor, image2: torch.Tensor,
                iters: int = 12, flow_init: Optional[torch.Tensor] = None,
                test_mode: bool = False, freeze_bn: bool = False,
                loss_targets: Optional[tuple] = None,
                generator: Optional[torch.Generator] = None):
        """``(B, H, W, 3)`` frames -> one of the three outputs of the
        module docstring; ``flow_init`` is ``(B, H/8, W/8, 2)``."""
        cfg = self.config
        net, inp, coords0, coords1, corr = self.encode(
            image1, image2, flow_init, freeze_bn, generator)
        lookup = functools.partial(self.corr_lookup, corr)
        B, H8, W8, _ = coords0.shape
        nets, flows = [], []
        for _ in range(iters):
            net, coords1 = self._refine(lookup, net, inp, coords0,
                                        coords1.detach())
            if not test_mode:
                nets.append(net)
                flows.append(coords1 - coords0)

        if test_mode:
            flow_low = coords1 - coords0
            return flow_low, self.upsample(net, flow_low)
        if cfg.small:
            return self._small_outputs(flows, coords1 - coords0,
                                       loss_targets)
        mask_head = self.upsampler["mask_head"]
        # every iteration folded into one batch, iteration-major
        flows = torch.stack(flows, dim=0).reshape(iters * B, H8, W8, 2)
        nets = torch.cat(nets, dim=0)
        remat_up = cfg.remat_upsample and torch.is_grad_enabled()
        # a shard's upsample reads a row of flow beyond each of its edges
        mesh = mesh_mod.active_spatial()
        halo = 0 if mesh is None else 1
        if halo:
            flows = mesh_mod.halo_rows(flows, 1, 1, mesh, dim=1)
        if loss_targets is not None:
            flow_gt, valid, max_flow = loss_targets
            vmask = combined_valid(flow_gt, valid, max_flow)
            gt = flow_gt.float().contiguous()
            loss_sums = functools.partial(self._upsample_loss_sums,
                                          halo=halo)
            sums = (_checkpoint(loss_sums, nets, flows, gt, vmask)
                    if remat_up else loss_sums(nets, flows, gt, vmask))
            return self._loss_outputs(sums, gt, vmask, iters, B)

        def upsample(nets, flows):
            mask = mask_head(nets)
            return convex_upsample_nchw(flows.permute(0, 3, 1, 2),
                                        mask.float(), halo)

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

    def _upsample_loss_sums(self, nets, flows, gt, vmask, halo=0):
        """Mask head on the folded GRU states, then the flat upsample +
        loss sums ``(iters * B, 5)``; ``halo``: the flow's extra rows."""
        cfg = self.config
        mask = self.upsampler["mask_head"](nets).contiguous()
        if cfg.upsample_loss_kernel == "pallas":
            return upsample_loss_sums(flows, mask, gt, vmask, halo)
        return upsample_loss_sums_plain(
            flows, mask, gt, vmask,
            COMPUTE_DTYPES[cfg.resolved_upsample_dtype], halo)

    def _small_outputs(self, flows, flow_low, loss_targets):
        """Small-model upsampling of every iteration's flow (``upflow8``),
        and with ``loss_targets`` the sequence-loss terms on them
        (``raft_tpu/models/raft.py:548-576``)."""
        iters = len(flows)
        B, H8, W8, _ = flow_low.shape
        flows, rows = torch.cat(flows, dim=0), None
        mesh = mesh_mod.active_spatial()
        if mesh is not None:    # the shard's rows of the image's upflow8
            flows = mesh_mod.all_gather_rows(flows, mesh, dim=1)
            rows = (8 * H8 * mesh.spatial_index,
                    8 * H8 * (mesh.spatial_index + 1))
        up = upflow8(flows, rows).reshape(iters, B, 8 * H8, 8 * W8, 2)
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
