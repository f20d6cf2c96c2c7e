"""The training step (the port of ``raft_tpu/train/step.py:31-216``):
forward in train mode + γ-weighted sequence loss + backward + global-norm
clip + AdamW/OneCycle update, on one device.

- ``cfg.fused_loss`` (default): the model returns the per-iteration loss
  terms from its flat upsample + loss chain; otherwise it returns stacked
  flows and :func:`raft_tpu_torch.train.loss.sequence_loss` weighs them.
- ``cfg.accum_steps > 1`` splits the batch into equal microbatches, runs
  forward and backward on each and sums the gradients in fp32; the update
  sees their mean.  Batch-norm statistics move microbatch by microbatch.
- A parameter that the loss does not reach (``fnet`` under a quantized
  pyramid, whose codes carry no gradient) takes a zero gradient, so AdamW
  still decays its weights and moments, as optax does.
- ``cfg.nonfinite_guard``: on the device, as JAX's (``raft_tpu/train/
  step.py:202-214``): a step whose loss or gradient norm is not finite
  leaves the parameters, the optimizer state (moments and update count,
  so the schedule stands still too) and the batch-norm statistics as they
  were, bit for bit, and adds one to the device counter
  ``nonfinite_steps``; ``step`` still advances.  Nothing is read back: the
  flag is the fused AdamW's ``found_inf`` (its kernel then returns before
  writing anything and its count is taken back) and the statistics are
  selected with ``torch.where``.  ``found_inf`` is the attribute
  ``GradScaler`` sets on an optimizer whose ``_step_supports_amp_scaling``
  is true, which ``Adam``/``AdamW.step`` pass to the fused kernel: a
  protocol torch does not document (relied on as torch 2.11 and 2.13 have
  it).  ``tests/test_torch_train.py::
  test_nonfinite_guard_leaves_state_bit_identical`` reads the update count
  after a NaN step, so a torch that drops it fails there.
- ``mesh`` (``parallel/mesh.py``): data parallel over the mesh's ranks,
  each feeding its own rows of the global batch.  Batch-norm statistics
  and the dropout mask are the global batch's (``models/layers.py``);
  after the microbatch accumulation the gradients and the metrics go
  into one preallocated fp32 buffer, one all-reduce sums it over the
  ranks, and the gradients and the loss terms are divided by the world
  size (gloo has no average), the pixel metrics (``epe``, ``1px``,
  ``3px``, ``5px``, ``epe_iter``) weighed by each rank's valid pixels:
  they are the global batch's, as JAX's replicated outputs are.  So the
  global norm, the clip, the guard (a non-finite gradient on one rank
  skips the step on all) and the update are the same on every rank.  A
  mesh backed by a process group all-reduces even at world 1 (exact: a
  sum of one, a division by 1).  No ``DistributedDataParallel``: it
  would reduce once per microbatch, need ``find_unused_parameters`` for
  ``fnet`` under a quantized pyramid, and hook into the backward that is
  captured.  Under NCCL the all-reduce is inside the captured graph; a
  gloo mesh (ranks sharing one GPU, or the CPU) runs eagerly.
- a ``mesh`` with ``spatial = N > 1`` also splits each sample's rows over
  the N ranks of a data index (``parallel/mesh.py``): ``batch`` is then
  this rank's rows of its data index's samples, the model exchanges
  what crosses the shards (``models/raft.py``), and the same one
  all-reduce over the world ends the step.  Dividing by the world holds
  for spatial ranks too: each rank's loss terms are means over its own
  shard, and the shards are equal (the image height a multiple of
  ``8 * N``), so the world's mean of the ranks' means is the global
  batch's mean; the gradient of each rank's loss carries, through the
  collectives' backwards, what its rows did to the other shards' loss,
  so the sum over the ranks is the gradient of the sum.  The pixel
  metrics stay weighed by each rank's valid pixels.
- The health taps (JAX's optax update tap, ``raft_tpu/train/state.py:
  41-51``): ``param_norm`` is the global L2 norm of the parameters before
  the update, ``update_ratio`` the norm of (new - old) over
  ``param_norm + 1e-12``, both from one device copy of the parameters
  taken before the fused AdamW updates them in place, after the
  reduction over ranks (every rank holds the same values).  On a step the
  guard skips, JAX reports the norm of the rejected update, which is not
  finite; the port's optimizer never forms that update (``found_inf``),
  so the parameters do not move and ``update_ratio`` is 0.
- Tuning registry (``tuning.py``): on its first call the step consults
  the per-hardware registry for the ``(train, device_kind, image_size,
  per-rank batch)`` key and applies the tuned winners to every
  ``RAFTConfig`` knob of the state's model still at its class default
  (``RAFT.reconfigure``); explicit knobs always win, ``RAFT_TUNING=0``
  disables, and a caller that already resolved tuning upstream
  (``train/loop.py``) sees an idempotent no-op.
- On the card the whole step (forward, backward, global norm, clip,
  learning rate, AdamW, statistics, guard; every microbatch) is one
  captured CUDA graph per batch shape, held by ``state.programs``
  (``utils/graphs.py``); the batch is copied into its static buffers and
  the dropout generator is registered with it.  ``graphs=False`` runs the
  same step eagerly, for comparisons; the CPU always runs eagerly.
"""

from __future__ import annotations

import weakref
from typing import Callable, Dict, List, Mapping, Optional

import torch
import torch.distributed as dist

from raft_tpu_torch.config import (RAFTConfig, TrainConfig, backend_flags,
                                   entry_precision)
from raft_tpu_torch.evaluate import DeviceLike, resolve_device
from raft_tpu_torch.models.raft import RAFT
from raft_tpu_torch.parallel import mesh as mesh_mod
from raft_tpu_torch.parallel.mesh import Mesh
from raft_tpu_torch.train.loss import combined_valid, sequence_loss
from raft_tpu_torch.train.optim import (clip_by_global_norm_, global_norm,
                                        make_optimizer, set_scheduled_lr_)
from raft_tpu_torch.train.state import TrainState

BATCH_KEYS = ("image1", "image2", "flow", "valid")


def init_state(model_cfg: RAFTConfig, cfg: TrainConfig,
               device: DeviceLike = "cuda",
               state_dict: Optional[Mapping] = None) -> TrainState:
    """A fresh state on ``device``: the model seeded from ``cfg.seed`` (or
    holding ``state_dict``) in train mode, AdamW + OneCycle from
    :func:`make_optimizer`, a dropout generator seeded from ``cfg.seed``
    and no captured graph yet."""
    dev = resolve_device(device)
    model = RAFT(model_cfg, seed=cfg.seed)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    model = model.to(dev).train()
    opt, sched = make_optimizer(model.parameters(), cfg.lr, cfg.num_steps,
                                cfg.wdecay, cfg.epsilon)
    gen = torch.Generator(device=dev).manual_seed(cfg.seed)
    return TrainState(model=model, optimizer=opt, schedule=sched,
                      generator=gen,
                      nonfinite_steps=torch.zeros((), dtype=torch.int64,
                                                  device=dev))


def make_loss_fn(cfg: TrainConfig) -> Callable:
    """``loss_fn(model, batch, generator) -> (loss, metrics)``: the
    differentiated core of the step.  ``batch`` holds tensors on the
    model's device; the metrics are detached."""

    def loss_fn(model: RAFT, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None):
        kwargs = dict(iters=cfg.iters, freeze_bn=cfg.freeze_bn,
                      generator=generator)
        if cfg.fused_loss:
            per_iter, metrics = model(
                batch["image1"], batch["image2"],
                loss_targets=(batch["flow"], batch["valid"], cfg.max_flow),
                **kwargs)
            i = torch.arange(cfg.iters, dtype=torch.float32,
                             device=per_iter.device)
            weights = cfg.gamma ** (cfg.iters - i - 1.0)
            loss = torch.sum(weights * per_iter)
            metrics = dict(metrics, loss_iter=per_iter)
        else:
            flows = model(batch["image1"], batch["image2"], **kwargs)
            loss, metrics = sequence_loss(flows, batch["flow"],
                                          batch["valid"], gamma=cfg.gamma,
                                          max_flow=cfg.max_flow)
        return loss, {k: v.detach() for k, v in metrics.items()}

    return loss_fn


def _grads(params) -> List[torch.Tensor]:
    """Each parameter's gradient, zero where the backward gave none."""
    return [torch.zeros_like(p) if p.grad is None else p.grad
            for p in params]


def _to_device(batch: Mapping, dev: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(batch[k], dtype=torch.float32, device=dev)
            for k in BATCH_KEYS}


# the metrics that are means over valid pixels, weighed by each rank's
# valid-pixel count in the cross-rank mean; the others are plain means
PIXEL_METRICS = ("epe", "1px", "3px", "5px", "epe_iter")


def _reduce_over_ranks_(grads: List[torch.Tensor], loss: torch.Tensor,
                        metrics: Dict[str, torch.Tensor],
                        n_valid: torch.Tensor, mesh: Mesh,
                        flat: torch.Tensor):
    """The gradients' and metrics' means over ``mesh``'s global batch
    through one all-reduce of ``flat`` (fp32, preallocated, as long as
    all of them).  The gradients are copied back into ``grads`` (so the
    norm and the update read tensors laid out as without a mesh: at
    world 1 the step is bit for bit the plain one); returns ``(loss,
    metrics)``, tensors of their own."""
    plain = sorted(k for k in metrics if k not in PIXEL_METRICS)
    pixel = sorted(k for k in metrics if k in PIXEL_METRICS)
    parts = ([g.reshape(-1) for g in grads] + [loss.float().reshape(1)]
             + [metrics[k].float().reshape(-1) for k in plain]
             + [(metrics[k].float() * n_valid).reshape(-1) for k in pixel]
             + [n_valid.reshape(1)])
    torch.cat(parts, out=flat)
    dist.all_reduce(flat, group=mesh.group)
    views, at = [], 0
    for part in parts:
        views.append(flat[at:at + part.numel()])
        at += part.numel()
    n_mean = len(grads) + 1 + len(plain)   # parts averaged over the ranks
    flat[:sum(p.numel() for p in parts[:n_mean])].div_(mesh.world)
    n = views[-1].clamp(min=1.0)
    for v in views[n_mean:-1]:
        v.div_(n)
    torch._foreach_copy_(grads, [v.view_as(g) for v, g in zip(views, grads)])
    # copies: the next step reuses the buffer
    out = dict(zip(plain + pixel, views[len(grads) + 1:-1]))
    return (views[len(grads)].view(()).clone(),
            {k: out[k].view_as(metrics[k]).clone() for k in metrics})


def _step_body(state: TrainState, cfg: TrainConfig, loss_fn: Callable,
               accum: int, batch: Dict[str, torch.Tensor],
               mesh: Optional[Mesh] = None,
               buffers: Optional[Dict] = None) -> Dict:
    """The device work of one step on ``batch`` (device tensors): updates
    ``state``'s tensors in place and returns the metrics.  Reads nothing
    back to the host and changes no host state, so it can be captured.
    With a ``mesh`` (distributed, and active for the norms and dropout:
    ``parallel.use``) the gradients and metrics are reduced over its
    ranks through a buffer kept in ``buffers``."""
    model = state.model
    B = batch["image1"].shape[0]
    params = list(model.parameters())
    stats = ([(b, b.clone()) for b in model.buffers()]
             if cfg.nonfinite_guard else [])
    model.train()
    model.zero_grad(set_to_none=True)
    if accum == 1:
        loss, metrics = loss_fn(model, batch, state.generator)
        loss.backward()
        grads = _grads(params)
    else:
        m = B // accum
        acc = [torch.zeros_like(p, dtype=torch.float32) for p in params]
        losses, parts = [], []
        for i in range(accum):
            micro = {k: v[i * m:(i + 1) * m] for k, v in batch.items()}
            model.zero_grad(set_to_none=True)
            loss_i, metrics_i = loss_fn(model, micro, state.generator)
            loss_i.backward()
            torch._foreach_add_(acc, [g.float() for g in _grads(params)])
            losses.append(loss_i.detach())
            parts.append(metrics_i)
        grads = [a / accum for a in acc]
        loss = torch.stack(losses).mean()
        metrics = {k: torch.stack([p[k] for p in parts]).mean(dim=0)
                   for k in parts[0]}
    if mesh is not None:
        n_valid = combined_valid(batch["flow"], batch["valid"],
                                 cfg.max_flow).sum()
        size = (sum(g.numel() for g in grads) + 2
                + sum(v.numel() for v in metrics.values()))
        flat = buffers.get(size)
        if flat is None:
            flat = buffers[size] = torch.empty(size, dtype=torch.float32,
                                               device=loss.device)
        loss, metrics = _reduce_over_ranks_(
            grads, loss.detach(), metrics, n_valid, mesh, flat)
    gnorm = global_norm(grads)
    clip_by_global_norm_(grads, cfg.clip, gnorm)
    for p, g in zip(params, grads):
        p.grad = g.to(p.dtype)
    opt = state.optimizer
    opt.found_inf = None
    if cfg.nonfinite_guard:
        ok = torch.isfinite(loss) & torch.isfinite(gnorm)
        bad = (~ok).float()
        opt.found_inf = bad
    set_scheduled_lr_(opt, state.schedule)
    # the health taps: one device copy of the parameters before the update
    with torch.no_grad():
        delta = [p.detach().clone() for p in params]
        param_norm = global_norm(delta)
    opt.step()
    with torch.no_grad():
        torch._foreach_sub_(delta, [p.detach() for p in params])
        update_ratio = global_norm(delta) / (param_norm + 1e-12)
    del delta
    if cfg.nonfinite_guard:
        with torch.no_grad():
            for buf, old in stats:
                buf.copy_(torch.where(ok, buf, old))
            state.nonfinite_steps.add_(bad.long())
    else:
        bad = torch.zeros((), device=loss.device)
    model.zero_grad(set_to_none=True)
    return dict(metrics, loss=loss.detach(), grad_norm=gnorm, nonfinite=bad,
                param_norm=param_norm, update_ratio=update_ratio)


def _apply_tuning(model: RAFT, cfg: TrainConfig, world: int) -> None:
    """The tuning registry's train winners onto ``model`` (see the module
    docstring)."""
    from raft_tpu_torch import tuning

    if not tuning.enabled():
        return
    tuned_cfg, info = tuning.resolve_config(
        model.config, "train", tuple(cfg.image_size),
        max(cfg.batch_size // max(world, 1), 1))
    if info.applied:
        model.reconfigure(tuned_cfg)


def make_train_step(cfg: TrainConfig, device: DeviceLike = "cuda",
                    graphs: Optional[bool] = None,
                    mesh: Optional[Mesh] = None) -> Callable:
    """``step_fn(state, batch) -> (state, metrics)``: one update of
    ``state`` in place.  ``batch`` holds ``image1``/``image2``
    ``(B, H, W, 3)`` in [0, 255], ``flow`` ``(B, H, W, 2)`` and ``valid``
    ``(B, H, W)`` as arrays or tensors (moved to ``device``).  Metrics are
    device tensors: ``loss``, ``epe``, ``1px``, ``3px``, ``5px``,
    ``loss_iter``, ``epe_iter``, ``grad_norm``, ``nonfinite``,
    ``param_norm`` and ``update_ratio`` (see the module docstring).
    ``step_fn.graphs`` says whether the step runs as captured graphs.

    ``graphs`` (default: on the card) runs the step as a captured graph
    per batch shape; ``False`` runs it eagerly (for comparisons).  Each
    call runs under :func:`entry_precision`.

    ``mesh``: data (and spatial) parallel over its ranks (see the module
    docstring); ``batch`` is then this rank's samples (and rows) and the
    metrics the global batch's.  A gloo mesh runs eagerly: gloo cannot
    be captured."""
    dev = resolve_device(device)
    if mesh is not None and not mesh.distributed:
        mesh = None                     # one process, no group: plain
    eager_mesh = mesh is not None and mesh.backend != "nccl"
    if graphs is None:
        graphs = dev.type == "cuda" and not eager_mesh
    if graphs and dev.type != "cuda":
        raise ValueError("graphs=True needs a CUDA device")
    if graphs and eager_mesh:
        raise ValueError(f"a {mesh.backend} mesh cannot run inside a "
                         "captured graph; pass graphs=False")
    loss_fn = make_loss_fn(cfg)
    accum = max(int(cfg.accum_steps), 1)
    buffers: Dict[int, torch.Tensor] = {}
    ranks = None if mesh is None else (mesh.world, mesh.rank, mesh.backend,
                                       mesh.spatial)
    tuned: "weakref.WeakSet[RAFT]" = weakref.WeakSet()

    def step_fn(state: TrainState, batch: Mapping):
        if state.model not in tuned:
            tuned.add(state.model)
            _apply_tuning(state.model, cfg,
                          1 if mesh is None else mesh.world)
        batch = _to_device(batch, dev)
        B = batch["image1"].shape[0]
        if B % accum:
            raise ValueError(
                f"accum_steps={accum} must divide the batch size {B} evenly "
                f"(remainder {B % accum})")
        with entry_precision(), mesh_mod.use(mesh):
            if graphs:
                metrics = state.programs(
                    ("train_step", cfg, backend_flags(), ranks),
                    lambda *ts: _step_body(state, cfg, loss_fn, accum,
                                           dict(zip(BATCH_KEYS, ts)), mesh,
                                           buffers),
                    [batch[k] for k in BATCH_KEYS], [state.generator])
            else:
                metrics = _step_body(state, cfg, loss_fn, accum, batch,
                                     mesh, buffers)
        state.step += 1
        return state, metrics

    step_fn.graphs = graphs
    return step_fn


def step_cost(count, batch_size: int, num_devices: int, kind=None):
    """The :class:`~raft_tpu_torch.obs.cost.ProgramCost` of a train step
    counted by ``obs.cost.counting`` (its first call).  One call on one
    device advances ``batch_size / num_devices`` pairs, which keeps
    ``flops_per_pair`` the same at any world size, as in the JAX
    package."""
    from raft_tpu_torch.obs import cost as cost_mod

    return cost_mod.counted_cost(
        count, program="train_step",
        pairs_per_call=float(batch_size) / max(int(num_devices), 1),
        kind=kind)
