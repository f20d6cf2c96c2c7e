"""The training loop (the port of ``raft_tpu/train/loop.py``).

- Host batches come from a ``ShardedLoader`` (or a caller's iterator) and
  pass through the overlapped input pipeline (``data/prefetch.py``): a
  producer thread applies the image noise and copies batch N+1 to the
  device while the step runs on batch N (``cfg.device_prefetch``; 0 = the
  serial path, the same batch stream either way).
- Checkpoints carry the full state (``train/checkpoint.py``); a run whose
  ``ckpt_dir/name`` holds one resumes from its newest restorable step and
  continues the loader's shuffle from there.
- Preemption is cooperative: :func:`request_preemption` (the train CLI's
  SIGTERM handler, or the ``preempt`` chaos fault) makes the loop save the
  last completed step and exit with ``SystemExit(143)`` at the next step
  boundary, or at once while it waits for input.  Across data-parallel
  ranks (``mesh``) a rank's flag is only a request: the loop takes the
  MAX of the flags over the ranks' host group at every step boundary,
  so every rank exits after the same step (the JAX package's agreed
  preemption step on more than one host).
- Under a mesh that splits rows (``spatial = N > 1``) the N ranks of a
  data index read the same samples (one ``ShardedLoader`` stride per
  data index, so the same augmentation too); after the image noise,
  which is drawn for the whole image, each keeps its rows
  ``[s*H/N, (s+1)*H/N)`` (:func:`shard_rows`), on the producer thread.
- Across ranks, rank 0 alone writes checkpoints, runs the validators and
  prints the logger's lines; every rank meets at a barrier after each
  ``val_freq`` step, so the others wait there while it validates.
- The step reads nothing back, so the host may run ahead of the card: the
  loop waits for step N-1 to finish on the device after it issues step
  N, which keeps at most two steps (and their batches) in flight and the
  card fed.
- The image noise's generator is ``SeedSequence([seed + 1, start_step])``,
  as in the JAX package: a resumed run does not replay the noise of step
  0, and a run started at step k draws what the JAX package draws.

The JAX loop's telemetry, tracing, health, watchdog and profiler hooks are
not carried over (ROADMAP A8).
"""

from __future__ import annotations

import functools
import os
import threading
import time
from typing import Callable, Dict, Mapping, Optional

import numpy as np
import torch

from raft_tpu_torch import chaos
from raft_tpu_torch.config import RAFTConfig, TrainConfig
from raft_tpu_torch.data.prefetch import (CudaBatchPut, DevicePipeline,
                                          PipelineInterrupted, host_put)
from raft_tpu_torch.evaluate import DeviceLike, resolve_device
from raft_tpu_torch.parallel.mesh import Mesh
from raft_tpu_torch.train.checkpoint import CheckpointManager
from raft_tpu_torch.train.logger import Logger
from raft_tpu_torch.train.state import TrainState
from raft_tpu_torch.train.step import init_state, make_train_step

_PREEMPT = threading.Event()


def request_preemption() -> None:
    """Ask the running :func:`train` to checkpoint and exit after the
    current step (safe from a signal handler).  Across ranks every rank
    exits at the first step boundary where any rank has asked."""
    _PREEMPT.set()


def _silent(*args, **kwargs) -> None:
    """The printing of a rank other than 0."""


def add_image_noise(rng: np.random.Generator, batch: Mapping) -> Dict:
    """Gaussian noise with stdv ~ U(0, 5), one draw for both frames,
    clipped to [0, 255]."""
    out = dict(batch)
    stdv = rng.uniform(0.0, 5.0)
    for k in ("image1", "image2"):
        out[k] = np.clip(
            batch[k] + stdv * rng.standard_normal(batch[k].shape)
            .astype(np.float32), 0.0, 255.0)
    return out


def shard_rows(batch: Mapping, index: int, count: int) -> Dict:
    """Rows ``[index*H/count, (index+1)*H/count)`` of every array of a
    host batch (``(B, H, ...)``); ``H`` must divide evenly."""
    H = batch["image1"].shape[1]
    if H % count:
        raise ValueError(f"image height {H} does not split into {count} "
                         "equal shards")
    h = H // count
    return {k: np.ascontiguousarray(v[:, index * h:(index + 1) * h])
            for k, v in batch.items()}


def noise_prep(seed: int, start_step: int) -> Callable[[Mapping], Dict]:
    """The pipeline's prep for ``add_noise``: :func:`add_image_noise` with
    one generator from ``SeedSequence([seed + 1, start_step])`` for the
    whole stream, called once per batch in stream order."""
    rng = np.random.default_rng(np.random.SeedSequence([seed + 1,
                                                        start_step]))
    return functools.partial(add_image_noise, rng)


def train(model_cfg: RAFTConfig, cfg: TrainConfig, batches=None, *,
          loader=None,
          validators: Optional[Dict[str, Callable]] = None,
          restore_params: Optional[Mapping] = None,
          tensorboard_dir: Optional[str] = None,
          device: DeviceLike = "cuda",
          log: Optional[Callable[[str], None]] = None,
          timings: Optional[list] = None,
          mesh: Optional[Mesh] = None) -> TrainState:
    """Train up to ``cfg.num_steps`` steps and return the state.

    ``batches``: an iterator of host batches (dicts of NHWC arrays:
    ``image1``, ``image2``, ``flow``, ``valid``); or ``loader``: a
    ``ShardedLoader``, whose stream continues from the restored step on
    resume.  ``validators``: name -> fn(state_dict) -> dict, run every
    ``cfg.val_freq`` steps after the checkpoint.  ``restore_params``: a
    model ``state_dict`` to start from (a previous stage's weights).
    ``log``: where the logger's lines go (default: printed).
    ``timings``: a list that gets one dict per step: ``loss`` (a device
    tensor, not read back), ``queue_wait_s`` (time blocked on the
    pipeline), ``step_s`` (queue wait + step, which ends when the previous
    step has finished on the device),
    and the producer's ``prep_s`` and ``h2d_s``.
    ``mesh``: data (and spatial) parallel over its ranks; each data
    index passes its own stride of the stream (``ShardedLoader(num_hosts=
    mesh.data_size, host_id=mesh.data_index)``) of whole images, which
    the loop cuts into the rank's rows when ``mesh.spatial > 1``, and
    ``cfg.batch_size`` is the global batch.
    """
    if (batches is None) == (loader is None):
        raise ValueError("pass exactly one of batches= or loader=")
    dev = resolve_device(device)
    _PREEMPT.clear()
    multi = mesh is not None and mesh.world > 1
    chief = mesh is None or mesh.rank == 0
    say = functools.partial(print, flush=True) if chief else _silent
    state = init_state(model_cfg, cfg, device=dev,
                       state_dict=restore_params)
    say(f"Parameter Count: "
        f"{sum(p.numel() for p in state.model.parameters())}")

    mgr = CheckpointManager(os.path.join(cfg.ckpt_dir, cfg.name),
                            commit_window=max(int(cfg.ckpt_commit_window),
                                              1), mesh=mesh)
    if mgr.restore_latest(state) is not None:
        saved_on = mgr.saved_topology(state.step) or {}
        say(f"resumed from step {state.step}"
            + (f" (saved on {saved_on.get('device_count')} x "
               f"{saved_on.get('device')}, world "
               f"{saved_on.get('world_size', 1)})" if saved_on else ""))

    step_fn = make_train_step(cfg, device=dev, **(
        {} if mesh is None else {"mesh": mesh}))
    step = state.step
    if loader is not None:
        batches = loader.batches_from_step(step)
    prep_fn = noise_prep(cfg.seed, step) if cfg.add_noise else None
    if mesh is not None and mesh.spatial > 1:
        noise = prep_fn

        def prep_fn(batch, noise=noise):
            return shard_rows(batch if noise is None else noise(batch),
                              mesh.spatial_index, mesh.spatial)
    logger = Logger(cfg.log_freq, lr_fn=state.schedule,
                    tensorboard_dir=tensorboard_dir, log=log)
    depth = max(int(cfg.device_prefetch), 0)
    if dev.type == "cuda":
        put = CudaBatchPut(dev, depth + 1)
        put_fn, ready_fn = put.put, put.ready
    else:
        put_fn, ready_fn = host_put, None
    # across ranks a flag interrupts nothing alone: the ranks agree at the
    # next step boundary
    pipeline = DevicePipeline(batches, put_fn=put_fn, ready_fn=ready_fn,
                              prep_fn=prep_fn, depth=depth,
                              interrupt=None if multi else _PREEMPT.is_set)
    t0, steps_t0 = time.time(), step
    in_flight = []          # the previous step's completion event
    try:
        while True:
            t_iter = time.perf_counter()
            try:
                batch = next(pipeline)
            except StopIteration:
                break
            except PipelineInterrupted:
                raise SystemExit(143)
            queue_wait_s = time.perf_counter() - t_iter
            if step >= cfg.num_steps:
                break
            if chaos.should_inject("preempt", step=step,
                                   point="train.preempt"):
                request_preemption()
            if (mesh.any_host(_PREEMPT.is_set()) if multi
                    else _PREEMPT.is_set()):
                raise SystemExit(143)  # step boundary: state consistent
            state, metrics = step_fn(state, batch)
            if dev.type == "cuda":
                in_flight.append(torch.cuda.Event())
                in_flight[-1].record()
                if len(in_flight) > 1:
                    in_flight.pop(0).synchronize()
            step += 1
            if chief:
                logger.push(step - 1, metrics)
            if timings is not None:
                timings.append({
                    "step": step - 1, "loss": metrics["loss"],
                    "queue_wait_s": queue_wait_s,
                    "step_s": time.perf_counter() - t_iter,
                    "prep_s": pipeline.last_prep_s,
                    "h2d_s": pipeline.last_h2d_s})
            if not multi and _PREEMPT.is_set():
                raise SystemExit(143)

            if step % cfg.val_freq == 0:
                mgr.save_async(step, state)
                if validators and chief:
                    sd = dict(state.model.state_dict())
                    results = {}
                    for fn in validators.values():
                        results.update(fn(sd))
                    logger.write_dict(step, results)
                if multi:
                    # every rank, validators or not: only rank 0 has them
                    mesh.barrier()
                dt = time.time() - t0
                ips = (step - steps_t0) * cfg.batch_size / max(dt, 1e-9)
                say(f"throughput: {ips:.2f} image-pairs/sec (host)")
                t0, steps_t0 = time.time(), step

        if mgr.last_requested_step() != state.step:
            mgr.save(state.step, state)
    except (KeyboardInterrupt, SystemExit):
        # flush the last completed step so the next run resumes there,
        # optimizer state and the loader's position in the shuffle included
        say(f"preempted at step {state.step}; checkpointing")
        try:
            mgr.wait()
        except Exception as e:
            say(f"checkpoint flush failed during preemption: {e}")
        if mgr.latest_step() != state.step:
            mgr.save(state.step, state)
        raise
    finally:
        pipeline.close()
        mgr.wait()
        mgr.close()
        logger.close()
    return state
