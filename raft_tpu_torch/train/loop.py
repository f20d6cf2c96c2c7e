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

Observability, at the JAX loop's places and with its events
(``obs/train.py``), none of it adding a device sync to the step path:

- ``telemetry_dir`` (default ``$RAFT_TELEMETRY_DIR``; unset = off): a
  JSONL stream of ``run_config``, one ``train_step`` a step (host
  ``perf_counter`` floats only), ``compile`` (the step key's first,
  eager call), ``cost_report`` (that first call counted,
  ``obs/cost.py``, at any world size: the counting modes step aside
  around the ranks' collectives, so each rank counts its own forward
  and backward, and ``flops_per_pair`` is world 1's), ``hbm_usage``
  (the allocator's peak, reset before the first step and read after the
  capture), ``train_health`` a Logger flush, and ``metrics_summary``
  last; the loader's ``sample_quarantine`` and the checkpoint manager's
  ``ckpt_fallback`` / ``ckpt_commit`` events land in the same stream.
- Health: every rank's Logger (silent but on rank 0) feeds its own
  :class:`~raft_tpu_torch.obs.health.HealthMonitor` from its one
  transfer per ``log_freq`` steps; a step the guard flagged gets a
  forensic bundle of the rank's own rows under
  ``<telemetry_dir>/forensics/`` (``cfg.forensic_keep`` host batches in
  the ring).
- ``cfg.trace_sample_rate``: each sampled step is a ``train_step`` trace
  with ``queue_wait``, ``prep``, ``h2d``, ``step_dispatch`` (the host's
  enqueue of the step; the device time shows in ``step_time_s``, since
  the loop waits one step behind) and ``ckpt_commit`` (recorded on the
  committer thread) children.
- ``cfg.watchdog_timeout``: the stall watchdog, paused across the first
  call of the step key (eager) and the second (the capture), and around
  save and validate.
- ``cfg.profile_steps = (A, B)``: a ``torch.profiler`` window over the
  absolute steps ``[A, B)``, a Chrome trace under
  ``<telemetry_dir>/profile/`` or ``profile_dir``; it waits for the card
  once, at its end.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import os
import threading
import time
from typing import Callable, Dict, Mapping, Optional

import numpy as np
import torch

from raft_tpu_torch import chaos, tuning
from raft_tpu_torch.config import RAFTConfig, TrainConfig
from raft_tpu_torch.data.prefetch import (CudaBatchPut, DevicePipeline,
                                          PipelineInterrupted, host_put)
from raft_tpu_torch.evaluate import DeviceLike, resolve_device
from raft_tpu_torch.obs import cost as cost_mod
from raft_tpu_torch.obs import trace
from raft_tpu_torch.obs.health import HealthMonitor
from raft_tpu_torch.obs.train import TrainTelemetry
from raft_tpu_torch.obs.watchdog import StallWatchdog, stack_dump_path
from raft_tpu_torch.parallel.mesh import Mesh
from raft_tpu_torch.train.checkpoint import CheckpointManager
from raft_tpu_torch.train.logger import Logger
from raft_tpu_torch.train.state import TrainState
from raft_tpu_torch.train.step import init_state, make_train_step, step_cost
from raft_tpu_torch.utils.profiling import (StepProfiler, annotate_step,
                                            hbm_usage, state_bytes)

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
          profile_dir: Optional[str] = None,
          telemetry_dir: Optional[str] = None,
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
    ``telemetry_dir`` / ``profile_dir``: see the module docstring.
    """
    if (batches is None) == (loader is None):
        raise ValueError("pass exactly one of batches= or loader=")
    dev = resolve_device(device)
    _PREEMPT.clear()
    multi = mesh is not None and mesh.world > 1
    world = 1 if mesh is None else mesh.world
    chief = mesh is None or mesh.rank == 0
    say = functools.partial(print, flush=True) if chief else _silent
    # Per-hardware tuning registry (tuning.py): fill every knob the user
    # left at its RAFTConfig default from the tuned winner for (train,
    # device_kind, image_size, per-rank batch).  Resolved HERE (not only
    # inside make_train_step, which re-resolves idempotently) so the
    # telemetry run_config can stamp what actually ran, and the printout
    # tells the operator which knobs moved.
    model_cfg, tuning_info = tuning.resolve_config(
        model_cfg, "train", tuple(cfg.image_size),
        max(cfg.batch_size // world, 1))
    if tuning_info.applied:
        say("tuning registry "
            f"[{tuning_info.key}{'' if tuning_info.exact else ', nearest'}"
            f"]: " + ", ".join(f"{k}={v}" for k, v in
                               sorted(tuning_info.applied.items())))
    state = init_state(model_cfg, cfg, device=dev,
                       state_dict=restore_params)
    say(f"Parameter Count: "
        f"{sum(p.numel() for p in state.model.parameters())}")

    # telemetry first: the checkpoint manager's ckpt_fallback events and
    # the loader's sample_quarantine events land in the same stream as
    # the steps, and a resume's fallback happens before the first step
    telem = TrainTelemetry(telemetry_dir, batch_size=cfg.batch_size,
                           num_devices=world, image_size=cfg.image_size,
                           tuning_stamp=tuning_info.stamp())
    if loader is not None and telem.enabled:
        loader.sink = telem.sink
        loader.registry = telem.registry
    mgr = CheckpointManager(os.path.join(cfg.ckpt_dir, cfg.name),
                            commit_window=max(int(cfg.ckpt_commit_window),
                                              1), mesh=mesh,
                            sink=telem.sink if telem.enabled else None)
    if mgr.restore_latest(state) is not None:
        saved_on = mgr.saved_topology(state.step) or {}
        say(f"resumed from step {state.step}"
            + (f" (saved on {saved_on.get('device_count')} x "
               f"{saved_on.get('device')}, world "
               f"{saved_on.get('world_size', 1)})" if saved_on else ""))

    step_fn = make_train_step(cfg, device=dev, **(
        {} if mesh is None else {"mesh": mesh}))
    step = start = state.step
    if loader is not None:
        batches = loader.batches_from_step(step)
    prep_fn = noise_prep(cfg.seed, step) if cfg.add_noise else None
    if mesh is not None and mesh.spatial > 1:
        noise = prep_fn

        def prep_fn(batch, noise=noise):
            return shard_rows(batch if noise is None else noise(batch),
                              mesh.spatial_index, mesh.spatial)
    # tracing: rate 0 leaves tracer None, one identity check a step
    tracer = None
    if float(cfg.trace_sample_rate or 0.0) > 0:
        tracer = trace.configure(
            sample_rate=float(cfg.trace_sample_rate), seed=cfg.seed,
            sink=telem.sink if telem.enabled else None)
    rank_tag = mesh.rank if multi else None
    if cfg.profile_steps:
        a, b = int(cfg.profile_steps[0]), int(cfg.profile_steps[1])
        pdir = profile_dir or (os.path.join(telem.directory, "profile")
                               if telem.enabled else "profile")
        profiler = StepProfiler(pdir, start_step=a, num_steps=max(b - a, 1),
                                absolute=True, rank=rank_tag)
    else:
        profiler = StepProfiler(profile_dir, rank=rank_tag)
    telem.start(start_step=step, num_steps=cfg.num_steps)
    health = None
    if telem.enabled:
        health = HealthMonitor(
            telem, forensics_dir=os.path.join(telem.directory, "forensics"),
            seed=cfg.seed, keep=max(int(cfg.forensic_keep), 0),
            # one scalar read at startup (a resume carries the count)
            initial_nonfinite=int(state.nonfinite_steps),
            run_meta={"model_cfg": dataclasses.asdict(model_cfg),
                      "train_cfg": dataclasses.asdict(cfg)},
            rank=rank_tag, generator_device=state.generator.device.type)
    keep_host = health is not None and cfg.forensic_keep > 0
    # every rank's logger feeds its own monitor; only rank 0's prints
    logger = Logger(cfg.log_freq, lr_fn=state.schedule,
                    tensorboard_dir=tensorboard_dir if chief else None,
                    log=log if chief else _silent,
                    on_flush=health.observe_flush if health else None)
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
                              keep_host=keep_host,
                              interrupt=None if multi else _PREEMPT.is_set)
    watchdog = None
    if float(cfg.watchdog_timeout or 0.0) > 0:
        watchdog = StallWatchdog(
            float(cfg.watchdog_timeout), sink=telem.sink,
            dump_path=stack_dump_path(telem.directory),
            hard_exit=bool(cfg.watchdog_exit),
            recent_records=telem.recent_records)
        watchdog.start()
    # the step's first call runs eagerly and, on the card, its second
    # captures the graph: both are legitimately slow, and the capture
    # ends the allocator peak that hbm_usage reads
    warm_calls = 2 if getattr(step_fn, "graphs", False) else 1
    hbm_pending = telem.hbm_enabled
    if hbm_pending and dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")

    def record_hbm():
        telem.record_hbm(hbm_usage(dev, args_bytes=state_bytes(state)))

    t0, steps_t0 = time.time(), step
    in_flight = []          # the previous step's completion event
    try:
        while True:
            if watchdog is not None:
                watchdog.beat(step)
            t_iter = time.perf_counter()
            st = (tracer.start_trace("train_step", step=step)
                  if tracer is not None else None)
            try:
                batch = next(pipeline)
            except StopIteration:
                break
            except PipelineInterrupted:
                raise SystemExit(143)
            queue_wait_s = time.perf_counter() - t_iter
            if st is not None:
                trace.record_span(st, "queue_wait", t_iter,
                                  t_iter + queue_wait_s)
                if pipeline.last_stamps is not None:
                    # the producer's stamps, attached on this thread
                    p0, p1, p2 = pipeline.last_stamps
                    trace.record_span(st, "prep", p0, p1)
                    trace.record_span(st, "h2d", p1, p2)
            if step >= cfg.num_steps:
                break
            if keep_host:
                # a reference append, and the dropout generator's state
                # before this step (host memory, no device access)
                health.note_batch(
                    step, pipeline.last_host_batch,
                    state.generator.get_state().numpy().tobytes())
            if chaos.should_inject("preempt", step=step,
                                   point="train.preempt"):
                request_preemption()
            if (mesh.any_host(_PREEMPT.is_set()) if multi
                    else _PREEMPT.is_set()):
                raise SystemExit(143)  # step boundary: state consistent
            profiler.maybe_start(step)
            warming = step - start < warm_calls
            if watchdog is not None and warming:
                watchdog.pause()
            count_cm = contextlib.nullcontext()
            if step == start and telem.cost_enabled:
                count_cm = cost_mod.counting()
            t_d0 = time.perf_counter()
            try:
                with annotate_step(step), count_cm as counted:
                    state, metrics = step_fn(state, batch)
            except BaseException as e:
                if st is not None:
                    trace.record_span(st, "step_dispatch", t_d0,
                                      time.perf_counter(), status="error",
                                      error=type(e).__name__)
                    st.end(status="error", error=type(e).__name__)
                raise
            if st is not None:
                trace.record_span(st, "step_dispatch", t_d0,
                                  time.perf_counter())
            if dev.type == "cuda":
                in_flight.append(torch.cuda.Event())
                in_flight[-1].record()
                if len(in_flight) > 1:
                    # the bounded in-flight wait: at most two steps queued
                    in_flight.pop(0).synchronize()  # raftlint: disable=JIT103
            profiler.maybe_stop(step, sync_on=metrics["loss"])
            step += 1
            if chief or health is not None:
                logger.push(step - 1, metrics)
            step_time_s = time.perf_counter() - t_iter
            if step - 1 == start:
                telem.record_compile(
                    step - 1, step_time_s,
                    key=("train_step", tuple(cfg.image_size),
                         cfg.batch_size))
                if counted is not None:
                    telem.record_cost(step_cost(counted, cfg.batch_size,
                                                world, kind=kind))
            if warming and step - start == warm_calls:
                if hbm_pending:
                    hbm_pending = False
                    record_hbm()
                if watchdog is not None:
                    watchdog.resume()  # the warm-up calls are over
            telem.record_step(step - 1, step_time_s, queue_wait_s,
                              h2d_s=pipeline.last_h2d_s,
                              prep_s=pipeline.last_prep_s)
            if timings is not None:
                timings.append({
                    "step": step - 1, "loss": metrics["loss"],
                    "queue_wait_s": queue_wait_s, "step_s": step_time_s,
                    "prep_s": pipeline.last_prep_s,
                    "h2d_s": pipeline.last_h2d_s})
            if st is not None:
                # the flush point: sampled traces emit now, the rest park
                # in the dropped ring for a late verdict
                st.end(step_time_s=round(step_time_s, 6))
            if not multi and _PREEMPT.is_set():
                raise SystemExit(143)

            if step % cfg.val_freq == 0:
                if watchdog is not None:
                    watchdog.pause()  # save + validate is legitimately slow
                # the step's trace context rides along: the committer's
                # ckpt_commit span lands in its tree (a late child)
                with trace.use_context(st):
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
                if watchdog is not None:
                    watchdog.resume()

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
        if watchdog is not None:
            watchdog.stop()  # first: the teardown below can be slow
        pipeline.close()
        mgr.wait()
        mgr.close()
        profiler.close()
        logger.close()
        if hbm_pending and step > start:
            record_hbm()    # a run shorter than the warm-up calls
        telem.close()
    return state
