#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``raft_tpu_torch``) on one NVIDIA
GPU (written for the H100).

    python3 chip_smoke.py                      # from the repository root
    python3 chip_smoke.py --report out.json    # also write every number

The phases drive the port's entry points as a user does: on the card,
``make_eval_fn`` and ``make_train_step`` (and the CLIs and the loop on
them) run each key as a captured CUDA graph after one eager call, so a
timed window follows an eager call and the capture (``_warm``: the peak
memory that follows covers the capture, the graph's working set).  The
one exception is phase small's test mode, which calls the model itself,
eagerly: no entry point runs the fused-encoder configuration at
inference (``make_inference_model`` maps it to ``allpairs``).  The
entry points set cuDNN TF32 for each call from ``config.CONV_TF32``;
this script turns it off for its checks and timings, except where a
phase names the shipped setting (the CLIs' subprocesses, their in-process
twins, the TF32 measurement of phase graphs).

Phases, each raising on failure (so the script exits nonzero):

1. device: ``nvidia-smi`` name and power limit, ``torch.cuda`` device;
2. build: compile every CUDA source of the port with ``nvcc`` (sm_90a),
   count the tensor-core instructions in ``lookup_encode``'s SASS, and
   check that the radius-3 and radius-4 instantiations of the pyramid
   lookup forward (``pyr_fwd_kernel``) and every instantiation of the
   upsample-loss forward (``ul_fwd_kernel``) have no local-memory
   instruction (``LDL``/``STL``) in theirs;
3. kernels: each kernel's wrapper against its plain PyTorch version on
   the card, with device times of kernel and plain version
   (``torch.profiler``; the run fails where it reports none) beside the
   bound computed from the inputs:
   - inference kernels at the shapes of the Sintel path (440x1024 input,
     55x128 feature grid, C = 256, 4 levels, r = 4) plus a small case
     with an empty pyramid level; the on-demand lookup under three center
     distributions, (a) U(-20, 20) px with 2% far, (b) a smooth flow up to
     20 px with 2% far, (c) U(-1, 1) px, with the share of (tile, level)
     pairs on the kernel's box path;
   - training kernels at the chairs stage (batch 8, 368x496, 46x62
     feature grid, 12 iterations folded into the upsample-loss batch):
     the pyramid lookup forward and backward with fp32 and bf16 storage,
     and the upsample-loss sums (each column on its own scale), dflow
     and dmask with an fp32 and a bf16 mask, plus a one-iteration case
     whose residuals span the 1/3/5 px thresholds (the pixel counts
     equal to the plain version's), and grids that take every access
     width of the upsample-loss forward and backward (an odd 45x63 at
     B = 1, 45x62, 40x64, and the chairs grid with the mask one value
     into its allocation); the row-halo form of the upsample-loss pair
     (``halo=1``, the flow with a row of each neighbouring shard) at
     phase spatial's shard shape (12 iterations x B 4, 23 (+2) x 62),
     fp32 and bf16 mask, timed beside its bound, and the whole image as
     one shard with zero halo rows bit for bit the unsharded kernels;
   - backward kernels of the on-demand configuration at the chairs
     shapes: the GRU gate backward (8, 128, 46, 62) in fp32 and bf16
     (z/r channel halves of one tensor, rh's gradient a channel slice;
     then the reset-gate backward on each access path: an odd 45x63
     grid, 3 channels, r and the gradient's batch stride off 16 bytes),
     the on-demand lookup backward with an NHWC and an NCHW tap
     gradient, and once more at B = 1 with a 136x240 feature grid
     (1088x1920 input), where the JAX package moves level 0 onto its
     blocked backward pair, each under the distributions (a), (b), (c);
   - the kernels of the quantized / fused-encoder slice at the chairs
     shapes: the lookup on int8, e4m3 and e5m2 codes with fp32 and bf16
     taps (plus an empty level), and the fused lookup + convc1 (F = 256)
     on fp32, bf16, int8 and e4m3 levels, forward and backward (dW, db,
     dpyramid), with the unfused pair (lookup kernel + cuDNN 1x1 conv +
     relu) timed beside it and two bounds (3xTF32 on the tensor cores,
     fp32 on CUDA cores), plus F = 40;
   - NaN and infinite centers on grids with an empty level for every
     lookup (on-demand forward and backward, pyramid forward and backward
     in both layouts, quantized, fused encoder): the kernel's NaN entries
     must be the plain version's and the rest within the tolerance;
4. path: ``make_eval_fn`` with the kernel configuration (on-demand
   correlation kernel + fused GRU gates) against the plain configuration
   on the same seeded weights, then the 32-iteration Sintel forward in
   fp32 and bf16 for the default ``allpairs`` and the kernel
   configuration (ms/pair, device busy time, peak memory) with launch
   counts;
5. serve: the serving engine (``raft_tpu_torch.serve``) at the Sintel
   bucket (436x1024 frames of seeded textures moving by (2, 1) px, 440x1024
   bucket), 32 iterations, 8 slots, ``max_batch`` 8: the three kernels of
   its path (the on-demand lookup and both gate forwards) at the slot
   shape (S = 8) against their plain versions, timed beside their bounds;
   ``forward_warp_flow`` twice bit for bit and against the CPU; in fp32
   with TF32 off, for ``allpairs`` and the kernel configuration, request
   mode against ``make_eval_fn`` (rtol 1e-4, atol 1e-3), slot mode with
   staggered arrivals bit for bit request mode, exact launches per
   replay of each program and one capture per ``(bucket, lanes,
   program)``, an injected ``device_err`` mid-iteration retried to the
   same bits, an 8-frame stream at a session budget of 4 iterations (its
   first pair bit for bit a stateless request of that budget; 8 frames,
   7 pairs, 6 warm), the early-exit sweep of the
   offline runner (iterations never above the budget nor rising with the
   threshold; threshold 0 bit for bit request mode), and the kernel
   configuration against the plain one within 1e-3 px at 4 iterations;
   in bf16, request mode's batch of 8 pairs against ``make_eval_fn`` in
   bf16 (rtol and atol 2e-2), a closed loop of 8 clients x 8 requests
   in request mode, slot mode and slot mode with budgets from
   {8, 16, 32} (pairs/s, p50 and p99 ms, batch fill or mean active
   lanes, resident, peak and reserved memory; device busy and idle share
   over a traced loop of 8 x 2 requests), a stream's cold and warm frame
   ms, and the copy kernels of one ``iter`` replay under ``allpairs``;
   for the kernel configuration's slot mode, the same closed loop with
   every request traced at rate 1 into a JSONL sink (pairs/s against the
   untraced loop, one tree a request, an ``iter_step`` an iteration with
   the cost book's MFU, its median in (0, 1)), the engine's MFU signal,
   and ``POST /debug/profile?seconds=1`` to an HTTP front end over the
   engine under 8 clients (the Chrome trace, under the sink's directory,
   must hold ``corr_ondemand_kernel``, ``rh_kernel`` and
   ``blend_kernel``);
   request mode's memory over the Sintel, KITTI and FlyingChairs buckets
   (``allpairs``, bf16, batch sizes 1/2/4/8: the serve CLI's defaults),
   with the default budget and with a budget of one bucket's memory
   (evictions, every bucket answered); then
   ``python -m raft_tpu_torch serve --random-init`` in a subprocess:
   flows bit for bit the in-process engine's, a stream session,
   ``/metrics`` and ``/v1/healthz``, a flood past ``--max-queue``
   answered by structured 429s, SIGINT ending it with its stats line;
   with ``--trace-sample-rate 1 --telemetry-dir``: one ``serve_http``
   tree a served request (``queue``, ``pad``, 32 ``iter_step`` with an
   MFU in (0, 1), ``device``), a 429 a root of status ``full``, and a
   request carrying an upstream ``X-Raft-Trace`` continued under the
   caller's span, the reply carrying its id;
6. fleet: the self-healing fleet (``ReplicaFleet`` + ``FlowRouter``) of
   the kernel configuration at the Sintel bucket, 32 iterations, two
   replicas sharing the card.  In fp32 with TF32 off, one pair a batch:
   replica 0 captures and writes the warm-start manifest, replica 1
   replays it (start time, what each engine holds, the reserved memory)
   and neither captures on its first request; the router's flows bit
   for bit a single engine's, with the launches of its path counted; a
   rolling update to seed-1 weights from a port checkpoint while 4
   clients loop through a least-loaded router until it returns (each
   replica's flip finds requests in flight on its old engine, requests
   span each flip, none fails or fails over; flows bit for bit a fresh
   engine's; the update's seconds and peak reserved memory), a torn copy
   refused at verify, NaN
   weights at the canary and weights x25 at the proxy gate (its score
   ratio); the fabric: a loopback server in this process fronting a
   second engine, its flows bit for bit over the wire, the ms a pair the
   wire adds, ``net_partition`` with ``heal=`` under load (no drop, the
   remote rejoins), then one request traced at rate 1 through the
   router to the remote: one tree (``route``, ``attempt`` on the remote,
   the server's ``serve_http`` under it through the ``X-Raft-Trace``
   header, the server engine's spans under that).  In bf16 at batch
   sizes 1 and 8, the fleet's incident manager on: ``replica_kill``
   under a closed loop of 8 clients twice (no drop, a generation bump,
   the restart seconds, no capture on the restarted engine's first
   request; the two kills' cascade ONE incident), a ``replica_hang``
   wedge (only the wedged replica restarts;
   detection time, the sibling's p99 meanwhile), reserved memory after
   these three restarts within 10%, ``replica_slow`` with a hedge (one
   hedge, which wins) and without (none), and the router's pairs/s and
   p50 / p99 over 8 x 16 requests against one engine, with the batches
   each loop ran (count, fill, ms); in slot mode, one autoscaler grow
   from 1 to 2 under load (the new replica capturing nothing on its
   request path) and one scale-down after idle migrating an open
   session (the fleet's CLI is phase clis');
7. graphs: the same entry points eagerly (``graphs=False``) against their
   captured graphs: the 32-iteration Sintel forward (440x1024, B = 1) in
   ``allpairs`` and the kernel configuration, fp32 and bf16, and the
   small model's bf16 forward (on-demand configuration): outputs bit for
   bit, one capture over every call, eager launch counts per replay; the
   chairs step (B = 8, 12 iterations) of the shipped ``allpairs_pallas``
   and the on-demand configuration, fp32 and bf16, over 3 steps from the
   same weights: losses and parameters within phase train's bounds, one
   capture, eager launch counts; each with ms/pair or ms/step, device busy
   and idle share and peak memory; a NaN batch through the shipped bf16
   graph under ``torch.cuda.set_sync_debug_mode("error")`` leaves the
   state bit for bit and counts 1; ``validate_sintel`` on a synthetic tree
   eager and graphed (EPE within 1e-4 px, ms/pair); cuDNN TF32 on against
   off for the fp32 Sintel forward and chairs step (ms, the flow and
   metric differences);
8. demo: the demo CLI on ``demo-frames`` with ``--alternate_corr``;
9. eval: the evaluation path on synthetic dataset trees written with the
   port's writers (Sintel: two scenes of 3 and 5 frames at 436x1024,
   clean and final; KITTI: a pair at each of four real resolutions, one
   376x1248 bucket, sparse ground truth; FlyingChairs: 4 pairs at
   384x512), every sequence a seeded texture under a constant shift:
   ``validate_sintel`` and ``validate_kitti`` under the kernel
   configuration against the plain one (fp32: every flow within 1e-3 px
   at 4 iterations, the EPE within 1e-2 px at 32 / 24), with exact
   launch counts for every batch; the evaluate CLI for each dataset in a
   subprocess against the same validator in this process (the printed
   EPE within 1.5e-3; the Sintel one with ``--telemetry_dir``: one
   counted ``cost_report`` of its one forward shape, a
   ``raft_eval_forward`` span a batch, the ``eval`` records of the
   printed EPEs); the Sintel submission with a warm start at batch 2
   against batch 1 (every ``.flo`` within 1e-3 px) and the KITTI
   submission read back at each image's shape; ``validate_sintel``
   ms/pair (kernel configuration bf16 and fp32, ``allpairs`` bf16), its
   host share and where the host's part goes, host ms of a PNG decode,
   a KITTI ground truth (as written, and every row Paeth-filtered) and a
   ``forward_interpolate``, and the peak memory of ``validate_kitti`` at
   batch 4 in bf16;
10. train: ``make_train_step`` with each kernel configuration against
   its plain one from the same seeded weights on one synthetic
   FlyingChairs-shaped batch, TF32 off, in fp32 and bf16 (loss, metrics,
   every parameter's unclipped gradient): ``allpairs_pallas`` +
   ``upsample_loss_kernel='pallas'`` against ``allpairs`` + ``'xla'``;
   the on-demand configuration (``corr_impl='pallas'`` + ``fused_gru`` +
   ``'pallas'``) against ``chunked`` + unfused gates + ``'xla'``; and
   ``allpairs_pallas`` + ``fused_lookup_encoder`` + ``'pallas'`` with
   ``corr_dtype`` int8 and auto against ``allpairs`` + the same
   ``corr_dtype`` + ``'xla'`` (under int8 ``fnet``'s gradient is exactly
   zero on both sides).  Then the chairs stage (368x496, batch 8, 12
   iterations, lr 2.5e-4) for every configuration in fp32 and bf16:
   warm-up steps, 10 timed steps for the two fused-encoder
   configurations, 5 for the three of the earlier slices and 3 for the
   unfused int8 one (ms/step, pairs/s, peak memory, device busy time,
   idle share, and device time per launch inside the step of the pyramid
   lookup, upsample-loss forward and backward and reset-gate backward
   kernels) with exact launch counts per step; then the peak memory
   of a bf16 step at the things stage (400x720, batch 5, 12 iterations)
   for the on-demand, the ``allpairs_pallas`` and the int8 + fused
   configurations;
11. train_cli: the training entry point on a synthetic FlyingChairs tree
   (24 training and 4 validation ``.ppm`` pairs at 384x512 with ``.flo``
   files and a split file): the native host library must load on this
   host (its build time, and whether cv2 is importable); the loader alone
   (``ShardedLoader(fetch_dataset('chairs', (368, 496)), 8)``) at 1 worker
   and at the CLI's default, samples/s and one sample's decode / augment
   / stack; ``python -m raft_tpu_torch train`` in a subprocess (bf16,
   ``--corr_impl auto``, 8 steps, a checkpoint every 2) stopped by SIGTERM
   after its second checkpoint (exit 143, the step saved), ``verify-ckpt
   --json`` on the run directory, its newest step torn with
   ``chaos.tear_files`` and flagged, the rerun falling back past it and
   finishing with every observability flag (``--telemetry_dir``,
   ``--trace_sample_rate 1``, ``--watchdog_timeout 120``,
   ``--profile_steps 7:8``, ``--forensic_keep 8``; its JSONL checked:
   the JAX loop's events, the allocator's peak, the counted cost and its
   MFU, the health record, the checkpoint events, a span tree a step,
   the profiler's Chrome trace, no stall), and ``evaluate --model <run
   dir>``; the CLI's configuration
   in this process with exact launch counts; the resume check in process
   (fp32, TF32 off, the shipped kernel configuration, device prefetch 2:
   4 steps against 2, a preemption and 2 more; the host batch stream
   bit-equal, the saved state restored bit for bit, final loss and
   parameters within the stated tolerance); one checkpoint's snapshot and
   commit time; and the bf16 shipped configuration on the real loader at
   ``device_prefetch`` 0 and 2 (ms/step, pairs/s, queue wait, prep and
   copy times, idle share, exact launch counts) beside phase train's
   reused batch, and the prefetch-2 arm again with telemetry, health,
   tracing at rate 1 and the watchdog on (ms/step and its spread beside
   the off arm's; the stream's peak memory, FLOPs a pair and MFU);
12. ddp: data-parallel training (``raft_tpu_torch/parallel``), on phase
   train_cli's tree: (a) world 1 over NCCL (the torchrun variables set
   in this process), the chairs stage (B 8, 12 iterations, bf16, the
   train CLI's defaults) through ``make_train_step(..., mesh=...)``
   captured against the plain captured step, 3 steps from the same
   weights with cuDNN deterministic: parameters, statistics and losses
   bit for bit, one capture each, the gradient all-reduce called while
   the stream was capturing, 12 + 12 lookups a step; then ms/step of
   the two with their timed replays alternating, device busy and idle;
   (b) two gloo ranks sharing the card (``chip_smoke.py --ddp-rank``
   children, B 4 each, the kernel configuration with the fused gates,
   eager, 2 steps) against the straight eager B 8 run: the ranks bit
   for bit, the parameter change within the norm bound of phase graphs
   widened by the straight run's own difference with its rows reversed
   (the doubled change must fail it), losses within the bf16 bound,
   every kernel of the configuration counted on each rank, eager ms per
   step and the gloo all-reduce of the step's buffer (a host round
   trip, not NCCL); (c) ``python -m raft_tpu_torch train --distributed``
   with the variables of one rank: 2 steps, exit 0, a checkpoint
   stamped world 1;
13. spatial: each image's rows split over two gloo ranks sharing the
   card (``chip_smoke.py --spatial-rank`` children, ``data 1 x spatial
   2``), the chairs stage (368x496, global B 4, 12 iterations, bf16,
   eager, 2 steps) in three arms: the kernel configuration
   (``allpairs_pallas``, the upsample-loss kernels, fused gates),
   ``allpairs`` with the upsample-loss kernels, and the on-demand kernels
   with fused gates; each against the straight eager B 4 run (the ranks
   bit for bit, the first moment after step 1 and each parameter's
   change within phase ddp's bound widened by the straight kernel run's
   spread under reversed rows, instance norm's sums over the row shards
   and cuDNN off, the doubled change rejected, losses within the
   bf16 bound), each kernel of the arm counted on each rank (the
   lookups 12 + 12 a step, the upsample-loss pair once a step, each
   call with ``halo=1``), each rank's peak memory against the straight
   run's, and the spatial collectives' share of the kernel arm's last
   step on rank 0 under the profiler;
14. small: the small model at full width (hidden 96, context 64, radius
   3, C = 128): each kernel of its paths at its shapes against the plain
   version, timed beside its bound (run as phase small_kernels right
   after phase kernels, early in the process; the on-demand forward at the Sintel
   grid and backward at chairs under (a), (b), (c); the pyramid forward
   and backward at radius 3 in fp32 and bf16; the quantized forward; the
   fused lookup + convc1 with F = 96 from K = 196 taps, fp32, bf16 and
   int8, beside the unfused pair; the four gate kernels on 96-channel
   halves, with the reset-gate backward's access path); the test-mode
   forward at 440x1024 in the on-demand (+ fused gates) and the
   fused-encoder configurations against the plain one within 1e-3 px at
   4 iterations, then 32 iterations in fp32 and bf16 (ms/pair, device
   busy and idle share, peak memory) with exact launch counts and none
   of the upsample-loss kernel; the chairs train step of
   ``allpairs_pallas`` (fp32, bf16) and of the on-demand configuration
   (fp32) against their plain ones (phase train's bounds), then timed
   with exact launch counts (ms/step, pairs/s, peak memory); the remat
   sweep: the full model's shipped kernel configuration in bf16 at the
   chairs and things stages under ``none``, ``save_corr``, ``full``,
   ``dots`` and ``save_corr`` + ``remat_upsample`` (peak memory, ms/step,
   launch counts a step), and each policy's fp32 gradients against
   ``none``;
15. clis: subprocesses that are checked, not timed, side by side, on a
   thread while phase train_cli's train CLI subprocesses run (nothing
   is timed or counted in this process meanwhile):
   ``python -m raft_tpu_torch curriculum`` on two small stages, killed
   between them by ``stage_kill`` (exit 143) and resumed;
   ``lk-compare --small`` on the demo frames; and ``python -m
   raft_tpu_torch serve --random-init --replicas 2`` at the Sintel
   bucket (two flows, ``/metrics`` of both replicas, SIGINT); and
   ``python -m raft_tpu_torch cost`` at the chairs shapes (its table
   printed; the four programs counted and classified against the
   card's peaks);
16. report: one JSON line ``{"kernels": [...]}`` (each kernel with its
   small-model launches and, where phase small timed it, its times
   there, and its launches per serving ``iter`` replay with, where phase
   serve timed it, its times at the slot shape, its launches through
   the fleet's router, its launches in phase ddp's world-1 step and
   on each of its two ranks, its launches on each of phase spatial's two
   ranks per arm, and for the upsample-loss pair the halo form's
   times), the nvidia-smi line,
   and last ``{"ok": true, "device": {...}}``.

It imports nothing of JAX.  Without CUDA it exits nonzero before any
result.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import glob
import hashlib
import json
import os
import re
import signal
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, "build", "chip_smoke")

SINTEL_HW = (436, 1024)          # a Sintel frame; pads to 440 x 1024
R, LEVELS, C = 4, 4, 256
CHAIRS_HW, CHAIRS_B, CHAIRS_ITERS = (368, 496), 8, 12


def _peaks(name: str):
    """(bytes/s, fp32 FLOP/s, dense TF32 tensor-core FLOP/s) of the card:
    NVIDIA's data-sheet figures (SXM unless the name says PCIe)."""
    if "PCIe" in name:
        return 2.0e12, 51e12, 378e12
    return 3.35e12, 67e12, 495e12


def _time_ms(fn, reps: int = 30, warmup: int = 3) -> float:
    """Median CUDA-event time of one call, after a warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _device_ms(fn, reps: int = 20, match: str = None):
    """Device time per call from ``torch.profiler`` (CUDA activity only):
    the summed time of the kernels whose name contains ``match`` (a string
    or a tuple of them, each launched once a call: the sum of their mean
    times per launch, so a launch the trace lost does not count as zero),
    or of every kernel the call runs.  None when the profiler reports no
    device time.  The launches sit 10 ms of idle card inside each end of
    the traced window: the trace was seen to drop more of them the older
    the process (1 of 20 in the first minute, all after ~400 s; the cause
    is not known), and the margin keeps them inside should the device's
    and the host's clocks drift apart."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(0.01)
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        time.sleep(0.01)
    total_us = 0.0
    names = (match,) if isinstance(match, str) else match
    for e in prof.key_averages():
        if names is None or any(n in e.key for n in names):
            t = (getattr(e, "device_time_total", None)
                 or getattr(e, "cuda_time_total", 0.0))
            if names is not None and e.count and t > 0:
                if e.count != reps:
                    print(f"[profile] {e.key[:60]}: {e.count} of {reps} "
                          "launches traced", flush=True)
                t = t / e.count * reps
            total_us += t
    return total_us / reps / 1e3 if total_us > 0 else None


def _profile(fn, reps: int = 2, warm: bool = True) -> dict:
    """Device activity of ``reps`` calls from ``torch.profiler`` (CUDA
    activity only), after one untraced call when ``warm``: ``busy_ms`` per call is the union of the device
    intervals (kernels, copies and sets never counted twice), ``wall_ms``
    per call the host clock over the same window, ``idle_share`` the
    rest, and ``by_kind`` the summed kernel time per call by kind (each
    of the port's kernels, cuDNN/cuBLAS convolutions and matrix
    products, everything else).  Busy is None when the profiler reports
    no device time."""
    from torch.profiler import ProfilerActivity, profile

    if warm:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / reps
    spans, kinds = [], {}
    for e in prof.events():
        tr = e.time_range
        if getattr(e.device_type, "name", "") != "CUDA" or tr.end <= tr.start:
            continue
        spans.append((tr.start, tr.end))
        name = e.name
        if (any(t in name for t in ("pyr_", "corr_ondemand", "rh_",
                                    "blend_", "lookup_encode"))
                or "ul_" in name[:12]):
            kind = name.split("<")[0].split("(")[0].replace("void ", "")
        elif any(t in name.lower() for t in ("conv", "gemm", "cudnn", "xmma",
                                              "cutlass", "sm90_", "wgrad",
                                              "dgrad")):
            kind = "conv_gemm"
        else:
            kind = "other"
        kinds[kind] = kinds.get(kind, 0.0) + (tr.end - tr.start)
    busy, end = 0.0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    if not spans:
        return {"busy_ms": None, "wall_ms": wall, "idle_share": None,
                "by_kind": {}}
    busy_ms = busy / reps / 1e3
    return {"busy_ms": busy_ms, "wall_ms": wall,
            "idle_share": max(0.0, 1.0 - busy_ms / wall),
            "by_kind": {k: v / reps / 1e3 for k, v in sorted(kinds.items())}}


def _timed(fn, match, reps: int = 30) -> dict:
    """The profiler's device time of one call's kernels (``ms``) beside
    its CUDA-event time (host launch gaps included); raises when three
    traces report no device time, so that no event time stands in for a
    kernel's."""
    event_ms = _time_ms(fn, reps=reps)
    for _ in range(3):
        # a trace that lost every launch (seen once, for the plain gate
        # forward: a few microseconds of work) is traced again
        dev_ms = _device_ms(fn, match=match)
        if dev_ms is not None:
            break
        print(f"[profile] no device time for {match or 'a plain version'}"
              "; tracing again", flush=True)
    if dev_ms is None:
        raise AssertionError(f"the profiler reported no device time for "
                             f"{match or 'a plain version'}")
    return {"ms": dev_ms, "event_ms": event_ms, "device_ms": dev_ms}


def _bound_ms(nbytes: float, ops: float, peaks) -> tuple:
    t_bytes = nbytes / peaks[0] * 1e3
    t_ops = ops / peaks[1] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations")


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    print(f"[device] nvidia-smi: {smi}")
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {name} count {torch.cuda.device_count()}", flush=True)
    return smi, name


def _sass_counts(build, name: str, pattern: str) -> dict:
    """{kernel function (mangled name): number of SASS instructions
    matching ``pattern``} in the library of source ``name``, every kernel
    listed (``cuobjdump -sass``, next to ``nvcc``)."""
    cuobjdump = os.path.join(os.path.dirname(build.find_nvcc()), "cuobjdump")
    sass = subprocess.run(
        [cuobjdump, "-sass", str(build.library_path(name))],
        capture_output=True, text=True, check=True, timeout=300).stdout
    per_fn, fn = {}, None
    for ln in sass.splitlines():
        if "Function :" in ln:
            fn = ln.split("Function :")[1].strip()
            per_fn[fn] = 0
        elif fn and re.search(pattern, ln):
            per_fn[fn] += 1
    return per_fn


def phase_build():
    """Compile every source; then count the tensor-core instructions
    (HMMA / GMMA) in the SASS of the fused lookup + convc1 library, which
    must run its contraction on the tensor cores, and the local-memory
    instructions (LDL / STL) of the pyramid lookup forward's radius-3 and
    radius-4 instantiations and of every upsample-loss forward
    instantiation, which must have none."""
    from raft_tpu_torch.ops import build

    t0 = time.perf_counter()
    reports = build.build()
    secs = time.perf_counter() - t0
    for src, log in reports.items():
        lines = [ln for ln in log.splitlines() if "ptxas info" in ln]
        print(f"[build] {src}: " + " | ".join(lines[-6:]))
    print(f"[build] {len(reports)} sources compiled in {secs:.2f} s",
          flush=True)
    per_fn = {f: n for f, n in _sass_counts(
        build, "lookup_encode", r"HMMA|GMMA").items() if n}
    mma = sum(per_fn.values())
    print(f"[build] lookup_encode SASS: {mma} HMMA/GMMA instructions in "
          f"{len(per_fn)} kernels ({sorted(set(per_fn.values()))} each)",
          flush=True)
    if not mma:
        raise AssertionError("lookup_encode: no tensor-core instruction in "
                             "its SASS")
    # pyr_fwd_kernel<T, To, RADIUS>: the radius is the last template
    # argument of the mangled name (Li4E, Li3E; Lin1E for the runtime one)
    local = {}
    for f, n in _sass_counts(build, "pyramid_lookup",
                             r"\b(LDL|STL)\b").items():
        m = re.search(r"pyr_fwd_kernelI.*?Li(n?\d+)EE", f)
        if m:
            local.setdefault(m.group(1), []).append(n)
    print(f"[build] pyramid_lookup SASS: LDL/STL per pyr_fwd_kernel "
          f"instantiation by radius {local}", flush=True)
    for radius in ("3", "4"):
        if len(local.get(radius, [])) != 10 or any(local[radius]):
            raise AssertionError(f"pyr_fwd_kernel radius {radius}: "
                                 f"{local.get(radius)} local-memory "
                                 "instructions (10 instantiations, none "
                                 "expected)")
    # ul_fwd_kernel<T, VB>: fp32 at 16, 8 and 4 bytes, bf16 at 16, 8, 4, 2
    ul_local = {f: n for f, n in _sass_counts(
        build, "upsample_loss", r"\b(LDL|STL)\b").items()
        if "ul_fwd_kernel" in f}
    print(f"[build] upsample_loss SASS: LDL/STL per ul_fwd_kernel "
          f"instantiation {sorted(ul_local.values())}", flush=True)
    if len(ul_local) != 7 or any(ul_local.values()):
        raise AssertionError(f"ul_fwd_kernel: {ul_local} local-memory "
                             "instructions (7 instantiations, none "
                             "expected)")
    return dict(build_s=secs, lookup_encode_sass_mma=mma,
                lookup_encode_sass_kernels=len(per_fn),
                pyr_fwd_sass_local=local, ul_fwd_sass_local=ul_local)


# center distributions of the on-demand kernel cases: (a) is the
# correctness case of earlier slices, (b) and (c) are
# corr_kernels.sample_centers' "smooth" and "near"
CENTERS = {"a": "U(-20, 20) px, 2% far", "b": "smooth flow up to 20 px, "
           "2% far", "c": "U(-1, 1) px"}


def _corr_inputs(rng, B, h, w, dev, dist="a", c=C):
    from raft_tpu_torch.ops.corr_kernels import sample_centers

    f1 = torch.from_numpy(rng.standard_normal((B, h, w, c))
                          .astype(np.float32)).to(dev)
    f2 = torch.from_numpy(rng.standard_normal((B, h, w, c))
                          .astype(np.float32)).to(dev)
    if dist != "a":
        kind = {"b": "smooth", "c": "near"}[dist]
        coords = sample_centers(kind, B, h, w, int(rng.integers(1 << 30)))
        return f1, f2, torch.from_numpy(coords).to(dev)
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    grid = np.stack([xs, ys], -1).astype(np.float32)[None]
    coords = grid + rng.uniform(-20, 20, (B, h, w, 2)).astype(np.float32)
    far = rng.random((B, h, w)) < 0.02           # some far off the image
    coords[far] = rng.choice([-1e3, -45.0, w + 45.0, 1e4], (far.sum(), 2))
    return f1, f2, torch.from_numpy(coords).to(dev)


def _box_share(counts) -> float:
    """Share of the (tile, level) pairs with a window in the level that
    took the kernel's box path."""
    box, per_query = counts
    return box / max(box + per_query, 1)


def _corr_ops(coords: np.ndarray, shapes, k: int, channels: int = C
              ) -> float:
    """fp32 operations this run's centers need: a C-long dot product (2C)
    for every in-level integer position of each bilinear window, plus
    4 multiplies and 3 adds per tap."""
    ops = 0.0
    n = coords.shape[0] * coords.shape[1] * coords.shape[2]
    for lvl, (hl, wl) in enumerate(shapes):
        c = coords.reshape(-1, 2) / 2.0 ** lvl
        cnt = []
        for axis, size in ((0, wl), (1, hl)):
            lo = np.floor(c[:, axis]) - (k - 1) // 2
            pos = lo[:, None] + np.arange(k + 1)[None]
            cnt.append(((pos >= 0) & (pos < size)).sum(1))
        ops += float((cnt[0] * cnt[1]).sum()) * 2 * channels + n * k * k * 7
    return ops


def phase_kernels(peaks):
    from raft_tpu_torch.ops.corr import chunked_corr_lookup, pool_fmap_pyramid
    from raft_tpu_torch.ops.corr_kernels import (_plain,
                                                 corr_lookup_ondemand,
                                                 corr_lookup_ondemand_nchw,
                                                 kernel_path_counts)

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    results = {}
    k = 2 * R + 1
    with torch.inference_mode():
        # --- on-demand correlation: Sintel shape under the center
        # distributions (a), (b), (c), then an empty level with two NaN
        # centers (NaN taps on the non-empty levels) ---
        h8, w8 = 440 // 8, SINTEL_HW[1] // 8
        for label, (B, h, w), dist in (
                ("sintel", (1, h8, w8), "a"), ("sintel_b", (1, h8, w8), "b"),
                ("sintel_c", (1, h8, w8), "c"),
                ("empty_level", (2, 6, 8), "a")):
            f1, f2, coords = _corr_inputs(rng, B, h, w, dev, dist)
            if label == "empty_level":
                coords[1, 1, 1] = float("nan")
                coords[0, 2, 3, 0] = float("nan")
            pyr = pool_fmap_pyramid(f2, LEVELS)
            got = corr_lookup_ondemand(f1, pyr, coords, R)
            got_nchw = corr_lookup_ondemand_nchw(f1, pyr, coords, R)
            want = _plain(f1, pyr, coords, R)
            torch.cuda.synchronize()
            err = _check(f"corr_ondemand {label} ({dist}: {CENTERS[dist]}) "
                         f"{tuple(f1.shape)} levels "
                         f"{[tuple(p.shape[1:3]) for p in pyr]}", got, want)
            paths = kernel_path_counts(f1, pyr, coords, R)["fwd"]
            print(f"[kernels] corr_ondemand {label}: (tile, level) pairs box "
                  f"/ per-query {paths}, box share {_box_share(paths):.3f}",
                  flush=True)
            if not _same(got_nchw, got.permute(0, 3, 1, 2)):
                raise AssertionError("corr_ondemand: NCHW != NHWC taps")
            if label == "empty_level" and (
                    got[..., 3 * k * k:].abs().max()
                    or int(got.isnan().sum()) != 2 * 3 * k * k):
                raise AssertionError("corr_ondemand: empty level not zero, "
                                     "or NaN taps off the NaN centers")
            if dist == "c" and not _box_share(paths) > 0.9:
                raise AssertionError(f"corr_ondemand {label}: box share "
                                     f"{paths} under near-grid centers")
            if label == "sintel" and not paths[1] > 0:
                raise AssertionError("corr_ondemand: the per-query path "
                                     f"was not exercised: {paths}")
            if label.startswith("sintel"):
                tk = _timed(lambda: corr_lookup_ondemand_nchw(
                    f1, pyr, coords, R), "corr_ondemand_kernel")
                tp = (_timed(lambda: chunked_corr_lookup(
                    f1, pyr, coords, R), None, reps=20) if dist == "a"
                    else {"ms": None})
                ms, plain_ms = tk["ms"], tp["ms"]
                nbytes = 4 * (f1.numel() + coords.numel() + want.numel()
                              + sum(p.numel() for p in pyr))
                shapes = [tuple(p.shape[1:3]) for p in pyr]
                ops = _corr_ops(coords.cpu().numpy(), shapes, k)
                bound, by = _bound_ms(nbytes, ops, peaks)
                results[f"corr_ondemand/{dist}"] = dict(
                    max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    bound_ms=bound, bound_by=by, bytes=nbytes, ops=ops,
                    paths=paths, box_share=_box_share(paths),
                    kernel_timing=tk, plain_timing=tp)
                print(f"[kernels] corr_ondemand {label}: kernel {tk}, plain "
                      f"{tp}, bound {bound:.4f} ms ({by}; "
                      f"{nbytes / 1e6:.1f} MB, {ops / 1e9:.3f} GFLOP)",
                      flush=True)
        results["corr_ondemand"] = results["corr_ondemand/a"]

        # --- GRU gates: (1|2, 128, 55, 128), fp32 and bf16, split views;
        # batch 2 checks the batch strides, batch 1 is timed ---
        for B in (1, 2):
            for dtype in (torch.float32, torch.bfloat16):
                dt = "fp32" if dtype == torch.float32 else "bf16"
                for name, rec in _gate_fwd_case(
                        rng, B, 128, h8, w8, dtype, peaks, "[kernels]",
                        time_it=B == 1).items():
                    results[f"{name}/B{B}/{dt}"] = rec
                    if B == 1 and dtype == torch.float32:
                        results[name] = rec
    return results


def _record(results, key, err, tk, tp, nbytes, ops, peaks, tag="[small]",
            **extra):
    bound, by = _bound_ms(nbytes, ops, peaks)
    results[key] = dict(max_abs_err=err, ms=tk["ms"], plain_ms=tp["ms"],
                        library_ms=None, bound_ms=bound, bound_by=by,
                        bytes=nbytes, ops=ops, kernel_timing=tk,
                        plain_timing=tp, **extra)
    print(f"{tag} {key}: kernel {tk['ms']} ms, plain {tp['ms']} ms, bound "
          f"{bound:.4f} ms ({by}; {nbytes / 1e6:.2f} MB, {ops / 1e9:.4f} "
          f"GFLOP), max|err| {err:.3e}", flush=True)


def _gate_fwd_check(name: str, got, want) -> float:
    """max |got - want| of a forward gate; raises unless within 1e-6 in
    fp32, or in bf16 within one bf16 ulp of the plain value plus 1e-6
    (where (1-s)h and s*tanh(q) cancel, an fp32 difference of 1e-7 is
    several ulps of the tiny result)."""
    err = float((got.float() - want.float()).abs().max())
    if got.dtype == torch.float32:
        ok, tol = err <= 1e-6, "1e-6"
    else:
        ok, tol = _bf16_close(got, want, 1e-6), "1 bf16 ulp + 1e-6"
    print(f"{name}: max|err| {err:.3e} ({tol})", flush=True)
    if got.dtype != want.dtype or not ok:
        raise AssertionError(f"{name}: {got.dtype} against {want.dtype}, "
                             f"max|err| {err}")
    return err


def _gate_vec(kernel: str, ins, outs) -> int:
    """Values per access that ``gate_plan`` picks for ``kernel`` on
    these inputs and outputs (``ins``: views as the wrapper reads them)."""
    from raft_tpu_torch.ops import gru_gates

    strides = [gru_gates._batch_strided(t)[1] for t in ins]
    vec, _ = gru_gates.gate_plan(
        kernel, [t.data_ptr() for t in (*ins, *outs)], strides,
        ins[0][0].numel(), ins[0].shape[0], ins[0].element_size(),
        torch.cuda.get_device_properties(0).multi_processor_count)
    return vec


def _gate_fwd_case(rng, B, ch, h, w, dtype, peaks, tag: str,
                   time_it: bool = True) -> dict:
    """``gru_gate_rh`` and ``gru_gate_blend`` on the z/r halves of one
    (B, 2 ch, h, w) conv output (split views) against their plain
    versions (``_gate_fwd_check``), each on the 16-byte path of
    ``gate_plan`` (raises otherwise: these are the model's shapes); timed
    beside the bound when ``time_it``.  {name: record}"""
    from raft_tpu_torch.ops.gru_gates import (gru_gate_blend,
                                              gru_gate_blend_plain,
                                              gru_gate_rh, gru_gate_rh_plain)

    dev = torch.device("cuda")
    dt = "fp32" if dtype == torch.float32 else "bf16"
    zr, q, hh = (torch.from_numpy(
        rng.standard_normal((B, c, h, w)).astype(np.float32) * scale).to(
        dev, dtype) for c, scale in ((2 * ch, 3.0), (ch, 3.0), (ch, 1.0)))
    z, r = torch.split(zr, ch, dim=1)               # split views
    out = {}
    for name, kern, plain, ins, flops, kname in (
            ("gru_gate_rh", lambda: gru_gate_rh(r, hh),
             lambda: gru_gate_rh_plain(r, hh), (r, hh), 4, "rh_kernel"),
            ("gru_gate_blend", lambda: gru_gate_blend(z, q, hh),
             lambda: gru_gate_blend_plain(z, q, hh), (z, q, hh), 8,
             "blend_kernel")):
        with torch.no_grad():
            got, want = kern(), plain()
            torch.cuda.synchronize()
            vec = _gate_vec(name, ins, (got,))
            err = _gate_fwd_check(
                f"{tag} {name} {dt} {tuple(got.shape)} ({vec} values per "
                "access)", got, want)
            if vec * got.element_size() != 16:
                raise AssertionError(f"{name} {dt} {tuple(got.shape)}: "
                                     f"{vec} values per access, not 16 "
                                     "bytes")
            tk, tp = ((_timed(kern, kname), _timed(plain, None)) if time_it
                      else ({"ms": None}, {"ms": None}))
        n = got.numel()
        _record(out, name, err, tk, tp, (len(ins) + 1) * n
                * got.element_size(), flops * n, peaks,
                tag=f"{tag} {dt} {tuple(got.shape)}", vector_bytes=16)
    return out


def _gate_bwd_case(rng, B, ch, x_ch, h, w, dtype, peaks, tag: str) -> dict:
    """The backward kernels of ``gru_gate_rh`` and ``gru_gate_blend`` on
    the z/r halves of one (B, 2 ch, h, w) conv output, rh's gradient a
    channel slice of the gradient of cat([rh, x]) (x: ``x_ch`` channels),
    against their plain versions (``_check``), timed beside the bound; the
    reset-gate backward's record carries its access width
    (``vector_bytes``).  {name: record}"""
    from raft_tpu_torch.ops import gru_gates

    dev = torch.device("cuda")
    dt = "fp32" if dtype == torch.float32 else "bf16"

    def mk(c, scale=1.0):
        return (torch.from_numpy(rng.standard_normal((B, c, h, w))
                                 .astype(np.float32)) * scale).to(dev, dtype)

    zr, q, hh = mk(2 * ch, 3.0), mk(ch, 3.0), mk(ch)
    g_cat, g_bl = mk(ch + x_ch), mk(ch)
    g_rh = g_cat[:, :ch]
    for t in (zr, q, hh):
        t.requires_grad_(True)
    z, r = torch.split(zr, ch, dim=1)           # views that carry grad
    n, es = hh.numel(), hh.element_size()
    vec = _gate_vec("gru_gate_rh_bwd", (r, hh, g_rh), ())
    print(f"{tag} gru_gate_rh_bwd {dt} {(B, ch, h, w)}: gate_plan {vec} "
          f"values ({vec * es} bytes) per access", flush=True)
    rh, bl = gru_gates.gru_gate_rh(r, hh), gru_gates.gru_gate_blend(z, q, hh)
    out = {}
    for name, o, leaves, gg, pick, plain, n_io, flops, kname, extra in (
            ("gru_gate_rh_bwd", rh, (zr, hh), g_rh,
             lambda d: [d[0][:, ch:], d[1]],
             lambda: gru_gates.gru_gate_rh_bwd_plain(r, hh, g_rh), 5, 9,
             "rh_bwd_kernel", {"vector_bytes": vec * es}),
            ("gru_gate_blend_bwd", bl, (zr, q, hh), g_bl,
             lambda d: [d[0][:, :ch], d[1], d[2]],
             lambda: gru_gates.gru_gate_blend_bwd_plain(z, q, hh, g_bl), 7,
             19, "blend_bwd_kernel", {})):
        got = pick(torch.autograd.grad(o, leaves, gg, retain_graph=True))
        err = max(_check(f"{tag} {name} {dt} {'d' + v} {tuple(a.shape)}",
                         a, b)
                  for v, a, b in zip("zqh" if len(got) == 3 else "rh", got,
                                     plain()))
        tk = _timed(lambda: torch.autograd.grad(o, leaves, gg,
                                                retain_graph=True), kname)
        _record(out, name, err, tk, _timed(plain, None), n_io * n * es,
                flops * n, peaks, tag=f"{tag} {dt} {(B, ch, h, w)}",
                **extra)
    return out


def _bf16_close(got, want, fp32_tol: float) -> bool:
    """Within one bf16 ulp of the plain value plus the fp32 bound."""
    diff = (got.float() - want.float()).abs()
    mag = want.float().abs().clamp_min(2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return bool((diff <= ulp + fp32_tol).all())


def _check(name: str, got, want) -> float:
    """max |got - want| over the finite entries; raises unless both have
    the same NaN entries and the others are within 1e-4 * max|want| +
    1e-5 (fp32) or one bf16 ulp of the plain value plus that bound
    (bf16)."""
    got, want = got.detach(), want.detach()
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"{name}: {got.dtype} {tuple(got.shape)} "
                             f"against {want.dtype} {tuple(want.shape)}")
    nan = torch.isnan(want)
    n_nan = int(nan.sum())
    if not torch.equal(torch.isnan(got), nan):
        raise AssertionError(f"{name}: NaN entries differ ({n_nan} in the "
                             f"plain version, {int(got.isnan().sum())} in "
                             "the kernel's)")
    if not want.numel():                     # an empty level
        return 0.0
    got, want = got.masked_fill(nan, 0.0), want.masked_fill(nan, 0.0)
    tol = 1e-4 * float(want.float().abs().max()) + 1e-5
    err = float((got.float() - want.float()).abs().max())
    ok = (_bf16_close(got, want, tol) if got.dtype == torch.bfloat16
          else err <= tol)
    print(f"[kernels] {name}: max|err| {err:.3e} (tol {tol:.3e}"
          f"{' + 1 bf16 ulp' if got.dtype == torch.bfloat16 else ''})"
          f"{f', {n_nan} NaN on both sides' if n_nan else ''}", flush=True)
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with the plain "
                             f"version ({err} > {tol})")
    return err


def _same(a, b) -> bool:
    """Bit for bit equal, NaN entries included."""
    return torch.equal(a.isnan(), b.isnan()) and torch.equal(
        a.nan_to_num(), b.nan_to_num())


def _check_sums(name: str, got, want) -> float:
    """The ``(gB, 5)`` upsample-loss sums: each column within
    1e-4 * max|plain column| + 1e-5, so the pixel counts are held on their
    own scale and not on the L1 column's."""
    got, want = got.detach(), want.detach()
    errs = (got - want).abs().amax(dim=0)
    tols = 1e-4 * want.abs().amax(dim=0) + 1e-5
    print(f"[kernels] {name}: per-column max|err| "
          f"{[f'{e:.3e}' for e in errs.tolist()]} (tol "
          f"{[f'{t:.3e}' for t in tols.tolist()]}); plain column max "
          f"{[f'{m:.1f}' for m in want.abs().amax(dim=0).tolist()]}",
          flush=True)
    if not bool((errs <= tols).all()) or got.shape != want.shape:
        raise AssertionError(f"{name}: kernel disagrees with the plain "
                             f"version ({errs.tolist()} > {tols.tolist()})")
    return float(errs.max())


def _window_elems(coords: np.ndarray, shapes, k: int) -> float:
    """Stored values this run's centers need: the in-level integer
    positions of each query's (k+1)^2 bilinear window, per level."""
    total = 0.0
    for lvl, (hl, wl) in enumerate(shapes):
        c = coords.reshape(-1, 2) / 2.0 ** lvl
        cnt = []
        for axis, size in ((0, wl), (1, hl)):
            lo = np.floor(c[:, axis]) - (k - 1) // 2
            pos = lo[:, None] + np.arange(k + 1)[None]
            cnt.append(((pos >= 0) & (pos < size)).sum(1))
        total += float((cnt[0] * cnt[1]).sum())
    return total


def _grid_sample_lookup(pyramid, coords, radius):
    """The lookup as one ``grid_sample`` call per level (align_corners,
    zeros padding): each query's row is an image, its window the grid.
    Timed as the library yardstick only; the port never calls it."""
    import torch.nn.functional as F

    B, H1, W1, _ = coords.shape
    N = H1 * W1
    k = 2 * radius + 1
    d = torch.arange(k, dtype=torch.float32, device=coords.device) - radius
    grids = []
    for lvl, lv in enumerate(pyramid):
        hl, wl = lv.shape[2:]
        c = coords.reshape(B * N, 1, 1, 2) / 2.0 ** lvl
        # grid[n, j, i] = (x + i - r, y + j - r)
        gx = (c[..., 0] + d[None, None, :]).expand(B * N, k, k)
        gy = (c[..., 1] + d[None, :, None]).expand(B * N, k, k)
        grids.append(torch.stack([2 * gx / max(wl - 1, 1) - 1,
                                  2 * gy / max(hl - 1, 1) - 1], -1))

    def run(levels):
        outs = [F.grid_sample(lv.reshape(B * N, 1, *lv.shape[2:]), g,
                              mode="bilinear", padding_mode="zeros",
                              align_corners=True)
                for lv, g in zip(levels, grids)]
        # (B*N, 1, j, i) -> x-major taps (B, H1, W1, L*k*k)
        return torch.cat([o.reshape(B, N, k, k).transpose(2, 3).reshape(
            B, N, k * k) for o in outs], -1).reshape(B, H1, W1, -1)

    return run


# Grids of the upsample-loss kernels on each access path: an odd grid at
# B = 1, H*W = 2 mod 4, H*W = 0 mod 8, and the chairs grid with the mask
# one value into its allocation; with the chairs case above (16 / 8
# bytes) every path of both kernels runs.  (label, G, B, H, W, offset in
# values, bytes per dmask store at a plane's edges in fp32, in bf16; the
# forward loads the mask as many bytes at a time, and 40x64 in bf16 is
# its one path with 8 pixels a lane)
UL_RAGGED = (("45x63 B=1", 12, 1, 45, 63, 0, 4, 2),
             ("45x62", 2, 2, 45, 62, 0, 8, 4),
             ("40x64", 2, 2, 40, 64, 0, 16, 16),
             ("46x62 +1", 2, 2, 46, 62, 1, 4, 2))


def _ul_ragged_cases(rng, dev):
    """The upsample-loss sums, dflow and dmask of the kernels against the
    plain version on ``UL_RAGGED``, fp32 and bf16 masks, residuals kept
    away from 0 as in the chairs case; raises unless each case takes its
    access paths (forward and backward)."""
    from raft_tpu_torch.ops.upsample_loss import (bwd_vector_bytes, fwd_plan,
                                                  upsample_loss_sums,
                                                  upsample_loss_sums_plain)

    for label, G, B, H, W, offset, vb32, vb16 in UL_RAGGED:
        gB = G * B
        flow = torch.from_numpy(rng.uniform(-1, 1, (gB, H, W, 2)).astype(
            np.float32)).to(dev)
        gt = (rng.uniform(8.5, 24, (B, 8 * H, 8 * W, 2))
              * rng.choice([-1.0, 1.0], (B, 8 * H, 8 * W, 2)))
        gt = torch.from_numpy(gt.astype(np.float32)).to(dev)
        vm = torch.from_numpy((rng.random((B, 8 * H, 8 * W)) > 0.1).astype(
            np.float32)).to(dev)
        wsum = torch.from_numpy(rng.random((gB, 5)).astype(np.float32)).to(
            dev)
        mask32 = torch.from_numpy(rng.standard_normal(
            (gB, 576, H, W)).astype(np.float32)).to(dev)
        for dtype, want_vb in ((torch.float32, vb32), (torch.bfloat16, vb16)):
            dt = "fp32" if dtype == torch.float32 else "bf16"
            outs = []
            for fn in (upsample_loss_sums, upsample_loss_sums_plain):
                leaf = torch.zeros(mask32.numel() + offset, dtype=dtype,
                                   device=dev)
                with torch.no_grad():
                    leaf[offset:].copy_(mask32.reshape(-1))
                leaf.requires_grad_(True)
                m = leaf[offset:].view(mask32.shape)
                if fn is upsample_loss_sums:    # dmask: a fresh allocation
                    vb = bwd_vector_bytes(m.data_ptr(), 0, H * W,
                                          m.element_size())
                    plan = fwd_plan(m.data_ptr(), H * W, m.element_size())
                fl = flow.clone().requires_grad_(True)
                sums = fn(fl, m, gt, vm)
                dfl, dleaf = torch.autograd.grad(sums, (fl, leaf), wsum)
                outs.append((sums, dfl, dleaf[offset:].view(m.shape)))
            name = (f"upsample_loss {dt} {label} (G={G}, B={B}, forward "
                    f"{plan.vec_bytes}-byte loads of {plan.pixels} pixels, "
                    f"backward {vb}-byte edge stores)")
            if vb != want_vb or plan.vec_bytes != want_vb:
                raise AssertionError(f"{name}: expected {want_vb} bytes")
            (sk, dflk, dmk), (sp, dflp, dmp) = outs
            _check_sums(f"{name} sums", sk, sp)
            _check(f"{name} dflow", dflk, dflp)
            _check(f"{name} dmask", dmk, dmp)
            del outs, sk, dflk, dmk, sp, dflp, dmp, leaf, m
    torch.cuda.empty_cache()


def phase_train_kernels(peaks):
    """The pyramid lookup (fwd, bwd) and the upsample-loss (fwd, bwd)
    kernels at the chairs training shapes, fp32 and bf16."""
    from raft_tpu_torch.ops.corr import build_corr_pyramid
    from raft_tpu_torch.ops.pyramid_kernels import (pyramid_lookup,
                                                    pyramid_lookup_nchw,
                                                    pyramid_lookup_plain)
    from raft_tpu_torch.ops.upsample import (convex_upsample_flat_nchw,
                                             depth_to_space_flow)
    from raft_tpu_torch.ops.upsample_loss import (bwd_vector_bytes, fwd_plan,
                                                  upsample_loss_sums,
                                                  upsample_loss_sums_plain)

    dev = torch.device("cuda")
    rng = np.random.default_rng(2)
    results = {}
    k = 2 * R + 1
    B = CHAIRS_B
    h8, w8 = CHAIRS_HW[0] // 8, CHAIRS_HW[1] // 8
    N = h8 * w8
    P = LEVELS * k * k
    f1, f2, coords = _corr_inputs(rng, B, h8, w8, dev)
    c_np = coords.cpu().numpy()
    shapes = [(h8 >> lvl, w8 >> lvl) for lvl in range(LEVELS)]
    win = _window_elems(c_np, shapes, k)
    g = torch.from_numpy(rng.standard_normal((B, P, h8, w8)).astype(
        np.float32)).to(dev)
    for dtype in (torch.float32, torch.bfloat16):
        dt = "fp32" if dtype == torch.float32 else "bf16"
        es = 4 if dtype == torch.float32 else 2
        with torch.no_grad():
            pyr = build_corr_pyramid(f1, f2, LEVELS, dtype)
        pyr = [lv.requires_grad_(True) for lv in pyr]
        got = pyramid_lookup_nchw(pyr, coords, R, dtype)
        want = pyramid_lookup_plain(pyr, coords, R, dtype).permute(0, 3, 1,
                                                                   2)
        err_f = _check(f"pyramid_lookup_fwd {dt} {tuple(got.shape)}",
                       got, want)
        gg = g.to(dtype)
        dk = torch.autograd.grad(got, pyr, gg, retain_graph=True)
        dp = torch.autograd.grad(want, pyr, gg, retain_graph=True)
        err_b = max(_check(f"pyramid_lookup_bwd {dt} level {i} "
                           f"{tuple(a.shape)}", a, b)
                    for i, (a, b) in enumerate(zip(dk, dp)))
        nhwc = pyramid_lookup(pyr, coords, R, dtype)
        if not torch.equal(nhwc.permute(0, 3, 1, 2), got):
            raise AssertionError("pyramid_lookup: NHWC != NCHW taps")
        # the backward from an NHWC tap gradient (the other layout)
        dkh = torch.autograd.grad(nhwc, pyr, gg.permute(0, 2, 3, 1))
        err_b = max([err_b] + [_check(f"pyramid_lookup_bwd {dt} NHWC level "
                                      f"{i}", a, b)
                               for i, (a, b) in enumerate(zip(dkh, dp))])
        del dkh
        with torch.no_grad():
            tk = _timed(lambda: pyramid_lookup_nchw(pyr, coords, R, dtype),
                        "pyr_fwd_kernel")
            tp = _timed(lambda: pyramid_lookup_plain(pyr, coords, R, dtype),
                        None, reps=10)
        tkb = _timed(lambda: torch.autograd.grad(got, pyr, gg,
                                                 retain_graph=True),
                     "pyr_bwd_kernel", reps=10)
        tpb = _timed(lambda: torch.autograd.grad(want, pyr, gg,
                                                 retain_graph=True),
                     None, reps=5)
        lib_f = lib_b = None
        if dtype == torch.float32:
            run = _grid_sample_lookup(pyr, coords, R)
            ref = run(pyr)
            lib_err = float((ref.permute(0, 3, 1, 2) - want).abs().max())
            print(f"[kernels] grid_sample yardstick vs plain: max|err| "
                  f"{lib_err:.3e}", flush=True)
            with torch.no_grad():
                lib_f = _timed(lambda: run(pyr), None, reps=10)
            lib_out = run(pyr)
            gl = gg.permute(0, 2, 3, 1)
            lib_b = _timed(lambda: torch.autograd.grad(
                lib_out, pyr, gl, retain_graph=True), None, reps=5)
            del lib_out, ref
        out_bytes = B * P * N * es
        lvl_bytes = sum(lv.numel() for lv in pyr) * es
        nb_f = win * es + coords.numel() * 4 + out_bytes
        ops_f = 9.0 * B * N * P
        bound_f, by_f = _bound_ms(nb_f, ops_f, peaks)
        nb_b = lvl_bytes + B * P * N * es + coords.numel() * 4
        ops_b = 12.0 * win
        bound_b, by_b = _bound_ms(nb_b, ops_b, peaks)
        for name, err, t, tpl, lib, bound, by, nb, ops in (
                ("pyramid_lookup_fwd", err_f, tk, tp, lib_f, bound_f, by_f,
                 nb_f, ops_f),
                ("pyramid_lookup_bwd", err_b, tkb, tpb, lib_b, bound_b, by_b,
                 nb_b, ops_b)):
            results[f"{name}/{dt}"] = dict(
                max_abs_err=err, ms=t["ms"], plain_ms=tpl["ms"],
                library_ms=None if lib is None else lib["ms"],
                bound_ms=bound, bound_by=by, bytes=nb, ops=ops,
                kernel_timing=t, plain_timing=tpl, library_timing=lib)
            print(f"[kernels] {name} {dt}: kernel {t}, plain {tpl}, "
                  f"library {lib}, bound {bound:.4f} ms ({by}; "
                  f"{nb / 1e6:.1f} MB, {ops / 1e9:.4f} GFLOP)", flush=True)
        del pyr, got, want, dk, dp, nhwc
        torch.cuda.empty_cache()

    # --- upsample-loss: 12 iterations x batch 8 folded, 46 x 62 ---
    gB = CHAIRS_ITERS * B
    H, W = h8, w8
    # The |.| subgradient flips with the sign of a residual, and two fp32
    # orders of the same sum can give opposite signs to a residual within
    # ~1e-6 of 0: at this size (35 M residuals) a few would flip and move
    # dflow by up to 16 * weight.  So the residuals are kept away from 0:
    # the upsampled flow lies in 8 * [-1, 1] and the ground truth at
    # +-[8.5, 24], both signs.  tests/test_torch_cuda.py covers exact
    # zeros.
    flow = torch.from_numpy(rng.uniform(-1, 1, (gB, H, W, 2)).astype(
        np.float32)).to(dev)
    gt = (rng.uniform(8.5, 24, (B, 8 * H, 8 * W, 2))
          * rng.choice([-1.0, 1.0], (B, 8 * H, 8 * W, 2)))
    gt = torch.from_numpy(gt.astype(np.float32)).to(dev)
    vm = torch.from_numpy((rng.random((B, 8 * H, 8 * W)) > 0.1).astype(
        np.float32)).to(dev)
    wsum = torch.from_numpy(rng.random((gB, 5)).astype(np.float32)).to(dev)
    mask32 = torch.from_numpy(rng.standard_normal((gB, 576, H, W)).astype(
        np.float32)).to(dev)
    # A second case whose residuals span the 1/3/5 px thresholds: one
    # iteration (gB = B), ground truth = the plain upsampled flow + offsets
    # whose end-point error is U(0.75, 7) px, kept >= 1e-3 from a
    # threshold (the two sum orders differ by ~1e-6 px), with both
    # components >= 0.5 px from 0; so the pixel counts are large and must
    # agree exactly.
    shape = (B, 8 * H, 8 * W)
    r = rng.uniform(0.75, 7.0, shape)
    near = np.min([np.abs(r - t) for t in (1.0, 3.0, 5.0)], axis=0) < 1e-3
    r[near] *= 1.01
    lo, hi = np.arcsin(0.5 / r), np.arccos(0.5 / r)
    theta = lo + rng.random(shape) * (hi - lo)
    off = (np.stack([r * np.cos(theta), r * np.sin(theta)], -1)
           * rng.choice([-1.0, 1.0], shape + (2,)))
    off = torch.from_numpy(off.astype(np.float32)).to(dev)

    def run(fn, fl, m, g_t, v):
        fl = fl.clone().requires_grad_(True)
        m = m.clone().requires_grad_(True)
        sums = fn(fl, m, g_t, v)
        dfl, dm = torch.autograd.grad(sums, (fl, m), wsum[:fl.shape[0]],
                                      retain_graph=True)
        return sums, dfl, dm, fl, m

    for dtype in (torch.float32, torch.bfloat16):
        dt = "fp32" if dtype == torch.float32 else "bf16"
        mask = mask32.to(dtype)
        outs = [run(fn, flow, mask, gt, vm)
                for fn in (upsample_loss_sums, upsample_loss_sums_plain)]
        (sk, dflk, dmk, flk, mk), (sp, dflp, dmp, flp, mp) = outs
        vb = bwd_vector_bytes(mask.data_ptr(), dmk.data_ptr(), H * W,
                              mask.element_size())
        plan = fwd_plan(mask.data_ptr(), H * W, mask.element_size())
        print(f"[kernels] upsample_loss {dt} chairs: forward {plan}, "
              f"backward {vb}-byte edge accesses", flush=True)
        if vb != (16 if dtype == torch.float32 else 8) or (
                plan.vec_bytes, plan.pixels) != (vb, 4):
            raise AssertionError(f"upsample_loss {dt}: {plan}, {vb} bytes")
        err_f = _check_sums(f"upsample_loss_fwd {dt} sums {tuple(sk.shape)}",
                            sk, sp)
        err_b = max(_check(f"upsample_loss_bwd {dt} dflow", dflk, dflp),
                    _check(f"upsample_loss_bwd {dt} dmask "
                           f"{tuple(dmk.shape)}", dmk, dmp))
        with torch.no_grad():
            up = convex_upsample_flat_nchw(flow[:B].permute(0, 3, 1, 2),
                                           mask[:B])
            gt_s = (depth_to_space_flow(up.permute(0, 2, 3, 1)) + off
                    ).contiguous()
        span = [run(fn, flow[:B], mask[:B], gt_s, vm)
                for fn in (upsample_loss_sums, upsample_loss_sums_plain)]
        counts = span[1][0][:, 2:].sum(dim=0).tolist()
        print(f"[kernels] upsample_loss {dt} threshold case: plain 1/3/5 px "
              f"counts {counts} of {float(vm.sum()):.0f} valid pixels",
              flush=True)
        if not 0 < counts[0] < counts[1] < counts[2] < float(vm.sum()):
            raise AssertionError(f"threshold case does not span: {counts}")
        err_f = max(err_f, _check_sums(
            f"upsample_loss_fwd {dt} threshold case sums", span[0][0],
            span[1][0]))
        # the kernel tests the squared EPE against 1, 9, 25 (the plain
        # version the EPE against 1, 3, 5): no count may differ
        if not torch.equal(span[0][0][:, 2:], span[1][0][:, 2:]):
            raise AssertionError(
                f"upsample_loss_fwd {dt}: 1/3/5 px counts "
                f"{span[0][0][:, 2:].sum(0).tolist()} against the plain "
                f"{counts}")
        err_b = max(err_b,
                    _check(f"upsample_loss_bwd {dt} threshold case dflow",
                           span[0][1], span[1][1]),
                    _check(f"upsample_loss_bwd {dt} threshold case dmask",
                           span[0][2], span[1][2]))
        del span, up, gt_s
        with torch.no_grad():
            tk = _timed(lambda: upsample_loss_sums(flow, mask, gt, vm),
                        ("ul_fwd_kernel", "ul_reduce_kernel"), reps=10)
            tp = _timed(lambda: upsample_loss_sums_plain(flow, mask, gt, vm),
                        None, reps=5)
        tkb = _timed(lambda: torch.autograd.grad(sk, (flk, mk), wsum,
                                                 retain_graph=True),
                     ("ul_bwd_kernel", "ul_dflow_kernel"), reps=10)
        tpb = _timed(lambda: torch.autograd.grad(sp, (flp, mp), wsum,
                                                 retain_graph=True),
                     None, reps=5)
        es = mask.element_size()
        small = (flow.numel() + gt.numel() + vm.numel()) * 4
        nb_f = mask.numel() * es + small + gB * 5 * 4
        ops_f = 100.0 * gB * H * W * 64
        nb_b = 2 * mask.numel() * es + small + gB * 4 + flow.numel() * 4
        ops_b = 170.0 * gB * H * W * 64
        for name, err, t, tpl, nb, ops in (
                ("upsample_loss_fwd", err_f, tk, tp, nb_f, ops_f),
                ("upsample_loss_bwd", err_b, tkb, tpb, nb_b, ops_b)):
            bound, by = _bound_ms(nb, ops, peaks)
            results[f"{name}/{dt}"] = dict(
                max_abs_err=err, ms=t["ms"], plain_ms=tpl["ms"],
                library_ms=None, bound_ms=bound, bound_by=by, bytes=nb,
                ops=ops, kernel_timing=t, plain_timing=tpl)
            print(f"[kernels] {name} {dt}: kernel {t}, plain {tpl}, bound "
                  f"{bound:.4f} ms ({by}; {nb / 1e6:.1f} MB, "
                  f"{ops / 1e9:.3f} GFLOP)", flush=True)
        del outs, sk, sp, dflk, dflp, dmk, dmp, flk, flp, mk, mp, mask
        torch.cuda.empty_cache()
    results.update(_ul_halo_cases(np.random.default_rng(6), dev, peaks))
    _ul_ragged_cases(np.random.default_rng(5), dev)
    # a ragged grid whose level 3 pools to nothing (rows of 91, 18 and 3
    # values, not multiples of 8) with a NaN x and a NaN y center: NaN taps
    # and all-NaN dcorr rows on the non-empty levels, both layouts
    sf1, sf2, sc = _corr_inputs(rng, 2, 7, 13, dev)
    sc[1, 3, 4, 0] = float("nan")
    sc[0, 5, 6, 1] = float("nan")
    sc[1, 4, 9, 0] = float("inf")            # no window: zero taps
    for dtype in (torch.float32, torch.bfloat16):
        dt = "fp32" if dtype == torch.float32 else "bf16"
        with torch.no_grad():
            spyr = build_corr_pyramid(sf1, sf2, LEVELS, dtype)
        spyr = [lv.requires_grad_(True) for lv in spyr]
        want = pyramid_lookup_plain(spyr, sc, R, dtype)
        sg = torch.from_numpy(rng.standard_normal(want.shape).astype(
            np.float32)).to(dev, dtype)
        dp = torch.autograd.grad(want, spyr, sg)
        for layout, fn, cot in (
                ("nhwc", pyramid_lookup, sg),
                ("nchw", pyramid_lookup_nchw, sg.permute(0, 3, 1, 2))):
            got = fn(spyr, sc, R, dtype)
            _check(f"pyramid_lookup_fwd {dt} 7x13 {layout} NaN centers",
                   got if layout == "nhwc" else got.permute(0, 2, 3, 1),
                   want)
            dk = torch.autograd.grad(got, spyr, cot)
            for i, (a, b) in enumerate(zip(dk, dp)):
                _check(f"pyramid_lookup_bwd {dt} 7x13 {layout} level {i} "
                       f"{tuple(a.shape)}", a, b)
                if a.numel() and int(a.isnan().sum()) != 2 * a[0, 0].numel():
                    raise AssertionError("pyramid_lookup_bwd: NaN rows")
        if int(want.isnan().sum()) != 2 * 3 * k * k:
            raise AssertionError("pyramid_lookup: NaN taps off the centers")
    for name in ("pyramid_lookup_fwd", "pyramid_lookup_bwd",
                 "upsample_loss_fwd", "upsample_loss_bwd"):
        results[name] = results[f"{name}/fp32"]
    return results


# The row-halo form of the upsample-loss kernels at the shape a rank of
# phase spatial gives them: 12 iterations x B 4 folded, one of two shards
# of the chairs grid (23 of 46 rows x 62), the flow with a row of each
# neighbouring shard.
SPATIAL_B, SPATIAL_N = 4, 2


def _ul_halo_cases(rng, dev, peaks) -> dict:
    """The halo kernels (``halo=1``) against their plain version with the
    same halo at the chairs shard shape, fp32 and bf16 mask, timed beside
    the bound of the same work (the flow's two extra rows included); and
    the whole image as one shard with zero halo rows, which must give the
    unsharded kernels' results bit for bit."""
    from raft_tpu_torch.ops.upsample_loss import (upsample_loss_sums,
                                                  upsample_loss_sums_plain)

    B = SPATIAL_B
    gB = CHAIRS_ITERS * B
    H, W = CHAIRS_HW[0] // 8 // SPATIAL_N, CHAIRS_HW[1] // 8
    # residuals away from 0, as for the unsharded check
    flow = torch.from_numpy(rng.uniform(-1, 1, (gB, H + 2, W, 2)).astype(
        np.float32)).to(dev)
    gt = (rng.uniform(8.5, 24, (B, 8 * H, 8 * W, 2))
          * rng.choice([-1.0, 1.0], (B, 8 * H, 8 * W, 2)))
    gt = torch.from_numpy(gt.astype(np.float32)).to(dev)
    vm = torch.from_numpy((rng.random((B, 8 * H, 8 * W)) > 0.1).astype(
        np.float32)).to(dev)
    wsum = torch.from_numpy(rng.random((gB, 5)).astype(np.float32)).to(dev)
    mask32 = torch.from_numpy(rng.standard_normal((gB, 576, H, W)).astype(
        np.float32)).to(dev)

    def run(fn, fl, m, halo):
        fl = fl.clone().requires_grad_(True)
        m = m.clone().requires_grad_(True)
        sums = fn(fl, m, gt, vm, halo=halo)
        dfl, dm = torch.autograd.grad(sums, (fl, m), wsum,
                                      retain_graph=True)
        return sums, dfl, dm, fl, m

    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        dt = "fp32" if dtype == torch.float32 else "bf16"
        mask = mask32.to(dtype)
        (sk, dflk, dmk, flk, mk), (sp, dflp, dmp, flp, mp) = [
            run(fn, flow, mask, 1)
            for fn in (upsample_loss_sums, upsample_loss_sums_plain)]
        err_f = _check_sums(f"upsample_loss_fwd halo {dt} sums "
                            f"{tuple(sk.shape)}", sk, sp)
        err_b = max(_check(f"upsample_loss_bwd halo {dt} dflow "
                           f"{tuple(dflk.shape)}", dflk, dflp),
                    _check(f"upsample_loss_bwd halo {dt} dmask", dmk, dmp))
        # zero halo rows: the unsharded kernels' bits
        z = flow.clone()
        z[:, 0] = 0.0
        z[:, -1] = 0.0
        s1, f1, m1, _, _ = run(upsample_loss_sums, z, mask, 1)
        s0, f0, m0, _, _ = run(upsample_loss_sums, z[:, 1:-1].contiguous(),
                               mask, 0)
        same = (torch.equal(s1, s0) and torch.equal(m1, m0)
                and torch.equal(f1[:, 1:-1], f0))
        print(f"[kernels] upsample_loss halo {dt}: zero halo rows give the "
              f"unsharded kernels' sums, dmask and dflow bit for bit: "
              f"{same}", flush=True)
        if not same:
            raise AssertionError(f"upsample_loss halo {dt}: a zero halo "
                                 "differs from no halo")
        del s1, f1, m1, s0, f0, m0, z
        with torch.no_grad():
            tk = _timed(lambda: upsample_loss_sums(flow, mask, gt, vm,
                                                   halo=1),
                        ("ul_fwd_kernel", "ul_reduce_kernel"), reps=10)
            tp = _timed(lambda: upsample_loss_sums_plain(flow, mask, gt, vm,
                                                         halo=1),
                        None, reps=5)
        tkb = _timed(lambda: torch.autograd.grad(sk, (flk, mk), wsum,
                                                 retain_graph=True),
                     ("ul_bwd_kernel", "ul_dflow_kernel"), reps=10)
        tpb = _timed(lambda: torch.autograd.grad(sp, (flp, mp), wsum,
                                                 retain_graph=True),
                     None, reps=5)
        es = mask.element_size()
        small = (flow.numel() + gt.numel() + vm.numel()) * 4
        nb_f = mask.numel() * es + small + gB * 5 * 4
        ops_f = 100.0 * gB * H * W * 64
        nb_b = 2 * mask.numel() * es + small + gB * 4 + flow.numel() * 4
        ops_b = 170.0 * gB * H * W * 64
        for name, err, t, tpl, nb, ops in (
                ("upsample_loss_fwd", err_f, tk, tp, nb_f, ops_f),
                ("upsample_loss_bwd", err_b, tkb, tpb, nb_b, ops_b)):
            bound, by = _bound_ms(nb, ops, peaks)
            results[f"{name}/halo/{dt}"] = dict(
                max_abs_err=err, ms=t["ms"], plain_ms=tpl["ms"],
                library_ms=None, bound_ms=bound, bound_by=by, bytes=nb,
                ops=ops, shape=[gB, H, W], kernel_timing=t,
                plain_timing=tpl)
            print(f"[kernels] {name} halo {dt} {gB} x {H} (+2) x {W}: "
                  f"kernel {t}, plain {tpl}, bound {bound:.4f} ms ({by}; "
                  f"{nb / 1e6:.1f} MB, {ops / 1e9:.3f} GFLOP)", flush=True)
        del sk, sp, dflk, dflp, dmk, dmp, flk, flp, mk, mp, mask
        torch.cuda.empty_cache()
    return results


def phase_slice4_kernels(peaks):
    """The lookup on a quantized pyramid (kernel 1) and the fused lookup +
    convc1 (kernel 2, forward and backward) at the chairs training shapes
    against their plain versions, with the unfused pair (lookup kernel +
    cuDNN 1x1 conv + relu) timed beside kernel 2 as a comparison."""
    import torch.nn.functional as F
    from raft_tpu_torch.ops.corr import build_corr_pyramid
    from raft_tpu_torch.ops.lookup_encode import (
        pyramid_lookup_encode, pyramid_lookup_encode_bwd_plain,
        pyramid_lookup_encode_plain)
    from raft_tpu_torch.ops.pyramid_kernels import (
        pyramid_lookup_nchw, pyramid_lookup_plain, pyramid_lookup_quantized,
        pyramid_lookup_quantized_nchw)

    dev = torch.device("cuda")
    rng = np.random.default_rng(5)
    results = {}
    k = 2 * R + 1
    B = CHAIRS_B
    h8, w8 = CHAIRS_HW[0] // 8, CHAIRS_HW[1] // 8
    N = h8 * w8
    P = LEVELS * k * k
    f1, f2, coords = _corr_inputs(rng, B, h8, w8, dev)
    shapes = [(h8 >> lvl, w8 >> lvl) for lvl in range(LEVELS)]
    win = _window_elems(coords.cpu().numpy(), shapes, k)

    # --- kernel 1: int8 / e4m3 / e5m2 codes, fp32 and bf16 taps ---
    for qname in ("int8", "float8_e4m3fn", "float8_e5m2"):
        with torch.no_grad():
            pyr = build_corr_pyramid(f1, f2, LEVELS, qname)
        for out_dtype in (torch.float32, torch.bfloat16):
            dt = "fp32" if out_dtype == torch.float32 else "bf16"
            got = pyramid_lookup_quantized_nchw(pyr, coords, R, out_dtype)
            want = pyramid_lookup_plain(pyr, coords, R, out_dtype).permute(
                0, 3, 1, 2)
            err = _check(f"pyramid_lookup_quantized {qname} -> {dt} "
                         f"{tuple(got.shape)}", got, want)
            nhwc = pyramid_lookup_quantized(pyr, coords, R, out_dtype)
            if not torch.equal(nhwc.permute(0, 3, 1, 2), got):
                raise AssertionError("pyramid_lookup_quantized: NHWC != NCHW")
            if qname != "int8":
                continue
            with torch.no_grad():
                tk = _timed(lambda: pyramid_lookup_quantized_nchw(
                    pyr, coords, R, out_dtype), "pyr_fwd_kernel")
                tp = _timed(lambda: pyramid_lookup_plain(pyr, coords, R,
                                                         out_dtype),
                            None, reps=10)
            es = got.element_size()
            nb = win + coords.numel() * 4 + B * LEVELS * 4 + B * P * N * es
            ops = 10.0 * B * N * P
            bound, by = _bound_ms(nb, ops, peaks)
            results[f"pyramid_lookup_quantized/int8/{dt}"] = dict(
                max_abs_err=err, ms=tk["ms"], plain_ms=tp["ms"],
                library_ms=None, bound_ms=bound, bound_by=by, bytes=nb,
                ops=ops, kernel_timing=tk, plain_timing=tp)
            print(f"[kernels] pyramid_lookup_quantized int8 -> {dt}: kernel "
                  f"{tk}, plain {tp}, bound {bound:.4f} ms ({by}; "
                  f"{nb / 1e6:.1f} MB, {ops / 1e9:.4f} GFLOP)", flush=True)
        del pyr, got, want, nhwc
    # an empty level: a 6 x 8 grid pools to 3 x 4, 1 x 2 and 0 x 1
    # and a NaN center: NaN taps on the three non-empty levels
    sf1, sf2, sc = _corr_inputs(rng, 2, 6, 8, dev)
    sc[1, 1, 1, 0] = float("nan")
    with torch.no_grad():
        spyr = build_corr_pyramid(sf1, sf2, LEVELS, "int8")
    got = pyramid_lookup_quantized(spyr, sc, R)
    _check("pyramid_lookup_quantized int8 empty level, NaN center", got,
           pyramid_lookup_plain(spyr, sc, R))
    if (spyr[-1].values.numel() or got[..., 3 * k * k:].abs().max()
            or int(got.isnan().sum()) != 3 * k * k):
        raise AssertionError("pyramid_lookup_quantized: empty level not "
                             "zero, or NaN taps off the NaN center")

    # --- kernel 2: F = 256, forward and backward ---
    gen = torch.Generator().manual_seed(6)
    Fc = 256
    w = (torch.randn(Fc, P, 1, 1, generator=gen) / P ** 0.5).to(dev)
    b = (torch.randn(Fc, generator=gen) * 0.1).to(dev)
    w.requires_grad_(True)
    b.requires_grad_(True)
    cot32 = torch.randn(B, Fc, h8, w8, generator=gen).to(dev)
    for label, store, out_dtype, timed in (
            ("fp32", torch.float32, torch.float32, True),
            ("bf16", torch.bfloat16, torch.bfloat16, True),
            ("int8", "int8", torch.float32, True),
            ("int8->bf16", "int8", torch.bfloat16, False),
            ("e4m3", "float8_e4m3fn", torch.float32, False)):
        with torch.no_grad():
            pyr = build_corr_pyramid(f1, f2, LEVELS, store)
        quantized = not torch.is_tensor(pyr[0])
        if not quantized:
            pyr = [lv.requires_grad_(True) for lv in pyr]
        leaves = [w, b] + ([] if quantized else pyr)
        cot = cot32.to(out_dtype)
        got = pyramid_lookup_encode(pyr, coords, R, w, b, out_dtype)
        with torch.no_grad():
            want = pyramid_lookup_encode_plain(pyr, coords, R, w, b,
                                               out_dtype)
        err_f = _check(f"lookup_encode fwd {label} {tuple(got.shape)}", got,
                       want)
        # the backward against the plain backward on the kernel's output,
        # so both apply the same relu mask (a pre-activation within
        # rounding of 0 may land on either side in two forwards)
        dk = torch.autograd.grad(got, leaves, cot, retain_graph=True)
        dw, db, dl = pyramid_lookup_encode_bwd_plain(pyr, coords, R, w,
                                                     got.detach(), cot)
        err_b = max(_check(f"lookup_encode bwd {label} {n}", a, c)
                    for n, a, c in zip(
                        ["dW", "db"] + [f"dlevel{i}" for i in range(LEVELS)],
                        dk, [dw, db] + (dl or [])))
        del dk, dw, db, dl
        if not timed:
            del pyr, got, want, leaves
            continue
        wc, bc = w.detach().to(out_dtype), b.detach().to(out_dtype)
        lookup = (pyramid_lookup_quantized_nchw if quantized
                  else pyramid_lookup_nchw)
        with torch.no_grad():
            tk = _timed(lambda: pyramid_lookup_encode(
                pyr, coords, R, w, b, out_dtype), "lookup_encode_kernel")
            tp = _timed(lambda: pyramid_lookup_encode_plain(
                pyr, coords, R, w, b, out_dtype), None, reps=10)
            tu = _timed(lambda: torch.relu(F.conv2d(
                lookup(pyr, coords, R, out_dtype), wc, bc)), None)
        tkb = _timed(lambda: torch.autograd.grad(got, leaves, cot,
                                                 retain_graph=True),
                     None, reps=10)
        es_s = 1 if quantized else pyr[0].element_size()
        nb = (win * es_s + coords.numel() * 4 + w.numel() * 4 + Fc * 4
              + (B * LEVELS * 4 if quantized else 0)
              + B * Fc * N * got.element_size())
        # two bounds: the function's fp32 operations on CUDA cores, and
        # the 3xTF32 split on the tensor cores (three products per
        # multiply-add at the dense TF32 peak) that the kernel runs and is
        # measured against
        ops = 2.0 * B * N * P * Fc + 9.0 * B * N * P
        bound_fp32, _ = _bound_ms(nb, ops, peaks)
        t_tc = 3 * 2.0 * B * N * P * Fc / peaks[2] * 1e3
        t_bytes = nb / peaks[0] * 1e3
        bound, by = max(t_tc, t_bytes), ("operations" if t_tc >= t_bytes
                                         else "bytes")
        results[f"lookup_encode/{label}"] = dict(
            max_abs_err=max(err_f, err_b), max_abs_err_fwd=err_f,
            max_abs_err_bwd=err_b, ms=tk["ms"], plain_ms=tp["ms"],
            library_ms=None, unfused_ms=tu["ms"], bwd_ms=tkb["ms"],
            bound_ms=bound, bound_by=by, bound_fp32_cuda_cores_ms=bound_fp32,
            bytes=nb, ops=ops, kernel_timing=tk, plain_timing=tp,
            unfused_timing=tu, bwd_timing=tkb)
        print(f"[kernels] lookup_encode {label}: kernel {tk}, plain {tp}, "
              f"unfused lookup + conv1x1 + relu {tu}, backward (recompute "
              f"+ dW/db + lookup bwd) {tkb}, bound {bound:.4f} ms ({by}, "
              f"3xTF32 on tensor cores; {nb / 1e6:.1f} MB, "
              f"{ops / 1e9:.3f} GFLOP), fp32 CUDA-core bound "
              f"{bound_fp32:.4f} ms; kernel/unfused "
              f"{tk['ms'] / tu['ms']:.3f}", flush=True)
        del pyr, got, want, leaves
        torch.cuda.empty_cache()
    # F = 40 (mma tiles past F) on e4m3 levels at chairs, then a ragged
    # grid with an empty level and a NaN x and a NaN y center on fp32
    # levels: NaN in all F outputs of those queries and in dW's rows of
    # the non-empty levels; forward and backward
    sf1, sf2, sc = _corr_inputs(rng, 2, 7, 13, dev)
    sc[1, 3, 4, 0] = float("nan")
    sc[0, 5, 6, 1] = float("nan")
    sc[1, 4, 9, 0] = float("inf")            # no window: zero taps
    for label, (cf1, cf2, cc), store, out_dtype, fn in (
            ("e4m3 F=40", (f1, f2, coords), "float8_e4m3fn", torch.bfloat16,
             40),
            ("fp32 7x13 NaN centers", (sf1, sf2, sc), torch.float32,
             torch.float32, Fc)):
        with torch.no_grad():
            pyr = build_corr_pyramid(cf1, cf2, LEVELS, store)
        quantized = not torch.is_tensor(pyr[0])
        if not quantized:
            pyr = [lv.requires_grad_(True) for lv in pyr]
        wf = w.detach()[:fn].clone().requires_grad_(True)
        bf = b.detach()[:fn].clone().requires_grad_(True)
        leaves = [wf, bf] + ([] if quantized else pyr)
        got = pyramid_lookup_encode(pyr, cc, R, wf, bf, out_dtype)
        with torch.no_grad():
            want = pyramid_lookup_encode_plain(pyr, cc, R, wf, bf, out_dtype)
        _check(f"lookup_encode fwd {label} {tuple(got.shape)}", got, want)
        cot = torch.from_numpy(rng.standard_normal(got.shape).astype(
            np.float32)).to(dev, out_dtype)
        dk = torch.autograd.grad(got, leaves, cot)
        dw, db, dl = pyramid_lookup_encode_bwd_plain(pyr, cc, R, wf,
                                                     got.detach(), cot)
        for n, a, c in zip(["dW", "db"] + [f"dlevel{i}" for i in range(4)],
                           dk, [dw, db] + (dl or [])):
            _check(f"lookup_encode bwd {label} {n}", a, c)
        if cc is sc and (int(got.isnan().sum()) != 2 * fn or int(
                dk[0].isnan().sum()) != 3 * k * k * fn):
            raise AssertionError("lookup_encode: NaN entries off the NaN "
                                 "centers")
        del pyr, got, want, leaves, dk
    results["pyramid_lookup_quantized"] = \
        results["pyramid_lookup_quantized/int8/fp32"]
    results["lookup_encode"] = results["lookup_encode/int8"]
    return results


def _corr_bwd_case(rng, B, h, w, label, peaks, time_plain=True, dist="a",
                   r=R, c=C):
    """The on-demand lookup backward kernel against its plain version on
    one input (centers from distribution ``dist`` of ``CENTERS``; radius
    ``r``, ``c`` features), with an NHWC and an NCHW tap gradient; the
    kernel's (and the plain version's) time, the bound from this run's
    centers and the box-path share.  df2 comes from atomic adds whose order varies between runs:
    held to the tolerance, never compared bit for bit."""
    from raft_tpu_torch.ops.corr import pool_fmap_pyramid
    from raft_tpu_torch.ops.corr_kernels import (
        corr_lookup_ondemand, corr_lookup_ondemand_bwd_plain,
        corr_lookup_ondemand_nchw, kernel_path_counts)

    dev = torch.device("cuda")
    k = 2 * r + 1
    P = LEVELS * k * k
    f1, f2, coords = _corr_inputs(rng, B, h, w, dev, dist, c)
    f1.requires_grad_(True)
    pyr = [lv.contiguous().requires_grad_(True)
           for lv in pool_fmap_pyramid(f2, LEVELS)]
    g = torch.from_numpy(rng.standard_normal((B, h, w, P)).astype(
        np.float32)).to(dev)
    leaves = [f1, *pyr]
    want = corr_lookup_ondemand_bwd_plain(f1, pyr, coords, r, g)
    want = [want[0], *want[1]]
    err = 0.0
    outs = {}
    for layout, fn, cot in (
            ("nhwc", corr_lookup_ondemand, g),
            ("nchw", corr_lookup_ondemand_nchw, g.permute(0, 3, 1, 2))):
        out = fn(f1, pyr, coords, r)
        got = torch.autograd.grad(out, leaves, cot, retain_graph=True)
        for i, (a, b) in enumerate(zip(got, want)):
            err = max(err, _check(f"corr_ondemand_bwd {label} ({dist}) "
                                  f"{layout} "
                                  f"{'df1' if i == 0 else f'df2 level {i - 1}'}"
                                  f" {tuple(a.shape)}", a, b))
        outs[layout] = (out, cot)
    del got
    with torch.no_grad():
        paths = kernel_path_counts(f1.detach(), [p.detach() for p in pyr],
                                   coords, r, g)["bwd"]
    if dist == "c" and not _box_share(paths) > 0.9:
        raise AssertionError(f"corr_ondemand_bwd {label}: box share {paths} "
                             "under near-grid centers")
    if dist == "a" and not paths[1] > 0:
        raise AssertionError(f"corr_ondemand_bwd {label}: the per-query "
                             f"path was not exercised: {paths}")
    out, cot = outs["nchw"]
    tk = _timed(lambda: torch.autograd.grad(out, leaves, cot,
                                            retain_graph=True),
                "corr_ondemand_bwd_kernel", reps=10)
    tp = (_timed(lambda: corr_lookup_ondemand_bwd_plain(f1, pyr, coords, r,
                                                        g), None, reps=3)
          if time_plain else {"ms": None})
    shapes = [tuple(p.shape[1:3]) for p in pyr]
    win = _window_elems(coords.cpu().numpy(), shapes, k)
    lvl = sum(p.numel() for p in pyr)
    nbytes = 4 * (2 * f1.numel() + coords.numel() + g.numel() + 2 * lvl)
    ops = 4.0 * c * win + 8.0 * B * h * w * P
    bound, by = _bound_ms(nbytes, ops, peaks)
    print(f"[kernels] corr_ondemand_bwd {label} ({dist}: {CENTERS[dist]}) "
          f"{tuple(f1.shape)} levels {shapes}: kernel {tk}, plain {tp}, "
          f"bound {bound:.4f} ms ({by}; {nbytes / 1e6:.1f} MB, "
          f"{ops / 1e9:.3f} GFLOP); (tile, level) pairs box / per-query "
          f"{paths}, box share {_box_share(paths):.3f}", flush=True)
    res = dict(max_abs_err=err, ms=tk["ms"], plain_ms=tp["ms"],
               library_ms=None, bound_ms=bound, bound_by=by, bytes=nbytes,
               ops=ops, paths=paths, box_share=_box_share(paths),
               kernel_timing=tk, plain_timing=tp)
    del outs, out, want, leaves, pyr, f1, f2
    torch.cuda.empty_cache()
    return res


# Layouts of the vectorized gates (the two forwards and the rh backward)
# on each access path: the model's (z/r channel halves, rh's gradient g a
# channel slice) on an odd grid (16-byte vectors), 3 channels on that
# grid, and r one channel off (so z's batch stride is off too) with a
# gradient of one more channel (so its batch stride is off too), at the
# chairs size (bf16 off 16 bytes; more units than one wave) and on the
# odd grid (both types off).  (label, B, C, H, W, r channel offset, extra
# gradient channels, values per access in fp32, in bf16)
GATE_RAGGED = (("45x63", 2, 128, 45, 63, 0, 0, 4, 8),
             ("3 channels 45x63", 2, 3, 45, 63, 0, 0, 1, 1),
             ("46x62 offset", 8, 128, 46, 62, 1, 1, 4, 1),
             ("45x63 offset", 2, 128, 45, 63, 1, 1, 1, 1))


def _gate_ragged_cases(rng, dev):
    """The forward kernels of ``gru_gate_rh`` and ``gru_gate_blend`` and
    the rh backward against their plain versions on ``GATE_RAGGED``, fp32
    and bf16; raises unless each case takes its access path."""
    from raft_tpu_torch.ops import gru_gates

    for label, B, C, H, W, r_off, g_pad, ve32, ve16 in GATE_RAGGED:
        for dtype, want_ve in ((torch.float32, ve32), (torch.bfloat16, ve16)):
            dt = "fp32" if dtype == torch.float32 else "bf16"

            def mk(c, scale=1.0):
                return (torch.from_numpy(rng.standard_normal((B, c, H, W))
                                         .astype(np.float32)) * scale).to(
                    dev, dtype)

            zr, q, hh = mk(2 * C + r_off, 3.0), mk(C, 3.0), mk(C)
            g_cat = mk(3 * C + g_pad)
            zr.requires_grad_(True)
            hh.requires_grad_(True)
            z, r = zr[:, :C], zr[:, C + r_off:2 * C + r_off]
            g = g_cat[:, :C]
            with torch.no_grad():
                fwd = (("gru_gate_rh", (r, hh), gru_gates.gru_gate_rh,
                        gru_gates.gru_gate_rh_plain),
                       ("gru_gate_blend", (z, q, hh), gru_gates.gru_gate_blend,
                        gru_gates.gru_gate_blend_plain))
                for kernel, ins, fn, plain in fwd:
                    got = fn(*ins)
                    ve = _gate_vec(kernel, ins, (got,))
                    name = (f"[kernels] {kernel} {dt} {label} "
                            f"{(B, C, H, W)} ({ve} values per access)")
                    if ve != want_ve:
                        raise AssertionError(f"{name}: expected {want_ve}")
                    _gate_fwd_check(name, got, plain(*ins))
            ve = _gate_vec("gru_gate_rh_bwd", (r, hh, g), ())
            name = (f"gru_gate_rh_bwd {dt} {label} {(B, C, H, W)} ({ve} "
                    "values per access)")
            if ve != want_ve:
                raise AssertionError(f"{name}: expected {want_ve}")
            dzr, dh = torch.autograd.grad(gru_gates.gru_gate_rh(r, hh),
                                          (zr, hh), g)
            want = gru_gates.gru_gate_rh_bwd_plain(r, hh, g)
            _check(f"{name} dr", dzr[:, C + r_off:2 * C + r_off], want[0])
            _check(f"{name} dh", dh, want[1])
            if dzr[:, :C + r_off].any():
                raise AssertionError(f"{name}: dr outside r")
            del zr, q, hh, g_cat, z, r, g, dzr, dh, want


def phase_bwd_kernels(peaks):
    """The backward kernels of the on-demand configuration against their
    plain versions: the GRU gates and the lookup at the chairs shapes,
    and the lookup at a 136x240 grid."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(3)
    results = {}
    B = CHAIRS_B
    h8, w8 = CHAIRS_HW[0] // 8, CHAIRS_HW[1] // 8

    # --- GRU gates: z/r halves of one convzr output; rh's gradient a
    # channel slice of the gradient of cat([rh, x]) (x: 256 channels) ---
    for dtype in (torch.float32, torch.bfloat16):
        dt = "fp32" if dtype == torch.float32 else "bf16"
        for name, rec in _gate_bwd_case(rng, B, 128, 256, h8, w8, dtype,
                                        peaks, "[kernels]").items():
            results[f"{name}/{dt}"] = rec
    _gate_ragged_cases(np.random.default_rng(6), dev)

    # --- on-demand lookup backward: chairs, then 1088x1920 at B = 1, each
    # under the center distributions (a), (b), (c) ---
    for dist in CENTERS:
        sfx = "" if dist == "a" else f"/{dist}"
        results[f"corr_ondemand_bwd/fp32{sfx}"] = _corr_bwd_case(
            rng, B, h8, w8, "chairs", peaks, time_plain=dist == "a",
            dist=dist)
        results[f"corr_ondemand_bwd/1088x1920{sfx}"] = _corr_bwd_case(
            rng, 1, 1088 // 8, 1920 // 8, "1088x1920", peaks,
            time_plain=False, dist=dist)
    # a NaN center on a grid with an empty level: its df1 row and all of
    # df2_l[1] NaN on each non-empty level, as in the plain version
    from raft_tpu_torch.ops.corr import pool_fmap_pyramid
    from raft_tpu_torch.ops.corr_kernels import (
        corr_lookup_ondemand_bwd_plain, corr_lookup_ondemand_nchw)

    f1, f2, coords = _corr_inputs(rng, 2, 7, 13, dev)
    coords[1, 2, 3, 1] = float("nan")
    f1.requires_grad_(True)
    pyr = [lv.contiguous().requires_grad_(True)
           for lv in pool_fmap_pyramid(f2, LEVELS)]
    g = torch.from_numpy(rng.standard_normal(
        (2, 7, 13, LEVELS * (2 * R + 1) ** 2)).astype(np.float32)).to(dev)
    out = corr_lookup_ondemand_nchw(f1, pyr, coords, R)
    got = torch.autograd.grad(out, [f1, *pyr], g.permute(0, 3, 1, 2))
    df1, df2 = corr_lookup_ondemand_bwd_plain(f1, pyr, coords, R, g)
    for i, (a, b) in enumerate(zip(got, [df1, *df2])):
        _check(f"corr_ondemand_bwd 7x13 NaN center "
               f"{'df1' if i == 0 else f'df2 level {i - 1}'}", a, b)
    if (int(got[0].isnan().sum()) != C
            or not all(bool(d[1].isnan().all()) for d in got[1:4])):
        raise AssertionError("corr_ondemand_bwd: NaN entries")
    del f1, f2, pyr, out, got, df1, df2
    for name in ("gru_gate_rh_bwd", "gru_gate_blend_bwd",
                 "corr_ondemand_bwd"):
        results[name] = results[f"{name}/fp32"]
    return results


def _frames(dev):
    """A Sintel-sized frame pair: a smooth seeded texture and the same
    texture shifted by (5, 2) px."""
    g = torch.Generator().manual_seed(0)
    H, W = SINTEL_HW
    base = torch.rand(1, 3, H + 64, W + 64, generator=g) * 255
    base = torch.nn.functional.avg_pool2d(base, 9, stride=1, padding=4)
    f1 = base[:, :, 32:32 + H, 32:32 + W]
    f2 = base[:, :, 30:30 + H, 27:27 + W]
    return [f.permute(0, 2, 3, 1).contiguous().to(dev) for f in (f1, f2)]


def _counters():
    from raft_tpu_torch.ops import launch_counters

    return launch_counters()


def _counts():
    return {k: v for d in _counters() for k, v in d.items()}


def _reset_counts():
    for d in _counters():
        for key in d:
            d[key] = 0


def _expect(nonzero: dict, where: str):
    """Every kernel's count is 0 except those in ``nonzero``."""
    got = _counts()
    want = {**{k: 0 for k in got}, **nonzero}
    print(f"[{where}] launches {got} (expected {want})", flush=True)
    if got != want:
        raise AssertionError(f"{where}: launches {got} != {want}")
    return got


def _expect_counts(iters_total: int, where: str):
    return _expect({"corr_ondemand": iters_total,
                    "gru_gate_rh": 2 * iters_total,
                    "gru_gate_blend": 2 * iters_total}, where)


def _expect_train_counts(label: str, steps: int, where: str):
    """Per step of a kernel configuration: one lookup forward and one
    backward per iteration, one upsample-loss forward and one backward
    (all iterations folded); with the on-demand lookup and fused gates,
    also two passes of both gates, forward and backward, per iteration;
    with the fused encoder one fused launch per iteration and the lookup
    its backward recomputes the taps with (the quantized lookup under
    int8, the lookup forward and backward otherwise); an unfused int8
    step one quantized lookup per iteration.  None for the plain
    configuration."""
    it = CHAIRS_ITERS * steps
    loss = {"upsample_loss_fwd": steps, "upsample_loss_bwd": steps}
    return _expect({
        "kernel": {"pyramid_lookup_fwd": it, "pyramid_lookup_bwd": it,
                   **loss},
        "int8_fused": {"lookup_encode": it, "pyramid_lookup_quantized": it,
                       **loss},
        "auto_fused": {"lookup_encode": it, "pyramid_lookup_fwd": it,
                       "pyramid_lookup_bwd": it, **loss},
        "int8": {"pyramid_lookup_quantized": it, **loss},
        "ondemand": {"corr_ondemand": it, "corr_ondemand_bwd": it,
                     "gru_gate_rh": 2 * it, "gru_gate_rh_bwd": 2 * it,
                     "gru_gate_blend": 2 * it, "gru_gate_blend_bwd": 2 * it,
                     **loss},
        "plain": {}}[label], where)


def phase_path():
    from raft_tpu_torch.config import RAFTConfig
    from raft_tpu_torch.evaluate import make_eval_fn
    from raft_tpu_torch.models.raft import RAFT
    from raft_tpu_torch.ops.pad import InputPadder

    dev = torch.device("cuda")
    sd = RAFT(RAFTConfig.full(), seed=0).state_dict()
    kernel_cfg = dict(corr_impl="pallas", fused_gru=True)
    results = {}

    # the GPU path agrees with the CPU path (itself held against the JAX
    # package by tests/test_torch_raft.py) on a small input
    rng = np.random.default_rng(1)
    small = [rng.uniform(0, 255, (1, 64, 96, 3)).astype(np.float32)
             for _ in range(2)]
    _, up_gpu = make_eval_fn(RAFTConfig.full(**kernel_cfg), 3)(sd, *small)
    _, up_cpu = make_eval_fn(RAFTConfig.full(), 3, device="cpu")(sd, *small)
    err = float((up_gpu.cpu() - up_cpu).abs().max())
    print(f"[path] 64x96 iters=3: kernel config on the card vs allpairs on "
          f"the CPU: max|dflow_up| {err:.3e} px (tol 1e-3)", flush=True)
    if not err <= 1e-3:
        raise AssertionError(f"card vs CPU: {err}")
    results["card_vs_cpu_64x96_px"] = err

    img1, img2 = _frames(dev)
    padder = InputPadder(img1.shape)
    img1, img2 = padder.pad(img1, img2)
    if tuple(img1.shape) != (1, 440, 1024, 3):
        raise AssertionError(f"padded frame {tuple(img1.shape)}")

    # kernel configuration against the plain one, 4 iterations, fp32
    eval_k = make_eval_fn(RAFTConfig.full(**kernel_cfg), 4)
    eval_p = make_eval_fn(RAFTConfig.full(corr_impl="chunked",
                                          fused_gru=False), 4)
    _reset_counts()
    _, up_k = eval_k(sd, img1, img2)
    torch.cuda.synchronize()
    _expect_counts(4, "path iters=4")
    _, up_p = eval_p(sd, img1, img2)
    err = float((up_k - up_p).abs().max())
    print(f"[path] 440x1024 iters=4: kernel vs plain config max|dflow_up| "
          f"{err:.3e} px (tol 1e-3); |flow_up| max "
          f"{float(up_p.abs().max()):.3f}", flush=True)
    if not (torch.isfinite(up_k).all() and err <= 1e-3):
        raise AssertionError(f"kernel vs plain path: {err}")
    results["kernel_vs_plain_iters4_px"] = err
    del eval_k, eval_p, up_k, up_p

    # the 32-iteration Sintel forward
    main_counts = None
    runs = {}
    for dtype in ("float32", "bfloat16"):
        for label, extra in (("allpairs", {}), ("kernel", kernel_cfg)):
            cfg = RAFTConfig.full(compute_dtype=dtype, **extra)
            eval_fn = make_eval_fn(cfg, 32)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            _warm(lambda: eval_fn(sd, img1, img2))       # eager, capture
            times = []
            for i in range(5):
                if i == 0 and label == "kernel" and dtype == "float32":
                    _reset_counts()                      # the main path
                t0 = time.perf_counter()
                lo, up = eval_fn(sd, img1, img2)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
                if i == 0 and label == "kernel" and dtype == "float32":
                    main_counts = _expect_counts(32, "path main run")
            peak = torch.cuda.max_memory_allocated()
            if not (torch.isfinite(up).all() and up.shape == img1.shape[:3]
                    + (2,)):
                raise AssertionError(f"{label} {dtype}: bad flow")
            prof = _profile(lambda: eval_fn(sd, img1, img2), reps=2)
            busy = prof["busy_ms"]
            key = f"{label}/{dtype}"
            wall = statistics.median(times)
            runs[key] = dict(ms_per_pair=wall, ms_all=times,
                             peak_mem_mb=peak / 2 ** 20,
                             device_busy_ms=busy,
                             idle_share=prof["idle_share"], profile=prof)
            print(f"[path] 440x1024 iters=32 {key}: {wall:.2f} ms/pair "
                  f"(runs {', '.join(f'{t:.2f}' for t in times)}), device "
                  f"busy {busy} ms/pair of {prof['wall_ms']:.2f} profiled "
                  f"(idle {prof['idle_share']}), peak "
                  f"{peak / 2 ** 20:.1f} MiB", flush=True)
            del eval_fn, lo, up
    results["iters32"] = runs
    return results, main_counts, sd


def _warm(fn, calls: int = 2):
    """An entry point's first calls before a timed window: an eager call
    (a key's warm-up), then the capture and first replay; the peak
    statistics are reset between them, so the peak that follows covers the
    capture, whose allocations are the graph's working set (a replay
    allocates only its outputs' copies).  Eagerly both calls are eager."""
    fn()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(calls - 1):
        fn()
    torch.cuda.synchronize()


GRAPH_FWD_REPS = 6          # timed forwards per arm of phase graphs
GRAPH_STEPS = 3             # steps compared eager against graph
# The graph's parameter change may differ from eager's by this many times
# eager's own run-to-run difference (beyond the norm bound): were the two
# the same computation, both differences would be draws of one noise.
EAGER_SPREAD_FACTOR = 2.0
GRAPH_STEP_REPS = 3         # timed steps per arm


def _graph_forward(sd, cfg, img1, img2, iters: int, label: str) -> dict:
    """The test-mode forward eagerly and as a graph from the same weights
    on the same frames: the replay's outputs equal eager's bit for bit
    (no forward kernel adds with atomics), one capture over every call,
    the eager launch counts per replay; ms/pair, device busy and idle
    share and peak memory of each."""
    from raft_tpu_torch.evaluate import make_eval_fn

    res, outs = {}, {}
    for graphs in (False, True):
        mode = "graph" if graphs else "eager"
        fn = make_eval_fn(cfg, iters, graphs=graphs)
        call = lambda: fn(sd, img1, img2)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        _warm(call)
        _reset_counts()
        outs[mode] = call()
        torch.cuda.synchronize()
        counts = _counts()
        times = []
        for _ in range(GRAPH_FWD_REPS):
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated()
        prof = _profile(call, reps=2)
        wall = statistics.median(times) / img1.shape[0]
        res[mode] = dict(ms_per_pair=wall, ms_all=times,
                         peak_mem_mb=peak / 2 ** 20,
                         device_busy_ms=prof["busy_ms"],
                         idle_share=prof["idle_share"],
                         by_kind=prof["by_kind"], launches=counts,
                         captures=sorted(fn.captures.counts().values()))
        print(f"[graphs] {label} {mode}: {wall:.2f} ms/pair (runs "
              f"{', '.join(f'{t:.2f}' for t in times)}), device busy "
              f"{prof['busy_ms']} ms of {prof['wall_ms']:.2f} profiled "
              f"(idle {prof['idle_share']}), peak {peak / 2 ** 20:.1f} MiB, "
              f"launches {counts}, captures {res[mode]['captures']}",
              flush=True)
        del fn, call
    same = all(torch.equal(a, b) for a, b in zip(outs["eager"],
                                                  outs["graph"]))
    res["bit_equal"] = same
    res["speedup"] = res["eager"]["ms_per_pair"] / res["graph"]["ms_per_pair"]
    print(f"[graphs] {label}: outputs bit-equal {same}; eager / graph "
          f"{res['speedup']:.3f}", flush=True)
    if not (same and res["graph"]["captures"] == [1]
            and res["eager"]["captures"] == []
            and res["graph"]["launches"] == res["eager"]["launches"]
            and torch.isfinite(outs["graph"][1]).all()):
        raise AssertionError(f"graphs {label}: bit-equal {same}, "
                             f"{res['graph']}, {res['eager']}")
    return res


def _graph_step(sd, batch, cfg, mcfg, label: str, guard: bool = False
                ) -> dict:
    """``GRAPH_STEPS`` train steps eagerly and as a graph from the same
    weights on the same batch: every step's loss within 1e-4 relative
    (fp32) or ``BF16_LOSS_TOL`` (bf16); each parameter's change over the
    steps (``p3 - p0``) against eager's change within
    ``_grad_agreement``'s norm bound widened by ``EAGER_SPREAD_FACTOR``
    times eager's own spread, the norm of a second eager run's parameters
    less the first's (each
    tensor; its entry bound reported: Adam turns a gradient entry within
    noise of zero into a step of up to lr either way, and a bias ahead of
    an instance or batch norm, whose loss gradient is zero in exact
    arithmetic, moves by rounding noise, which the on-demand backward's
    atomics make differ from run to run), with two controls that the
    bound must reject, the graph's change with its last step left out and
    the graph's change doubled (the update at twice the learning rate);
    one capture and the eager launch counts per step.  The last step's
    gradients against eager's are
    reported, not held: cuDNN may pick another weight-gradient algorithm
    under capture, the on-demand backward adds with atomics, and a filter
    gradient summed over a batch of full-size images in another order
    moves by more than fp32 noise where its terms cancel.  Then ms/step,
    device busy and idle share and peak memory of each.
    ``guard``: after the timed steps, a NaN batch through the graph under
    ``torch.cuda.set_sync_debug_mode("error")`` must leave the state bit
    for bit and count 1, with no synchronization."""
    from raft_tpu_torch.train.step import init_state, make_train_step

    res, got = {}, {}
    fp32 = mcfg.compute_dtype == "float32"
    for mode in ("eager", "graph", "eager_again"):
        graphs = mode == "graph"
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        state = init_state(mcfg, cfg, state_dict=sd)
        p0 = {k: v.clone() for k, v in state.model.state_dict().items()}
        grads = {}
        opt_step = state.optimizer.step

        def hooked(*a, _grads=grads, _model=state.model, _step=opt_step,
                   **kw):
            # at capture this records the copies the replays refresh
            _grads.update({n: p.grad.detach().clone()
                           for n, p in _model.named_parameters()})
            return _step(*a, **kw)

        state.optimizer.step = hooked
        step_fn = make_train_step(cfg, graphs=graphs)
        losses, counts = [], []
        for i in range(GRAPH_STEPS):
            if i == 1:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            _reset_counts()
            _, met = step_fn(state, batch)
            torch.cuda.synchronize()
            counts.append(_counts())
            losses.append(float(met["loss"]))
            if i == GRAPH_STEPS - 2:
                before_last = {k: v.clone() for k, v in
                               state.model.state_dict().items()}
        got[mode] = (losses, {n: g.clone() for n, g in grads.items()},
                     {k: v.clone() for k, v in
                      state.model.state_dict().items()}, counts,
                     before_last)
        if mode != "eager_again":      # (its steps only: the spread)
            times = []
            for _ in range(GRAPH_STEP_REPS):
                t0 = time.perf_counter()
                step_fn(state, batch)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            peak = torch.cuda.max_memory_allocated()
            prof = _profile(lambda: step_fn(state, batch), reps=1)
            wall = statistics.median(times)
            res[mode] = dict(ms_per_step=wall, ms_all=times,
                             pairs_per_s=batch["image1"].shape[0] / wall
                             * 1e3, peak_mem_mb=peak / 2 ** 20,
                             device_busy_ms=prof["busy_ms"],
                             idle_share=prof["idle_share"],
                             by_kind=prof["by_kind"], losses=losses,
                             captures=state.programs.counter.total())
            print(f"[graphs] {label} {mode}: {wall:.2f} ms/step (steps "
                  f"{', '.join(f'{t:.1f}' for t in times)}), device busy "
                  f"{prof['busy_ms']} ms of {prof['wall_ms']:.1f} profiled "
                  f"(idle {prof['idle_share']}), peak "
                  f"{peak / 2 ** 20:.1f} MiB, losses {losses}, captures "
                  f"{res[mode]['captures']}", flush=True)
            if guard and graphs:
                res["guard"] = _sync_free_guard(state, step_fn, batch)
        del state.optimizer.step          # (the cycle of _step_grads)
        del state, step_fn, hooked
    (le, ge, pe, ce, _), (lg, gg, pg, cg, pg2) = got["eager"], got["graph"]
    pe_again = got["eager_again"][2]
    rel = max(abs(a - b) / max(abs(b), 1e-12) for a, b in zip(lg, le))
    params = [k for k in pe if "running" not in k]
    want = {k: pe[k] - p0[k] for k in params}
    change = {k: pg[k] - p0[k] for k in params}
    own = {k: float((pe_again[k] - pe[k]).norm()) for k in params}
    spread = {k: EAGER_SPREAD_FACTOR * v for k, v in own.items()}
    agree = _grad_agreement(change, want, spread)
    skipped = _grad_agreement({k: pg2[k] - p0[k] for k in params}, want,
                              spread)
    doubled = _grad_agreement({k: 2 * v for k, v in change.items()}, want,
                              spread)
    worst_spread = max(own, key=own.get)
    grads = _grad_agreement(gg, ge)
    res.update(loss_rel=rel, parameter_change=agree,
               eager_spread=dict(param=worst_spread,
                                 norm=own[worst_spread],
                                 change_norm=float(want[worst_spread].norm())),
               control_last_step_left_out=skipped["leaf_ratio"],
               control_doubled=doubled["leaf_ratio"],
               last_gradients=grads,
               speedup=res["eager"]["ms_per_step"]
               / res["graph"]["ms_per_step"])
    print(f"[graphs] {label}: graph vs eager over {GRAPH_STEPS} steps: "
          f"loss rel {rel:.3e}, parameter change {agree}, eager's own "
          f"spread {res['eager_spread']} (x{EAGER_SPREAD_FACTOR} in the "
          f"bound), controls (must exceed 1): last step left out "
          f"{skipped['leaf_ratio']:.3f}, doubled "
          f"{doubled['leaf_ratio']:.3f}; last-step gradients {grads}; "
          f"eager / graph {res['speedup']:.3f}", flush=True)
    ok = (rel <= (1e-4 if fp32 else BF16_LOSS_TOL)
          and agree["leaf_ratio"] <= 1.0
          and skipped["leaf_ratio"] > 1.0 and doubled["leaf_ratio"] > 1.0
          and cg == ce and res["graph"]["captures"] == 1
          and res["eager"]["captures"] == 0)
    if not ok:
        raise AssertionError(f"graphs {label}: {res}, counts {cg} vs {ce}")
    return res


def _sync_free_guard(state, step_fn, batch) -> dict:
    """A NaN batch through the captured step under sync-debug mode
    ``"error"``: the state stays bit for bit, ``nonfinite_steps`` reads
    one more, and no operation synchronized."""
    bad = {k: v.clone() for k, v in batch.items()}
    bad["image1"][0, 7, 11, 0] = float("nan")
    torch.cuda.synchronize()
    params = {k: v.clone() for k, v in state.model.state_dict().items()}
    opt = [{k: v.clone() for k, v in s.items()}
           for s in state.optimizer.state.values()]
    count0 = int(state.nonfinite_steps)
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, met = step_fn(state, bad)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    same = (all(torch.equal(v, params[k])
                for k, v in state.model.state_dict().items())
            and all(torch.equal(now[k], v) for now, was in
                    zip(state.optimizer.state.values(), opt)
                    for k, v in was.items()))
    count = int(state.nonfinite_steps) - count0
    print(f"[graphs] guard: a NaN batch under sync-debug 'error' left the "
          f"state bit-identical {same}, nonfinite_steps +{count}, metric "
          f"{float(met['nonfinite'])}", flush=True)
    if not (same and count == 1 and float(met["nonfinite"]) == 1.0):
        raise AssertionError("graphs guard: the NaN step changed the state "
                             f"({same}) or counted {count}")
    return dict(state_bit_identical=same, counted=count)


def _graph_validator(sd, trees, dev) -> dict:
    """``validate_sintel`` (kernel configuration, bf16, 32 iterations) on
    the synthetic tree through an eager and a graph ``make_eval_fn``: the
    EPEs within 1e-4 px, ms/pair of each (one warm-up call first)."""
    from raft_tpu_torch.config import RAFTConfig
    from raft_tpu_torch.evaluate import make_eval_fn

    cfg = RAFTConfig.full(compute_dtype="bfloat16", **EVAL_KERNEL_CFG)
    iters, pairs = EVAL_ITERS["sintel"], trees["pairs"]["sintel"]
    res = {}
    for graphs in (False, True):
        mode = "graph" if graphs else "eager"
        fn = make_eval_fn(cfg, iters, device=dev, graphs=graphs)
        _validate("sintel", sd, cfg, iters, trees, eval_fn=fn, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        epe = _validate("sintel", sd, cfg, iters, trees, eval_fn=fn,
                        device=dev)
        wall = (time.perf_counter() - t0) * 1e3
        res[mode] = dict(epe=epe, ms_per_pair=wall / pairs,
                         captures=fn.captures.total())
        del fn
    diff = max(abs(res["graph"]["epe"][k] - v)
               for k, v in res["eager"]["epe"].items())
    res["max_epe_diff"] = diff
    print(f"[graphs] validate_sintel kernel bf16: eager {res['eager']}, "
          f"graph {res['graph']}; max|dEPE| {diff:.3e} px (tol 1e-4)",
          flush=True)
    if not (diff <= 1e-4 and res["graph"]["captures"] == 1):
        raise AssertionError(f"graphs validator: {res}")
    return res


def _tf32_measure(sd, img1, img2, batch, cfg) -> dict:
    """cuDNN TF32 (``config.CONV_TF32``) on against off for the fp32
    kernel-configuration Sintel forward (32 iterations) and the fp32
    shipped chairs step, both as graphs: ms of each, the largest flow
    difference of the forward and the first step's metric differences."""
    from raft_tpu_torch import config
    from raft_tpu_torch.config import RAFTConfig
    from raft_tpu_torch.evaluate import make_eval_fn
    from raft_tpu_torch.train.step import init_state, make_train_step

    saved = config.CONV_TF32
    res = {}
    try:
        fwd, step = {}, {}
        for on in (False, True):
            config.CONV_TF32 = on
            fn = make_eval_fn(RAFTConfig.full(corr_impl="pallas",
                                              fused_gru=True), 32)
            call = lambda: fn(sd, img1, img2)
            _warm(call)
            _, up = call()
            ms = _time_ms(call, reps=GRAPH_FWD_REPS, warmup=0)
            fwd[on] = (up.clone(), ms)
            del fn, call
            state = init_state(RAFTConfig.full(**KERNEL_CFG), cfg,
                               state_dict=sd)
            step_fn = make_train_step(cfg)
            _, met = step_fn(state, batch)
            first = {k: float(met[k]) for k in ("loss", "epe", "grad_norm")}
            _warm(lambda: step_fn(state, batch))
            ms = _time_ms(lambda: step_fn(state, batch),
                          reps=GRAPH_STEP_REPS, warmup=0)
            step[on] = (first, ms)
            del state, step_fn
            torch.cuda.empty_cache()
    finally:
        config.CONV_TF32 = saved
    px = float((fwd[True][0] - fwd[False][0]).abs().max())
    res = dict(
        forward_ms={"off": fwd[False][1], "on": fwd[True][1]},
        forward_max_flow_diff_px=px,
        forward_max_flow_px=float(fwd[False][0].abs().max()),
        step_ms={"off": step[False][1], "on": step[True][1]},
        step_rel_diff={k: abs(step[True][0][k] - v) / max(abs(v), 1e-12)
                       for k, v in step[False][0].items()})
    print(f"[graphs] TF32 (cuDNN) fp32: Sintel forward {fwd[False][1]:.2f} "
          f"ms off, {fwd[True][1]:.2f} ms on, max|dflow_up| {px:.3e} px "
          f"against off (|flow_up| max {res['forward_max_flow_px']:.2f}); "
          f"chairs step {step[False][1]:.2f} ms off, {step[True][1]:.2f} ms "
          f"on, first-step relative differences {res['step_rel_diff']}",
          flush=True)
    return res


def phase_graphs(sd):
    """Captured graphs against eager execution: the full model's Sintel
    forward (440x1024, B = 1, 32 iterations) in ``allpairs`` and the
    kernel configuration, fp32 and bf16; the small model's bf16 forward
    (on-demand kernel configuration); the chairs step (B = 8, 12
    iterations) of the shipped ``allpairs_pallas`` configuration and of
    the on-demand one, fp32 and bf16, with the guard's sync-free NaN step
    on the shipped bf16 graph; ``validate_sintel`` on a synthetic tree;
    TF32 on and off."""
    import tempfile

    from raft_tpu_torch.config import RAFTConfig, TrainConfig
    from raft_tpu_torch.models.raft import RAFT
    from raft_tpu_torch.ops.pad import InputPadder

    dev = torch.device("cuda")
    img1, img2 = _frames(dev)
    img1, img2 = InputPadder(img1.shape).pad(img1, img2)
    out = {"forward": {}, "step": {}}
    t0 = time.perf_counter()
    for dtype in ("float32", "bfloat16"):
        for label, extra in (("allpairs", {}),
                             ("kernel", dict(corr_impl="pallas",
                                             fused_gru=True))):
            key = f"{label}/{dtype}"
            out["forward"][key] = _graph_forward(
                sd, RAFTConfig.full(compute_dtype=dtype, **extra), img1,
                img2, 32, f"Sintel 440x1024 iters=32 {key}")
    sd_small = RAFT(RAFTConfig.small_model(), seed=0).state_dict()
    out["forward"]["small/ondemand/bfloat16"] = _graph_forward(
        sd_small, RAFTConfig.small_model(compute_dtype="bfloat16",
                                         **SMALL_ODM_CFG), img1, img2, 32,
        "small Sintel 440x1024 iters=32 ondemand/bfloat16")
    print(f"[time] graphs forwards: {time.perf_counter() - t0:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    batch = _chairs_batch(dev)
    cfg = TrainConfig(lr=2.5e-4, num_steps=120000, batch_size=CHAIRS_B,
                      image_size=CHAIRS_HW, iters=CHAIRS_ITERS, wdecay=1e-4)
    for label, extra in (("kernel", KERNEL_CFG), ("ondemand", ONDEMAND_CFG)):
        for dtype in ("float32", "bfloat16"):
            key = f"{label}/{dtype}"
            out["step"][key] = _graph_step(
                sd, batch, cfg, RAFTConfig.full(compute_dtype=dtype, **extra),
                f"chairs step {key}",
                guard=(label, dtype) == ("kernel", "bfloat16"))
    print(f"[time] graphs steps: {time.perf_counter() - t0:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    out["tf32"] = _tf32_measure(sd, img1, img2, batch, cfg)
    os.makedirs(WORK, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=WORK) as root:
        out["validator"] = _graph_validator(sd, _eval_trees(root), dev)
    print(f"[time] graphs TF32 + validator: {time.perf_counter() - t0:.1f} s",
          flush=True)
    return out


def phase_demo(sd):
    from raft_tpu_torch.cli import demo

    os.makedirs(WORK, exist_ok=True)
    weights = os.path.join(WORK, "weights.pth")
    torch.save(sd, weights)
    out = os.path.join(WORK, "demo-out")
    before = _counts()["corr_ondemand"]
    written = demo.main(["--model", weights,
                         "--path", os.path.join(REPO, "demo-frames"),
                         "--out", out, "--alternate_corr", "--iters", "8"])
    moved = _counts()["corr_ondemand"] - before
    print(f"[demo] wrote {written}; corr kernel launches {moved}",
          flush=True)
    if len(written) != 2 or not all(os.path.isfile(p) for p in written):
        raise AssertionError(f"demo wrote {written}")
    if moved != 2 * 8:
        raise AssertionError(f"demo corr launches {moved} != 16")
    return {"pngs": written, "corr_launches": moved}


# -- phase eval: the evaluation path on synthetic dataset trees ------------

EVAL_SINTEL_SCENES = (("alley_1", 3, (2, 1)), ("ambush_2", 5, (-3, 2)))
EVAL_KITTI_HW = ((375, 1242), (370, 1224), (374, 1238), (376, 1241))
EVAL_CHAIRS_HW, EVAL_CHAIRS_PAIRS = (384, 512), 4
EVAL_ITERS = {"sintel": 32, "kitti": 24, "chairs": 24}
EVAL_CHECK_ITERS = 4
EVAL_KERNEL_CFG = dict(corr_impl="pallas", fused_gru=True)
EVAL_PLAIN_CFG = dict(corr_impl="chunked", fused_gru=False)


def _texture(seed: int, h: int, w: int) -> np.ndarray:
    """A smooth seeded texture (h + 64, w + 64, 3) in [0, 255], float32."""
    g = torch.Generator().manual_seed(seed)
    base = torch.rand(1, 3, h + 64, w + 64, generator=g) * 255
    base = torch.nn.functional.avg_pool2d(base, 9, stride=1, padding=4)
    return base[0].permute(1, 2, 0).numpy()


def _shifted(base: np.ndarray, hw, k: int, shift) -> np.ndarray:
    """Frame ``k`` of a sequence moving by ``shift`` = (u, v) px a frame:
    frame k+1 at p + shift shows what frame k shows at p."""
    (h, w), (u, v) = hw, shift
    y0, x0 = 32 - k * v, 32 - k * u
    return np.clip(base[y0:y0 + h, x0:x0 + w], 0, 255).astype(np.uint8)


def _eval_trees(root: str) -> dict:
    """Synthetic Sintel, KITTI and FlyingChairs trees under ``root``, each
    sequence a seeded texture shifted by a constant flow, written with the
    port's own writers: Sintel ``training`` and ``test``, ``clean`` and
    ``final`` (clean plus seeded noise), two scenes of 3 and 5 frames at
    436x1024 (ragged sequences); KITTI ``training`` and ``testing``, one
    pair at each of four real resolutions (one 376x1248 bucket), its
    16-bit ground truth with about a third of the pixels invalid; 4
    FlyingChairs ``.ppm`` pairs at 384x512 with ``.flo`` files and a split
    file naming them all validation."""
    from PIL import Image

    from raft_tpu_torch.data import frame_utils, png16

    rng = np.random.default_rng(0)
    n_pairs = {"sintel": 0, "kitti": 0, "chairs": 0}
    for si, (scene, frames, shift) in enumerate(EVAL_SINTEL_SCENES):
        base = _texture(10 + si, *SINTEL_HW)
        clean = [_shifted(base, SINTEL_HW, k, shift) for k in range(frames)]
        noise = rng.normal(0, 8, (frames,) + SINTEL_HW + (3,))
        final = [np.clip(c + n, 0, 255).astype(np.uint8)
                 for c, n in zip(clean, noise)]
        for split in ("training", "test"):
            for dstype, seq in (("clean", clean), ("final", final)):
                d = os.path.join(root, "Sintel", split, dstype, scene)
                os.makedirs(d)
                for k, img in enumerate(seq):
                    Image.fromarray(img).save(
                        os.path.join(d, f"frame_{k + 1:04d}.png"))
        d = os.path.join(root, "Sintel", "training", "flow", scene)
        os.makedirs(d)
        gt = np.broadcast_to(np.float32(shift), SINTEL_HW + (2,))
        for k in range(frames - 1):
            frame_utils.write_flo(os.path.join(d, f"frame_{k + 1:04d}.flo"),
                                  gt)
        n_pairs["sintel"] += 2 * (frames - 1)
    for split in ("training", "testing"):
        os.makedirs(os.path.join(root, "KITTI", split, "image_2"))
    os.makedirs(os.path.join(root, "KITTI", "training", "flow_occ"))
    for i, hw in enumerate(EVAL_KITTI_HW):
        shift = (4 - i, i - 1)
        base = _texture(20 + i, *hw)
        for split in ("training", "testing"):
            for k, tag in ((0, "10"), (1, "11")):
                Image.fromarray(_shifted(base, hw, k, shift)).save(
                    os.path.join(root, "KITTI", split, "image_2",
                                 f"{i:06d}_{tag}.png"))
        uv = np.broadcast_to(64.0 * np.float64(shift) + 2 ** 15, hw + (2,))
        valid = rng.random(hw + (1,)) > 1 / 3
        png16.write_png(os.path.join(root, "KITTI", "training", "flow_occ",
                                     f"{i:06d}_10.png"),
                        np.concatenate([uv, valid], -1).astype(np.uint16))
        n_pairs["kitti"] += 1
    chairs = os.path.join(root, "FlyingChairs_release", "data")
    os.makedirs(chairs)
    for i in range(EVAL_CHAIRS_PAIRS):
        shift = (i - 2, 1 + i)
        base = _texture(30 + i, *EVAL_CHAIRS_HW)
        for k in (0, 1):
            Image.fromarray(_shifted(base, EVAL_CHAIRS_HW, k, shift)).save(
                os.path.join(chairs, f"{i:05d}_img{k + 1}.ppm"))
        frame_utils.write_flo(
            os.path.join(chairs, f"{i:05d}_flow.flo"),
            np.broadcast_to(np.float32(shift), EVAL_CHAIRS_HW + (2,)))
        n_pairs["chairs"] += 1
    split = os.path.join(root, "chairs_split.txt")
    with open(split, "w") as f:
        f.write("2\n" * EVAL_CHAIRS_PAIRS)
    return {"root": root, "sintel": os.path.join(root, "Sintel"),
            "kitti": os.path.join(root, "KITTI"), "chairs": chairs,
            "split": split, "pairs": n_pairs}


def _count_check(iters: int, kernel: bool, where: str):
    """The launches of one forward: ``iters`` on-demand lookups and twice
    ``iters`` of each gate for the kernel configuration, none at all for
    the plain one."""
    got = _counts()
    want = {k: 0 for k in got}
    if kernel:
        want.update(corr_ondemand=iters, gru_gate_rh=2 * iters,
                    gru_gate_blend=2 * iters)
    if got != want:
        raise AssertionError(f"{where}: launches {got} != {want}")


def _recording(eval_fn, iters: int, kernel: bool, where: str, outs: list):
    """``eval_fn`` that checks each call's exact launch counts (set to 0
    just before it, read just after) and keeps its ``flow_up``."""
    def fn(sd, im1, im2, flow_init=None):
        _reset_counts()
        lo, up = eval_fn(sd, im1, im2, flow_init)
        torch.cuda.synchronize()
        _count_check(iters, kernel, where)
        outs.append(up.clone())
        fn.calls += 1
        return lo, up

    fn.calls = 0
    return fn


def _validate(name: str, sd, cfg, iters: int, trees: dict, eval_fn=None,
              batch_size=None, device="cuda"):
    from raft_tpu_torch import evaluate

    kw = {"sintel": dict(root=trees["sintel"]),
          "kitti": dict(root=trees["kitti"]),
          "chairs": dict(root=trees["chairs"],
                         split_file=trees["split"])}[name]
    if batch_size is not None:
        kw["batch_size"] = batch_size
    return evaluate.VALIDATORS[name](sd, cfg, iters=iters, eval_fn=eval_fn,
                                     device=device, **kw)


def _kernel_vs_plain(sd, trees, dev) -> dict:
    """Sintel and KITTI validators under the kernel configuration and the
    plain one (``chunked`` + unfused gates), fp32: every flow within 1e-3
    px at 4 iterations, the EPE within 1e-2 px at the validators' own
    iteration counts; exact launch counts for every batch."""
    from raft_tpu_torch.config import RAFTConfig
    from raft_tpu_torch.evaluate import make_eval_fn

    out = {}
    for name in ("sintel", "kitti"):
        for iters in (EVAL_CHECK_ITERS, EVAL_ITERS[name]):
            res, flows, batches = {}, {}, {}
            for label, extra in (("kernel", EVAL_KERNEL_CFG),
                                 ("plain", EVAL_PLAIN_CFG)):
                cfg = RAFTConfig.full(**extra)
                flows[label] = []
                fn = _recording(make_eval_fn(cfg, iters, device=dev), iters,
                                label == "kernel", f"eval {name} {label}",
                                flows[label])
                res[label] = _validate(name, sd, cfg, iters, trees,
                                       eval_fn=fn, device=dev)
                batches[label] = fn.calls
            px = max(float((k - p).abs().max())
                     for k, p in zip(flows["kernel"], flows["plain"]))
            finite = all(bool(torch.isfinite(k).all())
                         for k in flows["kernel"])
            depe = max(abs(res["kernel"][k] - res["plain"][k])
                       for k in res["plain"])
            key = f"{name}/iters{iters}"
            out[key] = dict(max_px=px, max_epe_diff=depe, kernel=res["kernel"],
                            plain=res["plain"], batches=batches["kernel"])
            print(f"[eval] {key} kernel vs plain config (fp32): "
                  f"max|dflow_up| {px:.3e} px over {batches['kernel']} "
                  f"batches, EPE {res['kernel']} vs {res['plain']} "
                  f"(|diff| {depe:.3e}); launches exact every batch",
                  flush=True)
            if batches["kernel"] != batches["plain"] or not finite:
                raise AssertionError(f"eval {key}: batches {batches}, "
                                     f"finite {finite}")
            if iters == EVAL_CHECK_ITERS and not px <= 1e-3:
                raise AssertionError(f"eval {key}: kernel vs plain {px} px")
            if iters != EVAL_CHECK_ITERS and not depe <= 1e-2:
                raise AssertionError(f"eval {key}: EPE diff {depe}")
    return out


# the port's shipped cuDNN TF32 choice (config.CONV_TF32), read before
# main() turns it off for the checks
SHIPPED_CONV_TF32 = None


@contextlib.contextmanager
def _default_tf32():
    """The entry points' shipped TF32 choice, as a fresh process such as
    the CLI's has it."""
    from raft_tpu_torch import config

    saved = config.CONV_TF32
    config.CONV_TF32 = SHIPPED_CONV_TF32
    try:
        yield
    finally:
        config.CONV_TF32 = saved


def _cli_vs_inprocess(weights, sd, trees, dev) -> dict:
    """``python -m raft_tpu_torch.cli.evaluate --alternate_corr`` (bf16,
    the validators' iterations and batch 4) for each dataset in a
    subprocess, against the same validator in this process: the printed
    EPE within 1.5e-3 (3 printed decimals; cuDNN may choose other
    algorithms in another process) and exit code 0.  The Sintel run
    writes its telemetry (``--telemetry_dir``): ``_eval_telemetry``."""
    from raft_tpu_torch.config import RAFTConfig

    procs = {}
    tel = os.path.join(trees["root"], "eval_tel")
    try:
        for name in ("sintel", "kitti", "chairs"):
            cmd = [sys.executable, "-m", "raft_tpu_torch.cli.evaluate",
                   "--model", weights, "--dataset", name, "--alternate_corr",
                   "--iters", str(EVAL_ITERS[name]),
                   "--data_root", trees["root"], "--chairs_split",
                   trees["split"], "--device", str(dev)]
            if name == "sintel":
                cmd += ["--telemetry_dir", tel]
            procs[name] = subprocess.Popen(
                cmd, cwd=REPO, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True,
                env=dict(os.environ, PYTHONPATH=REPO))
        cfg = RAFTConfig.full(compute_dtype="bfloat16", **EVAL_KERNEL_CFG)
        with _default_tf32():
            want = {name: _validate(name, sd, cfg, EVAL_ITERS[name], trees,
                                    batch_size=4, device=dev)
                    for name in procs}
        outs = {name: p.communicate(timeout=600)
                for name, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    res = {}
    for name, p in procs.items():
        stdout, stderr = outs[name]
        printed = [float(x) for x in re.findall(
            r"(?:EPE|KITTI): (\d+\.\d+)", stdout)]
        inproc = [want[name][k] for k in
                  {"sintel": ("clean", "final"), "kitti": ("kitti-epe",),
                   "chairs": ("chairs",)}[name]]
        diff = (max(abs(a - b) for a, b in zip(printed, inproc))
                if len(printed) == len(inproc) else None)
        res[name] = dict(rc=p.returncode, printed=printed, inprocess=inproc,
                         max_diff=diff, stdout=stdout)
        print(f"[eval] CLI --dataset {name} --alternate_corr (bf16): rc "
              f"{p.returncode}, printed {stdout.strip()!r}, in-process "
              f"{inproc} (max|diff| {diff})", flush=True)
        if p.returncode != 0 or diff is None or not diff <= 1.5e-3:
            raise AssertionError(f"eval CLI {name}: rc {p.returncode}, "
                                 f"{printed} vs {inproc}; "
                                 f"stderr {stderr[-2000:]}")
    res["telemetry"] = _eval_telemetry(tel, res["sintel"]["printed"])
    return res


def _eval_telemetry(tel: str, printed) -> dict:
    """The Sintel validator CLI's stream: one ``cost_report`` (the
    forward's one shape, ``inference_440x1024``, counted on its first
    call: FLOPs and bytes above 0), a ``raft_eval_forward`` span event a
    batch, and the ``eval`` records of both passes with the printed
    EPEs."""
    import glob

    (path,) = glob.glob(os.path.join(tel, "*.jsonl"))
    with open(path) as f:
        recs = [json.loads(line) for line in f]
    costs = [r for r in recs if r["event"] == "cost_report"]
    fwd = [r for r in recs if r["event"] == "span"
           and r.get("name") == "raft_eval_forward"]
    evals = [r for r in recs if r["event"] == "eval"]
    rec = {"cost_reports": [{k: c.get(k) for k in (
        "program", "flops", "bytes", "flops_per_pair", "source",
        "device_kind", "bound_by")} for c in costs],
        "forward_spans": len(fwd),
        "forward_ms_median": (float(np.median([r["seconds"] for r in fwd]))
                              * 1e3 if fwd else None),
        "evals": [{k: r.get(k) for k in ("dataset", "epe")} for r in evals]}
    print(f"[eval] CLI --telemetry_dir (Sintel): {json.dumps(rec)}",
          flush=True)
    epes = [round(r.get("epe", -1), 3) for r in evals]
    if (len(costs) != 1 or costs[0]["program"] != "inference_440x1024"
            or not costs[0]["flops"] > 0 or not costs[0]["bytes"] > 0
            or costs[0]["source"] != "counted" or not fwd
            or [r["dataset"] for r in evals] != ["sintel-clean",
                                                 "sintel-final"]
            or epes != [round(x, 3) for x in printed]):
        raise AssertionError(f"eval telemetry: {rec}")
    return rec


def _submissions(sd, trees, dev) -> dict:
    """The Sintel submission with a warm start under the kernel
    configuration (fp32, 4 iterations) at batch 2 (ragged sequences share
    lanes) against batch 1, every ``.flo`` within 1e-3 px; the KITTI
    submission read back at each image's own shape."""
    from raft_tpu_torch import evaluate
    from raft_tpu_torch.config import RAFTConfig
    from raft_tpu_torch.data import frame_utils

    cfg = RAFTConfig.full(**EVAL_KERNEL_CFG)
    out = os.path.join(trees["root"], "submission")
    calls = {}
    for bs in (2, 1):
        fn = _recording(evaluate.make_eval_fn(cfg, EVAL_CHECK_ITERS,
                                              device=dev),
                        EVAL_CHECK_ITERS, True, f"sintel submission b{bs}",
                        [])
        evaluate.create_sintel_submission(
            sd, cfg, iters=EVAL_CHECK_ITERS, warm_start=True,
            root=trees["sintel"], output_path=os.path.join(out, f"b{bs}"),
            eval_fn=fn, batch_size=bs, device=dev)
        calls[bs] = fn.calls
    err, n = 0.0, 0
    for dstype in ("clean", "final"):
        for scene, frames, _ in EVAL_SINTEL_SCENES:
            for k in range(1, frames):
                rel = os.path.join(dstype, scene, f"frame{k:04d}.flo")
                a = frame_utils.read_flo(os.path.join(out, "b2", rel))
                b = frame_utils.read_flo(os.path.join(out, "b1", rel))
                if a.shape != SINTEL_HW + (2,) or not np.isfinite(a).all():
                    raise AssertionError(f"submission {rel}: {a.shape}")
                err = max(err, float(np.abs(a - b).max()))
                n += 1
    print(f"[eval] sintel submission (warm start, kernel config fp32, "
          f"iters {EVAL_CHECK_ITERS}): {n} .flo, batch 2 ({calls[2]} "
          f"forwards) vs batch 1 ({calls[1]}): max|diff| {err:.3e} px "
          f"(tol 1e-3)", flush=True)
    if not err <= 1e-3:
        raise AssertionError(f"sintel submission batch 2 vs 1: {err}")
    kdir = os.path.join(out, "kitti")
    evaluate.create_kitti_submission(sd, cfg, iters=EVAL_CHECK_ITERS,
                                     root=trees["kitti"], output_path=kdir,
                                     device=dev)
    shapes = []
    for i, hw in enumerate(EVAL_KITTI_HW):
        flow, valid = frame_utils.read_flow_kitti(
            os.path.join(kdir, f"{i:06d}_10.png"))
        shapes.append(flow.shape[:2])
        if flow.shape[:2] != hw or not valid.all():
            raise AssertionError(f"kitti submission {i}: {flow.shape}")
    print(f"[eval] kitti submission: {len(shapes)} PNGs at {shapes}",
          flush=True)
    return dict(sintel_flo=n, sintel_b2_vs_b1_px=err, forwards=calls,
                kitti_shapes=shapes)


def _paeth_png(path: str, img: np.ndarray):
    """``img`` (uint16, H x W x 3) as a PNG whose every row is Paeth
    filtered, as the encoders of real KITTI files mostly choose."""
    import struct
    import zlib

    h, w, _ = img.shape
    raw = np.frombuffer(img.astype(">u2").tobytes(), np.uint8).reshape(h, -1)
    x = raw.astype(np.int32)
    up = np.vstack([np.zeros_like(x[:1]), x[:-1]])
    a = np.hstack([np.zeros_like(x[:, :6]), x[:, :-6]])
    c = np.hstack([np.zeros_like(up[:, :6]), up[:, :-6]])
    p = a + up - c
    pa, pb, pc = np.abs(p - a), np.abs(p - up), np.abs(p - c)
    pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, up, c))
    rows = np.hstack([np.full((h, 1), 4), (x - pred) & 0xFF]).astype(np.uint8)

    def chunk(ctype, body):
        return (struct.pack(">I", len(body)) + ctype + body
                + struct.pack(">I", zlib.crc32(ctype + body) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 16, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(rows.tobytes()))
                + chunk(b"IEND", b""))


def _host_ms(fn, reps: int) -> float:
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _validator_times(sd, trees, dev) -> dict:
    """``validate_sintel`` ms/pair (wall, after one warm-up call) for the
    kernel configuration in bf16 and fp32 and ``allpairs`` in bf16; the
    same batches through ``make_eval_fn`` alone (host-stacked, so the
    host-to-device copy included) and the validator's host share 1 -
    forward / validator; where the host's part goes (decode, padding,
    device-to-host copy, EPE); host ms per decoded frame and ground truth
    and per ``forward_interpolate``; the peak memory of ``validate_kitti``
    (batch 4, one 376x1248 bucket) in bf16."""
    from raft_tpu_torch import evaluate
    from raft_tpu_torch.config import RAFTConfig
    from raft_tpu_torch.data import datasets, frame_utils
    from raft_tpu_torch.ops.pad import InputPadder
    from raft_tpu_torch.utils.warp import forward_interpolate

    pairs = trees["pairs"]["sintel"]
    res = {"pairs": pairs}
    for label, dtype, extra in (("kernel", "bfloat16", EVAL_KERNEL_CFG),
                                ("kernel", "float32", EVAL_KERNEL_CFG),
                                ("allpairs", "bfloat16", {})):
        key = f"{label}/{dtype}"
        cfg = RAFTConfig.full(compute_dtype=dtype, **extra)
        fn = evaluate.make_eval_fn(cfg, EVAL_ITERS["sintel"], device=dev)
        iters = EVAL_ITERS["sintel"]
        _validate("sintel", sd, cfg, iters, trees, eval_fn=fn, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _validate("sintel", sd, cfg, iters, trees, eval_fn=fn, device=dev)
        wall = (time.perf_counter() - t0) * 1e3
        # the same work, step by step: decode, pad and stack, forward
        # (synchronized), device-to-host copy, EPE
        parts = dict(decode=0.0, pad=0.0, forward=0.0, copy=0.0, epe=0.0)
        for dstype in ("clean", "final"):
            ds = datasets.MpiSintel(split="training", dstype=dstype,
                                    root=trees["sintel"])
            for start in range(0, len(ds), 2):
                idx = list(range(start, min(start + 2, len(ds))))
                t = time.perf_counter()
                samples = [ds.load(i) for i in idx]
                t1 = time.perf_counter()
                pads = [InputPadder(s["image1"].shape,
                                    target=evaluate._bucket_hw(ds))
                        for s in samples]
                im1 = [p.pad_np(s["image1"]) for p, s in zip(pads, samples)]
                im2 = [p.pad_np(s["image2"]) for p, s in zip(pads, samples)]
                im1 += [im1[-1]] * (2 - len(idx))
                im2 += [im2[-1]] * (2 - len(idx))
                b1, b2 = np.stack(im1), np.stack(im2)
                t2 = time.perf_counter()
                _, up = fn(sd, b1, b2)
                torch.cuda.synchronize()
                t3 = time.perf_counter()
                up = up.cpu().numpy()
                t4 = time.perf_counter()
                for j, (s, p) in enumerate(zip(samples, pads)):
                    np.sqrt(np.sum((p.unpad(up[j]) - s["flow"]) ** 2, -1))
                t5 = time.perf_counter()
                for part, a, b in (("decode", t, t1), ("pad", t1, t2),
                                   ("forward", t2, t3), ("copy", t3, t4),
                                   ("epe", t4, t5)):
                    parts[part] += (b - a) * 1e3
        res[key] = dict(ms_per_pair=wall / pairs,
                        parts_ms_per_pair={k: v / pairs
                                           for k, v in parts.items()},
                        host_share=1.0 - parts["forward"] / wall)
        print(f"[eval] validate_sintel {key} (batch 2, {iters} iters, {pairs} "
              f"pairs): {wall / pairs:.2f} ms/pair; step by step per pair "
              f"{ {k: round(v / pairs, 3) for k, v in parts.items()} } ms; "
              f"host share 1 - forward/validator = "
              f"{res[key]['host_share']:.3f}", flush=True)
        del fn
    # host costs of the path's pieces
    ds = datasets.MpiSintel(split="training", root=trees["sintel"])
    frame = ds.image_list[0][0]
    res["png_decode_ms"] = _host_ms(lambda: frame_utils.read_gen(frame), 10)
    gt = os.path.join(trees["kitti"], "training", "flow_occ", "000000_10.png")
    res["kitti_gt_decode_ms"] = _host_ms(
        lambda: frame_utils.read_flow_kitti(gt), 5)
    paeth = os.path.join(trees["root"], "paeth_gt.png")
    _paeth_png(paeth, frame_utils.read_png(gt))
    t0 = time.perf_counter()
    back = frame_utils.read_png(paeth)
    res["kitti_gt_paeth_decode_ms"] = (time.perf_counter() - t0) * 1e3
    if not np.array_equal(back, frame_utils.read_png(gt)):
        raise AssertionError("Paeth-filtered ground truth decodes wrong")
    low = np.random.default_rng(3).normal(0, 4, (55, 128, 2))
    res["forward_interpolate_ms"] = _host_ms(
        lambda: forward_interpolate(low), 10)
    print(f"[eval] host ms: PIL decode of a 436x1024 PNG "
          f"{res['png_decode_ms']:.2f}; KITTI ground truth (png16, NumPy) "
          f"{res['kitti_gt_decode_ms']:.2f} as written here (filter 0), "
          f"{res['kitti_gt_paeth_decode_ms']:.1f} with every row Paeth; "
          f"forward_interpolate of 55x128 {res['forward_interpolate_ms']:.2f}",
          flush=True)
    # the KITTI bucket's peak memory, batch 4, bf16
    for label, extra in (("kernel", EVAL_KERNEL_CFG), ("allpairs", {})):
        cfg = RAFTConfig.full(compute_dtype="bfloat16", **extra)
        fn = evaluate.make_eval_fn(cfg, EVAL_ITERS["kitti"], device=dev)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        _validate("kitti", sd, cfg, EVAL_ITERS["kitti"], trees, eval_fn=fn,
                  batch_size=4, device=dev)
        peak = torch.cuda.max_memory_allocated()
        res[f"kitti_peak_mb/{label}/bfloat16"] = peak / 2 ** 20
        print(f"[eval] validate_kitti {label} bf16 batch 4 (one bucket): "
              f"peak {peak / 2 ** 20:.1f} MiB ({base / 2 ** 20:.1f} MiB "
              "before: weights)", flush=True)
        del fn
    return res


def phase_eval(sd, dev="cuda"):
    """The evaluation path on synthetic Sintel, KITTI and FlyingChairs
    trees (``_eval_trees``), with phase 4's seed-0 weights."""
    import tempfile

    out = {}
    os.makedirs(WORK, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=WORK) as root:
        trees = _eval_trees(root)
        weights = os.path.join(root, "weights.pth")
        torch.save(sd, weights)
        print(f"[eval] trees: {trees['pairs']} pairs", flush=True)
        for key, fn, args in (
                ("kernel_vs_plain", _kernel_vs_plain, (sd, trees, dev)),
                ("cli", _cli_vs_inprocess, (weights, sd, trees, dev)),
                ("submissions", _submissions, (sd, trees, dev)),
                ("times", _validator_times, (sd, trees, dev))):
            t0 = time.perf_counter()
            out[key] = fn(*args)
            print(f"[time] eval {key}: {time.perf_counter() - t0:.1f} s",
                  flush=True)
    return out


def _chairs_batch(dev, seed: int = 0):
    """One synthetic FlyingChairs-shaped batch, made on the host from a
    seed: uniform frames, flow 8 * N(0, 1), all pixels valid."""
    rng = np.random.default_rng(seed)
    B, (H, W) = CHAIRS_B, CHAIRS_HW
    batch = {"image1": rng.uniform(0, 255, (B, H, W, 3)),
             "image2": rng.uniform(0, 255, (B, H, W, 3)),
             "flow": 8.0 * rng.standard_normal((B, H, W, 2)),
             "valid": np.ones((B, H, W))}
    return {k: torch.from_numpy(v.astype(np.float32)).to(dev)
            for k, v in batch.items()}


# Kernel vs plain configuration, one chairs step: each parameter's
# unclipped gradient must agree.  A conv bias that a normalization follows
# (most of fnet's and cnet's) has a gradient that is zero in exact
# arithmetic and rounding noise in fp32, so a relative test alone cannot
# hold it; each parameter is held within a share of its own scale plus a
# floor on the model's scale (its largest gradient entry, or its global
# norm).  bf16: the plain chain upsamples in bf16 and the kernel in fp32,
# so the two differ by bf16 rounding, not by fp32 noise.  The bounds were
# set from readings on the H100; in a sound run the worst parameter used
# 8% of the fp32 bound and 20% of the bf16 one, and the bf16 loss differed
# by 2.5e-4 relative (PERF.md, training slice findings).
FP32_GRAD_REL, FP32_GRAD_FLOOR = 1e-3, 1e-6
BF16_LOSS_TOL, BF16_GRAD_REL, BF16_GRAD_FLOOR = 2e-3, 0.1, 2e-4


def _step_grads(sd, batch, cfg, model_cfg):
    """Metrics and the gradients the optimizer sees of one train step."""
    from raft_tpu_torch.train.step import init_state, make_train_step

    state = init_state(model_cfg, cfg, state_dict=sd)
    grads = {}
    opt_step = state.optimizer.step

    def hooked(*a, **kw):
        grads.update({n: p.grad.detach().clone()
                      for n, p in state.model.named_parameters()})
        return opt_step(*a, **kw)

    state.optimizer.step = hooked
    _, met = make_train_step(cfg)(state, batch)
    met = {k: v.detach().cpu().numpy() for k, v in met.items()}
    # the hook and the optimizer refer to each other: without this the
    # state would stay allocated until the garbage collector runs
    del state.optimizer.step
    del state
    torch.cuda.empty_cache()
    return met, grads


def _grad_agreement(gk: dict, gp: dict, spread: dict = None) -> dict:
    """Per parameter: max|dg| against 1e-3 of max|g| plus the fp32 floor
    on the model's largest entry, and |dg| against the bf16 share of |g|
    plus the bf16 floor on the global norm (plus ``spread[name]``, the
    reference's own run-to-run difference, where given), each as a ratio
    (<= 1 passes); the worst parameter of each."""
    if set(gk) != set(gp) or not gp:
        raise AssertionError("train step: the two configurations' "
                             "parameters differ")
    gmax = max(float(g.abs().max()) for g in gp.values())
    gnorm = float(torch.sqrt(sum(g.double().square().sum()
                                 for g in gp.values())))
    entry, leaf = {}, {}
    for n, g in gp.items():
        d = gk[n] - g
        entry[n] = float(d.abs().max()) / (
            FP32_GRAD_REL * float(g.abs().max()) + FP32_GRAD_FLOOR * gmax)
        leaf[n] = float(d.norm()) / (BF16_GRAD_REL * float(g.norm())
                                     + BF16_GRAD_FLOOR * gnorm
                                     + (spread or {}).get(n, 0.0))
    we, wl = max(entry, key=entry.get), max(leaf, key=leaf.get)
    return dict(entry_ratio=entry[we], entry_param=we, leaf_ratio=leaf[wl],
                leaf_param=wl, max_entry=gmax, global_norm=gnorm)


# (kernel configuration, its plain configuration) of each training path
KERNEL_CFG = dict(corr_impl="allpairs_pallas", upsample_loss_kernel="pallas")
ONDEMAND_CFG = dict(corr_impl="pallas", fused_gru=True,
                    upsample_loss_kernel="pallas")
INT8_FUSED_CFG = dict(KERNEL_CFG, corr_dtype="int8", fused_lookup_encoder=True)
AUTO_FUSED_CFG = dict(KERNEL_CFG, fused_lookup_encoder=True)
INT8_CFG = dict(KERNEL_CFG, corr_dtype="int8")
TRAIN_PAIRS = {"kernel": (KERNEL_CFG, {}),
               "ondemand": (ONDEMAND_CFG,
                            dict(corr_impl="chunked", fused_gru=False,
                                 upsample_loss_kernel="xla")),
               "int8_fused": (INT8_FUSED_CFG, dict(corr_dtype="int8")),
               "auto_fused": (AUTO_FUSED_CFG, {})}


def compare_train_step(sd, batch, cfg, dtype: str, pair: str,
                       mk=None) -> dict:
    """One train step of a kernel configuration and of its plain one
    (``TRAIN_PAIRS[pair]``) from the same weights on the same batch, with
    the clip out of reach so the optimizer sees the unclipped gradients,
    which are captured there.  fp32: metrics within 1e-4 relative and
    every parameter's gradient within the fp32 bounds above; bf16: the
    loss within ``BF16_LOSS_TOL`` relative and every gradient within the
    bf16 bounds."""
    from raft_tpu_torch.config import RAFTConfig

    preset = mk or RAFTConfig.full
    cmp_cfg = dataclasses.replace(cfg, clip=1e9)
    (mk, gk), (mp, gp) = (
        _step_grads(sd, batch, cmp_cfg, preset(compute_dtype=dtype, **extra))
        for extra in TRAIN_PAIRS[pair])
    rel = {k: float(np.abs(mk[k] - mp[k]).max()
                    / max(float(np.abs(mp[k]).max()), 1e-12))
           for k in ("loss", "epe", "1px", "3px", "5px", "grad_norm",
                     "loss_iter", "epe_iter")}
    agree = _grad_agreement(gk, gp)
    print(f"[train] chairs {dtype} one step, {preset.__name__} {pair} vs "
          f"plain config: "
          f"relative differences {rel}; gradients {agree}; loss "
          f"{float(mp['loss']):.6f}", flush=True)
    if TRAIN_PAIRS[pair][0].get("corr_dtype") == "int8":
        # the codes carry no gradient: fnet, whose features reach the loss
        # only through them, gets exactly zero on both sides
        fnet = [n for n in gp if n.startswith("fnet.")]
        nonzero = [n for n in fnet if gk[n].any() or gp[n].any()]
        print(f"[train] {pair} {dtype}: {len(fnet)} fnet gradients, "
              f"{len(nonzero)} not exactly zero", flush=True)
        if not fnet or nonzero:
            raise AssertionError(f"{pair}: fnet gradients {nonzero}")
    if dtype == "float32":
        ok = all(v <= 1e-4 for v in rel.values()) and \
            agree["entry_ratio"] <= 1.0
    else:
        ok = rel["loss"] <= BF16_LOSS_TOL and agree["leaf_ratio"] <= 1.0
    if not ok:
        raise AssertionError(f"train step {dtype} {pair} vs plain: {rel}, "
                             f"{agree}")
    return dict(relative=rel, gradients=agree)


def phase_train(sd):
    from raft_tpu_torch.config import RAFTConfig, TrainConfig
    from raft_tpu_torch.train.step import init_state, make_train_step

    dev = torch.device("cuda")
    batch = _chairs_batch(dev)
    cfg = TrainConfig(lr=2.5e-4, num_steps=120000, batch_size=CHAIRS_B,
                      image_size=CHAIRS_HW, iters=CHAIRS_ITERS, wdecay=1e-4)
    step_fn = make_train_step(cfg)
    results = {}

    # each kernel configuration against its plain one: one step, fp32 and
    # bf16
    t0 = time.perf_counter()
    results["kernel_vs_plain"] = {
        f"{pair}/{dtype}": compare_train_step(sd, batch, cfg, dtype, pair)
        for pair in TRAIN_PAIRS for dtype in ("float32", "bfloat16")}
    print(f"[time] train step comparisons: {time.perf_counter() - t0:.1f} s",
          flush=True)

    # the chairs stage: fp32 and bf16, every configuration; each kernel
    # configuration's main path is its first fp32 timed step.  Steps per
    # configuration: (warm-up, timed, profiled); the configurations of the
    # earlier slices run fewer, to keep the script near its time budget.
    main_counts = {}
    runs = {}
    for dtype in ("float32", "bfloat16"):
        for label, extra, (n_warm, n_timed, n_prof) in (
                ("kernel", KERNEL_CFG, (2, 5, 2)), ("plain", {}, (2, 5, 2)),
                ("ondemand", ONDEMAND_CFG, (2, 5, 2)),
                ("int8_fused", INT8_FUSED_CFG, (3, 10, 3)),
                ("auto_fused", AUTO_FUSED_CFG, (3, 10, 3)),
                ("int8", INT8_CFG, (2, 3, 1))):
            t_cfg = time.perf_counter()
            key = f"{label}/{dtype}"
            mcfg = RAFTConfig.full(compute_dtype=dtype, **extra)
            torch.cuda.empty_cache()
            state = init_state(mcfg, cfg, state_dict=sd)
            _warm(lambda: step_fn(state, batch), n_warm)  # eager, capture
            _reset_counts()
            times, losses = [], []
            for i in range(n_timed):
                t0 = time.perf_counter()
                _, met = step_fn(state, batch)
                losses.append(met["loss"])
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
                if i == 0 and dtype == "float32" and label != "plain":
                    main_counts[label] = _expect_train_counts(
                        label, 1, f"train {label} main step")
            peak = torch.cuda.max_memory_allocated()
            losses = [float(x) for x in losses]
            _expect_train_counts(label, n_timed,
                                 f"train {key} {n_timed} steps")
            if not (np.isfinite(losses).all() and state.nonfinite_steps == 0):
                raise AssertionError(f"train {key}: losses {losses}, "
                                     f"{state.nonfinite_steps} non-finite")
            prof = _profile(lambda: step_fn(state, batch), reps=n_prof)
            wall = statistics.median(times)
            # device time per launch inside the step of the pyramid lookup
            # kernels (once per iteration), the upsample-loss forward's and
            # backward's two each (once per step) and the reset-gate
            # backward (twice per iteration): the counts above
            per_launch = {kind: prof["by_kind"][kind] / n
                          for kind, n in (
                              ("pyr_fwd_kernel", CHAIRS_ITERS),
                              ("pyr_bwd_kernel", CHAIRS_ITERS),
                              ("ul_fwd_kernel", 1), ("ul_reduce_kernel", 1),
                              ("ul_bwd_kernel", 1), ("ul_dflow_kernel", 1),
                              ("rh_bwd_kernel", 2 * CHAIRS_ITERS))
                          if kind in prof["by_kind"]}
            runs[key] = dict(ms_per_step=wall, ms_all=times,
                             pairs_per_s=CHAIRS_B / wall * 1e3,
                             peak_mem_mb=peak / 2 ** 20,
                             device_busy_ms=prof["busy_ms"],
                             idle_share=prof["idle_share"], profile=prof,
                             per_launch_ms=per_launch, losses=losses)
            print(f"[train] chairs {key}: {wall:.2f} ms/step "
                  f"({CHAIRS_B / wall * 1e3:.2f} pairs/s; steps "
                  f"{', '.join(f'{t:.1f}' for t in times)}), device busy "
                  f"{prof['busy_ms']} ms/step of {prof['wall_ms']:.1f} "
                  f"profiled (idle {prof['idle_share']}), by kind "
                  f"{prof['by_kind']}, per launch {per_launch}, peak "
                  f"{peak / 2 ** 20:.1f} MiB, losses {losses[0]:.4f} .. "
                  f"{losses[-1]:.4f}", flush=True)
            del state
            print(f"[time] chairs {key}: "
                  f"{time.perf_counter() - t_cfg:.1f} s", flush=True)
    results["chairs"] = runs
    t0 = time.perf_counter()
    results["things"] = _things_memory(sd)
    print(f"[time] things: {time.perf_counter() - t0:.1f} s", flush=True)
    results["cotangent_sum"] = _cotangent_sum()
    return results, main_counts


def _things_memory(sd) -> dict:
    """Peak memory and step time of one bf16 train step at the things
    stage (``scripts/train_single_host.sh:8``: 400x720, batch 5, 12
    iterations) for the on-demand, the ``allpairs_pallas`` and the int8 +
    fused-encoder configurations: one warm-up step, then 3 timed steps
    each."""
    from raft_tpu_torch.config import RAFTConfig, TrainConfig
    from raft_tpu_torch.train.step import init_state, make_train_step

    B, (H, W) = 5, (400, 720)
    rng = np.random.default_rng(4)
    batch = {"image1": rng.uniform(0, 255, (B, H, W, 3)),
             "image2": rng.uniform(0, 255, (B, H, W, 3)),
             "flow": 8.0 * rng.standard_normal((B, H, W, 2)),
             "valid": np.ones((B, H, W))}
    batch = {k: torch.from_numpy(v.astype(np.float32)).cuda()
             for k, v in batch.items()}
    cfg = TrainConfig(lr=1.25e-4, num_steps=100000, batch_size=B,
                      image_size=(H, W), iters=CHAIRS_ITERS, wdecay=1e-4)
    step_fn = make_train_step(cfg)
    out = {}
    for label, extra in (("ondemand", ONDEMAND_CFG), ("kernel", KERNEL_CFG),
                         ("int8_fused", INT8_FUSED_CFG)):
        torch.cuda.empty_cache()
        state = init_state(RAFTConfig.full(compute_dtype="bfloat16",
                                           **extra), cfg, state_dict=sd)
        _warm(lambda: step_fn(state, batch))              # eager, capture
        base = torch.cuda.memory_allocated()
        _reset_counts()
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            _, met = step_fn(state, batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        _expect_train_counts(label, 3, f"things bf16 {label} 3 steps")
        peak = torch.cuda.max_memory_allocated()
        if not (np.isfinite(float(met["loss"]))
                and state.nonfinite_steps == 0):
            raise AssertionError(f"things {label}: loss {met['loss']}")
        out[label] = dict(peak_mem_mb=peak / 2 ** 20,
                          resident_mb=base / 2 ** 20,
                          ms_per_step=statistics.median(times), ms_all=times)
        print(f"[train] things bf16 {label}: peak {peak / 2 ** 20:.1f} MiB "
              f"(resident between steps {base / 2 ** 20:.1f} MiB), "
              f"{statistics.median(times):.2f} ms/step (steps "
              f"{', '.join(f'{t:.1f}' for t in times)})", flush=True)
        del state
    torch.cuda.empty_cache()
    return out


def _cotangent_sum() -> dict:
    """What autograd adds on top of the lookup backward: the 12 dense
    per-iteration pyramid cotangents of a step summed into one, timed as
    11 in-place adds per level at the chairs shape (the same reads and
    writes autograd's accumulation does), fp32 and bf16."""
    dev = torch.device("cuda")
    B, N = CHAIRS_B, (CHAIRS_HW[0] // 8) * (CHAIRS_HW[1] // 8)
    h8, w8 = CHAIRS_HW[0] // 8, CHAIRS_HW[1] // 8
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        acc = [torch.zeros(B, N, h8 >> l, w8 >> l, dtype=dtype, device=dev)
               for l in range(LEVELS)]
        new = [torch.ones_like(a) for a in acc]

        def run():
            for _ in range(CHAIRS_ITERS - 1):
                for a, n in zip(acc, new):
                    a.add_(n)

        t = _timed(run, None, reps=5)
        nbytes = 3 * sum(a.numel() for a in acc) * acc[0].element_size() \
            * (CHAIRS_ITERS - 1)
        dt = "fp32" if dtype == torch.float32 else "bf16"
        out[dt] = dict(ms=t["ms"], timing=t, bytes=nbytes,
                       bound_ms=nbytes / _peaks(
                           torch.cuda.get_device_name(0))[0] * 1e3)
        print(f"[train] summing 12 dense pyramid cotangents per step, {dt}: "
              f"{t['ms']:.3f} ms (bound {out[dt]['bound_ms']:.3f} ms, "
              f"{nbytes / 1e9:.2f} GB)", flush=True)
        del acc, new
    return out


# ---------------------------------------------------------------------------
# phase train_cli: the training entry point on the card
# ---------------------------------------------------------------------------

TRAIN_CLI_PAIRS, TRAIN_CLI_VAL_PAIRS = 24, 4
TRAIN_CLI_STEPS, TRAIN_CLI_VAL_FREQ = 8, 2
RESUME_STEPS, RESUME_AT = 4, 2
TIMED_WARM, TIMED_STEPS = 3, 10


def _train_tree(root: str) -> dict:
    """A synthetic FlyingChairs tree in the real layout and resolution:
    ``TRAIN_CLI_PAIRS`` training and ``TRAIN_CLI_VAL_PAIRS`` validation
    ``.ppm`` pairs at 384x512 (seeded textures under a constant shift) with
    ``.flo`` files and a split file.  Cut: the pair count (real: 22232
    training, 640 validation)."""
    from PIL import Image

    from raft_tpu_torch.data import frame_utils

    data = os.path.join(root, "datasets", "FlyingChairs_release", "data")
    os.makedirs(data)
    n = TRAIN_CLI_PAIRS + TRAIN_CLI_VAL_PAIRS
    for i in range(n):
        shift = (i % 7 - 3, i % 5 - 2)
        base = _texture(100 + i, *EVAL_CHAIRS_HW)
        for k in (0, 1):
            Image.fromarray(_shifted(base, EVAL_CHAIRS_HW, k, shift)).save(
                os.path.join(data, f"{i:05d}_img{k + 1}.ppm"))
        frame_utils.write_flo(
            os.path.join(data, f"{i:05d}_flow.flo"),
            np.broadcast_to(np.float32(shift), EVAL_CHAIRS_HW + (2,)))
    split = os.path.join(root, "chairs_split.txt")
    with open(split, "w") as f:
        f.write("1\n" * TRAIN_CLI_PAIRS + "2\n" * TRAIN_CLI_VAL_PAIRS)
    return {"data_root": os.path.join(root, "datasets"), "split": split,
            "data": data}


def _native_status() -> dict:
    """The native host library on this host: it must load (the chairs
    path runs the C augmentors here, not the NumPy fallback)."""
    import importlib.util

    from raft_tpu_torch.native import build as native

    t0 = time.perf_counter()
    lib = native.load()
    res = dict(native.status(), load_s=time.perf_counter() - t0,
               aug_switch=bool(os.environ.get(native.NO_NATIVE_AUG_ENV)),
               cv2=importlib.util.find_spec("cv2") is not None)
    print(f"[train_cli] native host library: loaded {res['loaded']}, build "
          f"{res['build_s']} s (load call {res['load_s']:.3f} s), "
          f"{res['path']}; cv2 importable: {res['cv2']}", flush=True)
    if lib is None or native.aug_lib() is None:
        raise AssertionError(f"native host library not in use: {res}")
    return res


def _loader_throughput(tree: dict) -> dict:
    """``ShardedLoader(fetch_dataset('chairs', (368, 496)), 8)`` alone on
    the host: samples/s and ms per batch at 1 worker and at the CLI's
    default, and one sample's time split into decode, augment and stack."""
    from raft_tpu_torch.data import datasets, frame_utils

    ds = datasets.fetch_dataset("chairs", CHAIRS_HW, root=tree["data_root"],
                                split_file=tree["split"])
    out = {"cpus": len(os.sched_getaffinity(0))}
    for workers in (1, min(16, out["cpus"])):
        loader = datasets.ShardedLoader(ds, CHAIRS_B, seed=0,
                                        num_workers=workers)
        it = loader.batches()
        next(it)                                          # pool warm-up
        t0 = time.perf_counter()
        n = 6
        for _ in range(n):
            b = next(it)
        dt = time.perf_counter() - t0
        it.close()
        if b["image1"].shape != (CHAIRS_B,) + CHAIRS_HW + (3,):
            raise AssertionError(f"loader batch {b['image1'].shape}")
        out[f"workers_{workers}"] = dict(
            samples_per_s=n * CHAIRS_B / dt, ms_per_batch=dt / n * 1e3)
        print(f"[train_cli] loader alone, {workers} worker(s): "
              f"{n * CHAIRS_B / dt:.1f} samples/s, {dt / n * 1e3:.1f} ms a "
              f"batch of {CHAIRS_B}", flush=True)
    parts = {"decode": [], "augment": [], "stack": []}
    samples = []
    for i in range(CHAIRS_B):
        img1_p, img2_p = ds.image_list[i]
        t0 = time.perf_counter()
        img1 = datasets._to_rgb(frame_utils.read_gen(img1_p))
        img2 = datasets._to_rgb(frame_utils.read_gen(img2_p))
        flow = np.asarray(frame_utils.read_gen(ds.flow_list[i]), np.float32)
        t1 = time.perf_counter()
        a1, a2, f = ds.augmentor(np.random.default_rng(i), img1, img2, flow)
        t2 = time.perf_counter()
        parts["decode"].append((t1 - t0) * 1e3)
        parts["augment"].append((t2 - t1) * 1e3)
        samples.append({"image1": a1.astype(np.float32),
                        "image2": a2.astype(np.float32), "flow": f})
    t0 = time.perf_counter()
    {k: np.stack([s[k] for s in samples]) for k in samples[0]}
    parts["stack"] = [(time.perf_counter() - t0) * 1e3 / CHAIRS_B]
    out["sample_ms"] = {k: statistics.median(v) for k, v in parts.items()}
    print(f"[train_cli] one sample on the host (median ms): "
          f"{out['sample_ms']}", flush=True)
    return out


class _Child:
    """A subprocess whose output lines are read on a thread, so the caller
    can wait for a line with a deadline."""

    def __init__(self, args, env=None):
        import queue
        import threading

        self.lines, self._q = [], queue.Queue()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "raft_tpu_torch", *args], cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=dict(os.environ, PYTHONPATH=REPO, PYTHONUNBUFFERED="1",
                     **(env or {})))
        self._thread = threading.Thread(target=self._read, daemon=True)
        self._thread.start()

    def _read(self):
        for line in self.proc.stdout:
            self._q.put(line.rstrip("\n"))
        self._q.put(None)

    def wait_for(self, pattern: str, count: int = 1, timeout: float = 300):
        """Lines until the ``count``-th one matching ``pattern``."""
        import queue

        deadline, seen = time.monotonic() + timeout, 0
        while True:
            try:
                line = self._q.get(timeout=max(deadline - time.monotonic(),
                                               0.01))
            except queue.Empty:
                raise AssertionError(f"no {pattern!r} within {timeout} s: "
                                     + "\n".join(self.lines[-20:]))
            if line is None:
                raise AssertionError(f"child ended before {pattern!r}: "
                                     + "\n".join(self.lines[-40:]))
            self.lines.append(line)
            if re.search(pattern, line):
                seen += 1
                if seen == count:
                    return line

    def finish(self, timeout: float = 600) -> int:
        rc = self.proc.wait(timeout=timeout)
        self._thread.join(timeout=10)
        while not self._q.empty():
            line = self._q.get()
            if line is not None:
                self.lines.append(line)
        return rc

    def kill(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


def _run_cli(*args, timeout: float = 600, env=None) -> tuple:
    child = _Child(list(args), env)
    try:
        rc = child.finish(timeout)
    finally:
        child.kill()
    return rc, child.lines


def _cli_run(tree: dict, ckpt_dir: str) -> dict:
    """The train CLI in a subprocess (bf16, ``--corr_impl auto``): SIGTERM
    after its second checkpoint, exit 143 with the step it stopped at
    saved; ``verify-ckpt --json`` finds every step ok; the newest step
    torn, ``verify-ckpt`` flags it; the rerun falls back past it, resumes
    and finishes at ``TRAIN_CLI_STEPS``; the evaluate CLI reads the run
    directory."""
    from raft_tpu_torch import chaos
    from raft_tpu_torch.train.checkpoint import CheckpointManager

    args = ["train", "--name", "smoke", "--stage", "chairs",
            "--precision", "bf16", "--batch_size", str(CHAIRS_B),
            "--image_size", *map(str, CHAIRS_HW),
            "--iters", str(CHAIRS_ITERS), "--num_steps",
            str(TRAIN_CLI_STEPS), "--val_freq", str(TRAIN_CLI_VAL_FREQ),
            "--lr", "0.00025", "--data_root", tree["data_root"],
            "--chairs_split", tree["split"], "--ckpt_dir", ckpt_dir]
    run_dir = os.path.join(ckpt_dir, "smoke")
    res = {}
    t0 = time.perf_counter()
    child = _Child(args)
    try:
        child.wait_for(r"^throughput:", count=2)
        child.proc.send_signal(signal.SIGTERM)
        rc = child.finish()
    finally:
        child.kill()
    stop = [int(m.group(1)) for line in child.lines
            for m in [re.match(r"preempted at step (\d+)", line)] if m]
    mgr = CheckpointManager(run_dir)
    steps = mgr.all_steps()
    res["sigterm"] = dict(rc=rc, stopped_at=stop, steps=steps,
                          s=time.perf_counter() - t0, out=child.lines[-30:])
    print(f"[train_cli] CLI SIGTERM after the second checkpoint: rc {rc}, "
          f"stopped at {stop}, saved steps {steps} "
          f"({res['sigterm']['s']:.1f} s)", flush=True)
    if rc != 143 or len(stop) != 1 or steps[-1] != stop[0] \
            or len(steps) < 2:
        raise AssertionError(f"train CLI SIGTERM: {res['sigterm']}")

    rc, lines = _run_cli("verify-ckpt", run_dir, "--json")
    rep = json.loads(lines[-1])
    res["verify"] = dict(rc=rc, report=rep)
    print(f"[train_cli] verify-ckpt: rc {rc}, {rep['steps']}", flush=True)
    if rc != 0 or not rep["ok"] or [s["step"] for s in rep["steps"]] != steps:
        raise AssertionError(f"verify-ckpt: {res['verify']}")

    torn = chaos.tear_files(os.path.join(run_dir, str(steps[-1])))
    rc, lines = _run_cli("verify-ckpt", run_dir, "--json")
    rep = json.loads(lines[-1])
    res["verify_torn"] = dict(rc=rc, report=rep, torn=torn)
    print(f"[train_cli] step {steps[-1]} torn ({len(torn)} files): "
          f"verify-ckpt rc {rc}, latest valid {rep['latest_valid']}",
          flush=True)
    if rc != 1 or rep["latest_valid"] != steps[-2] \
            or rep["steps"][-1]["ok"]:
        raise AssertionError(f"verify-ckpt after tearing: {rep}")

    # the rerun with every observability flag (phase train_cli checks its
    # stream below); the profiler window is the last step
    tel = os.path.join(ckpt_dir, "telemetry")
    window = (TRAIN_CLI_STEPS - 1, TRAIN_CLI_STEPS)
    t0 = time.perf_counter()
    rc, lines = _run_cli(*args, "--telemetry_dir", tel,
                         "--trace_sample_rate", "1",
                         "--watchdog_timeout", "120",
                         "--profile_steps", "%d:%d" % window,
                         "--forensic_keep", "8")
    out = "\n".join(lines)
    resumed = re.findall(r"^resumed from step (\d+)", out, re.M)
    res["rerun"] = dict(rc=rc, resumed=resumed, s=time.perf_counter() - t0,
                        fallback="checkpoint fallback: step(s) "
                        f"[{steps[-1]}] unrestorable" in out,
                        steps=CheckpointManager(run_dir).all_steps(),
                        out=lines[-30:])
    print(f"[train_cli] CLI rerun: rc {rc}, resumed from {resumed}, "
          f"fallback past the torn step {res['rerun']['fallback']}, saved "
          f"steps {res['rerun']['steps']} ({res['rerun']['s']:.1f} s)",
          flush=True)
    if rc != 0 or resumed != [str(steps[-2])] or not res["rerun"]["fallback"] \
            or res["rerun"]["steps"][-1] != TRAIN_CLI_STEPS:
        raise AssertionError(f"train CLI rerun: {res['rerun']}")
    res["telemetry"] = _telemetry_checks(tel, steps[-2], steps[-1], window)

    rc, lines = _run_cli("evaluate", "--model", run_dir, "--dataset",
                         "chairs", "--data_root", tree["data_root"],
                         "--chairs_split", tree["split"])
    epe = [float(x) for line in lines
           for x in re.findall(r"Validation Chairs EPE: (\d+\.\d+)", line)]
    res["evaluate"] = dict(rc=rc, epe=epe, out=lines[-10:])
    print(f"[train_cli] evaluate --model <run dir> --dataset chairs: rc {rc},"
          f" EPE {epe}", flush=True)
    if rc != 0 or len(epe) != 1 or not np.isfinite(epe[0]):
        raise AssertionError(f"evaluate CLI on the run dir: {res['evaluate']}")
    return res


def _telemetry_checks(tel: str, resumed: int, torn: int, window) -> dict:
    """The JSONL of the train CLI's rerun with every observability flag
    (bf16, chairs B 8, 12 iterations): ``run_config`` the first record but
    the resume's ``ckpt_fallback`` (emitted while restoring, before the
    run starts, as in the JAX loop) and ``metrics_summary`` the last; one
    ``compile``; ``hbm_usage`` with a peak above 0 and under the card's
    memory; ``cost_report`` with FLOPs a pair above 0 and the summary's
    ``raft_cost_mfu`` in (0, 1]; a ``train_step`` a step; a
    ``train_health`` a Logger flush with ``param_norm``,
    ``update_ratio`` and an ``epe_iter`` a refinement iteration;
    ``ckpt_fallback`` for the torn step and ``ckpt_commit``; a span tree
    a step with ``queue_wait``, ``prep``, ``h2d`` and ``step_dispatch``
    children and ``ckpt_commit`` under the steps that saved; the
    profiler's Chrome trace of the window; no ``stall``.  The MFU held to
    (0, 1] is the cost record's FLOPs over the median ``step_time_s`` of
    the replayed steps outside the window, against the record's peak:
    the ``raft_cost_mfu`` gauge is the last step's alone (the JAX
    package's meaning), and a step whose input wait hid the device time,
    or the window's, reads far off it."""
    recs = []
    for name in sorted(glob.glob(os.path.join(tel, "telemetry-p*.jsonl"))):
        with open(name) as f:
            recs += [json.loads(line) for line in f if line.strip()]
    events = [r["event"] for r in recs]
    bad = []
    head = [e for e in events if e != "ckpt_fallback"]
    if not head or head[0] != "run_config" or events[-1] != "metrics_summary":
        bad.append(f"first/last events {events[:3]} ... {events[-2:]}")
    if events.count("compile") != 1:
        bad.append(f"{events.count('compile')} compile events")
    hbm = next((r for r in recs if r["event"] == "hbm_usage"), {})
    card_gib = torch.cuda.get_device_properties(0).total_memory / 2 ** 30
    if not 0 < hbm.get("peak_hbm_gb", 0) < card_gib:
        bad.append(f"hbm_usage {hbm}")
    cost = next((r for r in recs if r["event"] == "cost_report"), {})
    summary = recs[-1].get("metrics", {}) if recs else {}
    gauge = summary.get("raft_cost_mfu", {}).get("values", {}).get(
        "program=train_step")
    want_steps = list(range(resumed, TRAIN_CLI_STEPS))
    step_recs = [r for r in recs if r["event"] == "train_step"]
    got_steps = [r["step"] for r in step_recs]
    if got_steps != want_steps:
        bad.append(f"train_step steps {got_steps}, want {want_steps}")
    steady = [r["step_time_s"] for r in step_recs
              if resumed + 2 <= r["step"] < window[0]]
    mfu = (cost.get("flops", 0) / statistics.median(steady)
           / (cost.get("peak_tflops") or float("inf")) / 1e12
           if steady else None)
    if not cost.get("flops_per_pair", 0) > 0 or not (
            mfu is not None and 0 < mfu <= 1) or not (gauge or 0) > 0:
        bad.append(f"cost_report {cost}, mfu {mfu}, gauge {gauge}")
    health = [r for r in recs if r["event"] == "train_health"]
    # log_freq 100: one flush, at the end
    if len(health) != 1 or not all(
            np.isfinite(h.get("param_norm", np.nan))
            and np.isfinite(h.get("update_ratio", np.nan))
            and len(h.get("epe_iter", [])) == CHAIRS_ITERS for h in health):
        bad.append(f"train_health {health}")
    fb = [r["step"] for r in recs if r["event"] == "ckpt_fallback"]
    commits = [r for r in recs if r["event"] == "ckpt_commit"]
    if fb != [torn] or not commits or not all(c["ok"] for c in commits):
        bad.append(f"ckpt_fallback {fb}, ckpt_commit {commits}")
    spans = [r for r in recs if r["event"] == "trace_span"]
    roots = {r["span_id"]: r["step"] for r in spans
             if r["parent_id"] is None}
    kids = {}
    for r in spans:
        if r["parent_id"] in roots:
            kids.setdefault(roots[r["parent_id"]], set()).add(r["name"])
    four = {"queue_wait", "prep", "h2d", "step_dispatch"}
    saved = [s for s in want_steps if (s + 1) % TRAIN_CLI_VAL_FREQ == 0]
    if sorted(roots.values()) != want_steps or not all(
            four <= kids.get(s, set()) for s in want_steps) or not all(
            "ckpt_commit" in kids.get(s, set()) for s in saved):
        bad.append(f"span trees {kids}")
    traces = glob.glob(os.path.join(tel, "profile",
                                    "trace-%d-%d*.json" % window))
    if len(traces) != 1 or os.path.getsize(traces[0]) == 0:
        bad.append(f"profiler traces {traces}")
    if "stall" in events:
        bad.append("a stall event")
    res = dict(events={e: events.count(e) for e in sorted(set(events))},
               hbm=hbm, cost=cost, mfu=mfu, mfu_gauge=gauge,
               steady_step_s=steady, health=health, fallback=fb,
               commits=len(commits), span_children=sorted(
                   set().union(*kids.values())) if kids else [],
               profile_trace=traces, profile_trace_mb=(
                   os.path.getsize(traces[0]) / 2 ** 20 if traces else None),
               bad=bad)
    print(f"[train_cli] rerun telemetry: events {res['events']}; peak "
          f"{hbm.get('peak_hbm_gb')} GiB (reserved {hbm.get('reserved_gb')}),"
          f" {cost.get('flops_per_pair', 0) / 1e9:.1f} GFLOP a pair "
          f"({cost.get('source')}), MFU {mfu} at the median of steps "
          f"{steady} s (last step's gauge {gauge}); spans "
          f"{res['span_children']}; profiler trace "
          f"{res['profile_trace_mb']} MiB", flush=True)
    if bad:
        raise AssertionError(f"train CLI telemetry: {bad}")
    return res


def _cli_config_counts(tree: dict, ckpt_dir: str) -> dict:
    """The CLI's configuration (bf16, ``--corr_impl auto`` ->
    ``allpairs_pallas``, the plain upsample) through the same entry point
    in this process for 2 steps: exactly 12 lookup forwards and 12
    backwards a step, and no other kernel."""
    from raft_tpu_torch.cli import train as train_cli

    _reset_counts()
    state = train_cli.run([
        "--name", "counts", "--stage", "chairs", "--precision", "bf16",
        "--batch_size", str(CHAIRS_B), "--image_size", *map(str, CHAIRS_HW),
        "--iters", str(CHAIRS_ITERS), "--num_steps", "2",
        "--data_root", tree["data_root"], "--chairs_split", tree["split"],
        "--ckpt_dir", ckpt_dir])
    if state.step != 2:
        raise AssertionError(f"CLI in process: step {state.step}")
    return _expect({"pyramid_lookup_fwd": 2 * CHAIRS_ITERS,
                    "pyramid_lookup_bwd": 2 * CHAIRS_ITERS},
                   "train_cli CLI configuration in process, 2 steps")


class _HashingLoader:
    """A loader whose streams record a SHA-256 of every host batch they
    give (the loop adds no noise here: the chairs stage has none)."""

    def __init__(self, loader):
        self.loader, self.hashes = loader, []

    def batches_from_step(self, step):
        for b in self.loader.batches_from_step(step):
            h = hashlib.sha256()
            for k in sorted(b):
                h.update(np.ascontiguousarray(b[k]).tobytes())
            self.hashes.append(h.hexdigest())
            yield b


def _resume_check(tree: dict, ckpt_dir: str, sd) -> dict:
    """In process, fp32 with TF32 off, the shipped kernel configuration,
    ``device_prefetch=2``: ``train(loader=...)`` for ``RESUME_STEPS``
    steps, against ``RESUME_AT`` steps, a preemption (the ``preempt``
    fault) and the rest.  The host batch stream must be bit-equal, the
    state saved at ``RESUME_AT`` must restore bit for bit (held against
    the live state a validator copies at that step), and the final loss
    and parameters must agree within the tolerance below: cuDNN may sum
    in another order in another run, and Adam turns a near-zero gradient
    entry into a step of up to ``lr`` either way (2 * lr a step)."""
    from raft_tpu_torch import chaos
    from raft_tpu_torch.config import RAFTConfig, TrainConfig
    from raft_tpu_torch.data.datasets import ShardedLoader, fetch_dataset
    from raft_tpu_torch.train import loop
    from raft_tpu_torch.train.checkpoint import CheckpointManager
    from raft_tpu_torch.train.step import init_state

    from raft_tpu_torch import config

    if config.CONV_TF32:
        raise AssertionError("the resume check runs with TF32 off")
    ds = fetch_dataset("chairs", CHAIRS_HW, root=tree["data_root"],
                       split_file=tree["split"])
    mk = lambda: _HashingLoader(ShardedLoader(ds, CHAIRS_B, seed=5))
    mcfg = RAFTConfig.full(**KERNEL_CFG)
    cfg = TrainConfig(name="full", lr=2.5e-4, num_steps=RESUME_STEPS,
                      batch_size=CHAIRS_B, image_size=CHAIRS_HW,
                      iters=CHAIRS_ITERS, val_freq=RESUME_AT, log_freq=100,
                      seed=5, ckpt_dir=ckpt_dir, device_prefetch=2)
    full_loader, timings = mk(), []
    _reset_counts()
    full = loop.train(mcfg, cfg, loader=full_loader, restore_params=sd,
                      timings=timings)
    counts = _expect_train_counts("kernel", RESUME_STEPS,
                                  f"train_cli resume check, "
                                  f"{RESUME_STEPS} steps")
    grabbed = {}

    def grab(state_dict):
        grabbed.update({k: v.detach().clone()
                        for k, v in state_dict.items()})
        return {}

    cut_cfg = dataclasses.replace(cfg, name="cut")
    cut_loader = mk()
    chaos.install(chaos.FaultPlan.parse(f"preempt@step={RESUME_AT}"))
    try:
        loop.train(mcfg, cut_cfg, loader=cut_loader, restore_params=sd,
                   validators={"grab": grab})
        raise AssertionError("the preempt fault did not stop the run")
    except SystemExit as e:
        if e.code != 143:
            raise
    finally:
        chaos.uninstall()
    mgr = CheckpointManager(os.path.join(ckpt_dir, "cut"))
    template = init_state(mcfg, cut_cfg)
    mgr.restore_latest(template)
    restored_equal = template.step == RESUME_AT and all(
        torch.equal(v, grabbed[k])
        for k, v in template.model.state_dict().items())
    del template
    res_loader, res_timings = mk(), []
    resumed = loop.train(mcfg, cut_cfg, loader=res_loader,
                         restore_params=sd, timings=res_timings)
    want = full_loader.hashes[:RESUME_STEPS]
    got = cut_loader.hashes[:RESUME_AT] + \
        res_loader.hashes[:RESUME_STEPS - RESUME_AT]
    p_full = {k: v.detach() for k, v in full.model.named_parameters()}
    p_res = {k: v.detach() for k, v in resumed.model.named_parameters()}
    dp = max(float((p_full[k] - p_res[k]).abs().max()) for k in p_full)
    bit_equal = all(torch.equal(p_full[k], p_res[k]) for k in p_full)
    l_full = float(timings[-1]["loss"])
    l_res = float(res_timings[-1]["loss"])
    rel = abs(l_full - l_res) / max(abs(l_full), 1e-12)
    tol_p = 2 * cfg.lr * (RESUME_STEPS - RESUME_AT)
    res = dict(stream_equal=got == want, restored_bit_equal=restored_equal,
               params_bit_equal=bit_equal, param_max_abs_diff=dp,
               param_tol=tol_p, loss_full=l_full, loss_resumed=l_res,
               loss_rel_diff=rel, loss_tol=1e-3, counts=counts,
               resumed_step=resumed.step)
    print(f"[train_cli] resume check (fp32, TF32 off, prefetch 2): host "
          f"batch stream bit-equal {res['stream_equal']}, step {RESUME_AT} "
          f"restores bit for bit {restored_equal}, final loss {l_full:.6f} "
          f"vs {l_res:.6f} (rel {rel:.2e}, tol 1e-3), parameters max|diff| "
          f"{dp:.3e} (tol {tol_p:.1e}; bit-equal {bit_equal})", flush=True)
    if not (res["stream_equal"] and restored_equal and rel <= 1e-3
            and dp <= tol_p and resumed.step == RESUME_STEPS):
        raise AssertionError(f"train_cli resume check: {res}")

    # the commit of one chairs-model checkpoint on its own
    mgr = CheckpointManager(os.path.join(ckpt_dir, "commit"))
    t0 = time.perf_counter()
    mgr.save_async(RESUME_STEPS, resumed)
    snap_ms = (time.perf_counter() - t0) * 1e3
    mgr.wait()
    res["checkpoint"] = dict(snapshot_ms=snap_ms,
                             commit_ms=mgr.commit_s[-1] * 1e3,
                             bytes=os.path.getsize(os.path.join(
                                 mgr.directory, str(RESUME_STEPS),
                                 "state.pt")))
    mgr.close()
    print(f"[train_cli] checkpoint: save_async returns after "
          f"{snap_ms:.1f} ms (host snapshot), commit "
          f"{res['checkpoint']['commit_ms']:.1f} ms for "
          f"{res['checkpoint']['bytes'] / 2 ** 20:.1f} MiB", flush=True)
    return res


def _loader_step_times(tree: dict, ckpt_dir: str, sd, reused: dict) -> dict:
    """bf16, the shipped configuration, the real loader: ``train()`` at
    ``device_prefetch`` 0 and 2 for ``TIMED_WARM + TIMED_STEPS`` steps
    (ms/step, pairs/s, queue wait, prep and copy: medians of the timed
    steps; exact launch counts), then the same pipeline and step under
    ``torch.profiler`` for the idle share, beside phase train's reused
    batch (``reused``)."""
    from raft_tpu_torch.config import RAFTConfig, TrainConfig
    from raft_tpu_torch.data.datasets import ShardedLoader, fetch_dataset
    from raft_tpu_torch.data.prefetch import CudaBatchPut, DevicePipeline
    from raft_tpu_torch.train import loop
    from raft_tpu_torch.train.step import init_state, make_train_step

    ds = fetch_dataset("chairs", CHAIRS_HW, root=tree["data_root"],
                       split_file=tree["split"])
    workers = min(16, len(os.sched_getaffinity(0)))
    mcfg = RAFTConfig.full(compute_dtype="bfloat16", **KERNEL_CFG)
    n = TIMED_WARM + TIMED_STEPS
    out = {"reused_batch": {k: reused.get(k) for k in
                            ("ms_per_step", "idle_share",
                             "device_busy_ms")}}
    for depth in (0, 2):
        cfg = TrainConfig(name=f"time{depth}", lr=2.5e-4, num_steps=n,
                          batch_size=CHAIRS_B, image_size=CHAIRS_HW,
                          iters=CHAIRS_ITERS, val_freq=10 ** 6,
                          log_freq=100, ckpt_dir=ckpt_dir,
                          device_prefetch=depth)
        timings = []
        _reset_counts()
        loop.train(mcfg, cfg, loader=ShardedLoader(ds, CHAIRS_B, seed=1,
                                                   num_workers=workers),
                   restore_params=sd, timings=timings)
        counts = _expect_train_counts("kernel", n, f"train_cli bf16 "
                                      f"prefetch {depth}, {n} steps")
        med = lambda key: statistics.median(
            t[key] for t in timings[TIMED_WARM:])
        ms = med("step_s") * 1e3
        # the loop's own body under the profiler: pipeline + step
        state = init_state(mcfg, cfg, state_dict=sd)
        step_fn = make_train_step(cfg)
        put = CudaBatchPut(torch.device("cuda"), depth + 1)
        pipe = DevicePipeline(ShardedLoader(ds, CHAIRS_B, seed=2,
                                            num_workers=workers).batches(),
                              put_fn=put.put, ready_fn=put.ready,
                              depth=depth)
        try:
            for _ in range(2):
                step_fn(state, next(pipe))
            prof = _profile(lambda: step_fn(state, next(pipe)), reps=3)
        finally:
            pipe.close()
        del state
        out[f"prefetch_{depth}"] = dict(
            ms_per_step=ms, pairs_per_s=CHAIRS_B / ms * 1e3,
            queue_wait_ms=med("queue_wait_s") * 1e3,
            prep_ms=med("prep_s") * 1e3, h2d_ms=med("h2d_s") * 1e3,
            ms_all=[t["step_s"] * 1e3 for t in timings],
            device_busy_ms=prof["busy_ms"], idle_share=prof["idle_share"],
            profiled_wall_ms=prof["wall_ms"], counts=counts)
        r = out[f"prefetch_{depth}"]
        print(f"[train_cli] bf16 real loader, device_prefetch {depth}: "
              f"{ms:.2f} ms/step ({r['pairs_per_s']:.2f} pairs/s), queue "
              f"wait {r['queue_wait_ms']:.2f} ms, prep {r['prep_ms']:.3f} "
              f"ms, h2d {r['h2d_ms']:.3f} ms, device busy "
              f"{prof['busy_ms']} ms of {prof['wall_ms']:.1f} (idle "
              f"{prof['idle_share']}); reused batch (phase train): "
              f"{out['reused_batch']}", flush=True)
    out["telemetry_on"] = _telemetry_arm(ds, workers, mcfg, ckpt_dir, sd, n,
                                         out["prefetch_2"])
    return out


def _telemetry_arm(ds, workers, mcfg, ckpt_dir, sd, n, off) -> dict:
    """The prefetch-2 arm again with telemetry on (the JSONL, health and
    its forensics ring, tracing at rate 1, the watchdog, the first step
    counted): ms/step (median of the timed steps, and their spread)
    beside the off arm's, and the stream's peak memory, FLOPs a pair and
    MFU."""
    from raft_tpu_torch.config import TrainConfig
    from raft_tpu_torch.data.datasets import ShardedLoader
    from raft_tpu_torch.obs import trace
    from raft_tpu_torch.train import loop

    tel = os.path.join(ckpt_dir, "telemetry_on")
    cfg = TrainConfig(name="time2tel", lr=2.5e-4, num_steps=n,
                      batch_size=CHAIRS_B, image_size=CHAIRS_HW,
                      iters=CHAIRS_ITERS, val_freq=10 ** 6, log_freq=100,
                      ckpt_dir=ckpt_dir, device_prefetch=2,
                      trace_sample_rate=1.0, watchdog_timeout=120.0,
                      forensic_keep=8)
    timings = []
    _reset_counts()
    try:
        loop.train(mcfg, cfg, loader=ShardedLoader(ds, CHAIRS_B, seed=1,
                                                   num_workers=workers),
                   restore_params=sd, timings=timings, telemetry_dir=tel)
    finally:
        trace.reset_default_tracer()
    counts = _expect_train_counts("kernel", n, f"train_cli bf16 prefetch 2 "
                                  f"telemetry on, {n} steps")
    ms_on = [t["step_s"] * 1e3 for t in timings[TIMED_WARM:]]
    ms_off = off["ms_all"][TIMED_WARM:]
    recs = []
    for name in glob.glob(os.path.join(tel, "telemetry-p*.jsonl")):
        with open(name) as f:
            recs += [json.loads(line) for line in f if line.strip()]
    first = lambda ev: next((r for r in recs if r["event"] == ev), {})
    gauge = first("metrics_summary").get("metrics", {}).get(
        "raft_cost_mfu", {}).get("values", {}).get("program=train_step")
    # the counted FLOPs over the median timed step, against the record's
    # peak (the gauge is the last step's alone)
    cost = first("cost_report")
    mfu = (cost.get("flops", 0) / (statistics.median(ms_on) / 1e3)
           / (cost.get("peak_tflops") or float("inf")) / 1e12)
    res = dict(ms_per_step=statistics.median(ms_on),
               ms_min=min(ms_on), ms_max=max(ms_on),
               off_ms_per_step=statistics.median(ms_off),
               off_ms_min=min(ms_off), off_ms_max=max(ms_off),
               ms_all=[t["step_s"] * 1e3 for t in timings],
               hbm=first("hbm_usage"), cost=cost, mfu=mfu, mfu_gauge=gauge,
               compile_s=first("compile").get("seconds"), counts=counts,
               spans=sum(1 for r in recs if r["event"] == "trace_span"))
    res["overhead"] = res["ms_per_step"] / res["off_ms_per_step"] - 1
    print(f"[train_cli] bf16 real loader, device_prefetch 2, telemetry on: "
          f"{res['ms_per_step']:.2f} ms/step (timed steps "
          f"{res['ms_min']:.2f}-{res['ms_max']:.2f}) against off "
          f"{res['off_ms_per_step']:.2f} ({res['off_ms_min']:.2f}-"
          f"{res['off_ms_max']:.2f}), {100 * res['overhead']:+.2f}%; peak "
          f"{res['hbm'].get('peak_hbm_gb')} GiB, reserved "
          f"{res['hbm'].get('reserved_gb')} GiB, args "
          f"{res['hbm'].get('args_gb')} GiB; "
          f"{res['cost'].get('flops_per_pair', 0) / 1e9:.2f} GFLOP a pair, "
          f"{res['cost'].get('bytes', 0) / 2 ** 30:.2f} GiB moved a step "
          f"(unfused bound), MFU {mfu:.4f} at the median step (last "
          f"step's gauge {gauge}); first step {res['compile_s']} s "
          f"(counted); {res['spans']} spans", flush=True)
    if mfu is None or not 0 < mfu <= 1 or not res["hbm"].get("peak_hbm_gb"):
        raise AssertionError(f"telemetry-on arm: {res}")
    return res


def phase_train_cli(sd, train_res):
    """The training entry point on the card (see the module docstring,
    phase 8).  ``sd``: the seed-0 weights; ``train_res``: phase train's
    results (its reused-batch bf16 numbers)."""
    import shutil

    work = os.path.join(WORK, "train_cli")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    res, secs = {}, {}

    def part(name, fn, *a):
        t = time.perf_counter()
        res[name] = fn(*a)
        secs[name] = time.perf_counter() - t
        print(f"[time] train_cli {name}: {secs[name]:.1f} s", flush=True)

    part("tree", _train_tree, work)
    tree = res["tree"]
    part("native", _native_status)
    part("loader", _loader_throughput, tree)
    # phase clis' subprocesses run beside the CLI's: both are checked and
    # neither is timed, and this process launches nothing meanwhile
    clis = _Beside(phase_clis, tree)
    try:
        part("cli", _cli_run, tree, os.path.join(work, "cli"))
    finally:
        t = time.perf_counter()
        clis.join()
        secs["clis_after_cli"] = time.perf_counter() - t
    res["clis"] = clis.result()
    part("cli_counts", _cli_config_counts, tree, os.path.join(work, "cnt"))
    part("resume", _resume_check, tree, os.path.join(work, "resume"), sd)
    part("timing", _loader_step_times, tree, os.path.join(work, "timing"),
         sd, train_res["chairs"]["kernel/bfloat16"])
    res["phase_s"] = secs
    return res


# ---------------------------------------------------------------------------
# phase small: the small model at full width, remat, curriculum, lk-compare
# ---------------------------------------------------------------------------

# the small model's shapes: radius 3 (7 x 7 windows, K = 196 taps over 4
# levels), C = 128 features, hidden 96 (96-channel gate halves), F = 96
# outputs of convc1
SMALL_R, SMALL_C, SMALL_F, SMALL_HIDDEN = 3, 128, 96, 96
SMALL_ITERS, SMALL_CHECK_ITERS = 32, 4
SMALL_ODM_CFG = dict(corr_impl="pallas", fused_gru=True)
SMALL_FUSED_CFG = dict(corr_impl="allpairs_pallas", fused_lookup_encoder=True,
                       upsample_loss_kernel="pallas")
SMALL_PLAIN_CFG = dict(corr_impl="chunked")
# per iteration of the small model's test-mode forward
SMALL_INFER_LAUNCHES = {"ondemand": {"corr_ondemand": 1, "gru_gate_rh": 1,
                                     "gru_gate_blend": 1},
                        "fused": {"lookup_encode": 1}}
# per iteration of a small train step (no upsample-loss kernel: the small
# model has no mask head)
SMALL_TRAIN_LAUNCHES = {
    "kernel": {"pyramid_lookup_fwd": 1, "pyramid_lookup_bwd": 1},
    "ondemand": {"corr_ondemand": 1, "corr_ondemand_bwd": 1,
                 "gru_gate_rh": 1, "gru_gate_rh_bwd": 1,
                 "gru_gate_blend": 1, "gru_gate_blend_bwd": 1}}
# remat sweep: (label, remat, remat_policy, remat_upsample)
REMAT_POLICIES = (("none", False, "save_corr", False),
                  ("save_corr", True, "save_corr", False),
                  ("full", True, "full", False),
                  ("dots", True, "dots", False),
                  ("save_corr+up", True, "save_corr", True))
REMAT_STEPS = (2, 5)          # warm-up (eager, capture), timed
# fp32 gradients of a remat policy against none: the recompute runs the
# same cuDNN calls on the same inputs, but cuDNN may pick other
# algorithms in another memory state; the bound of phase train_cli's
# resume check
REMAT_GRAD_REL = 1e-3


def phase_small_kernels(peaks) -> dict:
    """Each kernel of the small model's paths at its shapes against its
    plain version, timed beside its bound (the formulas of phase
    kernels)."""
    from raft_tpu_torch.ops.corr import (build_corr_pyramid,
                                         chunked_corr_lookup,
                                         pool_fmap_pyramid)
    from raft_tpu_torch.ops.corr_kernels import (_plain,
                                                 corr_lookup_ondemand_nchw,
                                                 kernel_path_counts)
    from raft_tpu_torch.ops.lookup_encode import (
        _kpad, pyramid_lookup_encode, pyramid_lookup_encode_bwd_plain,
        pyramid_lookup_encode_plain)
    from raft_tpu_torch.ops.pyramid_kernels import (
        pyramid_lookup_nchw, pyramid_lookup_plain,
        pyramid_lookup_quantized_nchw)

    dev = torch.device("cuda")
    rng = np.random.default_rng(12)
    res = {}
    r, c, k = SMALL_R, SMALL_C, 2 * SMALL_R + 1
    P = LEVELS * k * k
    # --- on-demand forward at the Sintel grid, C 128, r 3, (a) (b) (c) ---
    h8, w8 = 440 // 8, SINTEL_HW[1] // 8
    with torch.inference_mode():
        for dist in CENTERS:
            f1, f2, coords = _corr_inputs(rng, 1, h8, w8, dev, dist, c)
            pyr = [p.contiguous() for p in pool_fmap_pyramid(f2, LEVELS)]
            got = corr_lookup_ondemand_nchw(f1, pyr, coords, r)
            want = _plain(f1, pyr, coords, r).permute(0, 3, 1, 2)
            err = _check(f"small corr_ondemand ({dist}) {tuple(got.shape)}",
                         got, want)
            paths = kernel_path_counts(f1, pyr, coords, r)["fwd"]
            tk = _timed(lambda: corr_lookup_ondemand_nchw(f1, pyr, coords, r),
                        "corr_ondemand_kernel")
            tp = (_timed(lambda: chunked_corr_lookup(f1, pyr, coords, r),
                         None, reps=10) if dist == "a" else {"ms": None})
            shapes = [tuple(p.shape[1:3]) for p in pyr]
            nbytes = 4 * (f1.numel() + coords.numel() + want.numel()
                          + sum(p.numel() for p in pyr))
            _record(res, f"corr_ondemand/{dist}", err, tk, tp, nbytes,
                    _corr_ops(coords.cpu().numpy(), shapes, k, c), peaks,
                    paths=paths, box_share=_box_share(paths))
    # --- on-demand backward at the chairs grid ---
    B = CHAIRS_B
    hc, wc = CHAIRS_HW[0] // 8, CHAIRS_HW[1] // 8
    for dist in CENTERS:
        res[f"corr_ondemand_bwd/{dist}"] = _corr_bwd_case(
            rng, B, hc, wc, "small chairs r3 C128", peaks,
            time_plain=dist == "a", dist=dist, r=r, c=c)

    # --- pyramid lookup forward / backward, r 3, fp32 and bf16 ---
    f1, f2, coords = _corr_inputs(rng, B, hc, wc, dev, "a", c)
    N = hc * wc
    shapes = [(hc >> l, wc >> l) for l in range(LEVELS)]
    win = _window_elems(coords.cpu().numpy(), shapes, k)
    g = torch.from_numpy(rng.standard_normal((B, P, hc, wc)).astype(
        np.float32)).to(dev)
    for dtype in (torch.float32, torch.bfloat16):
        dt = "fp32" if dtype == torch.float32 else "bf16"
        es = 4 if dtype == torch.float32 else 2
        with torch.no_grad():
            pyr = build_corr_pyramid(f1, f2, LEVELS, dtype)
        pyr = [lv.requires_grad_(True) for lv in pyr]
        got = pyramid_lookup_nchw(pyr, coords, r, dtype)
        want = pyramid_lookup_plain(pyr, coords, r, dtype).permute(0, 3, 1, 2)
        err_f = _check(f"small pyramid_lookup_fwd r3 {dt} "
                       f"{tuple(got.shape)}", got, want)
        gg = g.to(dtype)
        dk = torch.autograd.grad(got, pyr, gg, retain_graph=True)
        dp = torch.autograd.grad(want, pyr, gg, retain_graph=True)
        err_b = max(_check(f"small pyramid_lookup_bwd r3 {dt} level {i}",
                           a, b_) for i, (a, b_) in enumerate(zip(dk, dp)))
        with torch.no_grad():
            tk = _timed(lambda: pyramid_lookup_nchw(pyr, coords, r, dtype),
                        "pyr_fwd_kernel")
            tp = _timed(lambda: pyramid_lookup_plain(pyr, coords, r, dtype),
                        None, reps=10)
        tkb = _timed(lambda: torch.autograd.grad(got, pyr, gg,
                                                 retain_graph=True),
                     "pyr_bwd_kernel", reps=10)
        tpb = _timed(lambda: torch.autograd.grad(want, pyr, gg,
                                                 retain_graph=True),
                     None, reps=5)
        lvl_bytes = sum(lv.numel() for lv in pyr) * es
        _record(res, f"pyramid_lookup_fwd/{dt}", err_f, tk, tp,
                win * es + coords.numel() * 4 + B * P * N * es,
                9.0 * B * N * P, peaks)
        _record(res, f"pyramid_lookup_bwd/{dt}", err_b, tkb, tpb,
                lvl_bytes + B * P * N * es + coords.numel() * 4, 12.0 * win,
                peaks)
        del pyr, got, want, dk, dp
    # --- the quantized forward, r 3, int8 codes -> fp32 / bf16 taps ---
    with torch.no_grad():
        qpyr = build_corr_pyramid(f1, f2, LEVELS, "int8")
        for out_dtype in (torch.float32, torch.bfloat16):
            dt = "fp32" if out_dtype == torch.float32 else "bf16"
            got = pyramid_lookup_quantized_nchw(qpyr, coords, r, out_dtype)
            want = pyramid_lookup_plain(qpyr, coords, r, out_dtype).permute(
                0, 3, 1, 2)
            err = _check(f"small pyramid_lookup_quantized r3 int8 -> {dt}",
                         got, want)
            tk = _timed(lambda: pyramid_lookup_quantized_nchw(
                qpyr, coords, r, out_dtype), "pyr_fwd_kernel")
            tp = _timed(lambda: pyramid_lookup_plain(qpyr, coords, r,
                                                     out_dtype), None,
                        reps=10)
            _record(res, f"pyramid_lookup_quantized/int8/{dt}", err, tk, tp,
                    win + coords.numel() * 4 + B * LEVELS * 4
                    + B * P * N * got.element_size(), 10.0 * B * N * P,
                    peaks)
    # --- fused lookup + convc1: K 196 (padded to 200), F 96 ---
    import torch.nn.functional as F_

    gen = torch.Generator().manual_seed(13)
    Fc = SMALL_F
    w = (torch.randn(Fc, P, 1, 1, generator=gen) / P ** 0.5).to(dev)
    b = (torch.randn(Fc, generator=gen) * 0.1).to(dev)
    w.requires_grad_(True)
    b.requires_grad_(True)
    cot32 = torch.randn(B, Fc, hc, wc, generator=gen).to(dev)
    print(f"[small] lookup_encode: K {P} padded to {_kpad(LEVELS, r)}, F "
          f"{Fc}", flush=True)
    for label, store, out_dtype in (
            ("fp32", torch.float32, torch.float32),
            ("bf16", torch.bfloat16, torch.bfloat16),
            ("int8", "int8", torch.float32)):
        with torch.no_grad():
            pyr = build_corr_pyramid(f1, f2, LEVELS, store)
        quantized = not torch.is_tensor(pyr[0])
        if not quantized:
            pyr = [lv.requires_grad_(True) for lv in pyr]
        leaves = [w, b] + ([] if quantized else pyr)
        got = pyramid_lookup_encode(pyr, coords, r, w, b, out_dtype)
        if got.shape != (B, Fc, hc, wc):
            raise AssertionError(f"lookup_encode F={Fc}: {tuple(got.shape)}")
        with torch.no_grad():
            want = pyramid_lookup_encode_plain(pyr, coords, r, w, b,
                                               out_dtype)
        err_f = _check(f"small lookup_encode fwd {label} F={Fc} "
                       f"{tuple(got.shape)}", got, want)
        cot = cot32.to(out_dtype)
        dk = torch.autograd.grad(got, leaves, cot, retain_graph=True)
        dw, db, dl = pyramid_lookup_encode_bwd_plain(pyr, coords, r, w,
                                                     got.detach(), cot)
        err_b = max(_check(f"small lookup_encode bwd {label} {n}", a, d)
                    for n, a, d in zip(
                        ["dW", "db"] + [f"dlevel{i}" for i in range(LEVELS)],
                        dk, [dw, db] + (dl or [])))
        wc_, bc_ = w.detach().to(out_dtype), b.detach().to(out_dtype)
        lookup = (pyramid_lookup_quantized_nchw if quantized
                  else pyramid_lookup_nchw)
        with torch.no_grad():
            tk = _timed(lambda: pyramid_lookup_encode(
                pyr, coords, r, w, b, out_dtype), "lookup_encode_kernel")
            tp = _timed(lambda: pyramid_lookup_encode_plain(
                pyr, coords, r, w, b, out_dtype), None, reps=10)
            tu = _timed(lambda: torch.relu(F_.conv2d(
                lookup(pyr, coords, r, out_dtype), wc_, bc_)), None)
        es_s = 1 if quantized else pyr[0].element_size()
        nb = (win * es_s + coords.numel() * 4 + w.numel() * 4 + Fc * 4
              + (B * LEVELS * 4 if quantized else 0)
              + B * Fc * N * got.element_size())
        ops = 2.0 * B * N * P * Fc + 9.0 * B * N * P
        t_tc = 3 * 2.0 * B * N * P * Fc / peaks[2] * 1e3
        t_bytes = nb / peaks[0] * 1e3
        bound, by = max(t_tc, t_bytes), ("operations" if t_tc >= t_bytes
                                         else "bytes")
        res[f"lookup_encode/{label}"] = dict(
            max_abs_err=max(err_f, err_b), ms=tk["ms"], plain_ms=tp["ms"],
            library_ms=None, unfused_ms=tu["ms"], bound_ms=bound,
            bound_by=by, bytes=nb, ops=ops, kernel_timing=tk,
            plain_timing=tp, unfused_timing=tu)
        print(f"[small] lookup_encode/{label} F={Fc}: kernel {tk['ms']} ms, "
              f"plain {tp['ms']}, unfused lookup + conv1x1 + relu "
              f"{tu['ms']}, bound {bound:.4f} ms ({by}, 3xTF32), kernel/"
              f"unfused {tk['ms'] / tu['ms']:.3f}", flush=True)
        del pyr, got, want, leaves, dk
    torch.cuda.empty_cache()

    # --- the gates at 96 channels: forward at the Sintel grid (B = 1),
    # backward at the chairs grid, the halves of one conv output; rh's
    # gradient the first 96 channels of cat([rh, x])'s (x: 64 context + 82
    # motion channels), as in ConvGRU ---
    for dtype in (torch.float32, torch.bfloat16):
        dt = "fp32" if dtype == torch.float32 else "bf16"
        cases = {**_gate_fwd_case(rng, 1, SMALL_HIDDEN, h8, w8, dtype, peaks,
                                  "[small]"),
                 **_gate_bwd_case(rng, B, SMALL_HIDDEN, 146, hc, wc, dtype,
                                  peaks, "[small]")}
        for name, rec in cases.items():
            res[f"{name}/{dt}"] = rec
        vec_bytes = cases["gru_gate_rh_bwd"]["vector_bytes"]
        if vec_bytes != 16:
            raise AssertionError(f"gate_plan: {vec_bytes}-byte accesses, "
                                 "not the 16-byte path")
    for name in ("corr_ondemand", "corr_ondemand_bwd"):
        res[name] = res[f"{name}/a"]
    for name in ("pyramid_lookup_fwd", "pyramid_lookup_bwd", "gru_gate_rh",
                 "gru_gate_blend", "gru_gate_rh_bwd", "gru_gate_blend_bwd"):
        res[name] = res[f"{name}/fp32"]
    res["pyramid_lookup_quantized"] = res["pyramid_lookup_quantized/int8/fp32"]
    res["lookup_encode"] = res["lookup_encode/int8"]
    torch.cuda.empty_cache()
    return res


def _small_model(sd, extra, dtype, dev):
    from raft_tpu_torch.config import RAFTConfig
    from raft_tpu_torch.models.raft import RAFT

    model = RAFT(RAFTConfig.small_model(compute_dtype=dtype, **extra))
    model.load_state_dict(sd)
    return model.to(dev).eval()


def _small_inference(sd) -> tuple:
    """The small model's test mode at the Sintel size (440x1024, B = 1):
    each kernel configuration against the plain one at 4 iterations in
    fp32 (1e-3 px), then 32 iterations in fp32 and bf16 (ms/pair, device
    busy and idle share, peak memory) with exact launch counts; the
    on-demand configuration's first fp32 run is its main path."""
    from raft_tpu_torch.ops.pad import InputPadder

    dev = torch.device("cuda")
    img1, img2 = _frames(dev)
    img1, img2 = InputPadder(img1.shape).pad(img1, img2)
    out, main = {}, {}
    with torch.no_grad():
        plain = _small_model(sd, SMALL_PLAIN_CFG, "float32", dev)
        _, up_p = plain(img1, img2, iters=SMALL_CHECK_ITERS, test_mode=True)
        del plain
        for label, extra in (("ondemand", SMALL_ODM_CFG),
                             ("fused", SMALL_FUSED_CFG)):
            model = _small_model(sd, extra, "float32", dev)
            _reset_counts()
            _, up_k = model(img1, img2, iters=SMALL_CHECK_ITERS,
                            test_mode=True)
            torch.cuda.synchronize()
            _expect({k: v * SMALL_CHECK_ITERS
                     for k, v in SMALL_INFER_LAUNCHES[label].items()},
                    f"small {label} iters={SMALL_CHECK_ITERS}")
            err = float((up_k - up_p).abs().max())
            print(f"[small] 440x1024 iters={SMALL_CHECK_ITERS}: {label} vs "
                  f"plain config max|dflow_up| {err:.3e} px (tol 1e-3); "
                  f"|flow_up| max {float(up_p.abs().max()):.3f}", flush=True)
            if not (torch.isfinite(up_k).all() and err <= 1e-3):
                raise AssertionError(f"small {label} vs plain: {err}")
            out[f"{label}_vs_plain_iters4_px"] = err
            del model, up_k
        for dtype in ("float32", "bfloat16"):
            for label, extra in (("ondemand", SMALL_ODM_CFG),
                                 ("fused", SMALL_FUSED_CFG)):
                model = _small_model(sd, extra, dtype, dev)
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                model(img1, img2, iters=SMALL_ITERS, test_mode=True)
                torch.cuda.synchronize()
                times = []
                for i in range(5):
                    _reset_counts()
                    t0 = time.perf_counter()
                    lo, up = model(img1, img2, iters=SMALL_ITERS,
                                   test_mode=True)
                    torch.cuda.synchronize()
                    times.append((time.perf_counter() - t0) * 1e3)
                    counts = _expect(
                        {k: v * SMALL_ITERS for k, v in
                         SMALL_INFER_LAUNCHES[label].items()},
                        f"small {label} {dtype} iters={SMALL_ITERS} run {i}")
                    if i == 0 and dtype == "float32":
                        main[label] = counts
                peak = torch.cuda.max_memory_allocated()
                if not (torch.isfinite(up).all()
                        and up.shape == img1.shape[:3] + (2,)):
                    raise AssertionError(f"small {label} {dtype}: bad flow")
                prof = _profile(lambda: model(img1, img2, iters=SMALL_ITERS,
                                              test_mode=True), reps=2)
                wall = statistics.median(times)
                key = f"{label}/{dtype}"
                out[key] = dict(ms_per_pair=wall, ms_all=times,
                                peak_mem_mb=peak / 2 ** 20,
                                device_busy_ms=prof["busy_ms"],
                                idle_share=prof["idle_share"],
                                by_kind=prof["by_kind"])
                print(f"[small] 440x1024 iters={SMALL_ITERS} {key}: "
                      f"{wall:.2f} ms/pair (runs "
                      f"{', '.join(f'{t:.2f}' for t in times)}), device busy "
                      f"{prof['busy_ms']} ms/pair of {prof['wall_ms']:.2f} "
                      f"profiled (idle {prof['idle_share']}), by kind "
                      f"{prof['by_kind']}, peak {peak / 2 ** 20:.1f} MiB",
                      flush=True)
                del model, lo, up
    torch.cuda.empty_cache()
    return out, main


SMALL_TRAIN = (("kernel", dict(corr_impl="allpairs_pallas",
                               upsample_loss_kernel="pallas"),
                ("float32", "bfloat16")),
               ("ondemand", dict(SMALL_ODM_CFG, upsample_loss_kernel="pallas"),
                ("float32",)))


def _small_train(sd) -> tuple:
    """The small model's chairs-stage train step (368x496, B = 8, 12
    iterations): each kernel configuration against its plain one for one
    step (phase train's bounds), then 2 warm-up and 5 timed steps with
    exact launch counts (ms/step, pairs/s, peak memory, idle share)."""
    from raft_tpu_torch.config import RAFTConfig, TrainConfig
    from raft_tpu_torch.train.step import init_state, make_train_step

    dev = torch.device("cuda")
    batch = _chairs_batch(dev)
    cfg = TrainConfig(lr=2.5e-4, num_steps=120000, batch_size=CHAIRS_B,
                      image_size=CHAIRS_HW, iters=CHAIRS_ITERS, wdecay=1e-4)
    step_fn = make_train_step(cfg)
    out, main = {}, {}
    for label, extra, dtypes in SMALL_TRAIN:
        for dtype in dtypes:
            out[f"{label}_vs_plain/{dtype}"] = compare_train_step(
                sd, batch, cfg, dtype, label, mk=RAFTConfig.small_model)
            state = init_state(RAFTConfig.small_model(compute_dtype=dtype,
                                                      **extra), cfg,
                               state_dict=sd)
            _warm(lambda: step_fn(state, batch))          # eager, capture
            times, losses = [], []
            per_step = {k: v * CHAIRS_ITERS
                        for k, v in SMALL_TRAIN_LAUNCHES[label].items()}
            for i in range(5):
                _reset_counts()
                t0 = time.perf_counter()
                _, met = step_fn(state, batch)
                losses.append(met["loss"])
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
                counts = _expect(per_step, f"small train {label} {dtype} "
                                           f"step {i}")
                if i == 0 and dtype == "float32":
                    main[label] = counts
            peak = torch.cuda.max_memory_allocated()
            losses = [float(x) for x in losses]
            if not (np.isfinite(losses).all() and state.nonfinite_steps == 0):
                raise AssertionError(f"small train {label} {dtype}: {losses}")
            prof = _profile(lambda: step_fn(state, batch), reps=2)
            wall = statistics.median(times)
            key = f"{label}/{dtype}"
            out[key] = dict(ms_per_step=wall, ms_all=times,
                            pairs_per_s=CHAIRS_B / wall * 1e3,
                            peak_mem_mb=peak / 2 ** 20,
                            device_busy_ms=prof["busy_ms"],
                            idle_share=prof["idle_share"],
                            by_kind=prof["by_kind"], losses=losses)
            print(f"[small] chairs train {key}: {wall:.2f} ms/step "
                  f"({CHAIRS_B / wall * 1e3:.2f} pairs/s; steps "
                  f"{', '.join(f'{t:.1f}' for t in times)}), device busy "
                  f"{prof['busy_ms']} ms/step (idle {prof['idle_share']}), "
                  f"peak {peak / 2 ** 20:.1f} MiB, losses {losses[0]:.4f} .. "
                  f"{losses[-1]:.4f}", flush=True)
            del state
            torch.cuda.empty_cache()
    return out, main


def _remat_sweep(sd) -> dict:
    """The full model's shipped kernel configuration (``allpairs_pallas`` +
    the upsample-loss kernel) in bf16 under each remat policy at the
    chairs (368x496, B = 8) and things (400x720, B = 5) stages: peak
    memory, ms/step and launch counts per step; then fp32 with TF32 off,
    one chairs step's gradients under each policy against none."""
    from raft_tpu_torch.config import RAFTConfig, TrainConfig
    from raft_tpu_torch.train.step import init_state, make_train_step

    dev = torch.device("cuda")
    rng = np.random.default_rng(4)
    stages = {"chairs": (CHAIRS_B, CHAIRS_HW), "things": (5, (400, 720))}
    out = {}
    for stage, (B, (H, W)) in stages.items():
        if stage == "chairs":
            batch = _chairs_batch(dev)
        else:
            batch = {"image1": rng.uniform(0, 255, (B, H, W, 3)),
                     "image2": rng.uniform(0, 255, (B, H, W, 3)),
                     "flow": 8.0 * rng.standard_normal((B, H, W, 2)),
                     "valid": np.ones((B, H, W))}
            batch = {k: torch.from_numpy(v.astype(np.float32)).to(dev)
                     for k, v in batch.items()}
        cfg = TrainConfig(lr=2.5e-4, num_steps=120000, batch_size=B,
                          image_size=(H, W), iters=CHAIRS_ITERS)
        step_fn = make_train_step(cfg)
        for label, remat, policy, up in REMAT_POLICIES:
            mcfg = RAFTConfig.full(compute_dtype="bfloat16", remat=remat,
                                   remat_policy=policy, remat_upsample=up,
                                   **KERNEL_CFG)
            torch.cuda.empty_cache()
            state = init_state(mcfg, cfg, state_dict=sd)
            _warm(lambda: step_fn(state, batch), REMAT_STEPS[0])
            resident = torch.cuda.memory_allocated()
            times = []
            for i in range(REMAT_STEPS[1]):
                _reset_counts()
                t0 = time.perf_counter()
                _, met = step_fn(state, batch)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
                # the lookup once an iteration, again in backward when the
                # step's region holds it (full, dots); the upsample-loss
                # forward again in backward under remat_upsample
                it = CHAIRS_ITERS * (2 if policy in ("full", "dots") and remat
                                     else 1)
                counts = _expect({"pyramid_lookup_fwd": it,
                                  "pyramid_lookup_bwd": CHAIRS_ITERS,
                                  "upsample_loss_fwd": 2 if up else 1,
                                  "upsample_loss_bwd": 1},
                                 f"remat {stage} {label} step {i}")
            peak = torch.cuda.max_memory_allocated()
            if not (np.isfinite(float(met["loss"]))
                    and state.nonfinite_steps == 0):
                raise AssertionError(f"remat {stage} {label}: "
                                     f"{met['loss']}")
            wall = statistics.median(times)
            out[f"{stage}/{label}"] = dict(
                peak_mem_mb=peak / 2 ** 20, resident_mb=resident / 2 ** 20,
                ms_per_step=wall, ms_all=times, launches=counts,
                pairs_per_s=B / wall * 1e3)
            print(f"[remat] {stage} bf16 {label}: peak {peak / 2 ** 20:.1f} "
                  f"MiB (resident {resident / 2 ** 20:.1f}), {wall:.2f} "
                  f"ms/step ({B / wall * 1e3:.2f} pairs/s; steps "
                  f"{', '.join(f'{t:.1f}' for t in times)}), launches "
                  f"{counts}", flush=True)
            del state
    torch.cuda.empty_cache()
    # fp32, TF32 off: each policy's unclipped gradients against none
    batch = _chairs_batch(dev)
    cfg = TrainConfig(lr=2.5e-4, num_steps=120000, batch_size=CHAIRS_B,
                      image_size=CHAIRS_HW, iters=CHAIRS_ITERS, clip=1e9)
    ref = None
    for label, remat, policy, up in REMAT_POLICIES:
        met, grads = _step_grads(sd, batch, cfg, RAFTConfig.full(
            remat=remat, remat_policy=policy, remat_upsample=up,
            **KERNEL_CFG))
        if ref is None:
            ref = (met, grads)
            continue
        loss_rel = abs(float(met["loss"]) - float(ref[0]["loss"])) / abs(
            float(ref[0]["loss"]))
        gmax = max(float(g.abs().max()) for g in ref[1].values())
        worst = max(float((grads[n] - g).abs().max()) / (
            REMAT_GRAD_REL * float(g.abs().max()) + FP32_GRAD_FLOOR * gmax)
            for n, g in ref[1].items())
        bit_equal = all(torch.equal(grads[n], g) for n, g in ref[1].items())
        out[f"fp32_grads/{label}"] = dict(loss_rel=loss_rel,
                                          entry_ratio=worst,
                                          bit_equal=bit_equal)
        print(f"[remat] chairs fp32 {label} vs none: loss rel "
              f"{loss_rel:.3e}, worst gradient {worst:.4f} of its bound "
              f"({REMAT_GRAD_REL} of the parameter's largest entry + "
              f"{FP32_GRAD_FLOOR} of the model's), bit-equal {bit_equal}",
              flush=True)
        if not (loss_rel <= 1e-5 and worst <= 1.0):
            raise AssertionError(f"remat {label}: gradients off none")
        del grads
    torch.cuda.empty_cache()
    return out


def _small_clis(tree: dict, work: str, sd) -> dict:
    """``python -m raft_tpu_torch curriculum`` on two small stages of a few
    steps over phase train_cli's chairs tree, killed by ``stage_kill``
    between them and resumed; ``lk-compare --small`` on the demo frames
    runs beside it."""
    from PIL import Image

    res = {}
    weights = os.path.join(work, "small.pth")
    torch.save(sd, weights)
    frames = [os.path.join(REPO, "demo-frames", f"frame_000{i}.png")
              for i in (0, 1)]
    out_png = os.path.join(work, "lk_vs_raft.png")
    t0 = time.perf_counter()
    lk = _Child(["lk-compare", "--small", "--model", weights, "--image1",
                 frames[0], "--image2", frames[1], "--out", out_png])
    try:
        res["curriculum"] = _curriculum(tree, work)
        rc = lk.finish(600)
    finally:
        lk.kill()
    lines = lk.lines
    h, w = np.asarray(Image.open(frames[0])).shape[:2]
    shape = (np.asarray(Image.open(out_png)).shape
             if os.path.isfile(out_png) else None)
    median = [float(m.group(1)) for ln in lines
              for m in [re.search(r"median \|LK - RAFT\| = ([\d.]+)px", ln)]
              if m]
    print(f"[clis] lk-compare --small: rc {rc}, image {shape} (frame "
          f"{h}x{w}), median |LK - RAFT| {median} px "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    if rc != 0 or shape != (h, 2 * w, 3) or len(median) != 1:
        raise AssertionError(f"lk-compare: rc {rc}, {shape}: "
                             + "\n".join(lines[-20:]))
    res["lk_compare"] = dict(rc=rc, shape=shape, median_px=median[0])
    return res


def _curriculum(tree: dict, work: str) -> dict:
    """The curriculum CLI on two small stages, killed by ``stage_kill``
    between them and resumed."""
    from raft_tpu_torch.train.checkpoint import CheckpointManager

    manifest = os.path.join(work, "manifest.json")
    with open(manifest, "w") as f:
        json.dump({"base": {"num_steps": 3, "val_freq": 3},
                   "stages": [{"name": "s1", "stage": "chairs",
                               "overrides": {}},
                              {"name": "s2", "stage": "chairs",
                               "overrides": {"lr": 1e-4}}]}, f)
    wd = os.path.join(work, "curriculum")
    args = ["curriculum", "--workdir", wd, "--manifest", manifest,
            "--small", "--precision", "bf16", "--batch_size", str(CHAIRS_B),
            "--image_size", *map(str, CHAIRS_HW), "--iters",
            str(CHAIRS_ITERS), "--data_root", tree["data_root"],
            "--chairs_split", tree["split"]]
    from raft_tpu_torch import chaos

    t0 = time.perf_counter()
    # the fault goes to this child alone: phase train_cli's CLIs run beside
    rc1, lines1 = _run_cli(*args, env={chaos.ENV_SPEC: "stage_kill@step=1"})
    with open(os.path.join(wd, "curriculum_ledger.json")) as f:
        led1 = json.load(f)
    stages1 = {n: e["status"] for n, e in led1["stages"].items()}
    print(f"[clis] curriculum under stage_kill@step=1: rc {rc1}, stages "
          f"{stages1} ({time.perf_counter() - t0:.1f} s)", flush=True)
    if rc1 != 143 or stages1 != {"s1": "complete", "s2": "pending"}:
        raise AssertionError(f"curriculum stage_kill: rc {rc1}, {stages1}: "
                             + "\n".join(lines1[-20:]))
    t0 = time.perf_counter()
    rc2, lines2 = _run_cli(*args)
    with open(os.path.join(wd, "curriculum_ledger.json")) as f:
        led2 = json.load(f)
    stages2 = {n: (e["status"], e.get("final_step"), e["runs"])
               for n, e in led2["stages"].items()}
    seeded = any(ln.startswith("restored weights from")
                 and ln.rstrip().endswith(os.path.join("checkpoints", "s1"))
                 for ln in lines2)
    s2_steps = CheckpointManager(os.path.join(wd, "checkpoints",
                                              "s2")).all_steps()
    print(f"[clis] curriculum rerun: rc {rc2}, stages {stages2}, s2 seeded "
          f"from s1 {seeded}, s2 steps {s2_steps} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    if (rc2 != 0 or stages2 != {"s1": ("complete", 3, 1),
                                "s2": ("complete", 3, 1)}
            or not seeded or s2_steps != [3]):
        raise AssertionError(f"curriculum rerun: rc {rc2}, {stages2}: "
                             + "\n".join(lines2[-20:]))
    return dict(kill_rc=rc1, kill_stages=stages1, rerun_rc=rc2,
                rerun_stages=stages2, seeded=seeded)


def phase_small(sd_full, tree):
    """The small model at full width (see the module docstring, phase 14;
    its kernels are phase small_kernels').  ``sd_full``: the full model's
    seed-0 weights (the remat sweep); ``tree``: phase train_cli's
    synthetic chairs tree."""
    import shutil

    from raft_tpu_torch.config import RAFTConfig
    from raft_tpu_torch.models.raft import RAFT

    work = os.path.join(WORK, "small")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    sd = RAFT(RAFTConfig.small_model(), seed=0).state_dict()
    res, secs = {}, {}

    def part(name, fn, *a):
        t = time.perf_counter()
        res[name] = fn(*a)
        secs[name] = time.perf_counter() - t
        print(f"[time] small {name}: {secs[name]:.1f} s", flush=True)

    part("inference", _small_inference, sd)
    part("train", _small_train, sd)
    part("remat", _remat_sweep, sd_full)
    res["inference"], infer_main = res["inference"]
    res["train"], train_main = res["train"]
    res["main_counts"] = {"inference": infer_main, "train": train_main}
    res["phase_s"] = secs
    return res


# --- phase serve: the serving engine on the card ---------------------------

SERVE_HW = SINTEL_HW                 # 436 x 1024 -> bucket 440 x 1024
SERVE_BUCKET = (440, 1024)
SERVE_ITERS, SERVE_SLOTS, SERVE_CHECK_ITERS = 32, 8, 4
SERVE_CONFIGS = {"allpairs": {}, "kernel": dict(corr_impl="pallas",
                                                fused_gru=True)}
SERVE_PLAIN_CFG = dict(corr_impl="chunked", fused_gru=False)
SERVE_PAIRS = 8                      # distinct pairs of the checks
# closed loop: 8 x 16 = 128 requests (p99 over 128 samples), then 8 x 2
# traced for the busy and idle share (~4 request-mode batches at the
# 3.9 of 8 they fill, ~16 admissions in slot mode)
SERVE_LOOP_CLIENTS, SERVE_LOOP_REQS, SERVE_TRACED_REQS = 8, 16, 2
# request mode's memory: Sintel, KITTI and FlyingChairs frames
SERVE_MEMORY_SHAPES = (SINTEL_HW, (375, 1242), (384, 512))
SERVE_BUDGETS = (8, 16, 32)
# one serving replay of each program: the kernels it launches (the full
# model's separable ConvGRU runs its gates twice an iteration)
SERVE_REPLAY_LAUNCHES = {
    "allpairs": {"enc": {}, "iter": {}, "up": {}},
    "kernel": {"enc": {}, "iter": {"corr_ondemand": 1, "gru_gate_rh": 2,
                                   "gru_gate_blend": 2}, "up": {}}}


def _serve_pairs(n: int = SERVE_PAIRS):
    """``n`` frame pairs, each a seeded texture and the texture moved by
    (2, 1) px, as float32 (436, 1024, 3) arrays."""
    out = []
    for j in range(n):
        base = _texture(40 + j, *SERVE_HW)
        out.append(tuple(_shifted(base, SERVE_HW, k, (2, 1)).astype(
            np.float32) for k in (0, 1)))
    return out


def _serve_clip(n: int = 8, seed: int = 60):
    """An ``n``-frame clip of one texture moving by (2, 1) px a frame."""
    base = _texture(seed, *SERVE_HW)
    return [_shifted(base, SERVE_HW, k, (2, 1)).astype(np.float32)
            for k in range(n)]


def _serve_engine(sd, cfg_kw: dict, dtype: str, budget=None, **serve_kw):
    from raft_tpu_torch.config import RAFTConfig
    from raft_tpu_torch.serve import InferenceEngine, ServeConfig

    cfg = RAFTConfig.full(compute_dtype=dtype, **cfg_kw)
    serve_kw.setdefault("iters", SERVE_ITERS)
    return InferenceEngine(sd, cfg, ServeConfig(**serve_kw),
                           resident_budget_bytes=budget).start()


def _free():
    """Give the memory of dropped engines and graphs back (an engine holds
    reference cycles, so only a collection frees its graphs): call it after
    the caller's last reference is gone."""
    import gc

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def _one_batch(eng, pairs, **kw):
    """Submit ``pairs`` while the device worker is held, so that request
    mode coalesces them into one batch; their flows in order."""
    import threading

    gate = threading.Event()
    eng._device_pool.submit(gate.wait)
    futs = [eng.submit(a, b, **kw) for a, b in pairs]
    time.sleep(0.2)
    gate.set()
    return [f.result(timeout=600) for f in futs]


def _wait(pred, what: str, timeout: float = 300):
    t0 = time.monotonic()
    while not pred():
        if time.monotonic() - t0 > timeout:
            raise AssertionError(f"serve: timed out waiting for {what}")
        time.sleep(0.002)


def _one_capture_per_key(eng, label: str, programs, once=()) -> dict:
    """One capture of each program of ``programs`` over every call, and at
    most one of each of ``once`` (programs a run calls once: their one
    call is the key's eager warm-up, nothing is captured)."""
    counts = eng.capture_counter.counts()
    want = {(SERVE_BUCKET, lanes, p): 1 for lanes, p in programs}
    print(f"[serve] {label} captures {counts}", flush=True)
    rest = {k: v for k, v in counts.items() if k not in want}
    if ({k: counts.get(k) for k in want} != want or set(rest.values()) - {1}
            or {k[2] for k in rest} - set(once)):
        raise AssertionError(f"serve {label}: captures {counts} != {want}")
    return {f"{k[0][0]}x{k[0][1]}/b{k[1]}/{k[2]}": v
            for k, v in counts.items()}


def _replay_launches(eng, label: str, lanes: int) -> dict:
    """Launch counts of one replay of each program of ``(bucket, lanes)``
    (run with no lane admitted, so the state stays as it is): exactly the
    kernels of ``SERVE_REPLAY_LAUNCHES``."""
    progs = eng._get_programs(SERVE_BUCKET, lanes)
    H, W = SERVE_BUCKET
    zeros = np.zeros((lanes, H, W, 3), np.float32)
    budgets = np.zeros((lanes,), np.int32)
    got = {}

    def run():
        for prog, fn in (("enc", lambda: progs.encode(
                zeros, zeros, progs.admit_none, budgets)),
                ("iter", lambda: progs.iterate(0.0)),
                ("up", progs.upsample)):
            _reset_counts()
            fn()
            torch.cuda.synchronize()
            got[prog] = {k: v for k, v in _counts().items() if v}

    eng._device_pool.submit(run).result()
    want = SERVE_REPLAY_LAUNCHES[label]
    print(f"[serve] {label} launches per replay {got}", flush=True)
    if got != want:
        raise AssertionError(f"serve {label}: launches per replay {got} != "
                             f"{want}")
    return got


def _serve_checks(sd, label: str, pairs, clip) -> dict:
    """fp32 checks of one configuration: request mode against
    ``make_eval_fn``; slot mode (staggered arrivals) bit for bit against
    request mode; launches and captures; early exit; an injected
    ``device_err``; an 8-frame stream."""
    from raft_tpu_torch import chaos
    from raft_tpu_torch.config import RAFTConfig
    from raft_tpu_torch.evaluate import make_eval_fn
    from raft_tpu_torch.ops.pad import InputPadder
    from raft_tpu_torch.serve import EarlyExitRunner
    from raft_tpu_torch.serve.engine import _device_worker

    cfg_kw = SERVE_CONFIGS[label]
    res, t_last = {}, [time.perf_counter()]

    def tick(what):
        now = time.perf_counter()
        print(f"[time] serve {label} {what}: {now - t_last[0]:.1f} s",
              flush=True)
        t_last[0] = now
    # request mode: every batch at 8 lanes, one batch of the 8 pairs
    eng = _serve_engine(sd, cfg_kw, "float32", max_batch=SERVE_SLOTS,
                        batch_sizes=(SERVE_SLOTS,), max_wait_ms=20)
    eng.warmup([SERVE_HW])
    tick("request engine and captures")
    _reset_counts()
    req = _one_batch(eng, pairs)
    tick("request batch")
    _expect({k: SERVE_ITERS * n for k, n in
             SERVE_REPLAY_LAUNCHES[label]["iter"].items()},
            f"serve {label} request")
    res["replay_launches"] = _replay_launches(eng, label, SERVE_SLOTS)
    res["request_captures"] = _one_capture_per_key(
        eng, f"{label} request", [(SERVE_SLOTS, p)
                                  for p in ("enc", "iter", "up")])
    eng.stop()
    del eng
    _free()
    # against the offline path on the same padded batch
    pad = InputPadder(SERVE_HW, target=SERVE_BUCKET)
    im1 = np.stack([pad.pad_np(a) for a, _ in pairs])
    im2 = np.stack([pad.pad_np(b) for _, b in pairs])
    eval_fn = make_eval_fn(RAFTConfig.full(**cfg_kw), SERVE_ITERS)
    # on the engines' device-worker thread: cuDNN caches its plans per
    # thread, and this thread has searched them for these shapes already
    _, up = _device_worker(torch.device("cuda")).submit(
        eval_fn, sd, im1, im2).result()
    up = up.cpu().numpy()
    del eval_fn
    _free()
    tick("make_eval_fn")
    err = max(float(np.abs(pad.unpad(up[j]) - req[j]).max())
              for j in range(len(pairs)))
    ok = all(np.allclose(req[j], pad.unpad(up[j]), rtol=1e-4, atol=1e-3)
             for j in range(len(pairs)))
    print(f"[serve] {label} fp32 request mode vs make_eval_fn: max|diff| "
          f"{err:.3e} px (rtol 1e-4, atol 1e-3)", flush=True)
    if not ok:
        raise AssertionError(f"serve {label}: request mode vs make_eval_fn "
                             f"{err}")
    res["vs_eval_max_px"] = err

    # slot mode: staggered arrivals (join and leave), then a device_err
    # retried, then a session
    eng = _serve_engine(sd, cfg_kw, "float32", batching="slot",
                        slots=SERVE_SLOTS, device_retries=1,
                        retry_backoff_s=0.0, retry_jitter=0.0)
    eng.warmup([SERVE_HW])
    tick("slot engine and captures")
    _reset_counts()
    steps0 = eng.stats()["slot_steps"]
    f0 = eng.submit(*pairs[0])
    _wait(lambda: eng.stats()["slot_steps"] - steps0 >= 10, "10 steps")
    mid = [eng.submit(*p) for p in pairs[1:4]]        # join mid-flight
    f0.result(timeout=600)                            # lane 0 leaves
    late = [eng.submit(*p) for p in pairs[4:]]        # join after it
    slot = [f.result(timeout=600) for f in [f0] + mid + late]
    steps = eng.stats()["slot_steps"] - steps0
    _expect({k: steps * n for k, n in
             SERVE_REPLAY_LAUNCHES[label]["iter"].items()},
            f"serve {label} slot")
    same = [bool(np.array_equal(a, b)) for a, b in zip(slot, req)]
    print(f"[serve] {label} fp32 slot (staggered, {steps} steps) bit-equal "
          f"to request mode: {same}", flush=True)
    if not all(same):
        raise AssertionError(f"serve {label}: slot != request {same}")
    tick("staggered slot run")
    # a stateless request of SERVE_CHECK_ITERS iterations, then the same
    # with a device_err injected at its third iteration: retried, the
    # same bits
    ref = eng.infer(clip[0], clip[1], timeout=600, iters=SERVE_CHECK_ITERS)
    seq = eng._batch_seq
    chaos.install(chaos.FaultPlan.parse(f"device_err@batch={seq + 3}"))
    try:
        faulted = eng.infer(clip[0], clip[1], timeout=600,
                            iters=SERVE_CHECK_ITERS)
    finally:
        chaos.uninstall()
    retries = eng.stats()["retries"]
    print(f"[serve] {label} device_err at iteration 3 retried ({retries}): "
          f"bit-equal {np.array_equal(faulted, ref)}", flush=True)
    if retries != 1 or not np.array_equal(faulted, ref):
        raise AssertionError(f"serve {label}: device_err retry")
    tick("device_err run")
    # streaming (a session budget of SERVE_CHECK_ITERS): frame 1 bit for
    # bit the stateless request
    eng.stream_open("cam", clip[0], iters=SERVE_CHECK_ITERS)
    outs = [eng.stream_ingest("cam", f, timeout=600) for f in clip[1:]]
    summary = eng.stream_close("cam")
    warm = [o["warm"] for o in outs]
    finite = all(np.isfinite(o["flow"]).all() for o in outs)
    print(f"[serve] {label} stream: {summary}, warm {warm}, finite "
          f"{finite}, frame 1 bit-equal to stateless "
          f"{np.array_equal(outs[0]['flow'], ref)}", flush=True)
    if (summary["frames"], summary["pairs"], summary["warm_pairs"]) != (
            8, 7, 6) or warm != [False] + [True] * 6 or not finite \
            or not np.array_equal(outs[0]["flow"], ref):
        raise AssertionError(f"serve {label}: stream {summary} {warm}")
    res["slot_captures"] = _one_capture_per_key(
        eng, f"{label} slot", [(SERVE_SLOTS, p) for p in
                               ("enc", "iter", "up", "wenc")], ("stash",))
    res["stream"] = summary
    eng.stop()
    del eng
    _free()
    tick("stream")

    # early exit: the offline runner, one capture a program over every
    # threshold; threshold 0 reproduces request mode bit for bit
    runner = EarlyExitRunner(RAFTConfig.full(**cfg_kw))
    base, used, resid = runner.run(sd, im1, im2, SERVE_ITERS, 0.0,
                                   return_residuals=True)
    if not all(np.array_equal(pad.unpad(base[j]), req[j])
               for j in range(len(pairs))):
        raise AssertionError(f"serve {label}: EarlyExitRunner != request")
    med = float(np.median(resid))
    sweep, prev = {}, used
    for thr in (2.0 * med, 1e9):
        _, u = runner.run(sd, im1, im2, SERVE_ITERS, thr)
        if (u > SERVE_ITERS).any() or (u < 1).any() or (u > prev).any():
            raise AssertionError(f"serve {label}: early exit {thr}: {u} "
                                 f"after {prev}")
        sweep[f"{thr:.4g}"] = u.tolist()
        prev = u
    if prev.tolist() != [1] * len(pairs):
        raise AssertionError(f"serve {label}: threshold 1e9 {prev}")
    counts = runner.programs.counter.counts()
    if set(counts.values()) != {1} or len(counts) != 3:
        raise AssertionError(f"serve {label}: runner captures {counts}")
    print(f"[serve] {label} early exit: residual median {med:.4g}, "
          f"iters_used by threshold {sweep}", flush=True)
    res["early_exit"] = dict(residual_median=med, iters_used=sweep)
    del runner
    _free()
    tick("early exit")
    return res


def _serve_kernel_vs_plain(sd, pairs) -> dict:
    """The kernel configuration's engine against the plain one's
    (``chunked`` + unfused gates), fp32, 4 iterations: within 1e-3 px."""
    flows = {}
    for label, cfg_kw in (("kernel", SERVE_CONFIGS["kernel"]),
                          ("plain", SERVE_PLAIN_CFG)):
        eng = _serve_engine(sd, cfg_kw, "float32", iters=SERVE_CHECK_ITERS,
                            max_batch=SERVE_SLOTS, batch_sizes=(SERVE_SLOTS,),
                            max_wait_ms=20)
        flows[label] = _one_batch(eng, pairs)
        eng.stop()
        del eng
        _free()
    err = max(float(np.abs(a - b).max())
              for a, b in zip(flows["kernel"], flows["plain"]))
    print(f"[serve] kernel vs plain configuration, fp32, "
          f"{SERVE_CHECK_ITERS} iterations: max|diff| {err:.3e} px "
          "(1e-3)", flush=True)
    if not err <= 1e-3:
        raise AssertionError(f"serve: kernel vs plain {err}")
    return {"max_px": err}


def _serve_forward_warp() -> dict:
    """``forward_warp_flow`` at the slot shape: two runs bit for bit, and
    within 1e-5 of the CPU's."""
    from raft_tpu_torch.ops.sampler import forward_warp_flow

    rng = np.random.default_rng(7)
    flow = torch.from_numpy((rng.standard_normal(
        (SERVE_SLOTS, 55, 128, 2)) * 6).astype(np.float32))
    cpu = forward_warp_flow(flow)
    a = forward_warp_flow(flow.cuda())
    b = forward_warp_flow(flow.cuda())
    err = float((a.cpu() - cpu).abs().max())
    same = bool(torch.equal(a, b))
    print(f"[serve] forward_warp_flow {tuple(flow.shape)}: two runs "
          f"bit-equal {same}, max|card - cpu| {err:.3e} (1e-5)", flush=True)
    if not same or not err <= 1e-5:
        raise AssertionError(f"serve: forward_warp_flow {same} {err}")
    return {"repeat_bit_equal": same, "vs_cpu": err}


def _serve_kernels(peaks) -> dict:
    """The three kernels of the serving path at the slot shape (S = 8,
    the Sintel grid) against their plain versions, timed beside their
    bounds."""
    from raft_tpu_torch.ops.corr import chunked_corr_lookup, pool_fmap_pyramid
    from raft_tpu_torch.ops.corr_kernels import (_plain,
                                                 corr_lookup_ondemand_nchw)

    dev = torch.device("cuda")
    rng = np.random.default_rng(8)
    k = 2 * R + 1
    out = {}
    with torch.inference_mode():
        f1, f2, coords = _corr_inputs(rng, SERVE_SLOTS, 55, 128, dev, "b")
        pyr = pool_fmap_pyramid(f2, LEVELS)
        got = corr_lookup_ondemand_nchw(f1, pyr, coords, R)
        want = _plain(f1, pyr, coords, R).permute(0, 3, 1, 2)
        err = _check(f"[serve] corr_ondemand S={SERVE_SLOTS} (b)", got, want)
        tk = _timed(lambda: corr_lookup_ondemand_nchw(f1, pyr, coords, R),
                    "corr_ondemand_kernel")
        tp = _timed(lambda: chunked_corr_lookup(f1, pyr, coords, R), None,
                    reps=10)
        nbytes = 4 * (f1.numel() + coords.numel() + want.numel()
                      + sum(p.numel() for p in pyr))
        ops = _corr_ops(coords.cpu().numpy(),
                        [tuple(p.shape[1:3]) for p in pyr], k)
        _record(out, "corr_ondemand", err, tk, tp, nbytes, ops, peaks,
                tag=f"[serve] S={SERVE_SLOTS}")
        for dtype in (torch.float32, torch.bfloat16):
            dt = "fp32" if dtype == torch.float32 else "bf16"
            for name, rec in _gate_fwd_case(rng, SERVE_SLOTS, 128, 55, 128,
                                            dtype, peaks, "[serve]").items():
                out[f"{name}/{dt}"] = rec
                if dtype == torch.float32:
                    out[name] = rec
    return out


def _closed_loop(eng, pairs, budgets=None, clients=SERVE_LOOP_CLIENTS,
                 reqs=SERVE_LOOP_REQS, traced: bool = False) -> dict:
    """``clients`` threads, each sending ``reqs`` requests one after
    another: pairs/s over the window, client-side p50 / p99 ms.
    ``traced``: each request under a root span of the default tracer
    (``request``), as the HTTP front end opens ``serve_http``."""
    import threading

    from raft_tpu_torch.obs import trace

    lats, errs, ends = [], [], []
    rng = np.random.default_rng(9)
    plan = [[(pairs[(c + i) % len(pairs)],
              None if budgets is None else int(rng.choice(budgets)))
             for i in range(reqs)] for c in range(clients)]

    def client(c):
        for (a, b), it in plan[c]:
            t = time.perf_counter()
            root = (trace.default_tracer().start_trace("request")
                    if traced else trace.NOOP_SPAN)
            try:
                with trace.use_context(root):
                    fut = eng.submit(a, b, iters=it)
                fut.result(timeout=600)
            except Exception as e:        # noqa: BLE001 (reported below)
                errs.append(repr(e))
            t_end = time.perf_counter()
            root.end()          # a sampled root emits its tree here
            ends.append((time.perf_counter() - t_end) * 1e3)
            lats.append((time.perf_counter() - t) * 1e3)

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if errs:
        raise AssertionError(f"serve closed loop: {errs[:3]}")
    out = {"pairs_per_s": clients * reqs / wall,
           "p50_ms": float(np.percentile(lats, 50)),
           "p99_ms": float(np.percentile(lats, 99)), "wall_s": wall}
    if traced:
        out["root_end_ms_mean"] = float(np.mean(ends))
    return out


def _serve_observability(eng, pairs, untraced: dict) -> dict:
    """The kernel configuration's bf16 slot engine right after its timed
    loop (``untraced``, tracing off): the same closed loop with every
    request traced at rate 1 into a JSONL sink (its pairs/s against the
    untraced loop's; one tree a request, an ``iter_step`` an iteration,
    each with the MFU the cost book gives it: the median held to (0, 1));
    the engine's ``load_signals()["mfu"]`` and the cost book's ``iter``
    record; and one ``POST /debug/profile?seconds=1`` to an HTTP front
    end over the engine while 8 clients load it: the Chrome trace must
    hold the on-demand lookup and both gate kernels of the ``iter``
    graph's replays."""
    import glob
    import shutil
    import threading
    import urllib.request

    from raft_tpu_torch.cli.serve import make_server
    from raft_tpu_torch.obs import EventSink, reset_default_sink, trace

    class _Drop:
        """A sink that drops every record: the traced arm without the
        JSONL writes."""

        def emit(self, event, **fields):
            pass

    work = os.path.join(WORK, "serve_obs")
    shutil.rmtree(work, ignore_errors=True)
    sink = EventSink(os.path.join(work, "trace"))
    arms = {}
    for arm, arm_sink, reqs in (("jsonl", sink, SERVE_LOOP_REQS),
                                ("dropped", _Drop(), SERVE_LOOP_REQS // 2),
                                ("untraced_after", None,
                                 SERVE_LOOP_REQS // 2)):
        if arm_sink is not None:
            trace.configure(sample_rate=1.0, sink=arm_sink)
        try:
            arms[arm] = _closed_loop(eng, pairs, reqs=reqs,
                                     traced=arm_sink is not None)
        finally:
            trace.reset_default_tracer()
    sink.close()
    loop = arms["jsonl"]
    spans = _spans_of(os.path.join(work, "trace"))
    roots = [s for s in spans if s["name"] == "request"]
    iters = [s for s in spans if s["name"] == "iter_step"]
    mfu = [s["mfu"] for s in iters if s.get("mfu") is not None]
    signals, cost = eng.load_signals(), eng.stats()["cost"]
    book = cost[f"{SERVE_BUCKET[0]}x{SERVE_BUCKET[1]}/b{SERVE_SLOTS}/iter"]
    rec = {"traced_pairs_per_s": loop["pairs_per_s"],
           "traced_p99_ms": loop["p99_ms"],
           "untraced_pairs_per_s": untraced["pairs_per_s"],
           "traced_over_untraced": loop["pairs_per_s"]
           / untraced["pairs_per_s"],
           # where a traced request's time goes: the root's emission of
           # its tree (the client's, as an HTTP handler's before it
           # replies), the same spans dropped instead of written, and
           # the untraced loop again after both
           "arms": {k: {kk: v[kk] for kk in ("pairs_per_s", "p50_ms",
                                             "root_end_ms_mean")
                        if kk in v} for k, v in arms.items()},
           "trees": len(roots), "spans": len(spans),
           "iter_steps": len(iters),
           "iter_mfu_median": float(np.median(mfu)) if mfu else None,
           "iter_mfu_p10_p90": ([float(np.percentile(mfu, 10)),
                                 float(np.percentile(mfu, 90))]
                                if mfu else None),
           "signal_mfu": signals["mfu"],
           "iter_gflop_per_pair": book["flops_per_pair"] / 1e9,
           "iter_source": book["source"]}
    want_trees = SERVE_LOOP_CLIENTS * SERVE_LOOP_REQS
    if (len(roots) != want_trees or len(iters) != want_trees * SERVE_ITERS
            or len(mfu) != len(iters) or not 0 < rec["iter_mfu_median"] < 1
            or signals["mfu"] is None or not 0 < signals["mfu"] < 1
            or book["source"] != "counted"):
        raise AssertionError(f"serve traced loop: {rec}")

    # the profile endpoint under load, its trace under the sink's
    # directory (the process-default sink, pointed at the work dir)
    saved = os.environ.get("RAFT_TELEMETRY_DIR")
    os.environ["RAFT_TELEMETRY_DIR"] = os.path.join(work, "tel")
    reset_default_sink()
    server = make_server(eng, "127.0.0.1", 0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    load = threading.Thread(target=_closed_loop, args=(eng, pairs),
                            kwargs=dict(reqs=4))
    try:
        load.start()
        time.sleep(0.3)
        t0 = time.perf_counter()
        out = json.loads(urllib.request.urlopen(urllib.request.Request(
            f"http://127.0.0.1:{server.server_address[1]}/debug/profile"
            "?seconds=1", data=b"", method="POST"), timeout=600).read())
        secs = time.perf_counter() - t0
        load.join()
    finally:
        server.shutdown()
        server.server_close()
        if saved is None:
            os.environ.pop("RAFT_TELEMETRY_DIR", None)
        else:
            os.environ["RAFT_TELEMETRY_DIR"] = saved
        reset_default_sink()
    with open(out["file"]) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    names = {}
    for e in kernels:
        for k in ("corr_ondemand_kernel", "rh_kernel", "blend_kernel"):
            if k in e.get("name", ""):
                names[k] = names.get(k, 0) + 1
    ops = [e for e in events if e.get("cat") == "cpu_op"]
    rec["profile"] = {
        "dir_under_sink": out["dir"].startswith(os.path.join(work, "tel")),
        "seconds": out["seconds"], "request_s": secs,
        "file_mib": os.path.getsize(out["file"]) / 2 ** 20,
        "events": len(events), "kernel_events": len(kernels),
        "kernels": names, "cpu_ops": len(ops),
        "cpu_op_threads": len({e.get("tid") for e in ops}),
        "files": len(glob.glob(os.path.join(work, "tel", "xprof", "*",
                                            "*.json")))}
    print(f"[serve] kernel bf16 slot observability: {json.dumps(rec)}",
          flush=True)
    if (set(names) != {"corr_ondemand_kernel", "rh_kernel", "blend_kernel"}
            or not rec["profile"]["dir_under_sink"]):
        raise AssertionError(f"serve /debug/profile: {rec['profile']}")
    return rec


def _stream_times(eng, clip) -> dict:
    """ms a frame of a session's cold first pair and of its warm frames."""
    eng.stream_open("timed", clip[0])
    ms = []
    for f in clip[1:]:
        t = time.perf_counter()
        eng.stream_frame("timed", f, timeout=600)
        ms.append((time.perf_counter() - t) * 1e3)
    eng.stream_close("timed")
    return {"cold_ms": ms[0], "warm_ms": float(np.median(ms[1:]))}


def _copy_kernels_per_replay(eng) -> dict:
    """The kernels of one ``iter`` replay of the slot set, and those of
    them that copy: a replay must not copy the correlation state."""
    from torch.profiler import ProfilerActivity, profile

    progs = eng._get_programs(SERVE_BUCKET, SERVE_SLOTS)

    def run():
        progs.iterate(0.0)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(0.01)
            progs.iterate(0.0)
            torch.cuda.synchronize()
            time.sleep(0.01)
        copies, total = {}, 0.0
        for e in prof.events():
            tr = e.time_range
            if getattr(e.device_type, "name", "") != "CUDA":
                continue
            total += tr.end - tr.start
            if "copy" in e.name.lower() or "memcpy" in e.name.lower():
                copies[e.name[:80]] = copies.get(e.name[:80], 0.0) + (
                    tr.end - tr.start) / 1e3
        return {"replay_kernel_ms": total / 1e3, "copy_ms": copies,
                "copy_total_ms": sum(copies.values())}

    return eng._device_pool.submit(run).result()


def _serve_bf16_vs_eval(eng, sd, label: str, pairs) -> dict:
    """The bf16 request-mode engine's batch of ``pairs`` against bf16
    ``make_eval_fn`` on the same padded batch, within the repo's bf16
    bound (rtol and atol 2e-2)."""
    from raft_tpu_torch.config import RAFTConfig
    from raft_tpu_torch.evaluate import make_eval_fn
    from raft_tpu_torch.ops.pad import InputPadder

    req = _one_batch(eng, pairs)
    pad = InputPadder(SERVE_HW, target=SERVE_BUCKET)
    im1 = np.stack([pad.pad_np(a) for a, _ in pairs])
    im2 = np.stack([pad.pad_np(b) for _, b in pairs])
    eval_fn = make_eval_fn(RAFTConfig.full(compute_dtype="bfloat16",
                                           **SERVE_CONFIGS[label]),
                           SERVE_ITERS)
    # on the engine's device-worker thread, as in _serve_checks
    _, up = eng._device_pool.submit(eval_fn, sd, im1, im2).result()
    up = up.float().cpu().numpy()
    del eval_fn
    err = max(float(np.abs(pad.unpad(up[j]) - req[j]).max())
              for j in range(len(pairs)))
    same = all(np.array_equal(pad.unpad(up[j]), req[j])
               for j in range(len(pairs)))
    ok = all(np.allclose(req[j], pad.unpad(up[j]), rtol=2e-2, atol=2e-2)
             for j in range(len(pairs)))
    print(f"[serve] {label} bf16 request mode vs make_eval_fn: max|diff| "
          f"{err:.3e} px, bit-equal {same} (rtol, atol 2e-2)", flush=True)
    if not ok:
        raise AssertionError(f"serve {label}: bf16 request mode vs "
                             f"make_eval_fn {err}")
    return {"max_px": err, "bit_equal": same}


def _serve_timings(sd, label: str, pairs, clip, peaks) -> dict:
    """bf16 timings of one configuration: the closed loop in request and
    slot mode, slot mode under budgets drawn from {8, 16, 32}, the
    stream's warm and cold frames, device busy and idle share, memory;
    and request mode against ``make_eval_fn`` in bf16."""
    cfg_kw = SERVE_CONFIGS[label]
    out = {}
    for mode, kw, budgets in (
            ("request", dict(max_batch=SERVE_SLOTS), None),
            ("slot", dict(batching="slot", slots=SERVE_SLOTS), None),
            ("slot_budgets", dict(batching="slot", slots=SERVE_SLOTS),
             SERVE_BUDGETS)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        base_reserved = torch.cuda.memory_reserved()
        eng = _serve_engine(sd, cfg_kw, "bfloat16", **kw)
        eng.warmup([SERVE_HW])
        resident = torch.cuda.memory_allocated() - base
        _closed_loop(eng, pairs, budgets, clients=2, reqs=1)   # settle
        active = eng.registry.counter("raft_serve_slot_lanes_active_total")
        steps = eng.registry.counter("raft_serve_slot_steps_total")
        a0, s0 = active.value(), steps.value()
        rec = _closed_loop(eng, pairs, budgets)
        rec["requests"] = SERVE_LOOP_CLIENTS * SERVE_LOOP_REQS
        st = eng.stats()
        if mode == "request":
            rec["mean_batch_fill"] = st["mean_batch_fill"]
        else:
            rec["mean_active_lanes"] = ((active.value() - a0)
                                        / max(steps.value() - s0, 1))
        # busy and idle over a traced loop of 8 x 2 requests (the timed
        # loop has just warmed the engine)
        prof = _profile(lambda: _closed_loop(
            eng, pairs, budgets, reqs=SERVE_TRACED_REQS), reps=1, warm=False)
        rec.update(busy_share=(None if prof["busy_ms"] is None
                               else prof["busy_ms"] / prof["wall_ms"]),
                   idle_share=prof["idle_share"], by_kind=prof["by_kind"])
        if mode == "slot":
            rec["stream"] = _stream_times(eng, clip)
            if label == "allpairs":
                rec["replay_copies"] = _copy_kernels_per_replay(eng)
            else:
                rec["observability"] = _serve_observability(eng, pairs,
                                                            rec)
        rec["captures"] = {k: v for k, v in st["compiles"].items()}
        if set(rec["captures"].values()) != {1}:
            raise AssertionError(f"serve {label} {mode}: captures "
                                 f"{rec['captures']}")
        rec["resident_gib"] = resident / 2 ** 30
        rec["peak_gib"] = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        # the graphs' private pools hold their temporaries: reserved, not
        # allocated, between replays
        rec["reserved_gib"] = (torch.cuda.max_memory_reserved()
                               - base_reserved) / 2 ** 30
        if mode == "request":      # after the peak: eval_fn's graph adds
            rec["vs_eval_bf16"] = _serve_bf16_vs_eval(eng, sd, label, pairs)
        print(f"[serve] {label} bf16 {mode}: " + ", ".join(
            f"{k} {v:.4g}" if isinstance(v, float) else f"{k} {v}"
            for k, v in rec.items()), flush=True)
        out[mode] = rec
        eng.stop()
        del eng
        _free()
    return out


def _serve_memory(sd) -> dict:
    """Request mode (``allpairs``, bf16, batch sizes 1/2/4/8: the serve
    CLI's defaults) warmed up at the Sintel, KITTI and FlyingChairs
    buckets one after another: the memory reserved after each (cached
    free blocks returned), what the engine's sets hold (the budget's
    measure) and the peak, under the default budget and under a budget
    of what the first bucket's sets held (the least recently used keys
    freed, every bucket still answered with the default budget's
    flow)."""
    rng = np.random.default_rng(10)
    frames = {hw: tuple((rng.uniform(0, 255, hw + (3,))).astype(np.float32)
                        for _ in range(2)) for hw in SERVE_MEMORY_SHAPES}
    out, flows, budget = {}, {}, None
    for arm in ("default", "one_bucket"):
        _free()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_reserved()
        eng = _serve_engine(sd, {}, "bfloat16", budget=(
            None if arm == "default" else budget))
        after, held = [], []
        for hw in SERVE_MEMORY_SHAPES:
            eng.warmup([hw])
            torch.cuda.empty_cache()     # what the states and graphs hold
            after.append((torch.cuda.memory_reserved() - base) / 2 ** 30)
            held.append(eng.resident_bytes() / 2 ** 30)
        if arm == "default":
            budget = int(held[0] * 2 ** 30)
        got = {hw: eng.infer(*frames[hw], timeout=600)
               for hw in SERVE_MEMORY_SHAPES}
        rec = {"reserved_gib_after_each": after,
               "held_gib_after_each": held,
               "peak_reserved_gib": (torch.cuda.max_memory_reserved() - base)
               / 2 ** 30,
               "budget_gib": eng.resident_budget_bytes / 2 ** 30,
               "evictions": int(eng.registry.counter(
                   "raft_serve_state_evictions_total").value())}
        if arm == "default":
            flows = got
        else:
            rec["flows_bit_equal"] = [bool(np.array_equal(got[hw], flows[hw]))
                                      for hw in SERVE_MEMORY_SHAPES]
        bad = [hw for hw, f in got.items()
               if f.shape != hw + (2,) or not np.isfinite(f).all()]
        print(f"[serve] memory, request mode allpairs bf16, {arm} budget: "
              + ", ".join(f"{k} {v}" for k, v in rec.items()), flush=True)
        eng.stop()
        del eng
        if bad or (arm == "one_bucket" and not rec["evictions"]):
            raise AssertionError(f"serve memory {arm}: {bad} {rec}")
        out[arm] = rec
    _free()
    return out


def _serve_cli(sd, pairs, clip) -> dict:
    """``python -m raft_tpu_torch serve --random-init`` in a subprocess
    (slot mode, the CLI's bf16): flows of single requests equal to the
    in-process engine's, a stream session, /metrics and /v1/healthz, a
    flood past --max-queue answered by structured 429s, and SIGINT ending
    it with its stats line."""
    import io
    import threading
    import urllib.error
    import urllib.request

    def post(url, **arrays):
        buf = io.BytesIO()
        np.savez(buf, **arrays)
        r = urllib.request.urlopen(urllib.request.Request(
            url, data=buf.getvalue(), method="POST"), timeout=600)
        return np.load(io.BytesIO(r.read()))

    import shutil

    tel = os.path.join(WORK, "serve_cli_tel")
    shutil.rmtree(tel, ignore_errors=True)
    child = _Child(["serve", "--random-init", "--port", "0", "--batching",
                    "slot", "--max-queue", "4", "--warmup", "436x1024",
                    "--trace-sample-rate", "1", "--telemetry-dir", tel])
    upstream = ("5e2e2de0c0ffee01", "0123456789abcdef")
    try:
        line = child.wait_for(r"listening on http://", timeout=600)
        base = re.search(r"http://(\S+)", line).group(1)
        got = [post(f"http://{base}/v1/flow", image1=a, image2=b)["flow"]
               for a, b in pairs[:3]]
        # a request that continues an upstream trace: the reply carries
        # the header of the continued trace
        buf = io.BytesIO()
        np.savez(buf, image1=pairs[3][0], image2=pairs[3][1])
        r = urllib.request.urlopen(urllib.request.Request(
            f"http://{base}/v1/flow", data=buf.getvalue(), method="POST",
            headers={"X-Raft-Trace": "-".join(upstream) + "-s"}),
            timeout=600)
        reply_header = r.headers.get("X-Raft-Trace")
        r.read()
        stream = [post(f"http://{base}/v1/stream/s1", image=f)
                  for f in clip[:3]]
        summary = json.loads(urllib.request.urlopen(urllib.request.Request(
            f"http://{base}/v1/stream/s1", method="DELETE")).read())
        metrics = urllib.request.urlopen(f"http://{base}/metrics").read()
        health = urllib.request.urlopen(f"http://{base}/v1/healthz").read()
        codes, bodies = [], []

        def flood():
            try:
                post(f"http://{base}/v1/flow", image1=pairs[0][0],
                     image2=pairs[0][1])
                codes.append(200)
            except urllib.error.HTTPError as e:
                codes.append(e.code)
                bodies.append((e.headers.get("Retry-After"),
                               json.loads(e.read())))

        threads = [threading.Thread(target=flood) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        child.proc.send_signal(signal.SIGINT)
        rc = child.finish(timeout=300)
    finally:
        child.kill()
    stats = json.loads(next(ln for ln in reversed(child.lines)
                            if ln.startswith("{")))
    with _default_tf32():
        eng = _serve_engine(sd, {}, "bfloat16", batching="slot",
                            slots=SERVE_SLOTS)
        want = [eng.infer(a, b, timeout=600) for a, b in pairs[:3]]
        eng.stop()
        del eng
        _free()
    same = [bool(np.array_equal(g, w)) for g, w in zip(got, want)]
    n429 = codes.count(429)
    print(f"[serve] CLI: flows bit-equal to the in-process engine {same}; "
          f"stream {summary}; /metrics {len(metrics)} B, healthz {health!r};"
          f" flood codes {sorted(codes)}, a 429 body {bodies[:1]}; SIGINT "
          f"rc {rc}, stats completed {stats.get('completed')}", flush=True)
    if not all(same):
        raise AssertionError(f"serve CLI flows != in-process {same}")
    if (summary != {"session": "s1", "frames": 3, "pairs": 2,
                    "warm_pairs": 1}
            or int(stream[0]["frame"]) != 0 or not bool(stream[2]["warm"])):
        raise AssertionError(f"serve CLI stream {summary}")
    if b"raft_serve_compiles_total" not in metrics or health != b"ok":
        raise AssertionError("serve CLI: /metrics or /v1/healthz")
    if not n429 or any(
            ra is None or set(b) != {"error", "queue_depth", "retry_after_s"}
            for ra, b in bodies):
        raise AssertionError(f"serve CLI flood: {codes} {bodies[:2]}")
    if rc != 0 or "completed" not in stats:
        raise AssertionError(f"serve CLI exit {rc}: {child.lines[-3:]}")
    traces = _serve_cli_trees(tel, upstream, reply_header,
                              3 + 1 + codes.count(200))
    return {"flows_bit_equal": same, "flood_codes": sorted(codes),
            "stats_completed": stats["completed"], "stream": summary,
            "traces": traces}


def _spans_of(directory: str) -> list:
    """The ``trace_span`` records of the JSONL files under ``directory``."""
    import glob

    out = []
    for path in sorted(glob.glob(os.path.join(directory, "*.jsonl"))):
        with open(path) as f:
            out += [r for r in map(json.loads, f)
                    if r.get("event") == "trace_span"]
    return out


def _serve_cli_trees(tel: str, upstream, reply_header, flows: int) -> dict:
    """The serve CLI's trace trees (``--trace-sample-rate 1``): one
    ``serve_http`` root a ``/v1/flow`` request that reached the engine
    (each 429 a root of status ``full``), the upstream trace continued
    (its ``serve_http`` under the caller's span, the reply carrying its
    id), and under each served root ``queue``, ``pad``, one ``iter_step``
    an iteration and ``device``; the ``iter_step`` spans' MFU from the
    engine's cost book in (0, 1)."""
    spans = _spans_of(tel)
    roots = [s for s in spans if s["name"] == "serve_http"]
    served = [r for r in roots if r["status"] == "ok"]
    by_parent = {}
    for s in spans:
        by_parent.setdefault(s["parent_id"], []).append(s)
    kids = {}
    for r in served:
        names = sorted(c["name"] for c in by_parent.get(r["span_id"], []))
        kids[tuple(names)] = kids.get(tuple(names), 0) + 1
    want = tuple(sorted(["queue", "pad", "device"]
                        + ["iter_step"] * SERVE_ITERS))
    up = [r for r in roots if r["trace_id"] == upstream[0]]
    mfu = [s["mfu"] for s in spans if s["name"] == "iter_step"
           and s.get("mfu") is not None]
    rec = {"roots": len(roots), "served": len(served),
           "full": sum(r["status"] == "full" for r in roots),
           "children": {",".join(sorted(set(k))): n for k, n in
                        kids.items()},
           "upstream_parent_ok": bool(up) and up[0]["parent_id"]
           == upstream[1], "reply_header": reply_header,
           "iter_mfu_median": float(np.median(mfu)) if mfu else None,
           "iter_mfu_range": [min(mfu), max(mfu)] if mfu else None}
    print(f"[serve] CLI traces: {json.dumps(rec)}", flush=True)
    if (len(served) != flows or kids != {want: flows}
            or not rec["upstream_parent_ok"]
            or not (reply_header or "").startswith(upstream[0] + "-")
            or len(mfu) != flows * SERVE_ITERS
            or not all(0 < m < 1 for m in mfu)):
        raise AssertionError(f"serve CLI trace trees: {rec}")
    return rec


def phase_serve(sd, peaks):
    """The serving engine on the card (see the module docstring)."""
    pairs, clip = _serve_pairs(), _serve_clip()
    res, secs = {}, {}

    def part(name, fn, *args):
        t = time.perf_counter()
        res[name] = fn(*args)
        secs[name] = time.perf_counter() - t
        print(f"[time] serve {name}: {secs[name]:.1f} s", flush=True)

    part("kernels", _serve_kernels, peaks)
    part("forward_warp", _serve_forward_warp)
    for label in SERVE_CONFIGS:
        part(f"checks/{label}", _serve_checks, sd, label, pairs, clip)
    part("kernel_vs_plain", _serve_kernel_vs_plain, sd, pairs)
    for label in SERVE_CONFIGS:
        part(f"timings/{label}", _serve_timings, sd, label, pairs, clip,
             peaks)
    part("memory", _serve_memory, sd)
    part("cli", _serve_cli, sd, pairs, clip)
    res["seconds"] = secs
    res["replay_launches"] = {
        label: res[f"checks/{label}"]["replay_launches"]
        for label in SERVE_CONFIGS}
    return res


# --- phase fleet: the self-healing serving fleet on the card ---------------

# the kernel configuration at the Sintel bucket, 32 iterations; the fp32
# checks batch one pair at a time, the bf16 drills at the batch sizes
# (1, 8)
FLEET_CFG = SERVE_CONFIGS["kernel"]
FLEET_SIZES = (1, 8)
FLEET_CLIENTS, FLEET_REQS = 8, 16    # the throughput loop (p99 over 128)
FLEET_DRILL_REQS = 2                 # per client in the kill / wedge loops
FLEET_UPDATE_CLIENTS = 4             # loop across the rolling update
FLEET_SLOW_S, FLEET_HEDGE_S = 1.5, 0.3
FLEET_STALL_S = 3.0      # above the straggler: a slow batch is no stall
FLEET_DEVICE = "cuda"


class _Events:
    """An event sink that keeps ``(perf_counter, event, fields)``; with
    ``directory``, every event also goes through an ``EventSink`` there,
    whose observers (an incident manager) see it and whose directory takes
    the incident bundles."""

    def __init__(self, directory=None):
        import threading

        from raft_tpu_torch.obs import EventSink

        self.records = []
        self._lock = threading.Lock()
        self._tee = EventSink(directory)

    @property
    def directory(self):
        return self._tee.directory

    def add_observer(self, fn) -> None:
        self._tee.add_observer(fn)

    def emit(self, event, step=None, **fields):
        with self._lock:
            self.records.append((time.perf_counter(), event, fields))
        self._tee.emit(event, step=step, **fields)

    def of(self, name: str) -> list:
        with self._lock:
            return [(t, f) for t, e, f in self.records if e == name]


def _fleet_cfg(dtype: str):
    from raft_tpu_torch.config import RAFTConfig

    return RAFTConfig.full(compute_dtype=dtype, **FLEET_CFG)


def _fleet_serve_cfg(sizes=(1,), **kw):
    from raft_tpu_torch.serve import ServeConfig

    kw = {"iters": SERVE_ITERS, "max_batch": max(sizes),
          "batch_sizes": tuple(sizes), "max_wait_ms": 5.0, **kw}
    return ServeConfig(**kw)


def _fleet(sd, dtype: str, sink, aot_dir: str, serve_kw=None, **fleet_kw):
    """A started two-replica fleet of the kernel configuration, warmed up
    at the Sintel bucket, with short backoffs and polls."""
    from raft_tpu_torch.serve import FleetConfig, ReplicaFleet

    fkw = {"replicas": 2, "aot_dir": aot_dir, "warmup_shapes": (SERVE_HW,),
           "restart_backoff_s": 0.05, "restart_backoff_max_s": 0.2,
           "health_poll_s": 0.02, **fleet_kw}
    return ReplicaFleet(sd, _fleet_cfg(dtype),
                        _fleet_serve_cfg(**(serve_kw or {})),
                        FleetConfig(**fkw), sink=sink,
                        device=FLEET_DEVICE).start()


def _reserved_gib() -> float:
    """The card's reserved memory after the cached free blocks went back
    (on the engines' device worker, where no capture can be in flight)."""
    import gc

    from raft_tpu_torch.serve.engine import on_device

    def run():
        gc.collect()
        torch.cuda.empty_cache()
        return torch.cuda.memory_reserved() / 2 ** 30

    return on_device("cuda", run)


def _fleet_loop(router, pairs, clients=FLEET_CLIENTS, reqs=FLEET_REQS) -> dict:
    """A closed loop through ``router``: ``clients`` threads, ``reqs``
    requests each; latencies with their completion times (no error
    allowed)."""
    import threading

    recs, errs = [], []

    def client(c):
        for i in range(reqs):
            a, b = pairs[(c + i) % len(pairs)]
            t = time.perf_counter()
            try:
                flow = router.infer(a, b, timeout=600)
                if flow.shape != SERVE_HW + (2,) or not np.isfinite(
                        flow).all():
                    errs.append(f"bad flow {flow.shape}")
            except Exception as e:        # noqa: BLE001 (reported below)
                errs.append(repr(e))
            recs.append((t, time.perf_counter()))

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if errs:
        raise AssertionError(f"fleet loop: {len(errs)} failed: {errs[:3]}")
    lats = [(e - s) * 1e3 for s, e in recs]
    return {"pairs_per_s": clients * reqs / wall, "wall_s": wall,
            "p50_ms": float(np.percentile(lats, 50)),
            "p99_ms": float(np.percentile(lats, 99)), "errors": len(errs),
            "recs": recs}


def _loop_batches(sink, rec) -> dict:
    """The request-mode batches that ran during one :func:`_fleet_loop`
    (the ``serve_batch`` events between its first submission and its
    last answer): how many, how full, how long."""
    t0, t1 = min(s for s, _ in rec["recs"]), max(e for _, e in rec["recs"])
    fills = [f["real"] for t, f in sink.of("serve_batch") if t0 <= t <= t1]
    secs = [f["seconds"] for t, f in sink.of("serve_batch")
            if t0 <= t <= t1]
    return {"batches": len(fills), "mean_fill": float(np.mean(fills)),
            "fill_counts": {str(n): fills.count(n) for n in sorted(
                set(fills))},
            "batch_ms_p50": float(np.percentile(secs, 50)) * 1e3}


def _no_capture_first_request(eng, pair, where: str) -> dict:
    before = eng.capture_counter.counts()
    flow = eng.infer(*pair, timeout=600)
    after = eng.capture_counter.counts()
    if after != before or not np.isfinite(flow).all():
        raise AssertionError(f"fleet {where}: captures on the first "
                             f"request {before} -> {after}")
    return {"captures_at_start": sum(before.values()),
            "captures_on_request": 0}


def _warm_start(fleet, pairs, label: str) -> dict:
    """Step 1: replica 0 captured and wrote the manifest, replica 1
    replayed it; neither captures on its first request."""
    out = {"reserved_gib": _reserved_gib()}
    for r in fleet.replicas:
        eng = r.engine
        rec = {"start_s": r.start_s, "aot": dict(eng.aot_info),
               "held_gib": eng.resident_bytes() / 2 ** 30,
               **_no_capture_first_request(eng, pairs[0],
                                           f"{label} {r.name}")}
        out[r.name] = rec
    if not (out["r1"]["aot"]["ok"] and out["r1"]["aot"]["replayed"]):
        raise AssertionError(f"fleet {label}: r1 did not replay the "
                             f"manifest: {out['r1']['aot']}")
    print(f"[fleet] {label} warm start: " + json.dumps(out), flush=True)
    return out


def _checkpoint(sd, path: str) -> str:
    """A port training-run directory holding ``sd`` as its step 1 (made
    on the CPU)."""
    from raft_tpu_torch.config import RAFTConfig, TrainConfig
    from raft_tpu_torch.train.checkpoint import CheckpointManager
    from raft_tpu_torch.train.step import init_state

    state = init_state(RAFTConfig.full(), TrainConfig(), device="cpu",
                       state_dict=sd)
    mgr = CheckpointManager(path)
    mgr.save(1, state)
    mgr.close()
    return path


def _engine_flows(sd, dtype: str, pairs, sizes=(1,)) -> list:
    """Flows of a fresh single engine (not a fleet member) on ``pairs``."""
    from raft_tpu_torch.serve import InferenceEngine

    eng = InferenceEngine(sd, _fleet_cfg(dtype), _fleet_serve_cfg(sizes),
                          device=FLEET_DEVICE)
    eng.start()
    try:
        eng.warmup([SERVE_HW])
        return [eng.infer(a, b, timeout=600) for a, b in pairs]
    finally:
        eng.stop()
        del eng


def _fleet_checks(sd, pairs, work: str) -> dict:
    """fp32 (TF32 off) checks: steps 1, 2, 6 and 7."""
    import shutil
    import threading

    from raft_tpu_torch import chaos
    from raft_tpu_torch.cli.serve import make_server
    from raft_tpu_torch.models.raft import RAFT
    from raft_tpu_torch.serve import (FlowRouter, InferenceEngine,
                                      RemoteConfig, RouterConfig,
                                      WeightUpdateError)

    res = {}
    aot = os.path.join(work, "aot_fp32")
    sink = _Events()
    fleet = _fleet(sd, "float32", sink, aot)
    try:
        res["warm_start"] = _warm_start(fleet, pairs, "fp32")
        router = FlowRouter(fleet, RouterConfig(), sink=sink)
        # step 2: the router's flows against a single engine's, and the
        # kernels of the path launched through the router
        _reset_counts()
        got = [router.infer(a, b, timeout=600) for a, b in pairs[:3]]
        res["launches"] = _expect_counts(3 * SERVE_ITERS,
                                         "fleet fp32 router")
        want = _engine_flows(sd, "float32", pairs[:3])
        same = [bool(np.array_equal(g, w)) for g, w in zip(got, want)]
        print(f"[fleet] fp32 router flows bit-equal to a single engine's: "
              f"{same}", flush=True)
        if not all(same):
            raise AssertionError(f"fleet: router != single engine {same}")
        res["same_bits"] = same

        # step 6: a rolling update to seed-1 weights from a checkpoint,
        # under load; a torn copy, NaN and scrambled weights refused
        sd1 = RAFT(_fleet_cfg("float32"), seed=1).state_dict()
        run = _checkpoint(sd1, os.path.join(work, "run_seed1"))
        torn = os.path.join(work, "run_torn")
        shutil.rmtree(torn, ignore_errors=True)
        shutil.copytree(run, torn)
        chaos.tear_files(os.path.join(torn, "1"))
        refused = {}
        try:
            fleet.update_weights(torn)
            raise AssertionError("fleet: a torn checkpoint rolled out")
        except WeightUpdateError as e:
            refused["torn"] = str(e)[:160]
        # clients loop until the update returns; least-loaded placement
        # keeps both replicas busy, so each flip finds requests in flight
        # on the old engine, which drain
        spread = FlowRouter(fleet, RouterConfig(affinity_spill=0.0),
                            sink=sink)
        done, recs, errs = threading.Event(), [], []

        def client(c):
            i = c
            while not done.is_set():
                t = time.perf_counter()
                try:
                    spread.infer(*pairs[i % len(pairs)], timeout=600)
                except Exception as e:    # noqa: BLE001 (reported below)
                    errs.append(repr(e))
                recs.append((t, time.perf_counter()))
                i += 1

        clients = [threading.Thread(target=client, args=(c,))
                   for c in range(FLEET_UPDATE_CLIENTS)]
        torch.cuda.reset_peak_memory_stats()
        t_up = time.perf_counter()
        for t in clients:
            t.start()
        try:
            report = fleet.update_weights(run)
        finally:
            done.set()
            for t in clients:
                t.join()
        peak = torch.cuda.max_memory_reserved() / 2 ** 30
        flips = [{"replica": f["replica"], "in_flight": f["in_flight"],
                  "at_s": t - t_up,
                  "spanning": sum(s < t < e for s, e in recs)}
                 for t, f in sink.of("fleet_replica_flip") if t > t_up]
        sstats = spread.router_stats()
        if (sorted(report["flipped"]) != ["r0", "r1"] or errs
                or sorted(f["replica"] for f in flips) != ["r0", "r1"]
                or not all(f["in_flight"] and f["spanning"] for f in flips)
                or sstats["failovers_total"] or sstats["dropped_total"]):
            raise AssertionError(f"fleet update under load: {report} "
                                 f"{flips} {sstats} {errs[:3]}")
        after = [router.infer(a, b, timeout=600) for a, b in pairs[:2]]
        fresh = _engine_flows(sd1, "float32", pairs[:2])
        same_new = [bool(np.array_equal(a, b)) for a, b in zip(after, fresh)]
        for name, bad in (("nan", {k: torch.full_like(v, float("nan"))
                                   if v.is_floating_point() else v
                                   for k, v in sd1.items()}),
                          ("scrambled", {k: v * 25.0 if v.is_floating_point()
                                         else v for k, v in sd1.items()})):
            try:
                fleet.update_weights(bad)
                raise AssertionError(f"fleet: {name} weights rolled out")
            except WeightUpdateError as e:
                refused[name] = str(e)[:200]
        proxy = [f for _, f in sink.of("fleet_canary_proxy")]
        res["update"] = {
            "seconds": report["seconds"], "peak_reserved_gib": peak,
            "loop_errors": len(errs), "loop_requests": len(recs),
            "flips": flips, "failovers": sstats["failovers_total"],
            "flows_bit_equal_fresh": same_new,
            "canary": report["canary"], "refused": refused,
            "proxy": proxy, "version": fleet.weights_version}
        print(f"[fleet] fp32 rolling update: {json.dumps(res['update'])}",
              flush=True)
        if (not all(same_new) or fleet.weights_version != 2
                or "verify-ckpt" not in refused["torn"]
                or "canary" not in refused["nan"]
                or "proxy" not in refused["scrambled"]):
            raise AssertionError(f"fleet update gates: {res['update']}")
    finally:
        chaos.uninstall()
        fleet.stop()
        del fleet
    _reserved_gib()

    # step 7: the fabric: a loopback server in this process fronts a
    # second engine; a one-local fleet joins it as a remote replica
    server_eng = InferenceEngine(sd1, _fleet_cfg("float32"),
                                 _fleet_serve_cfg(), device=FLEET_DEVICE)
    server_eng.start()
    server_eng.warmup([SERVE_HW])
    server = make_server(server_eng, "127.0.0.1", 0)
    addr = f"127.0.0.1:{server.server_address[1]}"
    serve_thread = threading.Thread(target=server.serve_forever, daemon=True)
    serve_thread.start()
    sink = _Events()
    fleet = _fleet(sd1, "float32", sink, aot, replicas=1, remote=(addr,),
                   remote_cfg=RemoteConfig(connect_timeout_s=1.0,
                                           health_timeout_s=1.0,
                                           health_cache_s=0.1))
    try:
        local, remote = fleet.replicas
        wire = [remote.engine.infer(a, b, timeout=600) for a, b in pairs[:2]]
        direct = [server_eng.infer(a, b, timeout=600) for a, b in pairs[:2]]
        mine = [local.engine.infer(a, b, timeout=600) for a, b in pairs[:2]]
        same_wire = [bool(np.array_equal(a, b)) for a, b in zip(wire, direct)]
        same_local = [bool(np.array_equal(a, b)) for a, b in zip(wire, mine)]
        ms = {}
        for name, fn in (("wire", remote.engine.infer),
                         ("direct", server_eng.infer)):
            t = time.perf_counter()
            for a, b in pairs[:4]:
                fn(a, b, timeout=600)
            ms[name] = (time.perf_counter() - t) / 4 * 1e3
        router = FlowRouter(fleet, RouterConfig(breaker_threshold=1,
                                                breaker_cooldown_s=0.5),
                            sink=sink)
        gen0 = remote.generation
        chaos.install(chaos.FaultPlan.parse(
            "net_partition@step=0,heal=12"))
        part = _fleet_loop(router, pairs, clients=2, reqs=FLEET_DRILL_REQS)
        _wait(lambda: remote.generation > gen0, "the remote to rejoin", 60)
        chaos.uninstall()
        _wait(remote.eligible, "the rejoined remote to be eligible", 60)
        rstats = router.router_stats()
        res["trace"] = _traced_remote_request(router, remote, pairs[0])
        res["fabric"] = {
            "remote_bit_equal_direct": same_wire,
            "remote_bit_equal_local": same_local,
            "ms_per_pair": ms, "added_ms_per_pair": ms["wire"] - ms["direct"],
            "partition_errors": part["errors"],
            "failovers": rstats["failovers_total"],
            "dropped": rstats["dropped_total"],
            "net_retries": len(sink.of("net_retry")),
            "rejoins": len(sink.of("fleet_remote_rejoin"))}
        print(f"[fleet] fp32 fabric: {json.dumps(res['fabric'])}", flush=True)
        if (not all(same_wire) or not all(same_local)
                or rstats["dropped_total"] or part["errors"]
                or not res["fabric"]["rejoins"]):
            raise AssertionError(f"fleet fabric: {res['fabric']}")
    finally:
        chaos.uninstall()
        fleet.stop()
        server.shutdown()
        server_eng.stop()
        del fleet, server_eng
    _reserved_gib()
    return res


def _traced_remote_request(router, remote, pair) -> dict:
    """One request traced at rate 1 through the router to the remote
    replica (the Sintel bucket's affine replica): ONE tree across the
    wire — ``route``, its ``attempt`` on the remote, the server's
    ``serve_http`` under that attempt (the ``X-Raft-Trace`` header), and
    the server engine's ``queue`` / ``pad`` / ``device`` under it."""
    from raft_tpu_torch.obs import trace

    spans = _Events()
    trace.configure(sample_rate=1.0, sink=spans)
    try:
        flow = router.infer(*pair, timeout=600)
        _wait(lambda: len(spans.of("trace_span")) >= 6, "the trace", 30)
    finally:
        trace.reset_default_tracer()
    recs = [f for _, f in spans.of("trace_span")]
    by_id = {r["span_id"]: r for r in recs}
    names = sorted(r["name"] for r in recs)
    (root,) = [r for r in recs if r["name"] == "route"]
    att = [r for r in recs if r["name"] == "attempt"]
    http = [r for r in recs if r["name"] == "serve_http"]
    rec = {"names": names, "trace_ids": len({r["trace_id"] for r in recs}),
           "attempt_replica": [a["replica"] for a in att],
           "serve_http_under_attempt": len(http) == 1 and len(att) == 1
           and http[0]["parent_id"] == att[0]["span_id"],
           "engine_spans_under_serve_http": all(
               by_id.get(r["parent_id"], {}).get("name") == "serve_http"
               for r in recs if r["name"] in ("queue", "pad", "device"))}
    print(f"[fleet] traced request through the router to the remote: "
          f"{json.dumps(rec)}", flush=True)
    if (rec["trace_ids"] != 1 or names != sorted(
            ["route", "attempt", "serve_http", "queue", "pad", "device"])
            or rec["attempt_replica"] != [remote.name]
            or not rec["serve_http_under_attempt"]
            or not rec["engine_spans_under_serve_http"]
            or root["status"] != "ok" or not np.isfinite(flow).all()):
        raise AssertionError(f"fleet traced remote request: {rec}")
    return rec


def _kill_and_restart(fleet, router, sink, pairs, what: str) -> dict:
    """A ``replica_kill`` on the affine replica's next batch under a
    closed loop; every request answered, the victim restarted with a
    generation bump and no capture on its first request."""
    from raft_tpu_torch import chaos

    affine = router._pick(SERVE_BUCKET, set())
    gen = affine.generation
    t0 = time.perf_counter()
    chaos.install(chaos.FaultPlan.parse(
        f"replica_kill@batch={affine.engine._batch_seq + 2}"))
    try:
        loop = _fleet_loop(router, pairs, reqs=FLEET_DRILL_REQS)
    finally:
        chaos.uninstall()

    def back():
        return [t for t, f in sink.of("fleet_restart")
                if f["replica"] == affine.name and t > t0]

    _wait(lambda: back() and affine.state == "ready", f"{what}: the restart",
          120)
    t_kill = [t for t, f in sink.of("chaos_inject") if t > t0][0]
    t_back = back()[0]
    first = _no_capture_first_request(affine.engine, pairs[0], what)
    out = {"replica": affine.name, "generation": [gen, affine.generation],
           "restart_s": t_back - t_kill, "start_s": affine.start_s,
           "loop": {k: v for k, v in loop.items() if k != "recs"},
           "dropped": router.router_stats()["dropped_total"], **first,
           "reserved_gib": _reserved_gib()}
    if affine.generation <= gen or out["dropped"] or loop["errors"]:
        raise AssertionError(f"fleet {what}: {out}")
    return out


def _fleet_drills(sd, pairs, work: str) -> dict:
    """bf16 drills at batch sizes (1, 8): steps 1, 3, 4, 5, 9 and 10."""
    from raft_tpu_torch import chaos
    from raft_tpu_torch.serve import FlowRouter, RouterConfig

    res = {}
    # the fleet's incident manager (one for the shared stream) on a
    # sink with a directory for its bundles
    sink = _Events(os.path.join(work, "tel_bf16"))
    fleet = _fleet(sd, "bfloat16", sink, os.path.join(work, "aot_bf16"),
                   serve_kw={"sizes": FLEET_SIZES,
                             "stall_timeout_s": FLEET_STALL_S,
                             "chaos_slow_s": FLEET_SLOW_S,
                             "chaos_hang_max_s": 60.0,
                             "incidents": True})
    try:
        res["warm_start"] = _warm_start(fleet, pairs, "bf16")
        router = FlowRouter(fleet, RouterConfig(), sink=sink)
        _fleet_loop(router, pairs, clients=2, reqs=1)           # settle
        opened0 = fleet.stats()["fleet"]["incidents"]["opened"]
        # step 3: two kills; the wedge's restart below is step 10's third
        kills = [_kill_and_restart(fleet, router, sink, pairs,
                                   f"kill {i + 1}") for i in range(2)]
        res["kill"] = kills[0]
        print(f"[fleet] bf16 kill: {json.dumps(kills)}", flush=True)
        # the kill drill's cascade (crashes, failovers, restarts) is ONE
        # incident of the fleet's manager
        snap = fleet.stats()["fleet"]["incidents"]
        res["incidents"] = {"opened": snap["opened"] - opened0,
                            "open": snap["open"]}
        print(f"[fleet] bf16 kill drill incidents: "
              f"{json.dumps(res['incidents'])}", flush=True)
        if (res["incidents"]["opened"] != 1 or snap["open"] is None
                or "replica_crash" not in snap["open"]["signals"]):
            raise AssertionError(f"fleet kill incidents: {snap}")

        # step 4: a wedge on the affine replica; only it restarts, the
        # sibling serves throughout
        import threading

        wedged = router._pick(SERVE_BUCKET, set())
        sibling = next(r for r in fleet.replicas if r is not wedged)
        others = {r.name: r.restarts for r in fleet.replicas
                  if r is not wedged}
        probe, probing = [], threading.Event()

        def probe_sibling():
            # the sibling's own latency while its neighbour is wedged
            while not probing.is_set():
                t = time.perf_counter()
                sibling.engine.infer(*pairs[2], timeout=600)
                probe.append((t, time.perf_counter()))

        t0 = time.perf_counter()
        chaos.install(chaos.FaultPlan.parse(
            f"replica_hang@batch={wedged.engine._batch_seq + 1}"))
        prober = threading.Thread(target=probe_sibling)
        prober.start()
        try:
            loop = _fleet_loop(router, pairs, reqs=FLEET_DRILL_REQS)
        finally:
            chaos.uninstall()

        def after(name):
            return [t for t, f in sink.of(name)
                    if f.get("replica") == wedged.name and t > t0]

        _wait(lambda: after("fleet_restart") and wedged.state == "ready",
              "the wedged replica's restart", 120)
        probing.set()
        prober.join()
        t_hang = after("chaos_inject")[0]
        t_detect = after("fleet_restart_begin")[0]
        t_back = after("fleet_restart")[0]
        during = [(e - s) * 1e3 for s, e in probe
                  if t_hang <= s and e <= t_detect]
        res["wedge"] = {
            "replica": wedged.name, "detect_s": t_detect - t_hang,
            "restart_s": t_back - t_hang, "stall_timeout_s": FLEET_STALL_S,
            "sibling": sibling.name,
            "sibling_p99_ms_during": (float(np.percentile(during, 99))
                                      if during else None),
            "sibling_served_during": len(during),
            "loop": {k: v for k, v in loop.items() if k != "recs"},
            "others_restarts": {r.name: r.restarts for r in fleet.replicas
                                if r is not wedged}}
        print(f"[fleet] bf16 wedge: {json.dumps(res['wedge'])}", flush=True)
        if (loop["errors"] or res["wedge"]["others_restarts"] != others
                or not during or router.router_stats()["dropped_total"]):
            raise AssertionError(f"fleet wedge: {res['wedge']}")
        # step 10: reserved memory after restarts 1-3 (two kills, a wedge)
        mem = [k["reserved_gib"] for k in kills] + [_reserved_gib()]
        res["memory_after_restarts_gib"] = mem
        print(f"[fleet] bf16 reserved after restarts 1-3: {mem} GiB",
              flush=True)
        if mem[2] > 1.1 * mem[0]:
            raise AssertionError(f"fleet: memory grew across restarts {mem}")

        # step 5: a straggler, hedged and not
        hedged = {}
        for label, hedge_s in (("on", FLEET_HEDGE_S), ("off", 0.0)):
            rt = FlowRouter(fleet, RouterConfig(hedge_timeout_s=hedge_s),
                            sink=sink)
            slow = rt._pick(SERVE_BUCKET, set())
            # the hedge counters live in the fleet's registry, which every
            # router of the fleet shares: each arm reads its own deltas
            h0 = {k: rt.router_stats()[k]
                  for k in ("hedges_total", "hedge_wins_total")}
            chaos.install(chaos.FaultPlan.parse(
                f"replica_slow@batch={slow.engine._batch_seq + 1}"))
            try:
                t = time.perf_counter()
                rt.infer(*pairs[1], timeout=600)
                ms = (time.perf_counter() - t) * 1e3
            finally:
                chaos.uninstall()
            h1 = rt.router_stats()
            hedged[label] = {
                "ms": ms, "hedges": h1["hedges_total"] - h0["hedges_total"],
                "hedge_wins": h1["hedge_wins_total"]
                - h0["hedge_wins_total"]}
            # the straggler's own batch ends before the next arm
            _wait(lambda s=slow: s.engine.health()["pending"] == 0,
                  "the straggler's batch", 60)
        res["straggler"] = {"slow_s": FLEET_SLOW_S,
                            "hedge_timeout_s": FLEET_HEDGE_S, **hedged}
        print(f"[fleet] bf16 straggler: {json.dumps(res['straggler'])}",
              flush=True)
        if (hedged["on"]["hedges"] != 1 or hedged["on"]["hedge_wins"] != 1
                or hedged["on"]["ms"] >= FLEET_SLOW_S * 1e3
                or hedged["off"]["hedges"] or hedged["off"]["hedge_wins"]
                or hedged["off"]["ms"] < FLEET_SLOW_S * 1e3):
            raise AssertionError(f"fleet straggler: {res['straggler']}")

        # step 9: throughput through the router against one engine
        by0 = router.router_stats()["requests_by_replica"]
        rec = _fleet_loop(router, pairs)
        by1 = router.router_stats()["requests_by_replica"]
        res["throughput"] = {"fleet": {
            **{k: v for k, v in rec.items() if k != "recs"},
            **_loop_batches(sink, rec)},
            "by_replica": {k: v - by0.get(k, 0) for k, v in by1.items()}}
    finally:
        chaos.uninstall()
        fleet.stop()
        del fleet
    _reserved_gib()
    from raft_tpu_torch.serve import InferenceEngine

    sink = _Events()
    eng = InferenceEngine(sd, _fleet_cfg("bfloat16"),
                          _fleet_serve_cfg(FLEET_SIZES), sink=sink,
                          device=FLEET_DEVICE).start()
    try:
        eng.warmup([SERVE_HW])
        rec = _fleet_loop(eng, pairs)
        res["throughput"]["one_engine"] = {
            **{k: v for k, v in rec.items() if k != "recs"},
            **_loop_batches(sink, rec)}
    finally:
        eng.stop()
        del eng
    _reserved_gib()
    print(f"[fleet] bf16 throughput: {json.dumps(res['throughput'])}",
          flush=True)
    return res


def _fleet_autoscale(sd, pairs, clip, work: str) -> dict:
    """Step 8 (bf16, slot mode, 8 slots): one grow from 1 to 2 under
    load, the new replica capturing nothing on its request path; then one
    scale-down after idle, with an open session migrated."""
    import threading

    from raft_tpu_torch.serve import FlowRouter, QueueFullError, RouterConfig

    sink = _Events()
    fleet = _fleet(sd, "bfloat16", sink, os.path.join(work, "aot_slot"),
                   serve_kw={"batching": "slot", "slots": SERVE_SLOTS,
                             "max_queue": 16},
                   replicas=1, autoscale_min=1, autoscale_max=2,
                   autoscale_interval_s=0.2, autoscale_up_queue_frac=0.25,
                   autoscale_down_queue_frac=0.02,
                   autoscale_up_consecutive=2, autoscale_down_consecutive=5,
                   autoscale_cooldown_s=3.0)
    try:
        router = FlowRouter(fleet, RouterConfig(), sink=sink)
        futs, deadline = [], time.monotonic() + 120
        while fleet.stats()["fleet"]["autoscale"]["ups"] < 1:
            if time.monotonic() > deadline:
                raise AssertionError("fleet: no scale-up under load")
            if sum(not f.done() for f in futs) < 12:
                try:
                    futs.append(router.submit(*pairs[len(futs) % len(pairs)]))
                except QueueFullError:
                    pass
            time.sleep(0.01)
        flows = [f.result(timeout=600) for f in futs]
        grown = fleet.replicas[-1]
        up = sink.of("fleet_scale")[-1][1]
        new_req = _no_capture_first_request(grown.engine, pairs[0],
                                            "scale-up replica")
        # a session on the grown replica (the bucket's affine one of two)
        router.stream_ingest("cam", clip[0], timeout=600)
        owner = router._streams["cam"].replica
        out1 = router.stream_ingest("cam", clip[1], timeout=600)
        _wait(lambda: fleet.stats()["fleet"]["autoscale"]["downs"] >= 1,
              "the idle scale-down", 120)
        down = sink.of("fleet_scale")[-1][1]
        out2 = router.stream_ingest("cam", clip[2], timeout=600)
        summary = router.stream_close("cam")
        rstats = router.router_stats()
        res = {"requests_under_load": len(futs), "up": {
            k: up[k] for k in ("replica", "replicas", "seconds")},
            "grown_start_s": grown.start_s, **new_req,
            "session_owner": owner, "down": {
                k: down[k] for k in ("replica", "replicas", "seconds",
                                     "moved")},
            "stream_frames": [out1["frame"], out2["frame"]],
            "stream_restarts": summary["restarts"],
            "dropped": rstats["dropped_total"],
            "restart_reasons": [f["reason"] for _, f in
                                sink.of("stream_restart")]}
        print(f"[fleet] bf16 autoscale: {json.dumps(res)}", flush=True)
        if (rstats["dropped_total"] or owner != grown.name
                or down["replica"] != grown.name or down["moved"] != 1
                or out2["flow"] is None or not all(
                    np.isfinite(f).all() for f in flows)):
            raise AssertionError(f"fleet autoscale: {res}")
        return res
    finally:
        fleet.stop()
        del fleet
        _reserved_gib()


def _fleet_cli_start():
    """``python -m raft_tpu_torch serve --random-init --replicas 2`` in a
    subprocess (the CLI's bf16 and model)."""
    return _Child(["serve", "--random-init", "--port", "0", "--replicas",
                   "2", "--batch-sizes", "1", "--max-batch", "1",
                   "--hedge-timeout-s", "5", "--warmup", "436x1024"])


def _fleet_cli(pairs, child) -> dict:
    """The CLI's fleet started by :func:`_fleet_cli_start`: two flows,
    ``/metrics`` with both replicas' samples, ``/v1/healthz``, SIGINT
    ending it with its stats line."""
    import io
    import urllib.request

    try:
        line = child.wait_for(r"listening on http://", timeout=600)
        base = re.search(r"http://(\S+)", line).group(1)
        flows = []
        for a, b in pairs[:2]:
            buf = io.BytesIO()
            np.savez(buf, image1=a, image2=b)
            r = urllib.request.urlopen(urllib.request.Request(
                f"http://{base}/v1/flow", data=buf.getvalue(),
                method="POST"), timeout=600)
            flows.append(np.load(io.BytesIO(r.read()))["flow"])
        metrics = urllib.request.urlopen(f"http://{base}/metrics").read()
        health = urllib.request.urlopen(f"http://{base}/v1/healthz").read()
        child.proc.send_signal(signal.SIGINT)
        rc = child.finish(timeout=300)
    finally:
        child.kill()
    stats = json.loads(next(ln for ln in reversed(child.lines)
                            if ln.startswith("{")))
    out = {"rc": rc, "health": health.decode(),
           "flows_finite": [bool(np.isfinite(f).all()) for f in flows],
           "metrics_replicas": sorted({m.decode() for m in re.findall(
               rb'replica="(r\d+)"', metrics)}),
           "requests": stats.get("router", {}).get("requests_total")}
    print(f"[fleet] CLI --replicas 2: {json.dumps(out)}", flush=True)
    if (rc != 0 or health != b"ok" or not all(out["flows_finite"])
            or out["metrics_replicas"] != ["r0", "r1"]
            or out["requests"] != 2):
        raise AssertionError(f"fleet CLI: {out} {child.lines[-5:]}")
    return out


def phase_fleet(sd):
    """The self-healing fleet on the card (see the module docstring)."""
    import shutil

    work = os.path.join(WORK, "fleet")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    pairs, clip = _serve_pairs(), _serve_clip(4)
    res, secs = {}, {}

    def part(name, fn, *args):
        t = time.perf_counter()
        res[name] = fn(*args)
        secs[name] = time.perf_counter() - t
        print(f"[time] fleet {name}: {secs[name]:.1f} s", flush=True)

    part("checks", _fleet_checks, sd, pairs, work)
    part("drills", _fleet_drills, sd, pairs, work)
    part("autoscale", _fleet_autoscale, sd, pairs, clip, work)
    res["seconds"] = secs
    res["launches"] = res["checks"]["launches"]
    return res


# ---------------------------------------------------------------------------
# phase ddp: data-parallel training (raft_tpu_torch/parallel, the step's
# all-reduce, the loop's agreement, train --distributed)
# ---------------------------------------------------------------------------

DDP_STEPS = 3            # world-1 steps, the DDP step against the plain one
DDP_TIMED = 5            # timed steps of each world-1 arm
DDP_SPLIT_STEPS = 2      # steps of the 2-rank run and its straight twin
DDP_LR = 2.5e-4
# the kernel configuration of the 2-rank run: the pyramid lookup, the
# upsample-loss pair and the four gate kernels
DDP_KERNEL_CFG = dict(corr_impl="allpairs_pallas",
                      upsample_loss_kernel="pallas", fused_gru=True)
DDP_AR_REPS = 5          # timed gloo all-reduces of the step's buffer


def _ddp_cfgs(kernel: bool, batch: int):
    from raft_tpu_torch.config import RAFTConfig, TrainConfig

    cfg = TrainConfig(lr=DDP_LR, num_steps=120000, batch_size=batch,
                      image_size=CHAIRS_HW, iters=CHAIRS_ITERS, wdecay=1e-4)
    # the train CLI's defaults (corr_impl auto -> allpairs_pallas on the
    # card), or the kernel configuration
    extra = DDP_KERNEL_CFG if kernel else dict(corr_impl="allpairs_pallas")
    return cfg, RAFTConfig.full(compute_dtype="bfloat16", **extra)


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def _rank_env(rank: int, world: int, port: int):
    """The variables ``torchrun`` sets for one rank on this host."""
    keys = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
    saved = {k: os.environ.get(k) for k in keys}
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK="0",
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _state_tensors(state) -> dict:
    return {k: v.detach().clone() for k, v in
            state.model.state_dict().items()}


@contextlib.contextmanager
def _all_reduce_calls(calls: list):
    """Record each ``torch.distributed.all_reduce`` call while inside:
    its element count and whether the current stream was capturing (the
    proof that the step's all-reduce went into the captured graph: a
    collective that refused capture would have raised)."""
    import torch.distributed as dist

    real = dist.all_reduce

    def recording(tensor, *a, **kw):
        calls.append({"numel": tensor.numel(),
                      "capturing": torch.cuda.is_current_stream_capturing()})
        return real(tensor, *a, **kw)

    dist.all_reduce = recording
    try:
        yield calls
    finally:
        dist.all_reduce = real


def _ddp_world1(sd) -> dict:
    """(a) World size 1 over NCCL: ``DDP_STEPS`` captured chairs steps of
    ``make_train_step(..., mesh=...)`` against the plain captured step on
    the same batches, cuDNN deterministic: parameters, batch-norm
    statistics and losses bit for bit, one capture each, the gradient
    all-reduce called inside the capture, the pyramid lookup 12 + 12 a
    step; ms/step, device busy and idle share of both."""
    from raft_tpu_torch.parallel import mesh as mesh_mod
    from raft_tpu_torch.train.step import init_state, make_train_step

    dev = torch.device("cuda")
    cfg, mcfg = _ddp_cfgs(False, CHAIRS_B)
    batches = [_chairs_batch(dev, 100 + s) for s in range(DDP_STEPS)]
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    res, arms, fns = {}, {}, {}
    with _rank_env(0, 1, _free_port()):
        mesh = mesh_mod.init_from_env("cuda")
    try:
        if (mesh.backend, mesh.world, mesh.distributed) != ("nccl", 1, True):
            raise AssertionError(f"ddp: not an NCCL mesh: {mesh}")
        for arm in ("plain", "ddp"):
            t0 = time.perf_counter()
            state = init_state(mcfg, cfg, state_dict=sd)
            step_fn = make_train_step(
                cfg, **({"mesh": mesh} if arm == "ddp" else {}))
            _reset_counts()
            losses, secs = [], [time.perf_counter() - t0]
            with _all_reduce_calls([]) as calls:
                for b in batches:      # eager, capture, replay
                    t0 = time.perf_counter()
                    losses.append(step_fn(state, b)[1]["loss"])
                    torch.cuda.synchronize()
                    secs.append(time.perf_counter() - t0)
            print(f"[ddp] world 1 {arm}: init {secs[0]:.1f} s, steps "
                  f"{', '.join(f'{t:.1f}' for t in secs[1:])} s (eager, "
                  f"capture, replay)", flush=True)
            arms[arm] = (_state_tensors(state), [float(x) for x in losses])
            fns[arm] = (state, step_fn)
            res[arm] = dict(losses=arms[arm][1], launches=_counts(),
                            captures=state.programs.counter.total(),
                            all_reduce_calls=calls)
        # the timed replays alternate between the arms, so that both see
        # the same card and host
        times = {arm: [] for arm in fns}
        for _ in range(DDP_TIMED):
            for arm, (state, step_fn) in fns.items():
                t0 = time.perf_counter()
                step_fn(state, batches[0])
                torch.cuda.synchronize()
                times[arm].append((time.perf_counter() - t0) * 1e3)
        for arm, (state, step_fn) in fns.items():
            prof = _profile(lambda: step_fn(state, batches[0]), reps=2)
            res[arm].update(ms_per_step=statistics.median(times[arm]),
                            ms_all=times[arm],
                            device_busy_ms=prof["busy_ms"],
                            idle_share=prof["idle_share"],
                            by_kind=prof["by_kind"])
            print(f"[ddp] world 1 {arm}: {res[arm]['ms_per_step']:.2f} "
                  f"ms/step (steps "
                  f"{', '.join(f'{t:.1f}' for t in times[arm])}), device "
                  f"busy {prof['busy_ms']} ms (idle {prof['idle_share']}), "
                  f"by kind {prof['by_kind']}, losses {arms[arm][1]}, "
                  f"captures {res[arm]['captures']}, all-reduce calls "
                  f"{res[arm]['all_reduce_calls']}, launches "
                  f"{res[arm]['launches']}", flush=True)
        del fns, state, step_fn
    finally:
        mesh_mod.shutdown()
        torch.backends.cudnn.deterministic = det
        torch.cuda.empty_cache()
    (pp, pl), (dp, dl) = arms["plain"], arms["ddp"]
    differ = [k for k in pp if not torch.equal(pp[k], dp[k])]
    want = {"pyramid_lookup_fwd": CHAIRS_ITERS * DDP_STEPS,
            "pyramid_lookup_bwd": CHAIRS_ITERS * DDP_STEPS}
    got = {k: v for k, v in res["ddp"]["launches"].items() if v}
    res.update(bit_equal=not differ and pl == dl, differ=differ[:8],
               overhead=res["ddp"]["ms_per_step"]
               / res["plain"]["ms_per_step"] - 1.0)
    print(f"[ddp] world 1 NCCL DDP against plain over {DDP_STEPS} captured "
          f"steps: parameters and statistics bit for bit "
          f"{not differ} ({len(differ)} tensors differ), losses equal "
          f"{pl == dl}; step time {100 * res['overhead']:+.2f}% (cuDNN "
          f"deterministic in both)", flush=True)
    # one all-reduce a step: the eager warm-up's, then the capture's
    captured = [c["capturing"] for c in res["ddp"]["all_reduce_calls"]]
    if differ or pl != dl or got != want or res["ddp"]["captures"] != 1 \
            or res["plain"]["captures"] != 1 or captured != [False, True] \
            or res["plain"]["all_reduce_calls"]:
        raise AssertionError(f"ddp world 1: {res}, launches {got} (want "
                             f"{want})")
    return res


def _ddp_rank_main(rank: int, world: int, port: int, out: str) -> int:
    """(b) one rank of the 2-rank gloo run (``chip_smoke.py --ddp-rank``):
    ``DDP_SPLIT_STEPS`` eager chairs steps of the kernel configuration on
    its rows of the global batches; writes its parameters, losses, launch
    counts, ms/step and the gloo all-reduce's ms to ``out``."""
    from raft_tpu_torch import config
    from raft_tpu_torch.config import RAFTConfig
    from raft_tpu_torch.models.raft import RAFT
    from raft_tpu_torch.parallel import mesh as mesh_mod
    from raft_tpu_torch.train.step import init_state, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    config.CONV_TF32 = False
    with _rank_env(rank, world, port):
        mesh = mesh_mod.init_from_env("cuda", backend="gloo")
    b = CHAIRS_B // world
    cfg, mcfg = _ddp_cfgs(True, CHAIRS_B)
    sd = RAFT(RAFTConfig.full(), seed=0).state_dict()
    state = init_state(mcfg, cfg, state_dict=sd)
    step_fn = make_train_step(cfg, mesh=mesh)
    batches = [{k: v[rank * b:(rank + 1) * b] for k, v in
                _chairs_batch(mesh.device, 110 + s).items()}
               for s in range(DDP_SPLIT_STEPS)]
    _reset_counts()
    losses, times = [], []
    for batch in batches:
        t0 = time.perf_counter()
        losses.append(float(step_fn(state, batch)[1]["loss"]))
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    counts = _counts()
    n = sum(p.numel() for p in state.model.parameters())
    buf = torch.zeros(n + 64, device=mesh.device)
    ar = []
    for _ in range(DDP_AR_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.distributed.all_reduce(buf, group=mesh.group)
        torch.cuda.synchronize()
        ar.append((time.perf_counter() - t0) * 1e3)
    torch.save({"params": {k: v.cpu() for k, v in
                           _state_tensors(state).items()},
                "losses": losses, "launches": counts, "step_ms": times,
                "allreduce_ms": ar, "allreduce_bytes": buf.numel() * 4,
                "nonfinite": int(state.nonfinite_steps)},
               os.path.join(out, f"rank{rank}.pt"))
    mesh_mod.shutdown()
    return 0


def _ddp_rank_start(rank: int, world: int, port: int, out: str):
    return subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--ddp-rank", str(rank),
         "--ddp-world", str(world), "--ddp-port", str(port), "--ddp-out",
         out], cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=dict(os.environ, PYTHONPATH=REPO,
                            PYTHONUNBUFFERED="1"))


def _wait_ranks(procs, timeout: float = 600) -> None:
    """Wait for every rank; the first to fail (or the deadline) ends the
    others at once, since its peers would wait on it in a collective."""
    deadline = time.monotonic() + timeout
    while any(p.poll() is None for p in procs):
        bad = [p for p in procs if p.poll() not in (None, 0)]
        if bad or time.monotonic() > deadline:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            outs = [p.communicate()[0][-3000:] for p in procs]
            raise AssertionError(f"ddp ranks: exit codes "
                                 f"{[p.returncode for p in procs]}: {outs}")
        time.sleep(0.2)
    for p in procs:
        out = p.communicate()[0]
        if p.returncode != 0:
            raise AssertionError(f"ddp rank exited {p.returncode}: "
                                 f"{out[-3000:]}")


def _ddp_straight(sd) -> dict:
    """The 2-rank run's straight twin: ``DDP_SPLIT_STEPS`` eager steps of
    the kernel configuration on the whole global batches, then again with
    each batch's rows in reverse order, the same computation summed in
    another order: its difference is the floor of reduction-order noise
    (a bias ahead of a norm has a zero gradient in exact arithmetic, and
    Adam turns its rounding noise into steps of up to lr either way)."""
    from raft_tpu_torch.train.step import init_state, make_train_step

    dev = torch.device("cuda")
    cfg, mcfg = _ddp_cfgs(True, CHAIRS_B)
    batches = [_chairs_batch(dev, 110 + s) for s in range(DDP_SPLIT_STEPS)]
    runs = []
    for flip in (False, True):
        state = init_state(mcfg, cfg, state_dict=sd)
        step_fn = make_train_step(cfg, graphs=False)
        losses = [float(step_fn(state, {k: v.flip(0) if flip else v
                                        for k, v in b.items()})[1]["loss"])
                  for b in batches]
        runs.append((_state_tensors(state), losses))
        del state, step_fn
        torch.cuda.empty_cache()
    return runs


def _ddp_two_ranks_check(sd, procs, out, straight) -> dict:
    """(b) Two gloo ranks sharing the card, eager, the kernel
    configuration at B 4 a rank, against the straight run at B 8: the
    ranks bit for bit each other; their parameter change within
    ``_grad_agreement``'s norm bound of the straight run's, widened by
    ``EAGER_SPREAD_FACTOR`` times the straight run's own spread under
    reversed rows, with the change doubled rejected; losses within ``BF16_LOSS_TOL``; every kernel
    of the configuration counted on each rank; the gloo all-reduce of the
    step's buffer timed (a host round trip: it says nothing of NCCL)."""
    _wait_ranks(procs)
    ranks = [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
             for r in range(2)]
    p0 = {k: v.float() for k, v in sd.items()}
    (s1, l1), (s2, _) = straight
    params = [k for k in s1 if "running" not in k]
    same = all(torch.equal(ranks[0]["params"][k], ranks[1]["params"][k])
               for k in ranks[0]["params"])
    want = {k: s1[k].cpu() - p0[k] for k in params}
    change = {k: ranks[0]["params"][k] - p0[k] for k in params}
    spread = {k: EAGER_SPREAD_FACTOR * float((s2[k] - s1[k]).norm())
              for k in params}
    agree = _grad_agreement(change, want, spread)
    doubled = _grad_agreement({k: 2 * v for k, v in change.items()}, want,
                              spread)
    stats = max(float((ranks[0]["params"][k] - s1[k].cpu()).abs().max())
                for k in s1 if "running" in k)
    loss_rel = max(abs(a - b) / abs(b) for a, b in
                   zip(ranks[0]["losses"], l1))
    it = CHAIRS_ITERS * DDP_SPLIT_STEPS
    want_counts = {"pyramid_lookup_fwd": it, "pyramid_lookup_bwd": it,
                   "upsample_loss_fwd": DDP_SPLIT_STEPS,
                   "upsample_loss_bwd": DDP_SPLIT_STEPS,
                   "gru_gate_rh": 2 * it, "gru_gate_rh_bwd": 2 * it,
                   "gru_gate_blend": 2 * it, "gru_gate_blend_bwd": 2 * it}
    counts = [{k: v for k, v in r["launches"].items() if v} for r in ranks]
    res = dict(ranks_bit_equal=same, parameter_change=agree,
               control_doubled=doubled["leaf_ratio"], stats_max_abs=stats,
               loss_rel=loss_rel, losses=[r["losses"] for r in ranks],
               straight_losses=l1, launches=counts,
               step_ms=[r["step_ms"] for r in ranks],
               allreduce_ms=[r["allreduce_ms"] for r in ranks],
               allreduce_bytes=ranks[0]["allreduce_bytes"])
    print(f"[ddp] 2 gloo ranks on one card, B {CHAIRS_B // 2} a rank, "
          f"against the straight B {CHAIRS_B} run over {DDP_SPLIT_STEPS} "
          f"eager steps: ranks bit for bit {same}, parameter change "
          f"{agree}, control doubled {doubled['leaf_ratio']:.3f} (must "
          f"exceed 1), statistics max |d| {stats:.3e}, loss rel "
          f"{loss_rel:.3e}, launches per rank {counts}; eager ms/step "
          f"{res['step_ms']}; gloo all-reduce of "
          f"{res['allreduce_bytes'] / 2 ** 20:.1f} MiB (a host round trip "
          f"through gloo, not NCCL): {res['allreduce_ms']} ms", flush=True)
    if not same or agree["leaf_ratio"] > 1.0 or doubled["leaf_ratio"] <= 1.0 \
            or loss_rel > BF16_LOSS_TOL or counts != [want_counts] * 2 \
            or any(r["nonfinite"] for r in ranks):
        raise AssertionError(f"ddp 2 ranks: {res}, want launches "
                             f"{want_counts}")
    return res


def _ddp_cli_start(tree: dict, ckpt_dir: str):
    """(c) ``train --distributed`` under the variables ``torchrun`` sets
    for one rank: 2 steps of the chairs stage on phase train_cli's
    tree."""
    port = _free_port()
    with _rank_env(0, 1, port):
        return _Child(["train", "--distributed", "--name", "ddp", "--stage",
                       "chairs", "--precision", "bf16", "--batch_size",
                       str(CHAIRS_B), "--image_size", *map(str, CHAIRS_HW),
                       "--iters", str(CHAIRS_ITERS), "--num_steps", "2",
                       "--val_freq", "2", "--lr", "0.00025",
                       "--num_workers", "2",
                       "--data_root", tree["data_root"], "--chairs_split",
                       tree["split"], "--ckpt_dir", ckpt_dir])


def _ddp_cli_check(child, ckpt_dir: str) -> dict:
    from raft_tpu_torch.train.checkpoint import CheckpointManager

    try:
        rc = child.finish(600)
    finally:
        child.kill()
    mgr = CheckpointManager(os.path.join(ckpt_dir, "ddp"))
    topo = mgr.saved_topology(2) or {}
    res = dict(rc=rc, steps=mgr.all_steps(), topology=topo,
               out=child.lines[-12:])
    print(f"[ddp] train --distributed (world 1 from the torchrun "
          f"variables): rc {rc}, saved steps {res['steps']}, topology "
          f"{topo}", flush=True)
    if rc != 0 or res["steps"] != [2] or topo.get("world_size") != 1 \
            or topo.get("mesh") != {"data": 1, "spatial": 1}:
        raise AssertionError(f"train --distributed: {res}")
    return res


def phase_ddp(sd, tree) -> dict:
    """Data-parallel training on the card (see the module docstring,
    phase 12)."""
    import shutil

    work = os.path.join(WORK, "ddp")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    res, secs = {}, {}
    t = time.perf_counter()
    res["world1"] = _ddp_world1(sd)
    secs["world1"] = time.perf_counter() - t
    t = time.perf_counter()
    out = os.path.join(work, "ranks")
    os.makedirs(out)
    port = _free_port()
    procs = [_ddp_rank_start(r, 2, port, out) for r in range(2)]
    cli = _ddp_cli_start(tree, os.path.join(work, "cli"))
    try:
        straight = _ddp_straight(sd)
        res["two_ranks"] = _ddp_two_ranks_check(sd, procs, out, straight)
        res["cli"] = _ddp_cli_check(cli, os.path.join(work, "cli"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        cli.kill()
    secs["two_ranks_and_cli"] = time.perf_counter() - t
    res["phase_s"] = secs
    for k, v in secs.items():
        print(f"[time] ddp {k}: {v:.1f} s", flush=True)
    return res


# --- phase spatial: each image's rows split over two gloo ranks ----------

SPATIAL_STEPS = 2        # steps of each arm, sharded and straight
SPATIAL_PROFILED_ARM = "kernel"   # the arm whose last step is traced
# the arms: the kernel configuration (the pyramid lookup on local
# queries, the halo form of the upsample-loss pair, the four gates), the
# plain lookup with the loss kernels, and the on-demand kernels
SPATIAL_ARMS = {"kernel": DDP_KERNEL_CFG,
                "allpairs": dict(corr_impl="allpairs",
                                 upsample_loss_kernel="pallas"),
                "ondemand": ONDEMAND_CFG}


def _spatial_launches(arm: str) -> dict:
    """Each kernel's launches a rank makes over ``SPATIAL_STEPS`` steps of
    ``arm`` (12 iterations; the separable GRU runs each gate twice an
    iteration)."""
    it = CHAIRS_ITERS * SPATIAL_STEPS
    want = {"upsample_loss_fwd": SPATIAL_STEPS,
            "upsample_loss_bwd": SPATIAL_STEPS}
    if arm == "kernel":
        want.update(pyramid_lookup_fwd=it, pyramid_lookup_bwd=it)
    if arm == "ondemand":
        want.update(corr_ondemand=it, corr_ondemand_bwd=it)
    if arm != "allpairs":
        want.update({g: 2 * it for g in (
            "gru_gate_rh", "gru_gate_rh_bwd", "gru_gate_blend",
            "gru_gate_blend_bwd")})
    return want


def _spatial_cfgs(arm: str):
    from raft_tpu_torch.config import RAFTConfig, TrainConfig

    cfg = TrainConfig(lr=DDP_LR, num_steps=120000, batch_size=SPATIAL_B,
                      image_size=CHAIRS_HW, iters=CHAIRS_ITERS, wdecay=1e-4)
    return cfg, RAFTConfig.full(compute_dtype="bfloat16",
                                **SPATIAL_ARMS[arm])


def _spatial_batches(dev, shard=None):
    """The phase's ``SPATIAL_STEPS`` global batches (the first
    ``SPATIAL_B`` pairs of phase train's chairs batches), or shard
    ``shard``'s rows of them."""
    h = CHAIRS_HW[0] // SPATIAL_N
    rows = slice(None) if shard is None else slice(shard * h,
                                                   (shard + 1) * h)
    return [{k: v[:SPATIAL_B, rows].contiguous() for k, v in
             _chairs_batch(dev, 120 + i).items()}
            for i in range(SPATIAL_STEPS)]


def _first_moments(state) -> dict:
    """Adam's first moment of each parameter: ``1 - beta1`` times the
    clipped global gradient after the first step."""
    opt = state.optimizer.state_dict()["state"]
    return {n: opt[i]["exp_avg"].detach().float().cpu()
            for i, (n, _) in enumerate(state.model.named_parameters())}


def _collective_ms(averages, label: str) -> float:
    """Wall ms of the ``label`` ranges (host side) in a profiler's
    ``key_averages()``."""
    return sum(e.cpu_time_total for e in averages if e.key == label) / 1e3


def _spatial_rank_main(rank: int, port: int, out: str) -> int:
    """One rank of phase spatial (``chip_smoke.py --spatial-rank``): the
    ``data 1 x spatial 2`` mesh over gloo on the shared card, then for
    each arm ``SPATIAL_STEPS`` eager steps on this rank's rows of the
    global batches; writes its parameters, first moments, losses, launch
    counts, ms/step, peak memory and (rank 0, the kernel arm, from its
    last step under the profiler) the spatial collectives' share of a
    step to ``out``."""
    from raft_tpu_torch import config
    from raft_tpu_torch.config import RAFTConfig
    from raft_tpu_torch.models.raft import RAFT
    from raft_tpu_torch.parallel import mesh as mesh_mod
    from raft_tpu_torch.train.step import init_state, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    config.CONV_TF32 = False
    with _rank_env(rank, SPATIAL_N, port):
        mesh = mesh_mod.init_from_env("cuda", backend="gloo",
                                      spatial=SPATIAL_N)
    sd = RAFT(RAFTConfig.full(), seed=0).state_dict()
    batches = _spatial_batches(mesh.device, mesh.spatial_index)
    # wall-clock stamps: when the rank was ready, when each arm ended
    res = {"mesh": mesh.mesh_shape(), "stamps": {"ready": time.time()}}
    # the halo argument of every upsample-loss kernel call: the model must
    # take the halo form under the mesh
    from raft_tpu_torch.ops import upsample_loss

    halos, apply = [], upsample_loss.UpsampleLossSums.apply

    def recording(flow, mask, gt, vmask, halo=0):
        halos.append(halo)
        return apply(flow, mask, gt, vmask, halo)

    upsample_loss.UpsampleLossSums.apply = recording
    for arm in SPATIAL_ARMS:
        halos.clear()
        cfg, mcfg = _spatial_cfgs(arm)
        state = init_state(mcfg, cfg, state_dict=sd)
        step_fn = make_train_step(cfg, mesh=mesh)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        losses, times, mu = [], [], None
        # the spatial collectives' share of a step: the kernel arm's last
        # step under the profiler on rank 0 (the profiler's own cost, a
        # few seconds an arm, is paid once)
        from torch.profiler import ProfilerActivity, profile

        for i, batch in enumerate(batches):
            traced = (rank == 0 and arm == SPATIAL_PROFILED_ARM
                      and i == len(batches) - 1)
            with (profile(activities=[ProfilerActivity.CPU]) if traced
                  else contextlib.nullcontext()) as prof:
                t0 = time.perf_counter()
                losses.append(float(step_fn(state, batch)[1]["loss"]))
                times.append((time.perf_counter() - t0) * 1e3)
            if mu is None:
                mu = _first_moments(state)
        torch.cuda.synchronize()
        rec = dict(losses=losses, step_ms=times, launches=_counts(),
                   first_moments=mu, loss_kernel_halos=list(halos),
                   params={k: v.detach().float().cpu() for k, v in
                           state.model.state_dict().items()},
                   peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                   nonfinite=int(state.nonfinite_steps))
        if rank == 0 and arm == SPATIAL_PROFILED_ARM:
            averages = prof.key_averages()
            rec.update(profiled_step_ms=times[-1],
                       halo_ms=_collective_ms(averages, mesh_mod.HALO_LABEL),
                       gather_ms=_collective_ms(averages,
                                                mesh_mod.GATHER_LABEL))
        res[arm] = rec
        res["stamps"][arm] = time.time()
        del state, step_fn
        torch.cuda.empty_cache()
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    mesh_mod.shutdown()
    return 0


def _spatial_rank_start(rank: int, port: int, out: str):
    return subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--spatial-rank",
         str(rank), "--spatial-port", str(port), "--spatial-out", out],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=dict(os.environ, PYTHONPATH=REPO,
                            PYTHONUNBUFFERED="1"))


@contextlib.contextmanager
def instance_norm_over_row_shards(n: int = SPATIAL_N):
    """Instance norm with its moments summed over ``n`` equal row shards
    and then added, the sharded step's order (exact arithmetic gives the
    same function): the straight run's twin whose difference from it is
    fp32 rounding alone.  With the seeded init several gradients
    (``fnet``'s, ``convc2``'s) are sums that cancel to a small part of
    their terms, and this reordering alone moves them by up to ~1.3% of
    their norm, as the sharded step does.  (The spatial tests take their
    twin from here too.)"""
    real = torch.nn.functional.instance_norm

    def sharded(x, eps=1e-5, **kwargs):
        cnt = x.shape[2] * x.shape[3]
        mean = sum(p.sum(dim=(2, 3)) for p in x.chunk(n, dim=2)) / cnt
        d = x - mean[..., None, None]
        var = sum((q * q).sum(dim=(2, 3)) for q in d.chunk(n, dim=2)) / cnt
        return d * torch.rsqrt(var + eps)[..., None, None]

    torch.nn.functional.instance_norm = sharded
    try:
        yield
    finally:
        torch.nn.functional.instance_norm = real


def _spatial_straight(sd) -> dict:
    """Each arm's straight twin: ``SPATIAL_STEPS`` eager steps on the
    whole global batches; then the reference's own rounding noise: again
    with each batch's rows (samples) reversed, with instance norm's sums
    taken over the row shards (the sharded order), and with cuDNN off
    (other convolution algorithms, as the shards' shapes take others);
    the peak memory of the first.  (The main process runs these while
    the ranks run; the ranks take the longer.)"""
    from raft_tpu_torch.train.step import init_state, make_train_step

    dev = torch.device("cuda")
    batches = _spatial_batches(dev)
    out = {}
    for arm in SPATIAL_ARMS:
        cfg, mcfg = _spatial_cfgs(arm)
        runs = []
        for flip, shards, cudnn in ((False, False, True),
                                    (True, False, True),
                                    (False, True, True),
                                    (False, False, False)):
            state = init_state(mcfg, cfg, state_dict=sd)
            step_fn = make_train_step(cfg, graphs=False)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            losses, mu = [], None
            torch.backends.cudnn.enabled = cudnn
            try:
                with (instance_norm_over_row_shards() if shards
                      else contextlib.nullcontext()):
                    for b in batches:
                        losses.append(float(step_fn(state, {
                            k: v.flip(0) if flip else v for k, v in
                            b.items()})[1]["loss"]))
                        if mu is None:
                            mu = _first_moments(state)
            finally:
                torch.backends.cudnn.enabled = True
            runs.append(dict(params={k: v.detach().float().cpu() for k, v in
                                     state.model.state_dict().items()},
                             first_moments=mu, losses=losses,
                             peak_gib=torch.cuda.max_memory_allocated()
                             / 2 ** 30))
            del state, step_fn
            torch.cuda.empty_cache()
        out[arm] = runs
    return out


def _spatial_check(sd, arm: str, ranks, straight) -> dict:
    """One arm: the ranks bit for bit each other; against the straight
    run, the first moment after step 1 and each parameter's change after
    ``SPATIAL_STEPS`` steps within ``_grad_agreement``'s norm bound
    widened by ``EAGER_SPREAD_FACTOR`` times the straight run's own
    spread (the largest of its twins': reversed rows, instance norm's
    sums over the row shards, cuDNN off; the doubled change must fail
    it), losses
    within ``BF16_LOSS_TOL``; every kernel of the arm counted on each rank,
    no step skipped."""
    ref, *twins = straight
    p0 = {k: v.float() for k, v in sd.items()}
    recs = [r[arm] for r in ranks]
    params = [k for k in ref["params"] if "running" not in k]
    same = all(torch.equal(recs[0]["params"][k], recs[1]["params"][k])
               for k in recs[0]["params"])
    res = {"ranks_bit_equal": same}
    for what, got, want, others in (
            ("first_moment", recs[0]["first_moments"],
             ref["first_moments"], [t["first_moments"] for t in twins]),
            ("change", {k: recs[0]["params"][k] - p0[k] for k in params},
             {k: ref["params"][k] - p0[k] for k in params},
             [{k: t["params"][k] - p0[k] for k in params} for t in twins])):
        spread = {k: EAGER_SPREAD_FACTOR * max(
            float((o[k] - want[k]).norm()) for o in others) for k in want}
        res[what] = _grad_agreement(got, want, spread)
        res[f"{what}_doubled"] = _grad_agreement(
            {k: 2 * v for k, v in got.items()}, want, spread)["leaf_ratio"]
    res["stats_max_abs"] = max(
        float((recs[0]["params"][k] - ref["params"][k]).abs().max())
        for k in ref["params"] if "running" in k)
    res["loss_rel"] = max(abs(a - b) / abs(b) for a, b in
                          zip(recs[0]["losses"], ref["losses"]))
    want_counts = _spatial_launches(arm)
    counts = [{k: v for k, v in r["launches"].items() if v} for r in recs]
    res.update(losses=[r["losses"] for r in recs],
               straight_losses=ref["losses"], launches=counts,
               step_ms=[r["step_ms"] for r in recs],
               peak_gib=[r["peak_gib"] for r in recs],
               straight_peak_gib=ref["peak_gib"])
    print(f"[spatial] {arm}: 2 gloo ranks on one card (data 1 x spatial 2, "
          f"{CHAIRS_HW[0] // SPATIAL_N} of {CHAIRS_HW[0]} rows a rank, "
          f"B {SPATIAL_B}) against the straight B {SPATIAL_B} run over "
          f"{SPATIAL_STEPS} eager bf16 steps: ranks bit for bit {same}, "
          f"first moment {res['first_moment']}, change {res['change']}, "
          f"doubled controls {res['first_moment_doubled']:.3f} / "
          f"{res['change_doubled']:.3f} (must exceed 1), statistics max |d| "
          f"{res['stats_max_abs']:.3e}, loss rel {res['loss_rel']:.3e}, "
          f"launches per rank {counts} (the loss kernels' halo "
          f"{[r['loss_kernel_halos'] for r in recs]}); eager ms/step "
          f"{res['step_ms']}",
          flush=True)
    print(f"[spatial] {arm}: peak memory per rank {res['peak_gib']} GiB "
          f"against the straight run's {ref['peak_gib']:.2f} GiB",
          flush=True)
    if "profiled_step_ms" in recs[0]:
        res.update({k: recs[0][k] for k in (
            "profiled_step_ms", "halo_ms", "gather_ms")})
        res["halo_share"] = res["halo_ms"] / res["profiled_step_ms"]
        res["gather_share"] = res["gather_ms"] / res["profiled_step_ms"]
        print(f"[spatial] {arm}: spatial collectives in rank 0's last "
              f"step under the profiler ({res['profiled_step_ms']:.1f} "
              f"ms): halo exchanges {res['halo_ms']:.1f} ms "
              f"({100 * res['halo_share']:.1f}%), fmap2 gathers "
              f"{res['gather_ms']:.1f} ms ({100 * res['gather_share']:.1f}"
              f"%) (host time inside the collectives: gloo copies through "
              f"the host, waiting for the card's queued work)", flush=True)
    if not same or res["first_moment"]["leaf_ratio"] > 1.0 \
            or res["change"]["leaf_ratio"] > 1.0 \
            or res["first_moment_doubled"] <= 1.0 \
            or res["change_doubled"] <= 1.0 \
            or res["loss_rel"] > BF16_LOSS_TOL \
            or counts != [want_counts] * SPATIAL_N \
            or any(r["loss_kernel_halos"] != [1] * SPATIAL_STEPS
                   for r in recs) \
            or any(r["nonfinite"] for r in recs):
        raise AssertionError(f"spatial {arm}: {res}, want launches "
                             f"{want_counts}")
    return res


def phase_spatial(sd) -> dict:
    """Spatially sharded training on the card (see the module docstring,
    phase 13)."""
    import shutil

    work = os.path.join(WORK, "spatial")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    t, t_wall = time.perf_counter(), time.time()
    port = _free_port()
    procs = [_spatial_rank_start(r, port, work) for r in range(SPATIAL_N)]
    secs = {}
    try:
        straight = _spatial_straight(sd)
        secs["straight"] = time.perf_counter() - t
        _wait_ranks(procs)
        secs["ranks"] = time.perf_counter() - t
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    ranks = [torch.load(os.path.join(work, f"rank{r}.pt"),
                        weights_only=False) for r in range(SPATIAL_N)]
    if [r["mesh"] for r in ranks] != [{"data": 1, "spatial": 2}] * 2:
        raise AssertionError(f"spatial: mesh {[r['mesh'] for r in ranks]}")
    res = {arm: _spatial_check(sd, arm, ranks, straight[arm])
           for arm in SPATIAL_ARMS}
    res["phase_s"] = time.perf_counter() - t
    for k, v in secs.items():       # from the phase's start
        print(f"[time] spatial {k} done: {v:.1f} s", flush=True)
    for r, rec in enumerate(ranks):
        print(f"[time] spatial rank {r} from the phase's start: " + ", ".join(
            f"{k} {v - t_wall:.1f} s" for k, v in rec["stamps"].items()),
            flush=True)
    res["rank_stamps_s"] = [{k: v - t_wall for k, v in r["stamps"].items()}
                            for r in ranks]
    print(f"[time] spatial: {res['phase_s']:.1f} s", flush=True)
    return res


# --- phase clis: subprocesses checked side by side, timing nothing --------

def phase_clis(tree):
    """Phase small's curriculum and lk-compare CLIs and phase fleet's
    ``serve --replicas 2``, run at once: each is checked, none timed, and
    together they take the time of the slowest.  Phase train_cli runs
    this on a thread beside its own CLI's subprocesses."""
    import shutil

    from raft_tpu_torch.config import RAFTConfig
    from raft_tpu_torch.models.raft import RAFT

    work = os.path.join(WORK, "clis")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    sd = RAFT(RAFTConfig.small_model(), seed=0).state_dict()
    child = _fleet_cli_start()
    cost = _Child(["cost"])
    try:
        small = _small_clis(tree, work, sd)
        fleet = _fleet_cli(_serve_pairs(2), child)
        cost_rc = cost.finish(timeout=600)
    finally:
        child.kill()
        cost.kill()
    return {"small": small, "fleet": fleet,
            "cost": _cost_table(cost_rc, cost.lines)}


def _cost_table(rc: int, lines) -> dict:
    """``python -m raft_tpu_torch cost`` at the chairs shapes (the shipped
    training configuration, bf16; train 368x496 B 8, 12 iterations; the
    serving pair at 440x1024 x 4 lanes): the table printed as it is, each
    of the four programs counted (GFLOPs and MB above 0, ``counted``) and
    classified against the H100's peaks."""
    for line in lines:
        print(f"[clis] cost | {line}", flush=True)
    rows = {}
    for line in lines:
        m = re.match(r"^(train_step|inference_\d+x\d+|serve_(?:enc|iter)_"
                     r"\d+x\d+_b\d+)\s+([\d.]+)\s+([\d.]+)\s+(\S+)\s+"
                     r"(\S+)\s+(\d+)\s+(\S+)$", line)
        if m:
            rows[m.group(1)] = {"gflops": float(m.group(2)),
                                "mb": float(m.group(3)),
                                "bound_by": m.group(5),
                                "flops_per_pair": int(m.group(6)),
                                "source": m.group(7)}
    head = next((ln for ln in lines if ln.startswith("device_kind:")), "")
    if (rc != 0 or set(rows) != {"train_step", "inference_368x496",
                                 "serve_enc_440x1024_b4",
                                 "serve_iter_440x1024_b4"}
            or "989.400" not in head
            or any(r["gflops"] <= 0 or r["mb"] <= 0 or r["source"]
                   != "counted" or r["bound_by"] not in ("compute",
                                                         "memory")
                   for r in rows.values())):
        raise AssertionError(f"cost CLI rc {rc}: {lines[-12:]}")
    return {"device": head, "programs": rows}


class _Beside:
    """``fn(*args)`` on a thread beside the caller's own work: ``join``
    waits for it, ``result`` gives its value or raises its exception."""

    def __init__(self, fn, *args):
        import threading

        self._out = {}

        def run():
            try:
                self._out["value"] = fn(*args)
            except BaseException as e:      # raised again in result()
                self._out["error"] = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def join(self) -> None:
        self._thread.join()

    def result(self):
        self.join()
        if "error" in self._out:
            raise self._out["error"]
        return self._out["value"]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--report", default=None,
                   help="also write every number to this JSON file")
    # one rank of phase ddp's 2-rank run (the phase starts these itself)
    p.add_argument("--ddp-rank", type=int, default=None,
                   help=argparse.SUPPRESS)
    p.add_argument("--ddp-world", type=int, default=2,
                   help=argparse.SUPPRESS)
    p.add_argument("--ddp-port", type=int, default=None,
                   help=argparse.SUPPRESS)
    p.add_argument("--ddp-out", default=None, help=argparse.SUPPRESS)
    # one rank of phase spatial's 2-rank run (the phase starts these)
    p.add_argument("--spatial-rank", type=int, default=None,
                   help=argparse.SUPPRESS)
    p.add_argument("--spatial-port", type=int, default=None,
                   help=argparse.SUPPRESS)
    p.add_argument("--spatial-out", default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; it needs one NVIDIA GPU",
              file=sys.stderr)
        return 2
    from raft_tpu_torch import config  # fails without the repository

    if args.ddp_rank is not None:
        return _ddp_rank_main(args.ddp_rank, args.ddp_world, args.ddp_port,
                              args.ddp_out)
    if args.spatial_rank is not None:
        return _spatial_rank_main(args.spatial_rank, args.spatial_port,
                                  args.spatial_out)

    global SHIPPED_CONV_TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # every entry point sets cuDNN TF32 for its calls from this: off for
    # the fp32 checks and timings, the shipped value where a phase says so
    SHIPPED_CONV_TF32, config.CONV_TF32 = config.CONV_TF32, False
    t0 = time.perf_counter()
    secs = {}

    def timed_phase(fn, *a):
        t = time.perf_counter()
        out = fn(*a)
        secs[fn.__name__] = time.perf_counter() - t
        print(f"[time] {fn.__name__}: {secs[fn.__name__]:.1f} s", flush=True)
        return out

    smi, name = phase_device()
    peaks = _peaks(name)
    build_res = phase_build()
    kern = {**timed_phase(phase_kernels, peaks),
            **timed_phase(phase_train_kernels, peaks),
            **timed_phase(phase_bwd_kernels, peaks),
            **timed_phase(phase_slice4_kernels, peaks)}
    small_kern = timed_phase(phase_small_kernels, peaks)
    path, main_counts, sd = timed_phase(phase_path)
    serve = timed_phase(phase_serve, sd, peaks)
    fleet = timed_phase(phase_fleet, sd)
    graphs = timed_phase(phase_graphs, sd)
    demo_res = timed_phase(phase_demo, sd)
    eval_res = timed_phase(phase_eval, sd)
    train, train_counts = timed_phase(phase_train, sd)
    train_cli = timed_phase(phase_train_cli, sd, train)
    clis = train_cli.pop("clis")
    ddp = timed_phase(phase_ddp, sd, train_cli["tree"])
    spatial = timed_phase(phase_spatial, sd)
    small = {"kernels": small_kern,
             **timed_phase(phase_small, sd, train_cli["tree"])}
    small["clis"], fleet["cli"] = clis["small"], clis["fleet"]
    cost_cli = clis["cost"]
    secs["total"] = time.perf_counter() - t0

    sources = {
        "corr_ondemand": ("raft_tpu_torch/csrc/corr_ondemand.cu",
                          "raft_tpu/ops/pallas_corr.py:174"),
        "gru_gate_rh": ("raft_tpu_torch/csrc/gru_gates.cu",
                        "raft_tpu/ops/pallas_gru.py:84"),
        "gru_gate_blend": ("raft_tpu_torch/csrc/gru_gates.cu",
                           "raft_tpu/ops/pallas_gru.py:99"),
        "pyramid_lookup_fwd": ("raft_tpu_torch/csrc/pyramid_lookup.cu",
                               "raft_tpu/ops/pallas_corr.py:660"),
        "pyramid_lookup_bwd": ("raft_tpu_torch/csrc/pyramid_lookup.cu",
                               "raft_tpu/ops/pallas_corr.py:682"),
        "upsample_loss_fwd": ("raft_tpu_torch/csrc/upsample_loss.cu",
                              "raft_tpu/ops/pallas_upsample.py:110"),
        "upsample_loss_bwd": ("raft_tpu_torch/csrc/upsample_loss.cu",
                              "raft_tpu/ops/pallas_upsample.py:129"),
        "corr_ondemand_bwd": ("raft_tpu_torch/csrc/corr_ondemand.cu",
                              "raft_tpu/ops/pallas_corr.py:261,375,396"),
        "gru_gate_rh_bwd": ("raft_tpu_torch/csrc/gru_gates.cu",
                            "raft_tpu/ops/pallas_gru.py:90"),
        "gru_gate_blend_bwd": ("raft_tpu_torch/csrc/gru_gates.cu",
                               "raft_tpu/ops/pallas_gru.py:106"),
        "pyramid_lookup_quantized": ("raft_tpu_torch/csrc/pyramid_lookup.cu",
                                     "raft_tpu/ops/pallas_corr.py:660 via "
                                     ":871"),
        "lookup_encode": ("raft_tpu_torch/csrc/lookup_encode.cu",
                          "raft_tpu/ops/pallas_corr.py:1165")}
    from raft_tpu_torch.ops import gru_gates

    kernels = []
    for kname, (src, replaces) in sources.items():
        r = kern[kname]
        # each kernel's launches on the main path it belongs to: the
        # inference forward, the allpairs_pallas, the on-demand or the
        # int8 + fused-encoder train step
        if kname in ("pyramid_lookup_quantized", "lookup_encode"):
            counts = train_counts["int8_fused"]
        elif kname.startswith(("pyramid", "upsample")):
            counts = train_counts["kernel"]
        elif kname.endswith("_bwd"):
            counts = train_counts["ondemand"]
        else:
            counts = main_counts
        # the small model's main paths: the on-demand and the fused-encoder
        # test-mode forward, the allpairs_pallas and the on-demand train
        # step (the quantized lookup is checked at its shapes only, and
        # the small model never reaches the upsample-loss kernel)
        sm = small["main_counts"]
        small_counts = {}
        for d in (sm["inference"]["fused"], sm["inference"]["ondemand"],
                  sm["train"]["kernel"], sm["train"]["ondemand"]):
            for k, v in d.items():
                if v:
                    small_counts.setdefault(k, v)
        rs = small["kernels"].get(kname)
        # the serving path (kernel configuration): launches of one iter
        # replay over the slots, through the fleet's router (3 requests of
        # 32 iterations), and the kernel at the slot shape
        sv = serve["kernels"].get(kname)
        serve_rec = {"launches_per_replay": serve["replay_launches"][
            "kernel"]["iter"].get(kname, 0),
            "fleet_launches": fleet["launches"].get(kname, 0), **(
            {k: sv[k] for k in ("max_abs_err", "ms", "plain_ms",
                                "bound_ms", "bound_by")} if sv else {})}
        kernels.append({
            "name": kname, "route": "cuda", "source": src,
            "replaces": replaces, "launches": counts[kname],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r.get("library_ms"),
            "small": {"launches": small_counts.get(kname, 0), **(
                {k: rs[k] for k in ("max_abs_err", "ms", "plain_ms",
                                    "bound_ms", "bound_by")} if rs else {})},
            "serve": serve_rec,
            # data parallel: launches of the world-1 NCCL step (the train
            # CLI's configuration) and of each of 2 gloo ranks (the
            # kernel configuration), each over its own steps
            "ddp": {"world1_launches": ddp["world1"]["ddp"]["launches"]
                    .get(kname, 0), "world1_steps": DDP_STEPS,
                    "per_rank_launches": [c.get(kname, 0) for c in
                                          ddp["two_ranks"]["launches"]],
                    "per_rank_steps": DDP_SPLIT_STEPS},
            # spatial sharding: each of the 2 ranks' launches per arm
            "spatial": {"per_rank_launches": {
                arm: [c.get(kname, 0) for c in spatial[arm]["launches"]]
                for arm in SPATIAL_ARMS}, "per_rank_steps": SPATIAL_STEPS}})
        if kname.startswith("upsample_loss"):
            # the row-halo form at phase spatial's shard shape
            kernels[-1]["halo"] = {
                dt: {k: kern[f"{kname}/halo/{dt}"][k] for k in (
                    "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                    "shape")} for dt in ("fp32", "bf16")}
        if kname in gru_gates.GATE_UNROLL:
            # the vectorized gates' design (csrc/gru_gates.cu) and the
            # access width its plan took at the timed shape
            kernels[-1]["design"] = {
                "access": "16-byte vectors, one value off 16 bytes",
                "vectors_in_flight": gru_gates.GATE_UNROLL[kname],
                "grid": f"one wave of {gru_gates.GATE_BLOCKS_PER_SM} x "
                        f"{gru_gates.GATE_THREADS}-thread blocks an SM "
                        "walking (sample, chunk) units",
                "vector_bytes": r["vector_bytes"]}
        if kernels[-1]["launches"] < 1:
            raise AssertionError(f"{kname}: no launch on its main path")
        if (kname.startswith("upsample_loss")
                != (kernels[-1]["small"]["launches"] == 0)
                and kname != "pyramid_lookup_quantized"):
            raise AssertionError(f"{kname}: small-model launches "
                                 f"{kernels[-1]['small']['launches']}")
    if args.report:
        os.makedirs(os.path.dirname(os.path.abspath(args.report)),
                    exist_ok=True)
        with open(args.report, "w") as f:
            json.dump({"nvidia_smi": smi, "device": name,
                       "torch": torch.__version__, "cuda": torch.version.cuda,
                       "build": build_res, "phase_s": secs,
                       "kernels": kern, "path": path, "serve": serve,
                       "fleet": fleet,
                       "graphs": graphs, "demo": demo_res,
                       "eval": eval_res,
                       "train": train, "train_cli": train_cli,
                       "ddp": ddp, "spatial": spatial,
                       "small": small, "cost_cli": cost_cli}, f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
