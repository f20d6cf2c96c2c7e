#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``raft_tpu_torch``) on one NVIDIA
GPU (written for the H100).

    python3 chip_smoke.py                      # from the repository root
    python3 chip_smoke.py --report out.json    # also write every number

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
   (``torch.profiler``; CUDA events where it reports none) beside the
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
     into its allocation);
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
5. demo: the demo CLI on ``demo-frames`` with ``--alternate_corr``;
6. train: ``make_train_step`` with each kernel configuration against
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
7. report: one JSON line ``{"kernels": [...]}``, the nvidia-smi line,
   and last ``{"ok": true, "device": {...}}``.

It imports nothing of JAX.  Without CUDA it exits nonzero before any
result.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
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
    device time (then the CUDA-event time stands)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
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


def _profile(fn, reps: int = 2) -> dict:
    """Device activity of ``reps`` calls from ``torch.profiler`` (CUDA
    activity only): ``busy_ms`` per call is the union of the device
    intervals (kernels, copies and sets never counted twice), ``wall_ms``
    per call the host clock over the same window, ``idle_share`` the
    rest, and ``by_kind`` the summed kernel time per call by kind (each
    of the port's kernels, cuDNN/cuBLAS convolutions and matrix
    products, everything else).  Busy is None when the profiler reports
    no device time."""
    from torch.profiler import ProfilerActivity, profile

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
    """CUDA-event time of one call (host launch gaps included) and the
    profiler's device time of its kernels; ``ms`` is the device time when
    the profiler reports one."""
    event_ms = _time_ms(fn, reps=reps)
    dev_ms = _device_ms(fn, match=match)
    return {"ms": dev_ms if dev_ms is not None else event_ms,
            "event_ms": event_ms, "device_ms": dev_ms}


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


def _corr_inputs(rng, B, h, w, dev, dist="a"):
    from raft_tpu_torch.ops.corr_kernels import sample_centers

    f1 = torch.from_numpy(rng.standard_normal((B, h, w, C))
                          .astype(np.float32)).to(dev)
    f2 = torch.from_numpy(rng.standard_normal((B, h, w, C))
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


def _corr_ops(coords: np.ndarray, shapes, k: int) -> float:
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
        ops += float((cnt[0] * cnt[1]).sum()) * 2 * C + n * k * k * 7
    return ops


def phase_kernels(peaks):
    from raft_tpu_torch.ops.corr import chunked_corr_lookup, pool_fmap_pyramid
    from raft_tpu_torch.ops.corr_kernels import (_plain,
                                                 corr_lookup_ondemand,
                                                 corr_lookup_ondemand_nchw,
                                                 kernel_path_counts)
    from raft_tpu_torch.ops.gru_gates import (gru_gate_blend,
                                              gru_gate_blend_plain,
                                              gru_gate_rh, gru_gate_rh_plain)

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

        # --- GRU gates: (1|2, 128, 55, 128), fp32 and bf16, split views ---
        for B in (1, 2):
            for dtype in (torch.float32, torch.bfloat16):
                zr, q, hh = (torch.from_numpy(
                    rng.standard_normal((B, c, h8, w8)).astype(np.float32)
                    * scale).to(dev, dtype)
                    for c, scale in ((256, 3.0), (128, 3.0), (128, 1.0)))
                z, r = torch.split(zr, 128, dim=1)      # split views
                cases = {
                    "gru_gate_rh": (lambda: gru_gate_rh(r, hh),
                                    lambda: gru_gate_rh_plain(r, hh), 2, 4,
                                    "rh_kernel"),
                    "gru_gate_blend": (lambda: gru_gate_blend(z, q, hh),
                                       lambda: gru_gate_blend_plain(z, q, hh),
                                       3, 8, "blend_kernel"),
                }
                for name, (kern, plain, n_in, flops, kname) in cases.items():
                    got, want = kern(), plain()
                    torch.cuda.synchronize()
                    diff = (got.float() - want.float()).abs()
                    err = float(diff.max())
                    if dtype == torch.float32:
                        ok, tol = err <= 1e-6, "1e-6"
                    else:
                        # one bf16 ulp of the plain value, plus the fp32
                        # bound: where (1-s)h and s*tanh(q) cancel, an fp32
                        # difference of 1e-7 is several ulps of the tiny
                        # result
                        w32 = want.float().abs().clamp_min(2.0 ** -126)
                        ulp = torch.exp2(torch.floor(torch.log2(w32)) - 7)
                        ok = bool((diff <= ulp + 1e-6).all())
                        tol = "1 bf16 ulp + 1e-6"
                    # batch 2 checks the batch strides; batch 1 is timed
                    tk, tp = ((_timed(kern, kname), _timed(plain, None))
                              if B == 1 else ({"ms": None}, {"ms": None}))
                    ms, plain_ms = tk["ms"], tp["ms"]
                    esize = got.element_size()
                    nbytes = (n_in + 1) * got.numel() * esize
                    bound, by = _bound_ms(nbytes, flops * got.numel(), peaks)
                    dt = "fp32" if dtype == torch.float32 else "bf16"
                    print(f"[kernels] {name} B={B} {dt} "
                          f"{tuple(got.shape)}: max|err| {err:.3e} ({tol}); "
                          f"kernel {tk}, plain {tp}, bound {bound:.4f} ms "
                          f"({by})", flush=True)
                    if not ok:
                        raise AssertionError(f"{name} B={B} {dt}: {err}")
                    results[f"{name}/B{B}/{dt}"] = dict(
                        max_abs_err=err, ms=ms, plain_ms=plain_ms,
                        bound_ms=bound, bound_by=by, bytes=nbytes,
                        kernel_timing=tk, plain_timing=tp)
                    if B == 1 and dtype == torch.float32:
                        results[name] = results[f"{name}/B{B}/{dt}"]
    return results


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


def _corr_bwd_case(rng, B, h, w, label, peaks, time_plain=True, dist="a"):
    """The on-demand lookup backward kernel against its plain version on
    one input (centers from distribution ``dist`` of ``CENTERS``), with
    an NHWC and an NCHW tap gradient; the kernel's (and the plain
    version's) time, the bound from this run's centers and the box-path
    share.  df2 comes from atomic adds whose order varies between runs:
    held to the tolerance, never compared bit for bit."""
    from raft_tpu_torch.ops.corr import pool_fmap_pyramid
    from raft_tpu_torch.ops.corr_kernels import (
        corr_lookup_ondemand, corr_lookup_ondemand_bwd_plain,
        corr_lookup_ondemand_nchw, kernel_path_counts)

    dev = torch.device("cuda")
    k = 2 * R + 1
    P = LEVELS * k * k
    f1, f2, coords = _corr_inputs(rng, B, h, w, dev, dist)
    f1.requires_grad_(True)
    pyr = [lv.contiguous().requires_grad_(True)
           for lv in pool_fmap_pyramid(f2, LEVELS)]
    g = torch.from_numpy(rng.standard_normal((B, h, w, P)).astype(
        np.float32)).to(dev)
    leaves = [f1, *pyr]
    want = corr_lookup_ondemand_bwd_plain(f1, pyr, coords, R, g)
    want = [want[0], *want[1]]
    err = 0.0
    outs = {}
    for layout, fn, cot in (
            ("nhwc", corr_lookup_ondemand, g),
            ("nchw", corr_lookup_ondemand_nchw, g.permute(0, 3, 1, 2))):
        out = fn(f1, pyr, coords, R)
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
                                   coords, R, g)["bwd"]
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
    tp = (_timed(lambda: corr_lookup_ondemand_bwd_plain(f1, pyr, coords, R,
                                                        g), None, reps=3)
          if time_plain else {"ms": None})
    shapes = [tuple(p.shape[1:3]) for p in pyr]
    win = _window_elems(coords.cpu().numpy(), shapes, k)
    lvl = sum(p.numel() for p in pyr)
    nbytes = 4 * (2 * f1.numel() + coords.numel() + g.numel() + 2 * lvl)
    ops = 4.0 * C * win + 8.0 * B * h * w * P
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


# Layouts of the reset-gate backward on each access path: the model's
# (r a channel half, g a channel slice) on an odd grid (16-byte vectors),
# 3 channels on that grid, and r one channel off with a gradient of one
# more channel (so its batch stride is off too), at the chairs size (bf16
# off 16 bytes; more units than one wave) and on the odd grid (both
# types off).  (label, B, C, H, W, r channel offset, extra gradient
# channels, values per access in fp32, in bf16)
RH_RAGGED = (("45x63", 2, 128, 45, 63, 0, 0, 4, 8),
             ("3 channels 45x63", 2, 3, 45, 63, 0, 0, 1, 1),
             ("46x62 offset", 8, 128, 46, 62, 1, 1, 4, 1),
             ("45x63 offset", 2, 128, 45, 63, 1, 1, 1, 1))


def _rh_ragged_cases(rng, dev):
    """``gru_gate_rh``'s backward kernel against its plain version on
    ``RH_RAGGED``, fp32 and bf16; raises unless each case takes its
    access path."""
    from raft_tpu_torch.ops import gru_gates

    for label, B, C, H, W, r_off, g_pad, ve32, ve16 in RH_RAGGED:
        for dtype, want_ve in ((torch.float32, ve32), (torch.bfloat16, ve16)):
            dt = "fp32" if dtype == torch.float32 else "bf16"

            def mk(c, scale=1.0):
                return (torch.from_numpy(rng.standard_normal((B, c, H, W))
                                         .astype(np.float32)) * scale).to(
                    dev, dtype)

            zr, hh, g_cat = mk(2 * C + r_off, 3.0), mk(C), mk(3 * C + g_pad)
            zr.requires_grad_(True)
            hh.requires_grad_(True)
            r, g = zr[:, C + r_off:2 * C + r_off], g_cat[:, :C]
            strides = [gru_gates._batch_strided(t)[1] for t in (r, hh, g)]
            ve, _ = gru_gates.rh_bwd_plan(
                [r.data_ptr(), hh.data_ptr(), g.data_ptr()], strides,
                C * H * W, B, hh.element_size(), 132)
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
            del zr, hh, g_cat, r, g, dzr, dh, want


def phase_bwd_kernels(peaks):
    """The backward kernels of the on-demand configuration against their
    plain versions: the GRU gates and the lookup at the chairs shapes,
    and the lookup at a 136x240 grid."""
    from raft_tpu_torch.ops.gru_gates import (gru_gate_blend,
                                              gru_gate_blend_bwd_plain,
                                              gru_gate_rh,
                                              gru_gate_rh_bwd_plain)

    dev = torch.device("cuda")
    rng = np.random.default_rng(3)
    results = {}
    B = CHAIRS_B
    h8, w8 = CHAIRS_HW[0] // 8, CHAIRS_HW[1] // 8

    # --- GRU gates: z/r halves of one convzr output; rh's gradient a
    # channel slice of the gradient of cat([rh, x]) (x: 256 channels) ---
    for dtype in (torch.float32, torch.bfloat16):
        dt = "fp32" if dtype == torch.float32 else "bf16"

        def mk(c, scale=1.0):
            return (torch.from_numpy(rng.standard_normal((B, c, h8, w8))
                                     .astype(np.float32)) * scale).to(
                dev, dtype)

        zr, q, hh = mk(256, 3.0), mk(128, 3.0), mk(128)
        g_cat, g_bl = mk(384), mk(128)
        g_rh = g_cat[:, :128]
        zr.requires_grad_(True)
        q.requires_grad_(True)
        hh.requires_grad_(True)
        z, r = torch.split(zr, 128, dim=1)
        rh, bl = gru_gate_rh(r, hh), gru_gate_blend(z, q, hh)
        cases = {
            "gru_gate_rh_bwd": (
                rh, (zr, hh), g_rh, lambda d: [d[0][:, 128:], d[1]],
                lambda: gru_gate_rh_bwd_plain(r, hh, g_rh), 5, 9,
                "rh_bwd_kernel"),
            "gru_gate_blend_bwd": (
                bl, (zr, q, hh), g_bl, lambda d: [d[0][:, :128], d[1], d[2]],
                lambda: gru_gate_blend_bwd_plain(z, q, hh, g_bl), 7, 19,
                "blend_bwd_kernel")}
        for name, (out, leaves, g, pick, plain, n_io, flops,
                   kname) in cases.items():
            got = pick(torch.autograd.grad(out, leaves, g, retain_graph=True))
            want = plain()
            err = max(_check(f"{name} {dt} {'d' + v} {tuple(a.shape)}", a, b)
                      for v, a, b in zip("zqh" if len(got) == 3 else "rh",
                                         got, want))
            tk = _timed(lambda: torch.autograd.grad(out, leaves, g,
                                                    retain_graph=True),
                        kname)
            tp = _timed(plain, None)
            nbytes = n_io * g_bl.numel() * g_bl.element_size()
            bound, by = _bound_ms(nbytes, flops * g_bl.numel(), peaks)
            print(f"[kernels] {name} {dt} {tuple(g_bl.shape)}: kernel {tk}, "
                  f"plain {tp}, bound {bound:.4f} ms ({by})", flush=True)
            results[f"{name}/{dt}"] = dict(
                max_abs_err=err, ms=tk["ms"], plain_ms=tp["ms"],
                library_ms=None, bound_ms=bound, bound_by=by, bytes=nbytes,
                kernel_timing=tk, plain_timing=tp)
        del zr, q, hh, g_cat, g_bl, rh, bl, cases
    _rh_ragged_cases(np.random.default_rng(6), dev)

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
    from raft_tpu_torch.ops import (corr_kernels, gru_gates, lookup_encode,
                                    pyramid_kernels, upsample_loss)

    return (corr_kernels.LAUNCHES, gru_gates.LAUNCHES,
            pyramid_kernels.LAUNCHES, upsample_loss.LAUNCHES,
            lookup_encode.LAUNCHES)


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
            torch.cuda.reset_peak_memory_stats()
            eval_fn(sd, img1, img2)                      # warm-up
            torch.cuda.synchronize()
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


def _chairs_batch(dev):
    """One synthetic FlyingChairs-shaped batch, made on the host from a
    seed: uniform frames, flow 8 * N(0, 1), all pixels valid."""
    rng = np.random.default_rng(0)
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
    del state
    torch.cuda.empty_cache()
    return met, grads


def _grad_agreement(gk: dict, gp: dict) -> dict:
    """Per parameter: max|dg| against 1e-3 of max|g| plus the fp32 floor
    on the model's largest entry, and |dg| against the bf16 share of |g|
    plus the bf16 floor on the global norm, each as a ratio (<= 1 passes);
    the worst parameter of each."""
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
                                     + BF16_GRAD_FLOOR * gnorm)
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


def compare_train_step(sd, batch, cfg, dtype: str, pair: str) -> dict:
    """One train step of a kernel configuration and of its plain one
    (``TRAIN_PAIRS[pair]``) from the same weights on the same batch, with
    the clip out of reach so the optimizer sees the unclipped gradients,
    which are captured there.  fp32: metrics within 1e-4 relative and
    every parameter's gradient within the fp32 bounds above; bf16: the
    loss within ``BF16_LOSS_TOL`` relative and every gradient within the
    bf16 bounds."""
    from raft_tpu_torch.config import RAFTConfig

    cmp_cfg = dataclasses.replace(cfg, clip=1e9)
    (mk, gk), (mp, gp) = (
        _step_grads(sd, batch, cmp_cfg,
                    RAFTConfig.full(compute_dtype=dtype, **extra))
        for extra in TRAIN_PAIRS[pair])
    rel = {k: float(np.abs(mk[k] - mp[k]).max()
                    / max(float(np.abs(mp[k]).max()), 1e-12))
           for k in ("loss", "epe", "1px", "3px", "5px", "grad_norm",
                     "loss_iter", "epe_iter")}
    agree = _grad_agreement(gk, gp)
    print(f"[train] chairs {dtype} one step, {pair} vs plain config: "
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
                ("int8", INT8_CFG, (1, 3, 1))):
            t_cfg = time.perf_counter()
            key = f"{label}/{dtype}"
            mcfg = RAFTConfig.full(compute_dtype=dtype, **extra)
            torch.cuda.empty_cache()
            state = init_state(mcfg, cfg, state_dict=sd)
            for _ in range(n_warm):                           # warm-up
                step_fn(state, batch)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
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
        step_fn(state, batch)                                 # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
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


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--report", default=None,
                   help="also write every number to this JSON file")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; it needs one NVIDIA GPU",
              file=sys.stderr)
        return 2
    import raft_tpu_torch  # noqa: F401  (fails without the repository)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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
    path, main_counts, sd = timed_phase(phase_path)
    demo_res = timed_phase(phase_demo, sd)
    train, train_counts = timed_phase(phase_train, sd)
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
        kernels.append({
            "name": kname, "route": "cuda", "source": src,
            "replaces": replaces, "launches": counts[kname],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r.get("library_ms")})
        if kernels[-1]["launches"] < 1:
            raise AssertionError(f"{kname}: no launch on its main path")
    if args.report:
        os.makedirs(os.path.dirname(os.path.abspath(args.report)),
                    exist_ok=True)
        with open(args.report, "w") as f:
            json.dump({"nvidia_smi": smi, "device": name,
                       "torch": torch.__version__, "cuda": torch.version.cuda,
                       "build": build_res, "phase_s": secs,
                       "kernels": kern, "path": path,
                       "demo": demo_res, "train": train}, f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
