#!/usr/bin/env python3
"""Time variants of one of the port's CUDA kernels against each other on
one NVIDIA GPU, in one process.

    python3 lookup_ab.py [--kernel NAME] [--parent OTHER/raft_tpu_torch/csrc]

``--kernel`` (default ``pyramid_lookup_fwd``) picks the kernel and the
source that holds it: ``pyramid_lookup_fwd`` (``pyramid_lookup.cu``),
``upsample_loss_bwd`` (``upsample_loss.cu``) or ``gru_gate_rh_bwd``
(``gru_gates.cu``).  The script builds that source as it is ("change"),
the same source from another checkout's ``csrc`` directory
(``--parent``), and probes: copies of a source with one step of the
kernel left out or changed (``PROBES``; those named ``parent_*`` are
copies of the parent's source and run only with ``--parent``).  Each
goes through ``nvcc`` into its own library under ``build/lookup_ab/``,
all ``nvcc`` started together.  Then it times each library through the
port's wrapper (the parent and its probes through the parent checkout's
own wrapper module, ``ops/<module>.py`` beside its ``csrc``, so that a
changed argument list is called as that checkout calls it;
``torch.profiler`` device time of the kernel, CUDA events where the
profiler reports none) at the chairs training shape, in the order
parent, change, probes, probes, change, parent, so that drift between
the two passes shows.  The parent's and the change's results are first
held to the plain version (``chip_smoke``'s tolerance); the probes
compute wrong results on purpose and are only timed.

- ``pyramid_lookup_fwd``: B = 8, 46 x 62, four levels, r = 4, centers as
  ``chip_smoke.py``'s kernel phase makes them, on fp32, bf16 and int8
  levels with channel-major taps as the model reads them, and once with
  query-major taps on fp32 levels (``pyramid_kernels.launch_fwd``).
- ``upsample_loss_bwd``: 12 iterations x B = 8 folded, 46 x 62, fp32 and
  bf16 masks, inputs as ``chip_smoke.py`` makes them; the time of
  ``ul_bwd_kernel`` + ``ul_dflow_kernel`` and, apart, of
  ``ul_dflow_kernel`` (the gather of dflow from the window-sum scratch),
  and as a yardstick of the card's rate the time of one ``copy_`` of the
  mask (the kernel reads the mask and writes as many bytes).
- ``gru_gate_rh_bwd``: (8, 128, 46, 62) in fp32 and bf16, r a channel
  half of a 256-channel tensor and the gradient a channel slice of a
  384-channel one, as in the model.

Prints the card's name and power limit, then one JSON line.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import torch

import chip_smoke as cs

REPO = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(REPO, "build", "lookup_ab")

# kernel -> (source and wrapper module name, profiler names of its kernels)
KERNELS = {"pyramid_lookup_fwd": ("pyramid_lookup", "pyr_fwd_kernel"),
           "upsample_loss_bwd": ("upsample_loss",
                                 ("ul_bwd_kernel", "ul_dflow_kernel")),
           "gru_gate_rh_bwd": ("gru_gates", "rh_bwd_kernel")}

# kernel -> [(probe name, [(text it replaces, replacement), ...])]
PROBES = {
    "pyramid_lookup_fwd": [
        ("no_copies", [(
            "      cp_async4(dst + 4u * p, base + (ok ? (s0 & ~3LL) + 4 * w"
            " : 0),\n                ok ? 4 : 0);",
            "      (void)ok; (void)dst; (void)base;")]),
        ("no_taps", [(
            "for (int u = warp; u < L * jc; u += FNT / 32) {",
            "for (int u = warp; u < L * jc - (1 << 30); u += FNT / 32) {")]),
        ("no_stores", [(
            "      else if (q < N)\n"
            "        o[(long long)(i * k + j) * out_sp] = from_f<To>(v);",
            "      else if (q < N && v == 12345.678f)\n"
            "        o[(long long)(i * k + j) * out_sp] = from_f<To>(v);")]),
    ],
    "upsample_loss_bwd": [
        # the ground truth and valid mask never copied (the compute reads
        # what the stage held)
        ("no_gt", [(
            "    if (j < lc) {  // CQ (x, y) pairs and CQ valid values",
            "    if (j < lc && ch < 0) {  // no ground truth")]),
        # the mask never copied in: compute and stores alone
        ("no_mask", [(
            "      if (a16 + 16 * t < a + lc * es)\n        copy_in(",
            "      if (a16 + 16 * t < a + lc * es && ch < 0)\n"
            "        copy_in(")]),
        # no dmask stores to global memory: copies and compute alone
        ("no_stores", [(
            "  auto store = [&](int ch) {\n",
            "  auto store = [&](int ch) {\n    if (ch >= 0) return;\n")]),
        # every run through the store loop of a plane's first and last
        # runs (the control of the next probe)
        ("generic_stores", [(
            "  const bool inner = run > 0 && pix0 + BPC <= HW;",
            "  const bool inner = false;")]),
        # stores from each run's own first pixel, not from a 32-byte
        # boundary: sectors shared by two blocks' stores
        ("unaligned", [(
            "  const bool inner = run > 0 && pix0 + BPC <= HW;",
            "  const bool inner = false;"), (
            "      const int lead = (int)((0u - pa) % GRAN) / es;",
            "      const int lead = 0 * (int)pa;")]),
        # no compute: the copies in and the stores alone
        ("no_compute", [(
            "    if (act) {\n      float gq[2 * CQ], vq[CQ];",
            "    if (act && ch < 0) {\n      float gq[2 * CQ], vq[CQ];")]),
        # the parent kernel without its ground-truth reads
        ("parent_no_gt", [(
            "      const float v = vmb[gi];\n"
            "      // d|d|/dd is +1 at exactly 0 (jnp.abs's VJP), not sign(0)"
            " = 0\n"
            "      const float gx = v * (outx >= gtb[gi * 2 + 0] ? 1.0f : "
            "-1.0f) * dl1;\n"
            "      const float gy = v * (outy >= gtb[gi * 2 + 1] ? 1.0f : "
            "-1.0f) * dl1;",
            "      const float v = 1.0f;\n      (void)gi;\n"
            "      const float gx = v * (outx >= 0.5f ? 1.0f : -1.0f) * dl1;\n"
            "      const float gy = v * (outy >= 0.5f ? 1.0f : -1.0f) * dl1;"
        )]),
        # the parent kernel with its subpixel column loop unrolled (the
        # nine loads of several subpixels in flight)
        ("parent_unroll_q", [(
            "\n    for (int q = 0; q < 8; ++q) {",
            "\n#pragma unroll\n    for (int q = 0; q < 8; ++q) {")]),
    ],
    "gru_gate_rh_bwd": [
        # one vector of each operand in flight per thread
        ("unroll1", [("#define RH_UNROLL 2 ", "#define RH_UNROLL 1 ")]),
        # one value per access on the aligned operands
        ("scalar", [
            ("    if (vec == 1) RH_BWD(float, 1);\n"
             "    else RH_BWD(float, 4);", "    RH_BWD(float, 1);"),
            ("    if (vec == 1) RH_BWD(__nv_bfloat16, 1);\n"
             "    else RH_BWD(__nv_bfloat16, 8);",
             "    RH_BWD(__nv_bfloat16, 1);")]),
        # one block per unit instead of one wave of blocks
        ("block_per_unit", [(
            "rh_bwd_kernel<T, VE><<<grid, RH_THREADS, 0, st>>>(",
            "rh_bwd_kernel<T, VE><<<(int)(total / inner * ((inner / VE + "
            "RH_UNROLL * RH_THREADS - 1) / (RH_UNROLL * RH_THREADS))), "
            "RH_THREADS, 0, st>>>(")]),
    ],
}
# (label, level storage, tap dtype, channel-major taps)
CASES = [("fp32", torch.float32, torch.float32, True),
         ("bf16", torch.bfloat16, torch.bfloat16, True),
         ("int8->fp32", "int8", torch.float32, True),
         ("int8->bf16", "int8", torch.bfloat16, True),
         ("fp32 query-major", torch.float32, torch.float32, False)]


def _start_build(name: str, csrc: str, source: str, replace=()):
    """Start ``nvcc`` on ``csrc``'s ``<source>.cu`` (with the texts of
    ``replace`` replaced) in ``build/lookup_ab/<name>/``, with the port's
    flags; returns (the process, the library's path)."""
    from raft_tpu_torch.ops import build

    d = os.path.join(OUT, name)
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(csrc, d)
    src = os.path.join(d, f"{source}.cu")
    text = open(src).read()
    for old, new in replace:
        if old not in text:
            raise AssertionError(f"{name}: the probed text is not in the "
                                 "source")
        text = text.replace(old, new)
    with open(src, "w") as f:
        f.write(text)
    lib = os.path.join(d, f"{source}.so")
    return subprocess.Popen([build.find_nvcc(), *build.NVCC_FLAGS, "-o", lib,
                             src], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), lib


def _wrapper(csrc: str, module: str):
    """The wrapper module ``ops/<module>.py`` of the checkout whose
    ``csrc`` this is, loaded apart from the port's own (it reaches its
    library through ``build._loaded``, which the timing loop sets)."""
    path = os.path.join(os.path.dirname(os.path.abspath(csrc)), "ops",
                        f"{module}.py")
    spec = importlib.util.spec_from_file_location(f"ab_parent_{module}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _time_pyramid(libs, first, order, build):
    """The pyramid lookup forward (the module docstring)."""
    from raft_tpu_torch.ops import pyramid_kernels as pk
    from raft_tpu_torch.ops.corr import build_corr_pyramid

    dev = torch.device("cuda")
    rng = np.random.default_rng(2)
    h8, w8 = cs.CHAIRS_HW[0] // 8, cs.CHAIRS_HW[1] // 8
    f1, f2, coords = cs._corr_inputs(rng, cs.CHAIRS_B, h8, w8, dev)
    result = {}
    for label, store, out_dtype, nchw in CASES:
        with torch.no_grad():
            pyr = build_corr_pyramid(f1, f2, cs.LEVELS, store)
        levels, scale = pk.split_quantized(pyr)
        want = pk.pyramid_lookup_plain(pyr, coords, cs.R, out_dtype)
        if nchw:
            want = want.permute(0, 3, 1, 2)

        def run():
            return pk.launch_fwd(levels, coords, cs.R, out_dtype, nchw, scale)

        for name in first:
            build._loaded["pyramid_lookup"] = libs[name]  # the wrapper's lib
            cs._check(f"lookup_ab {name} {label}", run(), want)
        times = {n: [] for n in libs}
        for name in order:
            build._loaded["pyramid_lookup"] = libs[name]
            times[name].append(cs._timed(run, "pyr_fwd_kernel")["ms"])
        result[label] = times
        print(f"[lookup_ab] {label}: " + ", ".join(
            f"{n} {' '.join(f'{t:.4f}' for t in ts)} ms"
            for n, ts in times.items()), flush=True)
        del pyr, levels, scale, want
    return result


def _time_backward(kernel, libs, first, order, build, mods):
    """``upsample_loss_bwd`` or ``gru_gate_rh_bwd`` at the chairs shapes
    (the module docstring), fp32 and bf16: each variant's backward through
    its checkout's wrapper (``mods``), held to the plain version for the
    parent and the change."""
    source, match = KERNELS[kernel]
    dev = torch.device("cuda")
    rng = np.random.default_rng(2)
    B, (H, W) = cs.CHAIRS_B, (cs.CHAIRS_HW[0] // 8, cs.CHAIRS_HW[1] // 8)
    result = {}
    for dtype in (torch.float32, torch.bfloat16):
        dt = "fp32" if dtype == torch.float32 else "bf16"
        if kernel == "upsample_loss_bwd":
            gB = cs.CHAIRS_ITERS * B
            flow = torch.from_numpy(rng.uniform(-1, 1, (gB, H, W, 2)).astype(
                np.float32)).to(dev).requires_grad_(True)
            # residuals kept >= 0.5 from 0, as chip_smoke.py keeps them
            gt = (rng.uniform(8.5, 24, (B, 8 * H, 8 * W, 2))
                  * rng.choice([-1.0, 1.0], (B, 8 * H, 8 * W, 2)))
            gt = torch.from_numpy(gt.astype(np.float32)).to(dev)
            vm = torch.from_numpy((rng.random((B, 8 * H, 8 * W)) > 0.1)
                                  .astype(np.float32)).to(dev)
            cot = torch.from_numpy(rng.random((gB, 5)).astype(
                np.float32)).to(dev)
            mask = torch.from_numpy(rng.standard_normal(
                (gB, 576, H, W)).astype(np.float32)).to(
                dev, dtype).requires_grad_(True)
            leaves = (flow, mask)

            def forward(mod):
                return mod.upsample_loss_sums(flow, mask, gt, vm)

            plain = mods["change"].upsample_loss_sums_plain(flow, mask, gt,
                                                            vm)
        else:
            def mk(c, scale=1.0):
                return (torch.from_numpy(rng.standard_normal(
                    (B, c, H, W)).astype(np.float32)) * scale).to(dev, dtype)

            zr, hh, g_cat = mk(256, 3.0), mk(128), mk(384)
            zr.requires_grad_(True)
            hh.requires_grad_(True)
            r, cot = zr[:, 128:], g_cat[:, :128]
            leaves = (zr, hh)

            def forward(mod):
                return mod.gru_gate_rh(r, hh)

            plain = mods["change"].gru_gate_rh_plain(r, hh)
        want = torch.autograd.grad(plain, leaves, cot)
        del plain
        outs = {}
        for name in libs:
            build._loaded[source] = libs[name]
            outs[name] = forward(mods[name])

        def run():
            return torch.autograd.grad(outs[cur], leaves, cot,
                                       retain_graph=True)

        for cur in first:
            build._loaded[source] = libs[cur]
            for i, (a, b) in enumerate(zip(run(), want)):
                cs._check(f"lookup_ab {cur} {kernel} {dt} gradient {i}", a,
                          b)
        if kernel == "upsample_loss_bwd":
            # the card's rate for these bytes: one contiguous copy of the
            # mask (the kernel reads it and writes dmask of its size)
            dst = torch.empty_like(mask)
            result[f"{dt} mask copy"] = [cs._device_ms(
                lambda: dst.copy_(mask.detach())) for _ in range(2)]
            print(f"[lookup_ab] {kernel} {dt}: a copy of the mask "
                  f"{result[f'{dt} mask copy']} ms", flush=True)
            del dst
        times = {n: [] for n in libs}
        gather = {n: [] for n in libs}
        for cur in order:
            build._loaded[source] = libs[cur]
            times[cur].append(cs._timed(run, match)["ms"])
            if kernel == "upsample_loss_bwd":
                gather[cur].append(cs._device_ms(run, match="ul_dflow_kernel"))
        result[dt] = times
        if kernel == "upsample_loss_bwd":
            result[f"{dt} ul_dflow_kernel"] = gather
        print(f"[lookup_ab] {kernel} {dt}: " + ", ".join(
            f"{n} {' '.join(f'{t:.4f}' for t in ts)} ms"
            for n, ts in times.items()), flush=True)
        if kernel == "upsample_loss_bwd":
            print(f"[lookup_ab] {kernel} {dt}, ul_dflow_kernel alone: "
                  + ", ".join(f"{n} {' '.join(f'{t:.4f}' for t in ts)} ms"
                              for n, ts in gather.items()), flush=True)
        del outs, want, leaves, cot
        torch.cuda.empty_cache()
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--kernel", default="pyramid_lookup_fwd",
                   choices=list(KERNELS))
    p.add_argument("--parent", default=None,
                   help="another checkout's raft_tpu_torch/csrc directory")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("lookup_ab: CUDA is not available; it needs one NVIDIA GPU",
              file=sys.stderr)
        return 2
    from raft_tpu_torch.ops import build

    smi, _ = cs.phase_device()
    source, _ = KERNELS[args.kernel]
    csrc = os.path.join(REPO, "raft_tpu_torch", "csrc")
    parent = os.path.abspath(args.parent) if args.parent else None
    builds = {"change": _start_build("change", csrc, source)}
    if parent:
        builds["parent"] = _start_build("parent", parent, source)
    for name, replace in PROBES[args.kernel]:
        if name.startswith("parent_"):
            if parent:
                builds[name] = _start_build(name, parent, source, replace)
        else:
            builds[name] = _start_build(name, csrc, source, replace)
    libs = {}
    for name, (proc, lib) in builds.items():  # all nvcc run together
        log, _ = proc.communicate(timeout=900)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name] = ctypes.CDLL(lib)
    first = [n for n in ("parent", "change") if n in libs]
    probes = [n for n in libs if n not in first]
    order = first + probes + probes[::-1] + first[::-1]
    if args.kernel == "pyramid_lookup_fwd":
        result = _time_pyramid(libs, first, order, build)
        print(smi)
        print(json.dumps({"lookup_ab_ms": result, "order": order}))
        return 0
    ours = importlib.import_module(f"raft_tpu_torch.ops.{source}")
    theirs = _wrapper(parent, source) if parent else None
    mods = {n: theirs if n.startswith("parent") else ours for n in libs}
    result = _time_backward(args.kernel, libs, first, order, build, mods)
    print(smi)
    print(json.dumps({"kernel": args.kernel, "ab_ms": result,
                      "order": order}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
