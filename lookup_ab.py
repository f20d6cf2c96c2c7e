#!/usr/bin/env python3
"""Time variants of one of the port's CUDA kernels against each other on
one NVIDIA GPU, in one process.

    python3 lookup_ab.py [--kernel NAME] [--parent OTHER/raft_tpu_torch/csrc]

``--kernel`` (default ``pyramid_lookup_fwd``) picks the kernel and the
source that holds it: ``pyramid_lookup_fwd`` (``pyramid_lookup.cu``),
``upsample_loss_fwd`` or ``upsample_loss_bwd`` (``upsample_loss.cu``),
``gru_gate_rh_bwd`` or ``gru_gate_fwd`` (``gru_gates.cu``).  The script
builds that source as it is ("change"),
the same source from another checkout's ``csrc`` directory
(``--parent``), and probes: copies of a source with one step of the
kernel left out or changed (``PROBES``, with the wrapper module's
constants a probe changes; those named ``parent_*`` are
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
- ``upsample_loss_fwd``: the same inputs; the time of ``ul_fwd_kernel``
  + ``ul_reduce_kernel`` (the loss sums, no gradient) and, as a yardstick
  of the card's read rate, of one ``mask.sum()`` (the kernel reads the
  mask once and writes next to nothing); how many of each variant's sums
  differ from the parent's in their bits; and the SASS instructions a
  subpixel of the parent's and the change's softmax loop at the chairs
  widths (``_sass_per_subpixel``).
- ``upsample_loss_bwd``: 12 iterations x B = 8 folded, 46 x 62, fp32 and
  bf16 masks, inputs as ``chip_smoke.py`` makes them; the time of
  ``ul_bwd_kernel`` + ``ul_dflow_kernel`` and, apart, of
  ``ul_dflow_kernel`` (the gather of dflow from the window-sum scratch),
  and as a yardstick of the card's rate the time of one ``copy_`` of the
  mask (the kernel reads the mask and writes as many bytes); how many of
  each variant's dflow and dmask values differ from the parent's in
  their bits.
- ``gru_gate_rh_bwd``: (8, 128, 46, 62) in fp32 and bf16, r a channel
  half of a 256-channel tensor and the gradient a channel slice of a
  384-channel one, as in the model.
- ``gru_gate_fwd``: the two forward gates, ``rh_kernel`` and
  ``blend_kernel`` timed apart, at the Sintel (1, 128, 55, 128), chairs
  (8, 128, 46, 62) and serving (8, 128, 55, 128) shapes in fp32 and
  bf16, z and r the channel halves of one 256-channel tensor; the
  parent's output is compared bit for bit with every variant's; as
  yardsticks of the card's rate for the same bytes on the same views,
  ``torch.mul(r, h)`` (rh's 2 reads and 1 write) and
  ``torch.addcmul(h, z, q)`` (blend's 3 and 1); each time beside its
  bound (the bytes over 3.35 TB/s).

``--no-probes`` builds and times the parent and the change alone.

Prints each variant's ``ptxas`` lines for the kernel (registers, stack,
spills), the card's name and power limit, then one JSON line.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import re
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
           "upsample_loss_fwd": ("upsample_loss",
                                 ("ul_fwd_kernel", "ul_reduce_kernel")),
           "upsample_loss_bwd": ("upsample_loss",
                                 ("ul_bwd_kernel", "ul_dflow_kernel")),
           "gru_gate_rh_bwd": ("gru_gates", "rh_bwd_kernel"),
           "gru_gate_fwd": ("gru_gates", ("rh_kernel", "blend_kernel"))}

# upsample_loss_fwd: the arithmetic of a pixel skipped (its values summed
# so that the loads stay), and the stage copies dropped
_UL_NO_MATH = [(
    "        float e[9];\n"
    "#pragma unroll\n"
    "        for (int c = 0; c < 9; ++c) e[c] = word_val<T>(w[c], i);\n",
    "        float t = v + gq.x + gq.y;\n"
    "#pragma unroll\n"
    "        for (int c = 0; c < 9; ++c) t += word_val<T>(w[c], i);\n"
    "        s5[0] += t;\n"
    "        if (t == 12345.678f) {\n"
    "        float e[9];\n"
    "#pragma unroll\n"
    "        for (int c = 0; c < 9; ++c) e[c] = word_val<T>(w[c], i);\n"), (
    "        s5[4] += d2 < 25.0f ? v : 0.0f;\n",
    "        s5[4] += d2 < 25.0f ? v : 0.0f;\n        }\n")]
_UL_NO_GT = [(
    "    for (int u = 0; u < 2 * P; ++u) {  // (x, y) of 2 columns",
    "    for (int u = 0; u < 2 * P * (s < 0); ++u) {  // none"), (
    "    for (int u = 0; u < P; ++u) {  // 4 columns a chunk",
    "    for (int u = 0; u < P * (s < 0); ++u) {  // none")]

def _unroll(**kernels):
    """``gru_gates.GATE_UNROLL`` with the named kernels' vectors in
    flight changed (a probe's constants for the wrapper's plan)."""
    from raft_tpu_torch.ops import gru_gates

    return {**gru_gates.GATE_UNROLL, **kernels}


# kernel -> [(probe name, [(text it replaces, replacement), ...][,
# {constant of the wrapper module: the probe's value}])]
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
    "upsample_loss_fwd": [
        # the reads alone: the mask loads and the staged ground truth
        # summed, no softmax, upsample or loss arithmetic
        ("no_math", _UL_NO_MATH),
        # the ground truth and valid mask never staged (the arithmetic
        # reads what the shared memory held)
        ("no_gt", _UL_NO_GT),
        # neither: the mask loads alone
        ("reads", _UL_NO_MATH + _UL_NO_GT),
        # a stage copied for every item, not once for the G iterations
        # that share it
        ("gt_per_item", [
            ("    if (it == i0 || g == 0) {", "    if (true) {"),
            ("      const long long nx = (it / G + 1) * G;",
             "      const long long nx = it + 1;")]),
        # neighbouring warps on the same tile (ranges of its items), not
        # on neighbouring tiles
        ("same_tile", [("kj = k % NT, kr = k / NT;",
                        "kj = k / RR, kr = k % RR;")]),
        # the mask loaded with __ldcs (evict-first) instead of ld_stream
        ("ldcs", [("? ld_stream<U>(pa + u) : U{};", "? __ldcs(pa + u) : U{};")]),
        # registers for 4 blocks an SM everywhere (fp32 spills)
        ("regs128", [("  static constexpr int MIN_BLOCKS = es == 4 ? 3 : "
                      "P == 4 && NPC <= 2 ? 4 : 2;",
                      "  static constexpr int MIN_BLOCKS = 4;")]),
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
    ],
    "gru_gate_rh_bwd": [
        # one vector of each operand in flight per thread
        ("unroll1", [("#define RH_BWD_UNROLL 2\n",
                      "#define RH_BWD_UNROLL 1\n")],
         {"GATE_UNROLL": _unroll(gru_gate_rh_bwd=1)}),
        # one value per access on the aligned operands
        ("scalar", [("      else K<T, 4><<<", "      else K<T, 1><<<"),
                    ("      else K<T, 8><<<", "      else K<T, 1><<<")]),
        # one block per unit instead of one wave of blocks
        ("block_per_unit", [(
            "  GATE_LAUNCH(rh_bwd_kernel,",
            "  grid = (int)(total / inner * ((inner / vec + RH_BWD_UNROLL * "
            "GATE_THREADS - 1) / (RH_BWD_UNROLL * GATE_THREADS)));\n"
            "  GATE_LAUNCH(rh_bwd_kernel,")]),
    ],
    "gru_gate_fwd": [
        # the loads and stores kept, sigmoid and tanh dropped
        ("no_math", [
            ("    y[0] = sigmoid_f32(x[0]) * x[1];",
             "    y[0] = x[0] * x[1];"),
            ("    const float s = sigmoid_f32(x[0]);\n"
             "    const float t = tanhf(x[1]);\n",
             "    const float s = x[0];\n    const float t = x[1];\n")]),
        # U vectors of every input in flight per thread (the change: rh
        # 2, blend 1)
        *[(f"rh_unroll{u}", [("#define RH_FWD_UNROLL 2",
                              f"#define RH_FWD_UNROLL {u}")],
           {"GATE_UNROLL": _unroll(gru_gate_rh=u)}) for u in (1, 3)],
        ("blend_unroll2", [("#define BLEND_FWD_UNROLL 1",
                            "#define BLEND_FWD_UNROLL 2")],
         {"GATE_UNROLL": _unroll(gru_gate_blend=2)}),
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
    # registered first: a dataclass looks its module up while it is made
    sys.modules[spec.name] = mod
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


def _ul_inputs(rng, dev):
    """The upsample-loss inputs at the chairs training shape, as
    ``chip_smoke.py`` makes them (residuals kept >= 0.5 from 0): flow,
    ground truth, valid mask, the cotangent of the sums and an fp32
    mask."""
    B, (H, W) = cs.CHAIRS_B, (cs.CHAIRS_HW[0] // 8, cs.CHAIRS_HW[1] // 8)
    gB = cs.CHAIRS_ITERS * B
    flow = torch.from_numpy(rng.uniform(-1, 1, (gB, H, W, 2)).astype(
        np.float32)).to(dev)
    gt = (rng.uniform(8.5, 24, (B, 8 * H, 8 * W, 2))
          * rng.choice([-1.0, 1.0], (B, 8 * H, 8 * W, 2)))
    gt = torch.from_numpy(gt.astype(np.float32)).to(dev)
    vm = torch.from_numpy((rng.random((B, 8 * H, 8 * W)) > 0.1)
                          .astype(np.float32)).to(dev)
    cot = torch.from_numpy(rng.random((gB, 5)).astype(np.float32)).to(dev)
    mask = torch.from_numpy(rng.standard_normal(
        (gB, 576, H, W)).astype(np.float32)).to(dev)
    return flow, gt, vm, cot, mask


def _sass_per_subpixel(lib: str, kernel: str) -> dict:
    """Static SASS of the innermost loop of ``kernel`` (a substring of its
    mangled name) in library ``lib`` that computes a softmax: its
    instructions, its MUFU.EX2 (nine a subpixel) and so its instructions
    a subpixel (``cuobjdump -sass``, next to ``nvcc``)."""
    from raft_tpu_torch.ops import build

    cuobjdump = os.path.join(os.path.dirname(build.find_nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    body = next(f for f in sass.split("Function : ")[1:]
                if f.split("\n", 1)[0].strip().startswith(kernel))
    ins = [(int(m.group(1), 16), m.group(2)) for m in re.finditer(
        r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", body)]
    best = None
    for pc, text in ins:
        m = re.search(r"\bBRA\b.*?0x([0-9a-f]+)", text)
        if not m or int(m.group(1), 16) >= pc:
            continue
        lo = int(m.group(1), 16)
        loop = [t for a, t in ins if lo <= a <= pc]
        ex2 = sum("MUFU.EX2" in t for t in loop)
        if ex2 >= 9 and (best is None or len(loop) < best[0]):
            best = (len(loop), ex2)
    n, ex2 = best
    return {"loop_instructions": n, "ex2": ex2,
            "per_subpixel": n * 9 / ex2}


def _time_forward(libs, first, order, build, mods):
    """``upsample_loss_fwd`` at the chairs shapes, fp32 and bf16 masks:
    each variant's sums through its checkout's wrapper (``mods``), held
    to the plain version for the parent and the change; and one
    ``mask.sum()``, the read-rate yardstick."""
    source, match = KERNELS["upsample_loss_fwd"]
    dev = torch.device("cuda")
    flow, gt, vm, _, mask32 = _ul_inputs(np.random.default_rng(2), dev)
    result = {}
    for dtype in (torch.float32, torch.bfloat16):
        dt = "fp32" if dtype == torch.float32 else "bf16"
        mask = mask32.to(dtype)
        with torch.no_grad():
            want = mods["change"].upsample_loss_sums_plain(flow, mask, gt, vm)
            outs = {}
            for cur in libs:
                build._loaded[source] = libs[cur]
                outs[cur] = mods[cur].upsample_loss_sums(flow, mask, gt, vm)
                if cur in first:
                    cs._check_sums(f"lookup_ab {cur} upsample_loss_fwd {dt}",
                                   outs[cur], want)
            if "parent" in outs:
                result[f"{dt} values_differing_from_parent"] = {
                    cur: int((_bits(o) != _bits(outs["parent"])).sum())
                    for cur, o in outs.items()}
                print(f"[lookup_ab] upsample_loss_fwd {dt}: sums differing "
                      f"from the parent's in their bits "
                      f"{result[f'{dt} values_differing_from_parent']}",
                      flush=True)
            result[f"{dt} mask.sum"] = [cs._device_ms(mask.sum)
                                        for _ in range(2)]
            print(f"[lookup_ab] upsample_loss_fwd {dt}: mask.sum() "
                  f"{result[f'{dt} mask.sum']} ms", flush=True)
            times = {n: [] for n in libs}
            for cur in order:
                build._loaded[source] = libs[cur]
                mod = mods[cur]
                times[cur].append(cs._timed(
                    lambda: mod.upsample_loss_sums(flow, mask, gt, vm),
                    match)["ms"])
        result[dt] = times
        print(f"[lookup_ab] upsample_loss_fwd {dt}: " + ", ".join(
            f"{n} {' '.join(f'{t:.4f}' for t in ts)} ms"
            for n, ts in times.items()), flush=True)
        del mask, want
    return result


GATE_SHAPES = (("sintel", (1, 128, 55, 128)), ("chairs", (8, 128, 46, 62)),
               ("serving", (8, 128, 55, 128)))


def _bits(t):
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int16)


def _time_gates(libs, first, order, use, mods):
    """``gru_gate_fwd`` (the module docstring): per shape, dtype and gate,
    each variant's device ms in ``order``, the yardstick's, the bound and
    how many of each variant's output values differ from the parent's in
    their bits."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(2)
    result = {}
    for label, (B, C, H, W) in GATE_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            dt = "fp32" if dtype == torch.float32 else "bf16"

            def mk(c, scale):
                return torch.from_numpy(rng.standard_normal(
                    (B, c, H, W)).astype(np.float32) * scale).to(dev, dtype)

            zr, q, hh = mk(2 * C, 3.0), mk(C, 3.0), mk(C, 1.0)
            z, r = torch.split(zr, C, dim=1)            # split views
            for name, match, ins, yard in (
                    ("gru_gate_rh", "rh_kernel", (r, hh),
                     lambda: torch.mul(r, hh)),
                    ("gru_gate_blend", "blend_kernel", (z, q, hh),
                     lambda: torch.addcmul(hh, z, q))):
                tag = f"{name} {label} {dt} {(B, C, H, W)}"
                with torch.no_grad():
                    want = getattr(mods["change"], f"{name}_plain")(*ins)
                    outs = {}
                    for cur in libs:
                        use(cur)
                        outs[cur] = getattr(mods[cur], name)(*ins)
                        if cur in first:
                            cs._gate_fwd_check(f"[lookup_ab] {cur} {tag}",
                                               outs[cur], want)
                    rec = {}
                    if "parent" in outs:
                        rec["values_differing_from_parent"] = {
                            cur: int((_bits(o) != _bits(outs["parent"]))
                                     .sum()) for cur, o in outs.items()}
                    rec["yardstick"] = [cs._device_ms(yard)
                                        for _ in range(2)]
                    rec["bound"] = ((len(ins) + 1) * hh.numel()
                                    * hh.element_size() / 3.35e12 * 1e3)
                    times = {n: [] for n in libs}
                    for cur in order:
                        use(cur)
                        mod = mods[cur]
                        times[cur].append(cs._timed(
                            lambda: getattr(mod, name)(*ins), match)["ms"])
                rec["ms"] = times
                result[tag] = rec
                print(f"[lookup_ab] {tag}: " + ", ".join(
                    f"{n} {' '.join(f'{t:.4f}' for t in ts)} ms"
                    for n, ts in times.items())
                    + f"; yardstick {rec['yardstick']} ms, bound "
                    f"{rec['bound']:.4f} ms, values differing from the "
                    f"parent's {rec.get('values_differing_from_parent')}",
                    flush=True)
            del zr, q, hh, z, r, want, outs
    return result


def _time_backward(kernel, libs, first, order, use, mods):
    """``upsample_loss_bwd`` or ``gru_gate_rh_bwd`` at the chairs shapes
    (the module docstring), fp32 and bf16: each variant's backward through
    its checkout's wrapper (``mods``), held to the plain version for the
    parent and the change."""
    match = KERNELS[kernel][1]
    dev = torch.device("cuda")
    rng = np.random.default_rng(2)
    B, (H, W) = cs.CHAIRS_B, (cs.CHAIRS_HW[0] // 8, cs.CHAIRS_HW[1] // 8)
    result = {}
    for dtype in (torch.float32, torch.bfloat16):
        dt = "fp32" if dtype == torch.float32 else "bf16"
        if kernel == "upsample_loss_bwd":
            flow, gt, vm, cot, mask = _ul_inputs(rng, dev)
            flow.requires_grad_(True)
            mask = mask.to(dtype).requires_grad_(True)
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
            use(name)
            outs[name] = forward(mods[name])

        def run():
            return torch.autograd.grad(outs[cur], leaves, cot,
                                       retain_graph=True)

        grads = {}
        for cur in libs:
            use(cur)
            grads[cur] = run()
            if cur in first:
                for i, (a, b) in enumerate(zip(grads[cur], want)):
                    cs._check(f"lookup_ab {cur} {kernel} {dt} gradient {i}",
                              a, b)
        if "parent" in grads:
            result[f"{dt} values_differing_from_parent"] = {
                cur: [int((_bits(a) != _bits(b)).sum()) for a, b in
                      zip(gs, grads["parent"])]
                for cur, gs in grads.items()}
            print(f"[lookup_ab] {kernel} {dt}: gradient values differing "
                  f"from the parent's in their bits (per gradient) "
                  f"{result[f'{dt} values_differing_from_parent']}",
                  flush=True)
        del grads
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
            use(cur)
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
    p.add_argument("--no-probes", action="store_true",
                   help="the parent and the change alone")
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
    settings = {}   # probe -> the wrapper module's constants it changes
    for name, replace, *consts in ([] if args.no_probes
                                   else PROBES[args.kernel]):
        settings[name] = consts[0] if consts else {}
        if name.startswith("parent_"):
            if parent:
                builds[name] = _start_build(name, parent, source, replace)
        else:
            builds[name] = _start_build(name, csrc, source, replace)
    libs = {}
    match = KERNELS[args.kernel][1]
    match = (match,) if isinstance(match, str) else match
    for name, (proc, lib) in builds.items():  # all nvcc run together
        log, _ = proc.communicate(timeout=900)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name] = ctypes.CDLL(lib)
        lines = log.splitlines()
        for i, ln in enumerate(lines):   # "Compiling entry ..." + "Used"
            if "Compiling entry" in ln and any(m in ln for m in match):
                used = [x.split(":", 1)[-1].strip()
                        for x in lines[i + 1:i + 6]
                        if "Used" in x or "spill" in x]
                print(f"[lookup_ab] {name}: {ln.split(chr(39))[1][:60]} "
                      f"{' | '.join(used)}", flush=True)
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
    own = {k: getattr(ours, k) for c in settings.values() for k in c}

    def use(name):
        """Point the wrapper at variant ``name``'s library, with the
        wrapper module's constants as that variant has them."""
        build._loaded[source] = libs[name]
        for k, v in {**own, **settings.get(name, {})}.items():
            setattr(ours, k, v)

    if args.kernel == "gru_gate_fwd":
        result = _time_gates(libs, first, order, use, mods)
    elif args.kernel == "upsample_loss_fwd":
        result = _time_forward(libs, first, order, build, mods)
        # ul_fwd_kernel<T, VB> at the chairs widths (16 bytes fp32, 8
        # bytes bf16)
        kern = ("_Z13ul_fwd_kernelIfLi16E",
                "_Z13ul_fwd_kernelI13__nv_bfloat16Li8E")
        for name in ("parent", "change"):
            if name in libs:
                result[f"{name} SASS"] = {
                    dt: _sass_per_subpixel(libs[name]._name, k)
                    for dt, k in zip(("fp32", "bf16"), kern)}
                print(f"[lookup_ab] {name} SASS of the softmax loop: "
                      f"{result[f'{name} SASS']}", flush=True)
    else:
        result = _time_backward(args.kernel, libs, first, order, use, mods)
    print(smi)
    print(json.dumps({"kernel": args.kernel, "ab_ms": result,
                      "order": order}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
