#!/usr/bin/env python3
"""Time variants of the pyramid lookup forward kernel against each other on
one NVIDIA GPU, in one process.

    python3 lookup_ab.py [--parent OTHER/raft_tpu_torch/csrc]

Builds ``raft_tpu_torch/csrc/pyramid_lookup.cu`` as it is ("change"), the
same source from another checkout's ``csrc`` directory (``--parent``), and
three probes: copies of this tree's source that each leave out one step
of the forward: the window copies into shared memory (``no_copies``), the
taps and their stores (``no_taps``), or only the tap stores
(``no_stores``).  Each goes through ``nvcc`` into its own library
under ``build/lookup_ab/``, all ``nvcc`` started together.  Then it times
each library's forward through the port's wrapper
(``pyramid_kernels.launch_fwd``; ``torch.profiler`` device time of
``pyr_fwd_kernel``, CUDA events where the profiler reports none) at the
chairs training shape (B = 8, 46 x 62, four levels, r = 4, centers as
``chip_smoke.py``'s kernel phase makes them) on fp32, bf16 and int8
levels, with channel-major taps as the model reads them, and once with
query-major taps on fp32 levels, in the order parent, change, probes,
probes, change, parent, so that drift between the two passes shows.  The
parent's and the change's taps are first held to the plain version
(``chip_smoke``'s tolerance); the probes compute wrong taps on purpose
and are only timed.  Prints the card's name and power limit, then one
JSON line.
"""

from __future__ import annotations

import argparse
import ctypes
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

# (probe name, the text it replaces in pyramid_lookup.cu, the replacement)
PROBES = [
    ("no_copies",
     "      cp_async4(dst + 4u * p, base + (ok ? (s0 & ~3LL) + 4 * w : 0),\n"
     "                ok ? 4 : 0);",
     "      (void)ok; (void)dst; (void)base;"),
    ("no_taps",
     "for (int u = warp; u < L * jc; u += FNT / 32) {",
     "for (int u = warp; u < L * jc - (1 << 30); u += FNT / 32) {"),
    ("no_stores",
     "      else if (q < N)\n"
     "        o[(long long)(i * k + j) * out_sp] = from_f<To>(v);",
     "      else if (q < N && v == 12345.678f)\n"
     "        o[(long long)(i * k + j) * out_sp] = from_f<To>(v);"),
]
# (label, level storage, tap dtype, channel-major taps)
CASES = [("fp32", torch.float32, torch.float32, True),
         ("bf16", torch.bfloat16, torch.bfloat16, True),
         ("int8->fp32", "int8", torch.float32, True),
         ("int8->bf16", "int8", torch.bfloat16, True),
         ("fp32 query-major", torch.float32, torch.float32, False)]


def _start_build(name: str, csrc: str, replace=None):
    """Start ``nvcc`` on ``csrc``'s pyramid_lookup.cu (with one text
    replaced) in ``build/lookup_ab/<name>/``, with the port's flags;
    returns (the process, the library's path)."""
    from raft_tpu_torch.ops import build

    d = os.path.join(OUT, name)
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(csrc, d)
    src = os.path.join(d, "pyramid_lookup.cu")
    if replace:
        text = open(src).read()
        if replace[0] not in text:
            raise AssertionError(f"{name}: the probed text is not in the "
                                 "source")
        with open(src, "w") as f:
            f.write(text.replace(*replace))
    lib = os.path.join(d, "pyramid_lookup.so")
    return subprocess.Popen([build.find_nvcc(), *build.NVCC_FLAGS, "-o", lib,
                             src], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), lib


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--parent", default=None,
                   help="another checkout's raft_tpu_torch/csrc directory")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("lookup_ab: CUDA is not available; it needs one NVIDIA GPU",
              file=sys.stderr)
        return 2
    from raft_tpu_torch.ops import build, pyramid_kernels as pk
    from raft_tpu_torch.ops.corr import build_corr_pyramid

    smi, _ = cs.phase_device()
    csrc = os.path.join(REPO, "raft_tpu_torch", "csrc")
    builds = {"change": _start_build("change", csrc)}
    if args.parent:
        builds["parent"] = _start_build("parent", os.path.abspath(args.parent))
    for name, old, new in PROBES:
        builds[name] = _start_build(name, csrc, (old, new))
    libs = {}
    for name, (proc, lib) in builds.items():  # all nvcc run together
        log, _ = proc.communicate(timeout=900)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name] = ctypes.CDLL(lib)
    first = [n for n in ("parent", "change") if n in libs]
    probes = [n for n in libs if n not in first]
    order = first + probes + probes[::-1] + first[::-1]
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
    print(smi)
    print(json.dumps({"lookup_ab_ms": result, "order": order}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
