"""Where the on-demand lookup backward kernel spends its time, on the card.

    python -m raft_tpu_torch.ops.corr_bwd_probe      # from the repository root

Builds two variants of ``csrc/corr_ondemand.cu`` beside the kernel
itself: ``stores`` writes each df2 contribution with a plain store in
place of the atomic add (wrong sums, the same traffic), ``no_df2`` drops
it (df1 and the window gradients only).  Times each at the chairs
training shape (batch 8, 46x62 grid, C = 256, 4 levels, r = 4) with all
levels and with each level alone, for centers near the grid (U(-1, 1)
px, as early in training) and spread by U(-20, 20) px, and prints one
JSON line.  It needs one CUDA device; the variants are measurement
aids, never called by the port.
"""

from __future__ import annotations

import ctypes
import json
import math
import subprocess

import numpy as np
import torch

from raft_tpu_torch.ops import build
from raft_tpu_torch.ops.corr import pool_fmap_pyramid

_ATOMIC = ("  atomicAdd(reinterpret_cast<float4*>(p), v);  "
           "// one 16-byte red on sm_90")
VARIANTS = {"kernel": _ATOMIC,
            "stores": "  *reinterpret_cast<float4*>(p) = v;",
            "no_df2": "  if (v.x == 12345.0f) *p = 0.0f;"}


def _build_variants():
    src = (build.CSRC_DIR / "corr_ondemand.cu").read_text()
    if _ATOMIC not in src:
        raise RuntimeError("corr_ondemand.cu: the df2 atomic add moved")
    out_dir = build.BUILD_DIR / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, line in VARIANTS.items():
        cu = out_dir / f"corr_ondemand_{name}.cu"
        cu.write_text(src.replace(_ATOMIC, line))
        procs[name] = subprocess.Popen(
            [build.find_nvcc(), *build.NVCC_FLAGS, "-o",
             str(cu.with_suffix(".so")), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    ll, vp, ci = ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for the {name} variant:\n{log}")
        fn = ctypes.CDLL(str(out_dir / f"corr_ondemand_{name}.so")
                         ).corr_ondemand_bwd
        fn.argtypes = ([ci, vp, vp, ctypes.POINTER(ll), ctypes.POINTER(ll),
                        ctypes.POINTER(ci), ctypes.POINTER(ci)] + [ci] * 5
                       + [ctypes.c_float, vp, ll, ll, ll, vp, vp])
        fn.restype = ci
        fns[name] = fn
    return fns


def _time_ms(fn, f1, levels, coords, g, reps=20):
    """CUDA-event time of one launch (NCHW tap gradient), warm L2."""
    B, H, W, C = f1.shape
    N, L, P = H * W, len(levels), g.shape[1]
    df1 = torch.empty_like(f1)
    df2 = [torch.zeros_like(lv) for lv in levels]
    ptrs = [(ctypes.c_longlong * L)(*[t.data_ptr() for t in ts])
            for ts in (levels, df2)]
    dims = [(ctypes.c_int * L)(*[lv.shape[i] for lv in levels])
            for i in (1, 2)]
    args = (f1.device.index or 0, f1.data_ptr(), coords.data_ptr(),
            *ptrs, *dims, L, B, N, C, 4, 1.0 / math.sqrt(C),
            g.data_ptr(), P * N, 1, N, df1.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    for _ in range(3):
        build.check_status("corr_bwd_probe", fn(*args))
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn(*args)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("corr_bwd_probe: needs a CUDA device")
    fns = _build_variants()
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    B, H, W, C, k = 8, 46, 62, 256, 9
    f1 = torch.from_numpy(rng.standard_normal((B, H, W, C)).astype(
        np.float32)).to(dev)
    f2 = torch.from_numpy(rng.standard_normal((B, H, W, C)).astype(
        np.float32)).to(dev)
    levels = [lv.contiguous() for lv in pool_fmap_pyramid(f2, 4)]
    ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    grid = np.stack([xs, ys], -1).astype(np.float32)[None]
    g = torch.from_numpy(rng.standard_normal((B, 4 * k * k, H, W)).astype(
        np.float32)).to(dev)
    out = {"device": torch.cuda.get_device_name(0), "ms": {}}
    for label, offset in (("near_grid", 1.0), ("offsets20", 20.0)):
        coords = torch.from_numpy((grid + rng.uniform(
            -offset, offset, (B, H, W, 2))).astype(np.float32)).to(dev)
        for name, fn in fns.items():
            row = {"all": _time_ms(fn, f1, levels, coords, g)}
            for lvl in range(4):
                row[f"level{lvl}"] = _time_ms(
                    fn, f1, [levels[lvl]], (coords / 2 ** lvl).contiguous(),
                    g[:, lvl * k * k:(lvl + 1) * k * k].contiguous())
            out["ms"][f"{label}/{name}"] = row
            print(f"[probe] {label} {name}: " + ", ".join(
                f"{key} {ms:.4f} ms" for key, ms in row.items()), flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
