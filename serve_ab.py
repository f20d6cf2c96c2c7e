#!/usr/bin/env python3
"""Serving throughput of two checkouts against each other on one NVIDIA
GPU, in one call: the slot-mode closed loop of ``chip_smoke.py``'s phase
``serve`` (the kernel configuration, bf16, 8 slots at the Sintel bucket,
32 iterations, 8 clients x 16 requests, tracing off), each arm in a
process of its own.

    python3 serve_ab.py --parent build/parent [--rounds 3] [--out F.json]

``--parent`` is the root of the other checkout (unpacked under the
gitignored ``build/``, e.g. ``git archive <commit> | tar -x -C
build/parent``); this checkout is the change.  The arms run in the order
parent, change, change, parent, so that drift between the two passes
shows.  Each arm imports its own checkout's port and ``chip_smoke.py``
(the engine and the seeded pairs), builds that checkout's kernels into
its own ``build/``, captures the programs, settles with a loop of 2 x 1
requests, then times ``--rounds`` loops with the same client loop in
every arm; it prints one JSON line ``{"arm", "tree", "pairs_per_s",
"p50_ms", "p99_ms"}`` and the parent process prints them all, with the
card's name and power limit, as the last line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def _loop(eng, pairs, clients: int = 8, reqs: int = 16) -> dict:
    """``clients`` threads, each sending ``reqs`` requests one after
    another: pairs/s over the window, client p50 / p99 ms."""
    import threading

    import numpy as np

    lats, errs = [], []

    def client(c):
        for i in range(reqs):
            a, b = pairs[(c + i) % len(pairs)]
            t = time.perf_counter()
            try:
                eng.infer(a, b, timeout=600)
            except Exception as e:        # noqa: BLE001 (raised below)
                errs.append(repr(e))
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
        raise RuntimeError(f"serve loop: {errs[:3]}")
    return {"pairs_per_s": clients * reqs / wall,
            "p50_ms": float(np.percentile(lats, 50)),
            "p99_ms": float(np.percentile(lats, 99))}


def child(tree: str, arm: str, rounds: int) -> int:
    """One arm, in ``tree``'s own port and ``chip_smoke.py``."""
    sys.path.insert(0, tree)
    os.chdir(tree)
    import torch

    import chip_smoke as cs
    from raft_tpu_torch import config
    from raft_tpu_torch.config import RAFTConfig
    from raft_tpu_torch.models.raft import RAFT

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    config.CONV_TF32 = False
    sd = RAFT(RAFTConfig.full(), seed=0).state_dict()
    pairs = cs._serve_pairs()
    eng = cs._serve_engine(sd, cs.SERVE_CONFIGS["kernel"], "bfloat16",
                           batching="slot", slots=cs.SERVE_SLOTS)
    try:
        eng.warmup([cs.SERVE_HW])
        _loop(eng, pairs, clients=2, reqs=1)            # settle
        runs = [_loop(eng, pairs) for _ in range(rounds)]
    finally:
        eng.stop()
    print(json.dumps({"arm": arm, "tree": tree,
                      "pairs_per_s": [r["pairs_per_s"] for r in runs],
                      "p50_ms": [r["p50_ms"] for r in runs],
                      "p99_ms": [r["p99_ms"] for r in runs]}), flush=True)
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--parent", required=False,
                   help="root of the other checkout")
    p.add_argument("--rounds", type=int, default=3,
                   help="timed loops an arm")
    p.add_argument("--out", default=None, help="also write the results")
    p.add_argument("--child", default=None, help=argparse.SUPPRESS)
    p.add_argument("--arm", default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.child:
        return child(args.child, args.arm, args.rounds)
    import torch

    if not torch.cuda.is_available():
        print("serve_ab: CUDA is not available; it needs one NVIDIA GPU",
              file=sys.stderr)
        return 2
    if not args.parent:
        p.error("--parent is required")
    parent = os.path.abspath(args.parent)
    results = []
    for arm, tree in (("parent", parent), ("change", HERE),
                      ("change", HERE), ("parent", parent)):
        out = subprocess.run(
            [sys.executable, os.path.join(HERE, "serve_ab.py"), "--child",
             tree, "--arm", arm, "--rounds", str(args.rounds)],
            capture_output=True, text=True, timeout=900,
            env=dict(os.environ, PYTHONPATH=tree))
        if out.returncode != 0:
            print(out.stdout[-4000:], out.stderr[-4000:], file=sys.stderr)
            return out.returncode
        rec = json.loads(out.stdout.strip().splitlines()[-1])
        print(json.dumps(rec), flush=True)
        results.append(rec)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    summary = {"device": smi, "arms": results}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
