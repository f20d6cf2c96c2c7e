"""Checkpoint verifier (the port of ``raft_tpu/cli/verify_ckpt.py``): the
checks that ``restore_latest``'s fallback applies at resume, run offline
on every saved step, so an operator can see whether a run will resume and
from which step, and on how many ranks each step was saved::

    python -m raft_tpu_torch verify-ckpt checkpoints/raft-chairs
    python -m raft_tpu_torch verify-ckpt checkpoints/raft-chairs --json

Exit codes: 0 every saved step reads; 1 some step is torn or corrupt but
another is valid (resume falls back to ``latest_valid``); 2 no saved step
reads, or the directory holds none (resume would raise).
"""

from __future__ import annotations

import argparse
import json


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="raft_tpu_torch verify-ckpt",
        description="verify that every saved step of a run directory "
                    "restores; preview what auto-resume would do")
    p.add_argument("ckpt_dir",
                   help="run directory (the ckpt_dir/name the train CLI "
                        "writes)")
    p.add_argument("--json", action="store_true",
                   help="one JSON report line instead of per-step text")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)

    import os

    from raft_tpu_torch.train.checkpoint import CheckpointManager

    reports, topology = [], {}
    if os.path.isdir(args.ckpt_dir):
        mgr = CheckpointManager(args.ckpt_dir)
        reports = mgr.verify_all()
        topology = mgr.saved_topology()
    valid = [r["step"] for r in reports if r["ok"]]
    latest_valid = max(valid) if valid else None
    for r in reports:
        topo = topology.get(str(r["step"]))
        if topo:
            r["topology"] = {k: topo[k] for k in
                             ("platform", "device", "device_count",
                              "world_size", "mesh")
                             if k in topo}
    report = {
        "dir": args.ckpt_dir,
        "steps": reports,
        "latest_valid": latest_valid,
        "ok": bool(reports) and all(r["ok"] for r in reports),
    }
    if args.json:
        print(json.dumps(report))
    else:
        if not reports:
            print(f"{args.ckpt_dir}: no saved steps")
        for r in reports:
            status = "ok" if r["ok"] else f"CORRUPT ({r['error']})"
            topo = r.get("topology")
            if topo:
                status += (f"  [saved on {topo.get('device_count')} x "
                           f"{topo.get('device')}, world "
                           f"{topo.get('world_size', 1)}]")
            print(f"step {r['step']}: {status}")
        if latest_valid is not None:
            print(f"resume would restore step {latest_valid}")
        else:
            print("resume would FAIL: no restorable checkpoint")
    if report["ok"]:
        return 0
    return 1 if latest_valid is not None else 2


if __name__ == "__main__":
    raise SystemExit(main())
