"""Curriculum CLI (the port of ``raft_tpu/cli/curriculum.py``): the
paper's four-stage schedule as one resumable job.

::

    # the reference train_standard.sh schedule, resumable:
    python -m raft_tpu_torch curriculum --workdir runs/standard \
        -- --data_root datasets --batch_per_chip 2

    # inspect / customize the schedule:
    python -m raft_tpu_torch curriculum --dump-manifest > my.json
    python -m raft_tpu_torch curriculum --workdir runs/custom \
        --manifest my.json

Unrecognized flags pass through to every stage's ``train`` invocation
(they win over manifest values).  Re-running the same command after a
preemption resumes from the stage ledger
(``<workdir>/curriculum_ledger.json``); a stage killed mid-run re-enters
training and resumes from its newest checkpoint step.  The CUDA kernels
are built once and cached by source hash, so later stages build nothing.
"""

from __future__ import annotations

import argparse
import json


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="raft_tpu_torch curriculum",
        description="run the chairs->things->sintel->kitti curriculum "
                    "as one resumable job (stage ledger on disk; extra "
                    "flags pass through to every stage's train run)")
    p.add_argument("--workdir", default=None,
                   help="curriculum state directory: stage ledger + "
                        "default checkpoint root (required unless "
                        "--dump-manifest)")
    p.add_argument("--manifest", default=None, metavar="PATH",
                   help="JSON manifest {base:{...}, stages:[{name, "
                        "stage, overrides:{...}}]}; default: the "
                        "paper's standard schedule")
    p.add_argument("--dump-manifest", action="store_true",
                   help="print the standard manifest JSON and exit "
                        "(edit it, then pass via --manifest)")
    return p.parse_known_args(argv)


def main(argv=None) -> int:
    args, extra = parse_args(argv)

    from raft_tpu_torch.curriculum import Manifest, run_curriculum

    if args.dump_manifest:
        print(json.dumps(Manifest.standard().to_dict(), indent=2))
        return 0
    if not args.workdir:
        raise SystemExit("curriculum: --workdir is required")
    manifest = (Manifest.from_json(args.manifest) if args.manifest
                else Manifest.standard())

    # a plan in $RAFT_CHAOS_SPEC applies across the whole curriculum (the
    # stage_kill seam lives in the driver itself)
    from raft_tpu_torch import chaos

    try:
        chaos.install_from_env()
    except chaos.ChaosSpecError as e:
        raise SystemExit(f"RAFT_CHAOS_SPEC: {e}")
    run_curriculum(manifest, args.workdir, extra_argv=extra)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
