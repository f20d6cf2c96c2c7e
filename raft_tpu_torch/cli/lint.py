"""``python -m raft_tpu_torch lint`` — run raftlint over the port.

Exit status is the contract: 0 when every finding is fixed, pragma-
suppressed, or baselined; 1 when active findings remain; 2 on usage
errors.  ``--json`` emits the machine-readable report (the JAX
package's schema: its regression gate's ``--lint-report`` reads it).

Typical loops::

    python -m raft_tpu_torch lint                       # human output
    python -m raft_tpu_torch lint --json report.json    # for a gate
    python -m raft_tpu_torch lint --only locks,telemetry
    python -m raft_tpu_torch lint --write-baseline --justification "..."

The rules are the JAX package's (docs/ANALYSIS.md), carried to the port
in ``raft_tpu_torch/analysis/`` (the ``jit`` family checks captured CUDA
graphs); the port's baseline is
``raft_tpu_torch/analysis/lint_baseline.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from raft_tpu_torch.analysis import (
    BASELINE_PATH, CHECKER_FAMILIES, PACKAGE, Workspace, files_scanned,
    load_baseline, make_report, run_checks, split_findings,
    write_baseline,
)


def _repo_root(start: str) -> str:
    """Nearest ancestor containing ``raft_tpu_torch/`` — lint is a repo
    tool, not a package tool, so paths in reports stay repo-relative."""
    d = os.path.abspath(start)
    while True:
        if os.path.isdir(os.path.join(d, PACKAGE)):
            return d
        parent = os.path.dirname(d)
        if parent == d:
            return os.path.abspath(start)
        d = parent


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m raft_tpu_torch lint",
        description="static analysis of the port (raftlint); rules in "
                    "raft_tpu_torch/analysis/")
    p.add_argument("--root", default=None,
                   help="repo root (default: auto-detect from cwd)")
    p.add_argument("--only", default=None,
                   help="comma-separated checker families to run "
                        f"(default all: {','.join(sorted(CHECKER_FAMILIES))})")
    p.add_argument("--json", dest="json_path", default=None,
                   metavar="PATH",
                   help="write the machine-readable report here "
                        "('-' for stdout)")
    p.add_argument("--baseline", default=None, metavar="PATH",
                   help=f"baseline file (default <root>/{BASELINE_PATH})")
    p.add_argument("--no-baseline", action="store_true",
                   help="ignore the baseline (show grandfathered "
                        "findings as active)")
    p.add_argument("--write-baseline", action="store_true",
                   help="grandfather all currently-active findings "
                        "into the baseline and exit 0")
    p.add_argument("--justification", default="",
                   help="justification recorded for new baseline "
                        "entries (required by --write-baseline for "
                        "entries without one)")
    p.add_argument("--show-baselined", action="store_true",
                   help="also print baselined findings")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    root = args.root or _repo_root(os.getcwd())
    ws = Workspace(root)
    families = (sorted(CHECKER_FAMILIES) if not args.only
                else [f.strip() for f in args.only.split(",")
                      if f.strip()])
    try:
        findings, rules = run_checks(ws, families)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    baseline_path = args.baseline or os.path.join(root, BASELINE_PATH)
    try:
        baseline = ({} if args.no_baseline
                    else load_baseline(baseline_path))
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    active, baselined, suppressed = split_findings(ws, findings,
                                                   baseline)

    if args.write_baseline:
        try:
            data = write_baseline(
                active + baselined, baseline_path,
                default_justification=args.justification)
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        print(f"wrote {len(data['entries'])} entries to "
              f"{baseline_path}")
        return 0

    report = make_report(active, baselined, suppressed,
                         files_scanned(ws), rules)
    if args.json_path == "-":
        json.dump(report, sys.stdout, indent=2)
        print()
    elif args.json_path:
        with open(args.json_path, "w") as fh:
            json.dump(report, fh, indent=2)
            fh.write("\n")

    for f in active:
        print(f)
    if args.show_baselined:
        for f in baselined:
            print(f"[baselined] {f}")
    tail = (f"raftlint: {len(active)} finding(s), "
            f"{len(baselined)} baselined, {len(suppressed)} "
            f"suppressed, {report['files_scanned']} files, "
            f"families: {','.join(families)}")
    print(tail, file=sys.stderr if active else sys.stdout)
    return 1 if active else 0


if __name__ == "__main__":
    sys.exit(main())
