"""raftlint for the port — static analysis of ``raft_tpu_torch/``.

The port's own copy of the JAX package's ``analysis/`` (imports neither
package's JAX side), with four checker families over the defect classes
the port shares with it:

- :mod:`raft_tpu_torch.analysis.capture_purity` — ``JIT101..JIT104``:
  host work inside captured CUDA graphs (family key ``jit``, as in the
  JAX package);
- :mod:`raft_tpu_torch.analysis.locks` — ``LOCK201/LOCK202``: guarded-
  attribute discipline and lock-acquisition-order cycles;
- :mod:`raft_tpu_torch.analysis.telemetry` — ``TEL301..TEL304``:
  emission sites vs the catalogs (``docs/OBSERVABILITY.md`` and
  README's port section); ``TEL305`` waits for a regression gate of the
  port's;
- :mod:`raft_tpu_torch.analysis.contracts` — ``CFG401..CFG403``:
  argparse flags vs config dataclasses vs tuning-registry knobs.

Entry point: ``python -m raft_tpu_torch lint``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from raft_tpu_torch.analysis.core import (  # noqa: F401  (public API)
    PACKAGE, ROOT_SCRIPTS, Finding, SourceFile, Workspace, load_baseline,
    load_report, make_report, split_findings, write_baseline,
)

#: The port's baseline (repo-relative); the root ``lint_baseline.json``
#: is the JAX package's.
BASELINE_PATH = "raft_tpu_torch/analysis/lint_baseline.json"

#: family name -> (module, rule IDs) — the registry ``run_checks``
#: dispatches on and ``--only`` filters by.
CHECKER_FAMILIES = {
    "jit": ("raft_tpu_torch.analysis.capture_purity",
            ("JIT101", "JIT102", "JIT103", "JIT104")),
    "locks": ("raft_tpu_torch.analysis.locks", ("LOCK201", "LOCK202")),
    "telemetry": ("raft_tpu_torch.analysis.telemetry",
                  ("TEL301", "TEL302", "TEL303", "TEL304")),
    "contracts": ("raft_tpu_torch.analysis.contracts",
                  ("CFG401", "CFG402", "CFG403")),
}


def run_checks(ws: Workspace,
               families: Optional[Sequence[str]] = None,
               ) -> Tuple[List[Finding], List[str]]:
    """Run the selected checker families (default: all) against the
    workspace.  Returns ``(findings, rules_run)`` — unfiltered;
    callers route through :func:`split_findings` for suppression and
    baseline handling."""
    import importlib

    findings: List[Finding] = []
    rules: List[str] = []
    # every file of the package and every root script is read: one that
    # does not parse is a finding of its own
    for sf in ws.glob_py(PACKAGE, *ROOT_SCRIPTS, exclude=("tests/",)):
        if sf.tree is None:
            findings.append(Finding(
                "LINT000", sf.relpath, 1, "parse-error",
                f"file does not parse: {sf.parse_error}"))
    for family in (families or sorted(CHECKER_FAMILIES)):
        if family not in CHECKER_FAMILIES:
            raise ValueError(
                f"unknown checker family {family!r}; have "
                f"{sorted(CHECKER_FAMILIES)}")
        modname, family_rules = CHECKER_FAMILIES[family]
        mod = importlib.import_module(modname)
        findings.extend(f for f in mod.check(ws) if f.rule != "LINT000")
        rules.extend(family_rules)
    return findings, rules


def files_scanned(ws: Workspace) -> int:
    return sum(1 for sf in ws._cache.values() if sf is not None)
