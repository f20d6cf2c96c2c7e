"""raftlint core for the port: findings, suppressions, baseline, report.

The port's own copy of the JAX package's ``analysis/core.py``: a static
pass over the defect classes the port shares with it (host work inside
captured CUDA graphs, lock discipline in the threaded serving and
observability layers, telemetry names drifting from their catalogs, and
CLI/config/tuning-registry drift).  Every rule is a tier-1 failure
(``tests/test_torch_lint.py``) instead of a production incident.

Three escape hatches, in order of preference:

- **fix it** — most findings are real;
- **suppress it** — ``# raftlint: disable=RULE`` on the flagged line
  (comma-separated rules, or ``all``) for a pattern the checker cannot
  see is safe.  The suppression lives next to the code it excuses, so
  review sees both; give the reason in a comment beside it;
- **baseline it** — the port's baseline
  (``raft_tpu_torch/analysis/lint_baseline.json``) grandfathers a
  finding by its stable key ``rule:path:detail`` (line numbers excluded
  on purpose: edits above a finding must not un-baseline it).  Every
  entry carries a one-line ``justification``; ``--write-baseline``
  refuses to write entries without one unless given a default.

The JSON report (``python -m raft_tpu_torch lint --json``) has the JAX
package's schema (``tool: raftlint``, ``version: 1``), so the regression
gate's ``--lint-report`` reads either package's report.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import os
import re
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

REPORT_TOOL = "raftlint"
REPORT_VERSION = 1

#: What the linter reads: the package and the port's root scripts (each
#: parses flags of its own).
PACKAGE = "raft_tpu_torch"
ROOT_SCRIPTS = ("chip_smoke.py", "lookup_ab.py", "serve_ab.py",
                "ddp_scale.py", "batch_fill_probe.py")

#: ``# raftlint: disable=JIT101,LOCK201`` / ``# raftlint: disable=all``
_PRAGMA_RE = re.compile(r"#\s*raftlint:\s*disable=([A-Za-z0-9_,\s]+)")
#: ``# raftlint: skip-file`` anywhere in the first 10 lines.
_SKIP_FILE_RE = re.compile(r"#\s*raftlint:\s*skip-file")


@dataclasses.dataclass
class Finding:
    """One lint finding.

    ``detail`` is the STABLE identifier baselines match on (a metric
    name, ``Class.attr``, a flag, a cycle signature) — never a line
    number, so edits elsewhere in the file don't churn the baseline.
    """

    rule: str
    path: str          # repo-relative, forward slashes
    line: int
    detail: str
    message: str

    @property
    def key(self) -> str:
        return f"{self.rule}:{self.path}:{self.detail}"

    def to_json(self) -> dict:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "detail": self.detail, "message": self.message,
                "key": self.key}

    def __str__(self) -> str:
        return (f"{self.path}:{self.line}: {self.rule} "
                f"[{self.detail}] {self.message}")


class SourceFile:
    """One parsed python file: AST + raw lines (for pragma scanning).

    Parse errors surface as a ``LINT000`` finding instead of crashing
    the whole run — a file the linter cannot read is itself a defect.
    """

    def __init__(self, abspath: str, relpath: str):
        self.abspath = abspath
        self.relpath = relpath
        with open(abspath, "r", encoding="utf-8", errors="replace") as f:
            self.text = f.read()
        self.lines = self.text.splitlines()
        self.tree: Optional[ast.Module] = None
        self.parse_error: Optional[str] = None
        try:
            self.tree = ast.parse(self.text, filename=relpath)
        except SyntaxError as e:
            self.parse_error = f"{type(e).__name__}: {e}"

    @property
    def skip_file(self) -> bool:
        return any(_SKIP_FILE_RE.search(ln)
                   for ln in self.lines[:10])

    def pragma_rules(self, line: int) -> frozenset:
        """Rules disabled on 1-indexed ``line`` (empty set if none)."""
        if 1 <= line <= len(self.lines):
            m = _PRAGMA_RE.search(self.lines[line - 1])
            if m:
                return frozenset(
                    r.strip().upper() for r in m.group(1).split(",")
                    if r.strip())
        return frozenset()

    def suppressed(self, finding: Finding) -> bool:
        rules = self.pragma_rules(finding.line)
        return finding.rule.upper() in rules or "ALL" in rules


class Workspace:
    """Shared parse cache over a repo checkout.  Checkers ask for files
    by repo-relative path (or glob the tree); each file parses once."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        self._cache: Dict[str, Optional[SourceFile]] = {}

    def rel(self, abspath: str) -> str:
        return os.path.relpath(abspath, self.root).replace(os.sep, "/")

    def get(self, relpath: str) -> Optional[SourceFile]:
        """The parsed file, or None when it doesn't exist."""
        relpath = relpath.replace(os.sep, "/")
        if relpath not in self._cache:
            abspath = os.path.join(self.root, relpath)
            self._cache[relpath] = (
                SourceFile(abspath, relpath)
                if os.path.isfile(abspath) else None)
        return self._cache[relpath]

    def glob_py(self, *subdirs: str,
                exclude: Sequence[str] = ()) -> List[SourceFile]:
        """Every ``*.py`` under the given repo-relative subdirs (or
        single files), sorted, parse-cached, ``skip-file`` honored."""
        out: List[SourceFile] = []
        seen = set()
        for sub in subdirs:
            abspath = os.path.join(self.root, sub)
            if os.path.isfile(abspath):
                paths = [abspath]
            else:
                paths = []
                for dirpath, dirnames, filenames in os.walk(abspath):
                    dirnames[:] = [d for d in dirnames
                                   if d != "__pycache__"]
                    paths.extend(os.path.join(dirpath, f)
                                 for f in filenames
                                 if f.endswith(".py"))
            for p in sorted(paths):
                rel = self.rel(p)
                if rel in seen or any(x in rel for x in exclude):
                    continue
                seen.add(rel)
                sf = self.get(rel)
                if sf is not None and not sf.skip_file:
                    out.append(sf)
        return out


def doc_texts(ws: Workspace, scope: Sequence) -> List[Tuple[str, int, str]]:
    """``(relpath, first_line, text)`` for each entry of a documentation
    scope: a repo-relative ``.md`` file or folder, or ``(path, heading)``
    for the part of one file from the line that starts with ``heading``
    to the end (README's port section).  ``first_line`` is the 1-based
    line of the file the text starts at, so findings name the file's own
    lines.  A missing file or heading contributes nothing."""
    out: List[Tuple[str, int, str]] = []
    for entry in scope:
        path, heading = (entry if isinstance(entry, tuple)
                         else (entry, None))
        abspath = os.path.join(ws.root, path)
        if os.path.isdir(abspath):
            files = [(f"{path}/{fn}", os.path.join(abspath, fn))
                     for fn in sorted(os.listdir(abspath))
                     if fn.endswith(".md")]
        elif os.path.isfile(abspath):
            files = [(path, abspath)]
        else:
            continue
        for relpath, fpath in files:
            with open(fpath, encoding="utf-8", errors="replace") as fh:
                lines = fh.read().splitlines()
            start = 0
            if heading is not None:
                start = next((i for i, ln in enumerate(lines)
                              if ln.startswith(heading)), None)
                if start is None:
                    continue
            out.append((relpath, start + 1, "\n".join(lines[start:])))
    return out


# ---------------------------------------------------------------------
# baseline
# ---------------------------------------------------------------------


def load_baseline(path: str) -> Dict[str, str]:
    """``{finding_key: justification}`` from a baseline file.  A missing
    file is an empty baseline; a malformed one raises — a baseline that
    silently fails open would grandfather everything."""
    if not os.path.isfile(path):
        return {}
    with open(path) as f:
        data = json.load(f)
    if not isinstance(data, dict) or not isinstance(
            data.get("entries"), list):
        raise ValueError(
            f"{path}: expected {{'entries': [...]}} baseline format")
    out: Dict[str, str] = {}
    for e in data["entries"]:
        key = (e.get("key")
               or f"{e.get('rule')}:{e.get('path')}:{e.get('detail')}")
        out[key] = str(e.get("justification", ""))
    return out


def write_baseline(findings: Sequence[Finding], path: str,
                   justifications: Optional[Dict[str, str]] = None,
                   default_justification: str = "") -> dict:
    """Write a baseline grandfathering ``findings``.  Entries keep any
    existing justification for the same key; new entries take the
    per-key override or the default (must be non-empty)."""
    existing = load_baseline(path)
    entries = []
    for f in sorted(findings, key=lambda f: f.key):
        just = ((justifications or {}).get(f.key)
                or existing.get(f.key)
                or default_justification)
        if not just:
            raise ValueError(
                f"baseline entry {f.key} needs a justification "
                "(--justification, or edit the baseline file)")
        entries.append({"rule": f.rule, "path": f.path,
                        "detail": f.detail, "justification": just})
    data = {"version": REPORT_VERSION, "entries": entries}
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(data, fh, indent=2, sort_keys=False)
        fh.write("\n")
    os.replace(tmp, path)
    return data


# ---------------------------------------------------------------------
# running + reporting
# ---------------------------------------------------------------------


def split_findings(ws: Workspace, findings: Iterable[Finding],
                   baseline: Dict[str, str]):
    """``(active, baselined, suppressed)`` — pragma suppression first
    (it lives in the code), then baseline matching by stable key."""
    active: List[Finding] = []
    baselined: List[Finding] = []
    suppressed: List[Finding] = []
    for f in sorted(findings, key=lambda f: (f.path, f.line, f.rule,
                                             f.detail)):
        sf = ws.get(f.path)
        if sf is not None and sf.suppressed(f):
            suppressed.append(f)
        elif f.key in baseline:
            baselined.append(f)
        else:
            active.append(f)
    return active, baselined, suppressed


def make_report(active: Sequence[Finding],
                baselined: Sequence[Finding],
                suppressed: Sequence[Finding],
                files_scanned: int, rules_run: Sequence[str]) -> dict:
    counts: Dict[str, int] = {}
    for f in active:
        counts[f.rule] = counts.get(f.rule, 0) + 1
    return {
        "tool": REPORT_TOOL,
        "version": REPORT_VERSION,
        "rules": sorted(rules_run),
        "files_scanned": files_scanned,
        "findings": [f.to_json() for f in active],
        "baselined": [f.to_json() for f in baselined],
        "suppressed": len(suppressed),
        "counts_by_rule": dict(sorted(counts.items())),
        "total": len(active),
    }


def load_report(path: str) -> Tuple[Optional[dict], Optional[str]]:
    """``(report, error)`` — a raftlint JSON report, validated just
    enough for a gate: it must distinguish "clean report" from "no or
    garbage report" (the latter fails the gate)."""
    try:
        with open(path) as f:
            data = json.load(f)
    except OSError as e:
        return None, f"cannot read lint report {path!r}: {e}"
    except ValueError as e:
        return None, f"lint report {path!r} is not JSON: {e}"
    if (not isinstance(data, dict) or data.get("tool") != REPORT_TOOL
            or not isinstance(data.get("findings"), list)):
        return None, (f"lint report {path!r} is not a raftlint report "
                      "(expected {'tool': 'raftlint', 'findings': "
                      "[...]})")
    return data, None
