"""Config/CLI drift checker (rules CFG401..CFG403).

The port's copy of the JAX package's ``analysis/contracts.py``.  Three
registries describe the same knob surface and nothing but convention
keeps them aligned: the frozen config dataclasses (``RAFTConfig`` /
``TrainConfig`` in ``config.py``, ``ServeConfig`` in
``serve/engine.py``), the argparse flags of the port's CLIs and root
scripts, and the tuning-registry knob tuples in ``tuning.py``.  Drift
here is user-facing: a flag that parses but is never read silently
ignores the user's intent; a doc that names a flag the CLI dropped sends
them to ``error: unrecognized arguments``; a tunable not backed by a
config field is a registry entry nothing consumes.

Rules:

- ``CFG401`` dead flag: an ``add_argument`` whose dest is never
  consumed in its own module — not accessed as an attribute
  (``args.<dest>``), not named in a string literal (``getattr`` /
  dict-key forwarding), and the module doesn't bulk-forward via
  ``vars(args)``.  The match is deliberately lenient; what it still
  catches is the flag nothing reads at all.
- ``CFG402`` phantom doc flag: ``--flag`` named inside a backtick
  span of README's port section that no argparse declaration of the
  port provides (the JAX package's docs name the JAX package's flags
  and are its own linter's scope).
- ``CFG403`` orphan tunable: a name in ``TUNABLE_KNOBS`` that is not
  a ``RAFTConfig`` field, or in ``SERVE_TUNABLE_KNOBS`` that is not a
  ``ServeConfig`` field — ``resolve_config`` would silently drop it.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Sequence, Set, Tuple

from raft_tpu_torch.analysis.core import (ROOT_SCRIPTS, Finding,
                                          Workspace, doc_texts)

CLI_SCOPE = ("raft_tpu_torch/cli", "raft_tpu_torch/convert.py") \
    + ROOT_SCRIPTS
#: README from the port's heading to its end (see ``core.doc_texts``).
DOC_SCOPE = (("README.md", "## PyTorch / H100 port"),)
CONFIG_CLASSES = {
    "RAFTConfig": "raft_tpu_torch/config.py",
    "TrainConfig": "raft_tpu_torch/config.py",
    "ServeConfig": "raft_tpu_torch/serve/engine.py",
}
TUNING_PATH = "raft_tpu_torch/tuning.py"
KNOB_REGISTRIES = {
    "TUNABLE_KNOBS": "RAFTConfig",
    "SERVE_TUNABLE_KNOBS": "ServeConfig",
}

#: ``--flag`` / ``--flag_name`` inside a backtick span.
_BACKTICK_RE = re.compile(r"`([^`]+)`")
_FLAG_RE = re.compile(r"--[A-Za-z0-9][-A-Za-z0-9_]*")


def _str_const(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def dataclass_fields(ws: Workspace, cls_name: str,
                     relpath: str) -> Set[str]:
    """Annotated field names of a (frozen) dataclass, by AST."""
    sf = ws.get(relpath)
    if sf is None or sf.tree is None:
        return set()
    for node in sf.tree.body:
        if isinstance(node, ast.ClassDef) and node.name == cls_name:
            return {item.target.id for item in node.body
                    if isinstance(item, ast.AnnAssign)
                    and isinstance(item.target, ast.Name)}
    return set()


class _Flag:
    __slots__ = ("dest", "options", "path", "line")

    def __init__(self, dest, options, path, line):
        self.dest = dest
        self.options = options
        self.path = path
        self.line = line


def collect_flags(ws: Workspace,
                  scope: Sequence[str] = CLI_SCOPE) -> List[_Flag]:
    flags: List[_Flag] = []
    for sf in ws.glob_py(*scope, exclude=("tests/",)):
        if sf.tree is None:
            continue
        for node in ast.walk(sf.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "add_argument"):
                continue
            options = [s for s in map(_str_const, node.args)
                       if s and s.startswith("-")]
            positional = [s for s in map(_str_const, node.args)
                          if s and not s.startswith("-")]
            dest = None
            for kw in node.keywords:
                if kw.arg == "dest":
                    dest = _str_const(kw.value)
            if dest is None:
                longs = [o for o in options if o.startswith("--")]
                if longs:
                    dest = longs[0].lstrip("-").replace("-", "_")
                elif positional:
                    dest = positional[0]
                elif options:
                    dest = options[0].lstrip("-")
            if dest:
                flags.append(_Flag(dest, options or positional,
                                   sf.relpath, node.lineno))
    return flags


def _module_consumes(sf) -> Tuple[Set[str], bool]:
    """``(names, bulk)`` — attribute/string names the module touches,
    and whether it bulk-forwards a namespace via ``vars(...)``."""
    names: Set[str] = set()
    bulk = False
    for node in ast.walk(sf.tree):
        if isinstance(node, ast.Attribute):
            names.add(node.attr)
        elif isinstance(node, ast.Constant) and \
                isinstance(node.value, str):
            names.add(node.value)
        elif isinstance(node, ast.Call):
            f = node.func
            if isinstance(f, ast.Name) and f.id == "vars":
                bulk = True
    return names, bulk


def check(ws: Workspace,
          cli_scope: Sequence[str] = CLI_SCOPE,
          doc_scope: Sequence = DOC_SCOPE,
          config_classes: Optional[Dict[str, str]] = None,
          tuning_path: str = TUNING_PATH,
          knob_registries: Optional[Dict[str, str]] = None,
          ) -> List[Finding]:
    findings: List[Finding] = []
    config_classes = (CONFIG_CLASSES if config_classes is None
                      else config_classes)
    knob_registries = (KNOB_REGISTRIES if knob_registries is None
                       else knob_registries)
    fields = {cls: dataclass_fields(ws, cls, rel)
              for cls, rel in config_classes.items()}
    flags = collect_flags(ws, cli_scope)

    # ------------------------------ CFG401 ----------------------------
    consumes: Dict[str, Tuple[Set[str], bool]] = {}
    for f in flags:
        if f.path not in consumes:
            consumes[f.path] = _module_consumes(ws.get(f.path))
        names, bulk = consumes[f.path]
        if bulk or f.dest in names:
            continue
        opt = f.options[0] if f.options else f.dest
        findings.append(Finding(
            "CFG401", f.path, f.line, f"{f.path}:{opt}",
            f"flag `{opt}` parses into `args.{f.dest}` but nothing "
            f"in {f.path} reads it — the user's setting is silently "
            "ignored; wire it through or delete the flag"))

    # ------------------------------ CFG402 ----------------------------
    declared: Set[str] = set()
    for f in flags:
        for o in f.options:
            if o.startswith("--"):
                declared.add(o)

    # Docs mix dash and underscore spellings; compare normalized.
    def norm(flag: str) -> str:
        return flag.lstrip("-").replace("-", "_")

    declared_norm = {norm(o) for o in declared}
    for relpath, first, text in doc_texts(ws, doc_scope):
        seen: Set[str] = set()
        for i, line in enumerate(text.splitlines(), start=first):
            for span in _BACKTICK_RE.findall(line):
                for m in _FLAG_RE.findall(span):
                    if norm(m) in declared_norm or m in seen:
                        continue
                    seen.add(m)
                    findings.append(Finding(
                        "CFG402", relpath, i, m,
                        f"doc names flag `{m}` but no argparse "
                        "declaration under "
                        f"{'/'.join(cli_scope)} provides it — "
                        "readers get `unrecognized arguments`"))
    # ------------------------------ CFG403 ----------------------------
    sf = ws.get(tuning_path)
    if sf is not None and sf.tree is not None:
        for node in sf.tree.body:
            if not isinstance(node, ast.Assign):
                continue
            for tgt in node.targets:
                if not (isinstance(tgt, ast.Name)
                        and tgt.id in knob_registries):
                    continue
                cls = knob_registries[tgt.id]
                valid = fields.get(cls, set())
                if not valid:
                    continue
                if isinstance(node.value, (ast.Tuple, ast.List)):
                    for elt in node.value.elts:
                        knob = _str_const(elt)
                        if knob and knob not in valid:
                            findings.append(Finding(
                                "CFG403", tuning_path, elt.lineno,
                                f"{tgt.id}:{knob}",
                                f"tunable `{knob}` in {tgt.id} is "
                                f"not a {cls} field — autotune "
                                "would persist winners "
                                "`resolve_config` silently drops"))
    return findings
