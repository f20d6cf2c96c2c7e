"""Telemetry-contract checker (rules TEL301..TEL305).

The port's copy of the JAX package's ``analysis/telemetry.py``.  The
port emits the JAX package's metric and event names, so its contract
lives in the same places: the emission sites
(``registry.counter/gauge/histogram``, ``sink.emit``, ``span``) under
``raft_tpu_torch/``, the JAX package's catalog in
``docs/OBSERVABILITY.md`` (read-only here), and a catalog of the names
only the port emits, in README's port section.  Dashboards fail
*silently* when these drift — a renamed metric doesn't error, it just
flatlines.

Matching is deliberately asymmetric:

- **documented?** is lenient — a metric/event counts as documented if
  its name appears in a backtick span anywhere in a catalog (table,
  prose, triage table), with ``{label}`` suffixes stripped.
- **still emitted?** is strict on the doc side (only names in actual
  catalog-table rows — header ``| metric |`` / ``| event |`` — assert
  existence) and lenient on the code side (any matching ``raft_*``
  string literal anywhere in the scanned tree counts, including
  f-string literal prefixes and ``span("name")`` → ``name_seconds``
  derivations), so refactors that route a name through a variable
  don't false-positive.
- **event names passed to a helper** count as emitted where the helper
  forwards them: a literal passed to a same-module function whose
  parameter reaches ``emit``'s first argument, directly or through
  further such functions (the serving engine's ``_fail_lanes`` and
  ``_pool_failed``).

Rules:

- ``TEL301`` metric emitted with a literal name no catalog mentions;
- ``TEL302`` metric named in a catalog-table row that nothing in the
  code can emit anymore (stale doc);
- ``TEL303`` / ``TEL304`` — same pair for JSONL events
  (``sink.emit("name", ...)`` vs the event-schema tables);
- ``TEL305`` a regression gate reads a record key (``cfg.get("k")`` /
  ``newest.get("k")``) that no producer script ever writes — a gate
  reading a key nobody emits passes vacuously forever.  It runs only
  when a gate is named (``gate_path``): the port has no regression gate
  of its own yet, and the JAX package's gate reads the JAX bench's keys.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Sequence, Set, Tuple

from raft_tpu_torch.analysis.core import Finding, Workspace, doc_texts

DOC_PATH = "docs/OBSERVABILITY.md"
#: The names only the port emits: README's port section.
PORT_CATALOG = ("README.md", "## PyTorch / H100 port")
#: Code scanned for emissions.  tests/ and the analysis package itself
#: are excluded (both quote metric names without emitting them).
CODE_SCOPE = ("raft_tpu_torch",)
CODE_EXCLUDE = ("tests/", "raft_tpu_torch/analysis/")

_BACKTICK_RE = re.compile(r"`([^`]+)`")
#: What a metric/event name looks like (vs a path / flag / expression
#: that happens to sit in backticks).
_NAME_RE = re.compile(r"^[a-z][a-z0-9_]*$")
_METRIC_RE = re.compile(r"^raft_[a-z0-9_]+$")


def _strip_labels(token: str) -> str:
    return re.sub(r"\{[^}]*\}", "", token).strip()


def _str_const(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def _fstring_prefix(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.JoinedStr) and node.values:
        first = _str_const(node.values[0])
        if first:
            return first
    return None


class _Emission:
    __slots__ = ("name", "path", "line", "kind", "prefix")

    def __init__(self, name, path, line, kind, prefix=False):
        self.name = name
        self.path = path
        self.line = line
        self.kind = kind      # "counter"/"gauge"/"histogram"/"event"
        self.prefix = prefix  # True when name is an f-string prefix


def _module_str_constants(tree: ast.Module) -> Dict[str, str]:
    """Module-level ``NAME = "literal"`` bindings (``EVENT =
    "trace_span"`` in obs/trace.py is the motivating case)."""
    out: Dict[str, str] = {}
    for node in tree.body:
        if isinstance(node, ast.Assign):
            val = _str_const(node.value)
            if val is not None:
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        out[tgt.id] = val
    return out


def _leaf(func: ast.AST) -> Optional[str]:
    return (func.attr if isinstance(func, ast.Attribute)
            else func.id if isinstance(func, ast.Name) else None)


def _params(fn: ast.AST) -> List[str]:
    a = fn.args
    return [p.arg for p in a.posonlyargs + a.args]


def _bound_args(call: ast.Call, fn: ast.AST,
                method: bool) -> List[Tuple[str, ast.AST]]:
    """``(parameter, argument)`` pairs of ``call`` against ``fn``'s
    signature; a method called through an attribute skips ``self``."""
    a = fn.args
    params = _params(fn)
    if method and isinstance(call.func, ast.Attribute) and params:
        params = params[1:]
    out = [(p, arg) for p, arg in zip(params, call.args)
           if not isinstance(arg, ast.Starred)]
    names = set(params) | {p.arg for p in a.kwonlyargs}
    out += [(kw.arg, kw.value) for kw in call.keywords
            if kw.arg in names]
    return out


def _forwarding(tree: ast.Module) -> Dict[str, Tuple[ast.AST, bool,
                                                     Set[str]]]:
    """Per function name of the module: ``(node, is_method, params)``,
    ``params`` those of its parameters that reach ``emit``'s first
    argument — directly, or passed on as a bare name into such a
    parameter of another function of the module (to a fixpoint)."""
    fns: Dict[str, Tuple[ast.AST, bool]] = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            fns.setdefault(node.name, (node, False))
        elif isinstance(node, ast.ClassDef):
            for item in node.body:
                if isinstance(item, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                    fns.setdefault(item.name, (item, True))
    reach: Dict[str, Set[str]] = {name: set() for name in fns}
    for name, (fn, _m) in fns.items():
        params = set(_params(fn)) | {p.arg for p in fn.args.kwonlyargs}
        for node in ast.walk(fn):
            if isinstance(node, ast.Call) and _leaf(node.func) == "emit" \
                    and isinstance(node.func, ast.Attribute) and node.args \
                    and isinstance(node.args[0], ast.Name) \
                    and node.args[0].id in params:
                reach[name].add(node.args[0].id)
    changed = True
    while changed:
        changed = False
        for name, (fn, _m) in fns.items():
            params = set(_params(fn)) | {p.arg for p in fn.args.kwonlyargs}
            for node in ast.walk(fn):
                callee = (_leaf(node.func) if isinstance(node, ast.Call)
                          else None)
                if callee not in fns or not reach[callee]:
                    continue
                cnode, cmethod = fns[callee]
                for p, arg in _bound_args(node, cnode, cmethod):
                    if p in reach[callee] and isinstance(arg, ast.Name) \
                            and arg.id in params \
                            and arg.id not in reach[name]:
                        reach[name].add(arg.id)
                        changed = True
    return {name: (fn, m, reach[name]) for name, (fn, m) in fns.items()
            if reach[name]}


def collect_emissions(ws: Workspace,
                      scope: Sequence[str] = CODE_SCOPE,
                      exclude: Sequence[str] = CODE_EXCLUDE,
                      ) -> Tuple[List[_Emission], Set[str], Set[str]]:
    """``(emissions, literal_pool, prefix_pool)``.

    ``emissions`` have resolvable names (literal / module constant /
    f-string prefix / a literal forwarded to ``emit``); the pools
    additionally hold every bare ``raft_*`` string literal in scope, so
    names routed through variables and function defaults still count as
    emitted for the staleness rules.
    """
    emissions: List[_Emission] = []
    literal_pool: Set[str] = set()
    prefix_pool: Set[str] = set()
    for sf in ws.glob_py(*scope, exclude=tuple(exclude)):
        if sf.tree is None:
            continue
        consts = _module_str_constants(sf.tree)
        forwarding = _forwarding(sf.tree)
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.Constant) and \
                    isinstance(node.value, str) and \
                    _METRIC_RE.match(node.value) and \
                    node.value != "raft_tpu":
                literal_pool.add(node.value)
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            attr = _leaf(f)
            if attr in ("counter", "gauge", "histogram") and node.args:
                arg = node.args[0]
                name = _str_const(arg)
                if name is None and isinstance(arg, ast.Name):
                    name = consts.get(arg.id)
                if name is not None:
                    emissions.append(_Emission(
                        name, sf.relpath, node.lineno, attr))
                else:
                    pref = _fstring_prefix(arg)
                    if pref and _METRIC_RE.match(pref.rstrip("_")):
                        emissions.append(_Emission(
                            pref, sf.relpath, node.lineno, attr,
                            prefix=True))
                        prefix_pool.add(pref)
            elif attr in ("span", "trace_span") and node.args:
                name = _str_const(node.args[0])
                if name is not None and not isinstance(
                        f, ast.Attribute):
                    # span(name) times into <name>_seconds and is a
                    # metric surface of its own (trace_span children
                    # fold into the trace_span event, not here).
                    if attr == "span":
                        derived = (name if name.endswith("_seconds")
                                   else f"{name}_seconds")
                        emissions.append(_Emission(
                            derived, sf.relpath, node.lineno,
                            "histogram"))
                        literal_pool.add(derived)
            elif attr == "emit" and node.args and \
                    isinstance(f, ast.Attribute):
                arg = node.args[0]
                name = _str_const(arg)
                if name is None and isinstance(arg, ast.Name):
                    name = consts.get(arg.id)
                if name is not None:
                    emissions.append(_Emission(
                        name, sf.relpath, node.lineno, "event"))
            elif attr in forwarding:
                fn, method, reach = forwarding[attr]
                for p, arg in _bound_args(node, fn, method):
                    name = _str_const(arg) if p in reach else None
                    if name is not None:
                        emissions.append(_Emission(
                            name, sf.relpath, node.lineno, "event"))
    return emissions, literal_pool, prefix_pool


# ---------------------------------------------------------------------
# doc parsing
# ---------------------------------------------------------------------


class DocCatalog:
    """Catalog documents parsed two ways: the lenient any-backtick token
    set and the strict catalog-table rows, each row by its file and
    line.  ``parts`` are ``(relpath, first_line, text)``
    (``core.doc_texts``)."""

    def __init__(self, parts: Sequence[Tuple[str, int, str]]):
        self.tokens: Set[str] = set()
        #: name -> (doc, 1-based line), from rows of ``| metric |`` tables
        self.metric_rows: Dict[str, Tuple[str, int]] = {}
        #: same, from rows of ``| event |`` tables
        self.event_rows: Dict[str, Tuple[str, int]] = {}
        for relpath, first, text in parts:
            self._parse(relpath, first, text)

    def _parse(self, relpath: str, first: int, text: str) -> None:
        header = None   # "metric" | "event" | other
        for i, line in enumerate(text.splitlines(), start=first):
            stripped = line.strip()
            for tok in _BACKTICK_RE.findall(line):
                tok = _strip_labels(tok)
                if tok:
                    self.tokens.add(tok)
            if not stripped.startswith("|"):
                header = None
                continue
            cells = [c.strip() for c in stripped.strip("|").split("|")]
            if not cells:
                continue
            first_cell = cells[0].lower()
            if first_cell in ("metric", "event"):
                header = first_cell
                continue
            if set(first_cell) <= {"-", " ", ":"}:
                continue
            if header is None:
                continue
            rows = (self.metric_rows if header == "metric"
                    else self.event_rows)
            for tok in _BACKTICK_RE.findall(cells[0]):
                name = _strip_labels(tok)
                if _NAME_RE.match(name):
                    rows.setdefault(name, (relpath, i))

    def documents(self, name: str, prefix: bool = False) -> bool:
        if prefix:
            return any(t.startswith(name) for t in self.tokens)
        return name in self.tokens


# ---------------------------------------------------------------------
# checks
# ---------------------------------------------------------------------


#: Receiver names that hold a bench record (or its ``config`` block)
#: inside the gate — only ``.get()`` reads off these are contract keys.
_RECORD_RECEIVERS = {"cfg", "config", "newest", "rec", "record", "r"}


def _gate_keys(sf) -> List[Tuple[str, int]]:
    """Literal keys the regression gate reads off bench records:
    ``cfg.get("k")`` / ``newest.get("k")`` / ``r.get("k")``."""
    out: List[Tuple[str, int]] = []
    if sf is None or sf.tree is None:
        return out
    for node in ast.walk(sf.tree):
        if isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                node.func.attr == "get" and node.args and \
                isinstance(node.func.value, ast.Name) and \
                node.func.value.id in _RECORD_RECEIVERS:
            key = _str_const(node.args[0])
            if key is not None and _NAME_RE.match(key):
                out.append((key, node.lineno))
    return out


def check(ws: Workspace,
          doc_path: str = DOC_PATH,
          catalogs: Sequence = (PORT_CATALOG,),
          scope: Sequence[str] = CODE_SCOPE,
          exclude: Sequence[str] = CODE_EXCLUDE,
          gate_path: Optional[str] = None,
          producer_scope: Sequence[str] = (),
          ) -> List[Finding]:
    """The four rules over ``scope`` against ``doc_path`` plus the
    further ``catalogs`` (``core.doc_texts`` scope entries); TEL305 when
    ``gate_path`` names a gate, with ``producer_scope`` its producers."""
    findings: List[Finding] = []
    doc_sf = ws.get(doc_path)
    if doc_sf is None:
        return [Finding("TEL302", doc_path, 1, "missing-doc",
                        f"{doc_path} does not exist — the telemetry "
                        "catalog is the contract this rule checks")]
    doc = DocCatalog([(doc_path, 1, doc_sf.text)]
                     + doc_texts(ws, catalogs))
    where = " or ".join([doc_path] + [c[0] if isinstance(c, tuple)
                                      else c for c in catalogs])
    emissions, literal_pool, prefix_pool = collect_emissions(
        ws, scope, exclude)

    # TEL301 / TEL303: emitted but undocumented (dedup per name).
    seen: Set[str] = set()
    for e in emissions:
        if e.name in seen:
            continue
        seen.add(e.name)
        if doc.documents(e.name, prefix=e.prefix):
            continue
        if e.kind == "event":
            findings.append(Finding(
                "TEL303", e.path, e.line, e.name,
                f"event `{e.name}` is emitted here but never "
                f"mentioned in {where}; add a schema-table row "
                "(or prose) — undocumented events rot into "
                "unparseable logs"))
        else:
            findings.append(Finding(
                "TEL301", e.path, e.line,
                e.name + ("*" if e.prefix else ""),
                f"{e.kind} `{e.name}{'…' if e.prefix else ''}` is "
                f"emitted here but never mentioned in {where}; "
                "add a catalog row — dashboards can't find what the "
                "doc doesn't name"))

    # TEL302 / TEL304: documented in a catalog table, no longer
    # emittable from code.
    emitted_names = {e.name for e in emissions} | literal_pool

    def emittable(name: str) -> bool:
        if name in emitted_names:
            return True
        return any(name.startswith(p) for p in prefix_pool)

    for name, (path, line) in sorted(doc.metric_rows.items()):
        if _METRIC_RE.match(name) and not emittable(name):
            findings.append(Finding(
                "TEL302", path, line, name,
                f"catalog row documents metric `{name}` but no "
                "emission site or string literal in "
                f"{'/'.join(scope)} can produce it — stale doc or "
                "renamed metric"))
    event_names = {e.name for e in emissions if e.kind == "event"}
    for name, (path, line) in sorted(doc.event_rows.items()):
        if name not in event_names and name not in literal_pool:
            findings.append(Finding(
                "TEL304", path, line, name,
                f"schema row documents event `{name}` but nothing "
                f"in {'/'.join(scope)} emits it — stale doc or "
                "renamed event"))

    # TEL305: regression-gate keys nobody produces.
    gate_sf = ws.get(gate_path) if gate_path else None
    if gate_sf is not None and gate_sf.tree is not None:
        pool: Set[str] = set()
        for sf in ws.glob_py(*producer_scope, exclude=("tests/",)):
            # The gate file is NOT its own producer: counting its
            # literals would put every `.get("k")` key into the pool
            # and make this rule vacuously green forever.
            if sf.relpath == gate_path or sf.tree is None:
                continue
            for node in ast.walk(sf.tree):
                if isinstance(node, ast.Constant) and \
                        isinstance(node.value, str):
                    pool.add(node.value)
                pref = _fstring_prefix(node)
                if pref:
                    pool.add(pref.rstrip("_"))
        seen_keys: Set[str] = set()
        for key, line in _gate_keys(gate_sf):
            if key in seen_keys:
                continue
            seen_keys.add(key)
            if key not in pool:
                findings.append(Finding(
                    "TEL305", gate_path, line, key,
                    f"gate reads record key `{key}` that no producer "
                    f"under {'/'.join(producer_scope)} ever writes — "
                    "the check passes vacuously forever"))
    return findings
