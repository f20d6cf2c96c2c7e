"""Lock-discipline + lock-order checker (rules LOCK201, LOCK202).

The port's copy of the JAX package's ``analysis/locks.py``, scoped to
the port's threading seams: the serving engine's host and device
threads, the fleet's supervisor, the router and the fabric client, the
observability registry, trace and event sinks, the stall watchdog, the
training input pipeline's producer thread and the background checkpoint
committer share state guarded by per-object ``threading.Lock`` /
``RLock`` / ``Condition`` instances.  The discipline is conventional —
nothing enforces it — so this checker derives it from the code itself:

- a class's **locks** are the attributes assigned
  ``threading.Lock()`` / ``RLock()`` / ``Condition()`` (or bare
  ``Lock()``) in ``__init__``;
- a class's **guarded attributes** are the ``self.<attr>`` names
  *written* inside any ``with self.<lock>:`` body outside
  ``__init__`` — if one code path takes the lock to write an
  attribute, every path must;
- module-level locks (``_default_lock`` next to a ``_default``
  singleton) guard the module globals written under them.

Rules:

- ``LOCK201`` guarded attribute written outside its lock.  Both the
  in-class form (``self.attr = ...`` with no enclosing ``with
  self._lock:``) and the cross-object form (``replica.attr = ...``
  from supervisor code) are flagged; the cross-object form only fires
  when the attribute name is guarded in exactly one scoped class, so
  generic names on unrelated objects stay quiet.  Conventions honored:
  ``__init__``/``__new__`` construct before publication;
  ``*_locked``-suffixed methods assert the caller holds the lock.
- ``LOCK202`` cycle in the cross-module lock-acquisition-order graph.
  Edges are added when lock B is taken while A is held — directly
  nested ``with`` blocks, plus one level of interprocedural resolution
  (method calls inside a ``with`` body, resolved by name across all
  scoped classes).  Any directed cycle is a deadlock the scheduler
  merely hasn't scheduled yet.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Sequence, Set, Tuple

from raft_tpu_torch.analysis.core import PACKAGE, Finding, Workspace

#: The port's threading seams (repo-relative).  :func:`default_scope`
#: adds every other port module that creates a lock.
DEFAULT_SCOPE = (
    "raft_tpu_torch/serve/engine.py",
    "raft_tpu_torch/serve/fleet.py",
    "raft_tpu_torch/serve/router.py",
    "raft_tpu_torch/serve/remote.py",
    "raft_tpu_torch/obs/registry.py",
    "raft_tpu_torch/obs/trace.py",
    "raft_tpu_torch/obs/events.py",
    "raft_tpu_torch/obs/watchdog.py",
    "raft_tpu_torch/data/prefetch.py",
    "raft_tpu_torch/train/checkpoint.py",
)
EXCLUDE = ("raft_tpu_torch/analysis/",)

_LOCK_CTORS = {"Lock", "RLock", "Condition", "Semaphore",
               "BoundedSemaphore"}


def _lock_ctor(value: ast.AST) -> bool:
    if not isinstance(value, ast.Call):
        return False
    f = value.func
    name = f.attr if isinstance(f, ast.Attribute) else (
        f.id if isinstance(f, ast.Name) else None)
    return name in _LOCK_CTORS


def default_scope(ws: Workspace) -> Tuple[str, ...]:
    """:data:`DEFAULT_SCOPE` plus every other module of the package that
    calls a lock constructor (``Lock()``, ``RLock()``, ``Condition()``,
    ``Semaphore()``, ``BoundedSemaphore()``)."""
    extra = [sf.relpath for sf in ws.glob_py(PACKAGE, exclude=EXCLUDE)
             if sf.tree is not None and sf.relpath not in DEFAULT_SCOPE
             and any(_lock_ctor(n) for n in ast.walk(sf.tree))]
    return DEFAULT_SCOPE + tuple(extra)


def _self_attr(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name) and node.value.id == "self":
        return node.attr
    return None


def _with_lock_name(item: ast.withitem) -> Optional[Tuple[str, str]]:
    """``("self", lockattr)`` for ``with self._lock:``, or
    ``(varname, lockattr)`` for ``with r._lock:``, or
    ``("", name)`` for a module-level ``with _default_lock:``."""
    expr = item.context_expr
    # with self._lock:  /  with lock.acquire_timeout(...): not handled
    if isinstance(expr, ast.Attribute) and isinstance(expr.value,
                                                     ast.Name):
        return expr.value.id, expr.attr
    if isinstance(expr, ast.Name):
        return "", expr.id
    # with self._cond:  via Call like self._lock.acquire() is not a
    # with-pattern used in this repo.
    return None


class _ClassInfo:
    __slots__ = ("name", "relpath", "locks", "guarded", "methods",
                 "all_attrs")

    def __init__(self, name: str, relpath: str):
        self.name = name
        self.relpath = relpath
        self.locks: Set[str] = set()
        #: attr -> set of lock names it has been written under
        self.guarded: Dict[str, Set[str]] = {}
        self.methods: Dict[str, ast.AST] = {}
        #: every self.<attr> this class writes anywhere (incl.
        #: __init__) — used to disambiguate cross-object writes
        self.all_attrs: Set[str] = set()


def _index_classes(sf) -> List[_ClassInfo]:
    out = []
    for node in sf.tree.body:
        if not isinstance(node, ast.ClassDef):
            continue
        info = _ClassInfo(node.name, sf.relpath)
        for item in node.body:
            if isinstance(item, (ast.FunctionDef,
                                 ast.AsyncFunctionDef)):
                info.methods[item.name] = item
        init = info.methods.get("__init__")
        if init is not None:
            for n in ast.walk(init):
                if isinstance(n, ast.Assign) and _lock_ctor(n.value):
                    for tgt in n.targets:
                        attr = _self_attr(tgt)
                        if attr:
                            info.locks.add(attr)
        for mnode in info.methods.values():
            for n in ast.walk(mnode):
                if isinstance(n, (ast.Assign, ast.AugAssign,
                                  ast.AnnAssign)):
                    targets = (n.targets if isinstance(n, ast.Assign)
                               else [n.target])
                    for tgt in targets:
                        attr = _self_attr(tgt)
                        if attr:
                            info.all_attrs.add(attr)
        out.append(info)
    return out


def _held_locks(stack: List[Tuple[str, str]], owner: str = "self"
                ) -> Set[str]:
    return {lock for (recv, lock) in stack if recv == owner}


def _collect_guarded(info: _ClassInfo) -> None:
    """Fill ``info.guarded`` from ``with self.<lock>:`` write sites."""
    for mname, mnode in info.methods.items():
        if mname == "__init__":
            continue

        def walk(node, held: List[Tuple[str, str]]):
            if isinstance(node, ast.With):
                names = [_with_lock_name(i) for i in node.items]
                pushed = [n for n in names
                          if n and n[0] == "self" and n[1] in info.locks]
                held = held + pushed
                for child in node.body:
                    walk(child, held)
                return
            if isinstance(node, (ast.FunctionDef,
                                 ast.AsyncFunctionDef, ast.Lambda)):
                return  # nested defs run later, not under this lock
            if held and isinstance(node, (ast.Assign, ast.AugAssign,
                                          ast.AnnAssign)):
                targets = (node.targets
                           if isinstance(node, ast.Assign)
                           else [node.target])
                for tgt in targets:
                    attr = _self_attr(tgt)
                    if attr and attr not in info.locks:
                        info.guarded.setdefault(attr, set()).update(
                            lock for (_r, lock) in held)
            for child in ast.iter_child_nodes(node):
                walk(child, held)

        for stmt in mnode.body:
            walk(stmt, [])


def check(ws: Workspace,
          scope: Optional[Sequence[str]] = None) -> List[Finding]:
    findings: List[Finding] = []
    if scope is None:
        scope = default_scope(ws)
    files = [sf for sf in ws.glob_py(*scope) if sf.tree is not None]
    classes: List[_ClassInfo] = []
    for sf in files:
        classes.extend(_index_classes(sf))
    for info in classes:
        _collect_guarded(info)

    # Attr name -> classes that guard it (for cross-object writes).
    # An attr qualifies only when the guarding class is ALSO the only
    # scoped class writing that name at all — `pool.state` must not
    # match `Replica.state` just because both spell it "state".
    guard_owners: Dict[str, List[_ClassInfo]] = {}
    attr_writers: Dict[str, Set[str]] = {}
    for info in classes:
        for attr in info.all_attrs:
            attr_writers.setdefault(attr, set()).add(info.name)
    for info in classes:
        for attr in info.guarded:
            if attr_writers.get(attr) == {info.name}:
                guard_owners.setdefault(attr, []).append(info)

    by_file: Dict[str, List[_ClassInfo]] = {}
    for info in classes:
        by_file.setdefault(info.relpath, []).append(info)

    # ---------------- LOCK201: writes outside the lock ----------------
    for sf in files:
        for info in by_file.get(sf.relpath, []):
            for mname, mnode in info.methods.items():
                if mname in ("__init__", "__new__") or \
                        mname.endswith("_locked"):
                    continue

                def walk(node, held: List[Tuple[str, str]]):
                    if isinstance(node, ast.With):
                        names = [_with_lock_name(i)
                                 for i in node.items]
                        held = held + [n for n in names if n]
                        for child in node.body:
                            walk(child, held)
                        return
                    if isinstance(node, (ast.FunctionDef,
                                         ast.AsyncFunctionDef,
                                         ast.Lambda)):
                        return
                    if isinstance(node, (ast.Assign, ast.AugAssign,
                                         ast.AnnAssign)):
                        targets = (node.targets
                                   if isinstance(node, ast.Assign)
                                   else [node.target])
                        for tgt in targets:
                            self_attr = _self_attr(tgt)
                            if self_attr:
                                locks = info.guarded.get(self_attr)
                                if locks and not (
                                        locks
                                        & _held_locks(held, "self")):
                                    findings.append(Finding(
                                        "LOCK201", sf.relpath,
                                        node.lineno,
                                        f"{info.name}.{self_attr}",
                                        f"`self.{self_attr}` is "
                                        "written under "
                                        f"`self.{sorted(locks)[0]}` "
                                        "elsewhere in "
                                        f"`{info.name}` but mutated "
                                        f"here in `{mname}()` "
                                        "without it; take the lock "
                                        "or rename the method "
                                        "`*_locked` if the caller "
                                        "holds it"))
                            elif isinstance(tgt, ast.Attribute) and \
                                    isinstance(tgt.value, ast.Name) \
                                    and tgt.value.id != "self":
                                # cross-object write, e.g. from a
                                # supervisor thread: r.attr = ...
                                owners = guard_owners.get(tgt.attr, [])
                                if len(owners) != 1:
                                    continue
                                owner = owners[0]
                                recv = tgt.value.id
                                need = owner.guarded[tgt.attr]
                                if not (need
                                        & _held_locks(held, recv)):
                                    findings.append(Finding(
                                        "LOCK201", sf.relpath,
                                        node.lineno,
                                        f"{owner.name}.{tgt.attr}",
                                        f"`{recv}.{tgt.attr}` is "
                                        "guarded by "
                                        f"`{owner.name}."
                                        f"{sorted(need)[0]}` but "
                                        "written here without "
                                        f"`with {recv}."
                                        f"{sorted(need)[0]}:`"))
                    for child in ast.iter_child_nodes(node):
                        walk(child, held)

                for stmt in mnode.body:
                    walk(stmt, [])

    # ---------------- LOCK202: acquisition-order cycles ---------------
    # Node = "Class.lock" (or "module.lock" for module-level with).
    # direct_acquires[method qualname] = locks taken inside the method.
    def lock_node(info: Optional[_ClassInfo], recv: str, lock: str,
                  sf) -> Optional[str]:
        if recv == "self" and info is not None and lock in info.locks:
            return f"{info.name}.{lock}"
        if recv == "" :
            mod = sf.relpath.rsplit("/", 1)[-1][:-3]
            return f"{mod}.{lock}"
        # cross-object with (with r._lock:): attribute to owning class
        owners = [c for c in classes if lock in c.locks]
        if len(owners) == 1:
            return f"{owners[0].name}.{lock}"
        return None

    method_acquires: Dict[str, Set[str]] = {}
    method_nodes: Dict[str, List[Tuple[_ClassInfo, ast.AST, object]]] \
        = {}
    for sf in files:
        for info in by_file.get(sf.relpath, []):
            for mname, mnode in info.methods.items():
                method_nodes.setdefault(mname, []).append(
                    (info, mnode, sf))
                acq: Set[str] = set()
                for n in ast.walk(mnode):
                    if isinstance(n, ast.With):
                        for item in n.items:
                            nm = _with_lock_name(item)
                            if nm:
                                node = lock_node(info, nm[0], nm[1],
                                                 sf)
                                if node:
                                    acq.add(node)
                method_acquires[f"{info.name}.{mname}"] = acq

    edges: Dict[str, Set[str]] = {}
    edge_sites: Dict[Tuple[str, str], Tuple[str, int]] = {}

    def add_edge(a: str, b: str, relpath: str, line: int):
        if a == b:
            return  # re-entrant (RLock) or same-lock nesting
        edges.setdefault(a, set()).add(b)
        edge_sites.setdefault((a, b), (relpath, line))

    for sf in files:
        for info in by_file.get(sf.relpath, []):
            for mname, mnode in info.methods.items():

                def walk(node, held: List[str]):
                    if isinstance(node, ast.With):
                        acquired = []
                        for item in node.items:
                            nm = _with_lock_name(item)
                            if nm:
                                ln = lock_node(info, nm[0], nm[1], sf)
                                if ln:
                                    for h in held:
                                        add_edge(h, ln, sf.relpath,
                                                 node.lineno)
                                    acquired.append(ln)
                        held = held + acquired
                        for child in node.body:
                            walk(child, held)
                        return
                    if isinstance(node, (ast.FunctionDef,
                                         ast.AsyncFunctionDef,
                                         ast.Lambda)):
                        return
                    if held and isinstance(node, ast.Call):
                        f = node.func
                        callee = (f.attr if isinstance(f, ast.Attribute)
                                  else f.id if isinstance(f, ast.Name)
                                  else None)
                        if callee:
                            # one interprocedural level: union over
                            # same-named methods in scoped classes
                            for (cinfo, _cm, _csf) in \
                                    method_nodes.get(callee, []):
                                for ln in method_acquires.get(
                                        f"{cinfo.name}.{callee}",
                                        set()):
                                    for h in held:
                                        add_edge(h, ln, sf.relpath,
                                                 node.lineno)
                    for child in ast.iter_child_nodes(node):
                        walk(child, held)

                for stmt in mnode.body:
                    walk(stmt, [])

    # Cycle detection (DFS with colors); report each cycle once with a
    # canonical rotation so the finding key is stable.
    seen_cycles: Set[Tuple[str, ...]] = set()
    WHITE, GREY, BLACK = 0, 1, 2
    color = {n: WHITE for n in
             set(edges) | {b for bs in edges.values() for b in bs}}
    stack: List[str] = []

    def dfs(n: str):
        color[n] = GREY
        stack.append(n)
        for b in sorted(edges.get(n, ())):
            if color[b] == GREY:
                i = stack.index(b)
                cyc = stack[i:]
                k = min(range(len(cyc)), key=lambda j: cyc[j])
                canon = tuple(cyc[k:] + cyc[:k])
                if canon not in seen_cycles:
                    seen_cycles.add(canon)
                    site = edge_sites.get((n, b), ("", 1))
                    findings.append(Finding(
                        "LOCK202", site[0] or canon[0], site[1],
                        "->".join(canon),
                        "lock-acquisition-order cycle "
                        f"{' -> '.join(canon + (canon[0],))}: two "
                        "threads taking these locks in opposing "
                        "order deadlock; impose a global order or "
                        "drop the lock before the call"))
            elif color[b] == WHITE:
                dfs(b)
        stack.pop()
        color[n] = BLACK

    for n in sorted(color):
        if color[n] == WHITE:
            dfs(n)

    return findings
