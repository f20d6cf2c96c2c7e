"""Capture-purity / host-sync checker (rules JIT101..JIT104).

The port's counterpart of the JAX package's ``analysis/jit_purity.py``.
Where the JAX package traces its hot paths under ``jax.jit``, the port
captures them as CUDA graphs (``utils/graphs.py``) and replays them.  A
captured function's Python runs once, at capture, so host work inside it
is wrong, not slow: a ``time.perf_counter()`` or a host random draw is
frozen into every replay, a ``print`` fires once, and a read back to the
host (``.item()``, ``.cpu()``, ``float()`` on a device tensor) is a sync
that the capture refuses with an error.  The family key stays ``jit`` and
the rule IDs stay the JAX package's, so pragmas, ``--only`` and baselines
mean the same in both packages.

The checker walks functions *reachable from capture roots* rather than
flagging whole files, so host drivers (``serve/slots.py``'s dispatcher
loop, the ``make_*`` factories) can read results back an inch away from
the captured functions they build:

- **roots**: the function handed to a capture — the ``fn`` of a
  ``GraphCache`` call (any name or attribute bound to ``GraphCache(...)``
  or annotated ``GraphCache``) or of ``CapturedProgram(fn, ...)``, and of
  any function that forwards one of its parameters there
  (``SlotPrograms.run`` → ``_call``); as a name, an attribute, a lambda
  (the functions it calls are the captured code) or a factory call whose
  returned inner function is resolved; the functions called inside a
  ``with torch.cuda.graph(...)`` body; every method of an ``nn.Module``
  subclass but ``__init__`` (module dispatch is not statically
  resolvable, and construction runs once, before any capture); and
  ``forward`` / ``backward`` of a ``torch.autograd.Function`` subclass;
- **edges**: calls by name, resolved against nested defs, module-level
  defs, same-class methods, names bound to a factory's returned inner
  function (``self.encode_admit = make_encode_fn(model)``), and a
  cross-module union over the scoped files (imported helpers are called
  by bare name) — a deliberate over-approximation; suppress the rare
  false positive inline.  A nested def passed as an argument from
  captured code (a ``torch.utils.checkpoint`` region) is reached too.

Rules:

- ``JIT101`` host call in captured code: ``time.*``,
  ``np.random.*``, stdlib ``random.*``, ``print`` — each runs at
  capture, not at replay;
- ``JIT102`` host read of a device tensor: ``.item()`` /
  ``.tolist()`` / ``.cpu()`` / ``.numpy()`` / ``float()`` / ``int()`` /
  ``bool()`` / ``np.asarray`` / ``np.array`` on a *strongly tainted*
  value (metadata reads — ``.shape`` / ``.dtype`` / ``.device`` /
  ``.size()`` / ``len()`` — never taint: they are host values) — a sync,
  and under capture an error;
- ``JIT103`` ``torch.cuda.synchronize()`` or ``.synchronize()`` on an
  event or stream anywhere in the package outside the profiling utils
  (``raft_tpu_torch/utils/profiling.py``) — library code must not block
  the host on the device; a wait that a caller needs is suppressed
  inline with its reason;
- ``JIT104`` Python ``if`` / ``while`` / ternary on a strongly tainted
  value (same taint; ``if cfg.small:``, ``x is None`` and shape branches
  stay legal) — a sync, and under capture the branch of the capture
  replays forever.

Taint has two levels, as in the JAX package: a root's tensor parameters
are STRONG; a reached helper's parameters are WEAK (often static tile
sizes) and turn strong only through ``torch.*`` / ``F.*`` ops.  Only
strong taint fires JIT102/JIT104.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Sequence, Set, Tuple

from raft_tpu_torch.analysis.core import PACKAGE, Finding, Workspace

#: Files whose functions can be captured (repo-relative): the
#: counterparts of the JAX package's traced files, the mesh's autograd
#: Functions, and the two files that hand functions to a capture (the
#: evaluation forward, the graph cache itself).
DEFAULT_SCOPE = (
    "raft_tpu_torch/models",
    "raft_tpu_torch/ops",
    "raft_tpu_torch/train/step.py",
    "raft_tpu_torch/train/loss.py",
    "raft_tpu_torch/serve/slots.py",
    "raft_tpu_torch/parallel/mesh.py",
    "raft_tpu_torch/evaluate.py",
    "raft_tpu_torch/utils/graphs.py",
)
EXCLUDE = ("tests/", "raft_tpu_torch/analysis/")

#: Where ``.synchronize()`` is legitimate: the profiling helpers exist
#: to time device work.
SYNC_ALLOWED = ("raft_tpu_torch/utils/profiling.py",)

#: Classes whose instances capture the function passed at this position
#: (or as keyword ``fn``) when called.
_CACHE_CLASSES = {"GraphCache": 1}
#: Constructors that capture the function passed at this position.
_CAPTURE_CTORS = {"CapturedProgram": 0}

#: Attribute reads that stay on the host (never propagate taint).
_STATIC_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda",
                 "requires_grad", "layout", "grad_fn", "is_leaf"}

#: Builtins whose result is a host value even on tensor arguments.
_STATIC_CALLS = {"len", "isinstance", "type", "hasattr", "getattr",
                 "id", "repr", "str", "format", "callable"}

#: Parameter names that are configuration/static by convention in the
#: port: config dataclasses, the mesh and its groups, the autograd
#: context, train/test switches, iteration and tile counts, dtypes and
#: devices.  Branching on these is legal capture-time specialization.
_STATIC_PARAM_NAMES = {
    "self", "cls", "ctx", "cfg", "config", "model_cfg", "serve_cfg",
    "train_cfg", "mesh", "group", "axis_name",
    "train", "training", "test_mode", "freeze_bn", "interpret",
    "iters", "accum", "unroll", "block_q", "block_kv", "radius",
    "npad", "dtype", "out_dtype", "corr_dtype", "device", "dev",
}
_STATIC_ANNOS = {"int", "float", "bool", "str", "bytes", "tuple",
                 "Tuple", "Sequence", "Optional", "Callable",
                 "dtype", "device"}

#: torch calls that return host values even on tensor arguments.
_CONCRETE_CALLS = {"size", "dim", "numel", "element_size", "stride",
                   "is_contiguous", "data_ptr", "get_device",
                   "is_floating_point", "is_complex", "finfo", "iinfo",
                   "is_tensor", "promote_types", "result_type",
                   "can_cast", "ndim", "shape", "is_grad_enabled",
                   "is_inference_mode_enabled", "is_autocast_enabled"}

#: Call roots whose results are device tensors when any argument is
#: tainted at all (the weak→strong upgrade).
_ARRAY_NAMESPACES = {"torch", "F", "nn"}

#: Host reads of a tensor (JIT102).
_HOST_READS = ("item", "tolist", "cpu", "numpy")

_WEAK, _STRONG = 1, 2


def _call_name(func: ast.AST) -> Tuple[Optional[str], List[str]]:
    """``(root_name, attr_chain)`` of a call target: ``np.random.rand``
    -> ``("np", ["random", "rand"])``; bare ``print`` -> ``("print",
    [])``."""
    chain: List[str] = []
    node = func
    while isinstance(node, ast.Attribute):
        chain.insert(0, node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        return node.id, chain
    return None, chain


def _leaf(func: ast.AST) -> Optional[str]:
    root, chain = _call_name(func)
    return chain[-1] if chain else root


class _FuncInfo:
    __slots__ = ("node", "sf", "qualname", "cls", "nested", "parent")

    def __init__(self, node, sf, qualname, cls, parent):
        self.node = node          # FunctionDef, Lambda or With
        self.sf = sf
        self.qualname = qualname
        self.cls = cls            # enclosing class name or None
        self.parent = parent      # enclosing _FuncInfo or None
        self.nested: Dict[str, "_FuncInfo"] = {}

    @property
    def body(self) -> List[ast.AST]:
        if isinstance(self.node, ast.Lambda):
            return [self.node.body]
        return self.node.body


class _ModuleIndex(ast.NodeVisitor):
    """Function/class tables for one module."""

    def __init__(self, sf):
        self.sf = sf
        self.functions: List[_FuncInfo] = []
        self.by_node: Dict[int, _FuncInfo] = {}
        self.toplevel: Dict[str, _FuncInfo] = {}
        self.methods: Dict[str, List[_FuncInfo]] = {}
        self.module_classes: Set[str] = set()    # nn.Module subclasses
        self.function_classes: Set[str] = set()  # autograd Functions
        self._cls_stack: List[str] = []
        self._fn_stack: List[_FuncInfo] = []
        self.visit(sf.tree)

    def visit_ClassDef(self, node):
        bases = []
        for b in node.bases:
            root, chain = _call_name(b)
            bases.append(".".join(filter(None, [root] + chain)))
        if any(b.endswith("Module") or b in self.module_classes
               for b in bases):
            self.module_classes.add(node.name)
        elif any(b.endswith("Function") or b in self.function_classes
                 for b in bases):
            self.function_classes.add(node.name)
        self._cls_stack.append(node.name)
        self.generic_visit(node)
        self._cls_stack.pop()

    def _visit_fn(self, node):
        cls = self._cls_stack[-1] if self._cls_stack else None
        parent = self._fn_stack[-1] if self._fn_stack else None
        prefix = (parent.qualname + "." if parent
                  else (cls + "." if cls else ""))
        info = _FuncInfo(node, self.sf, prefix + node.name, cls, parent)
        self.functions.append(info)
        self.by_node[id(node)] = info
        if parent is not None:
            parent.nested[node.name] = info
        elif cls is not None:
            self.methods.setdefault(node.name, []).append(info)
        else:
            self.toplevel[node.name] = info
        self._fn_stack.append(info)
        self.generic_visit(node)
        self._fn_stack.pop()

    visit_FunctionDef = _visit_fn
    visit_AsyncFunctionDef = _visit_fn

    def enclosing(self) -> Dict[int, Optional[_FuncInfo]]:
        """Every node's innermost enclosing function (None at module
        level)."""
        out: Dict[int, Optional[_FuncInfo]] = {}

        def walk(node, fn):
            for child in ast.iter_child_nodes(node):
                out[id(child)] = fn
                walk(child, self.by_node.get(id(child), fn))

        walk(self.sf.tree, None)
        return out


def _returned_nested(factory: _FuncInfo) -> List[_FuncInfo]:
    """The nested defs a factory returns (``return step_fn``)."""
    out = []
    for ret in ast.walk(factory.node):
        if isinstance(ret, ast.Return) and ret.value is not None:
            for n in ast.walk(ret.value):
                if isinstance(n, ast.Name) and n.id in factory.nested:
                    out.append(factory.nested[n.id])
    return out


def _resolve(name: str, scope: Optional[_FuncInfo],
             idx: _ModuleIndex,
             global_fns: Dict[str, List[_FuncInfo]]) -> List[_FuncInfo]:
    """All functions a bare-name reference could mean: nested defs in
    enclosing scopes, then module level, then the cross-module union."""
    f = scope
    while f is not None:
        if name in f.nested:
            return [f.nested[name]]
        f = f.parent
    if name in idx.toplevel:
        return [idx.toplevel[name]]
    return global_fns.get(name, [])


def _params(node: ast.AST) -> List[str]:
    a = node.args
    return [p.arg for p in a.posonlyargs + a.args]


def _captured_arg(call: ast.Call, index: int,
                  keyword: str) -> Optional[ast.AST]:
    if len(call.args) > index and not any(
            isinstance(a, ast.Starred) for a in call.args[:index + 1]):
        return call.args[index]
    for kw in call.keywords:
        if kw.arg == keyword:
            return kw.value
    return None


def _cache_names(ws: Workspace, package: str,
                 exclude: Sequence[str]) -> Set[str]:
    """Names and attributes bound to a ``GraphCache(...)`` or annotated
    ``GraphCache`` anywhere in the package (``programs``, ``_graphs``)."""
    out: Set[str] = set()
    for sf in ws.glob_py(package, exclude=tuple(exclude)):
        if sf.tree is None:
            continue
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.Assign):
                value, targets = node.value, node.targets
            elif isinstance(node, ast.AnnAssign):
                value, targets = node.value, [node.target]
                if _leaf(node.annotation) in _CACHE_CLASSES:
                    value = None
                    out.update(t.attr if isinstance(t, ast.Attribute)
                               else t.id for t in targets
                               if isinstance(t, (ast.Attribute, ast.Name)))
            else:
                continue
            if value is not None and any(
                    isinstance(n, ast.Call)
                    and _leaf(n.func) in _CACHE_CLASSES
                    for n in ast.walk(value)):
                out.update(t.attr if isinstance(t, ast.Attribute)
                           else t.id for t in targets
                           if isinstance(t, (ast.Attribute, ast.Name)))
    return out


class _TaintChecker(ast.NodeVisitor):
    """Single-function taint pass: captured params flow through
    assignments/ops/torch calls; metadata reads do not.  See the
    ``_WEAK``/``_STRONG`` notes in the module docstring."""

    def __init__(self, info: _FuncInfo, findings: List[Finding],
                 param_levels: Dict[str, int]):
        self.info = info
        self.findings = findings
        self.level: Dict[str, int] = dict(param_levels)

    # -- taint propagation --------------------------------------------

    def _lv(self, node: ast.AST) -> int:
        if node is None:
            return 0
        if isinstance(node, ast.Name):
            return self.level.get(node.id, 0)
        if isinstance(node, ast.Attribute):
            if node.attr in _STATIC_ATTRS:
                return 0
            return self._lv(node.value)
        if isinstance(node, ast.Subscript):
            return self._lv(node.value)
        if isinstance(node, ast.Call):
            root, chain = _call_name(node.func)
            if root in _STATIC_CALLS and not chain:
                return 0
            leaf = chain[-1] if chain else root
            if leaf in _CONCRETE_CALLS:
                return 0
            arg_lv = max(
                [self._lv(a) for a in node.args]
                + [self._lv(kw.value) for kw in node.keywords]
                + [0])
            if root in _ARRAY_NAMESPACES and arg_lv:
                return _STRONG  # a torch op on a captured input
            recv_lv = (self._lv(node.func.value)
                       if isinstance(node.func, ast.Attribute) else 0)
            return max(arg_lv, recv_lv)
        if isinstance(node, ast.BinOp):
            return max(self._lv(node.left), self._lv(node.right))
        if isinstance(node, ast.UnaryOp):
            return self._lv(node.operand)
        if isinstance(node, ast.BoolOp):
            return max(self._lv(v) for v in node.values)
        if isinstance(node, ast.Compare):
            # `x is None` / `x is not None` is host identity on the
            # Python object, never a device-valued branch.
            if all(isinstance(op, (ast.Is, ast.IsNot))
                   for op in node.ops):
                return 0
            return max([self._lv(node.left)]
                       + [self._lv(c) for c in node.comparators])
        if isinstance(node, (ast.Tuple, ast.List)):
            return max([self._lv(e) for e in node.elts] + [0])
        if isinstance(node, ast.IfExp):
            return max(self._lv(node.body), self._lv(node.orelse))
        if isinstance(node, ast.Starred):
            return self._lv(node.value)
        return 0

    def _strong(self, node: ast.AST) -> bool:
        return self._lv(node) >= _STRONG

    def _taint_target(self, tgt: ast.AST, lv: int) -> None:
        if isinstance(tgt, ast.Name):
            if lv > self.level.get(tgt.id, 0):
                self.level[tgt.id] = lv
            elif lv == 0:
                self.level.pop(tgt.id, None)  # rebound to untainted
        elif isinstance(tgt, (ast.Tuple, ast.List)):
            for e in tgt.elts:
                self._taint_target(e, lv)
        elif isinstance(tgt, ast.Starred):
            self._taint_target(tgt.value, lv)

    def visit_Assign(self, node):
        lv = self._lv(node.value)
        for t in node.targets:
            self._taint_target(t, lv)
        self.generic_visit(node)

    def visit_AugAssign(self, node):
        lv = self._lv(node.value)
        if lv:
            self._taint_target(node.target, lv)
        self.generic_visit(node)

    def visit_AnnAssign(self, node):
        if node.value is not None:
            self._taint_target(node.target, self._lv(node.value))
        self.generic_visit(node)

    def visit_For(self, node):
        lv = self._lv(node.iter)
        if lv:
            self._taint_target(node.target, lv)
        self.generic_visit(node)

    def _skip_nested(self, node):
        # Nested defs are separate reachability nodes; don't double-walk.
        return None

    visit_FunctionDef = _skip_nested
    visit_AsyncFunctionDef = _skip_nested
    visit_Lambda = _skip_nested

    # -- findings ------------------------------------------------------

    def _flag(self, rule, node, detail, message):
        self.findings.append(Finding(
            rule=rule, path=self.info.sf.relpath, line=node.lineno,
            detail=f"{self.info.qualname}:{detail}", message=message))

    def visit_Call(self, node):
        root, chain = _call_name(node.func)
        dotted = ".".join(filter(None, [root] + chain))
        qn = self.info.qualname
        # JIT101: host-state calls that run once, at capture.
        if root == "time" and chain:
            self._flag("JIT101", node, dotted,
                       f"host clock call `{dotted}()` inside captured "
                       f"function `{qn}` runs ONCE, at capture (every "
                       "replay reuses its value: a frozen constant, not "
                       "a timing)")
        elif root in ("np", "numpy", "onp") and chain[:1] == ["random"]:
            self._flag("JIT101", node, dotted,
                       f"`{dotted}()` inside captured function `{qn}` "
                       "draws host randomness at capture — every replay "
                       "reuses the same draw; draw on the device from a "
                       "generator registered with the graph")
        elif root == "random" and chain:
            self._flag("JIT101", node, dotted,
                       f"stdlib `{dotted}()` inside captured function "
                       f"`{qn}` is capture-time host randomness")
        elif root == "print" and not chain:
            self._flag("JIT101", node, "print",
                       f"`print` inside captured function `{qn}` fires "
                       "at capture only, never at replay")
        # JIT102: host reads of device tensors.
        if root in ("float", "int", "bool", "complex") and not chain \
                and node.args and self._strong(node.args[0]):
            self._flag("JIT102", node, f"{root}()",
                       f"`{root}()` on a device tensor in `{qn}` reads "
                       "it back to the host: a sync, and an error under "
                       "capture; keep it a tensor (metadata like .shape "
                       "does not need this)")
        if root in ("np", "numpy", "onp") and chain and \
                chain[-1] in ("asarray", "array") and node.args and \
                self._strong(node.args[0]):
            self._flag("JIT102", node, dotted,
                       f"`{dotted}()` on a device tensor in `{qn}` "
                       "copies it to the host mid-capture; use torch")
        if isinstance(node.func, ast.Attribute) and \
                node.func.attr in _HOST_READS and \
                not node.args and self._strong(node.func.value):
            self._flag("JIT102", node, node.func.attr,
                       f"`.{node.func.attr}()` on a device tensor in "
                       f"`{qn}` is a device sync inside the captured "
                       "region (an error under capture)")
        self.generic_visit(node)

    # JIT104: Python control flow on device values.
    def _check_branch(self, node, kind: str):
        test = getattr(node, "test", None)
        if test is not None and self._strong(test):
            names = sorted({n.id for n in ast.walk(test)
                            if isinstance(n, ast.Name)
                            and self.level.get(n.id, 0) >= _STRONG})
            self._flag("JIT104", node, f"{kind}:{','.join(names)}",
                       f"Python `{kind}` on device value(s) "
                       f"{names} in `{self.info.qualname}` — a sync, "
                       "and under capture the branch taken at capture "
                       "replays forever; use torch.where (shape/config "
                       "branches are fine and not flagged)")

    def visit_If(self, node):
        self._check_branch(node, "if")
        self.generic_visit(node)

    def visit_While(self, node):
        self._check_branch(node, "while")
        self.generic_visit(node)

    def visit_IfExp(self, node):
        self._check_branch(node, "ifexp")
        self.generic_visit(node)


def _traced_params(info: _FuncInfo, is_root: bool) -> Dict[str, int]:
    """Parameter taint levels: everything except self/cls/ctx, known
    config names, and scalar/static annotations.  Root functions get
    STRONG params (the capture's tensors); transitively reached helpers
    get WEAK (their params are often static sizes passed down — only
    torch-op results upgrade to STRONG there)."""
    out: Dict[str, int] = {}
    level = _STRONG if is_root else _WEAK
    if isinstance(info.node, ast.With):
        return out
    args = info.node.args
    extra = [a for a in (args.vararg, args.kwarg) if a is not None]
    for a in (args.posonlyargs + args.args + args.kwonlyargs + extra):
        name = a.arg
        if name in _STATIC_PARAM_NAMES or name.endswith("_cfg") \
                or name.endswith("_config"):
            continue
        anno = a.annotation
        if anno is not None:
            root, chain = _call_name(anno)
            label = ".".join(filter(None, [root] + chain))
            if (root in _STATIC_ANNOS or (chain and chain[-1]
                                          in _STATIC_ANNOS)
                    or (label and "Config" in label)):
                continue
        out[name] = level
    return out


def _is_graph_capture(item: ast.withitem) -> bool:
    """``with torch.cuda.graph(...)`` (or ``cuda.graph`` / ``graph``
    imported from ``torch.cuda``)."""
    expr = item.context_expr
    if not isinstance(expr, ast.Call):
        return False
    root, chain = _call_name(expr.func)
    names = [root] + chain
    return names[-1:] == ["graph"] and (len(names) == 1
                                        or "cuda" in names)


def check(ws: Workspace,
          scope: Sequence[str] = DEFAULT_SCOPE,
          sync_scope: Sequence[str] = (PACKAGE,),
          sync_allowed: Sequence[str] = SYNC_ALLOWED,
          exclude: Sequence[str] = EXCLUDE) -> List[Finding]:
    findings: List[Finding] = []
    indexes: List[_ModuleIndex] = []
    for sf in ws.glob_py(*scope, exclude=tuple(exclude)):
        if sf.tree is None:
            findings.append(Finding(
                "LINT000", sf.relpath, 1, "parse-error",
                f"file does not parse: {sf.parse_error}"))
            continue
        indexes.append(_ModuleIndex(sf))

    # Cross-module union index (imported helpers are called by bare
    # name; methods by attribute name).
    global_fns: Dict[str, List[_FuncInfo]] = {}
    for idx in indexes:
        for info in idx.functions:
            global_fns.setdefault(info.node.name, []).append(info)

    def resolve(name, scope_fn, idx) -> List[_FuncInfo]:
        return _resolve(name, scope_fn, idx, global_fns) \
            + bound.get(name, [])

    # Names bound to a factory's returned inner function(s):
    # ``self.encode_admit = make_encode_fn(model)``.
    bound: Dict[str, List[_FuncInfo]] = {}
    enclosing = {idx.sf.relpath: idx.enclosing() for idx in indexes}
    for idx in indexes:
        enc = enclosing[idx.sf.relpath]
        for node in ast.walk(idx.sf.tree):
            if not (isinstance(node, ast.Assign)
                    and isinstance(node.value, ast.Call)):
                continue
            name = _leaf(node.value.func)
            if name is None:
                continue
            inner = [r for f in _resolve(name, enc.get(id(node)), idx,
                                         global_fns)
                     for r in _returned_nested(f)]
            for tgt in node.targets:
                leaf = (tgt.attr if isinstance(tgt, ast.Attribute)
                        else tgt.id if isinstance(tgt, ast.Name)
                        else None)
                if leaf and inner:
                    bound.setdefault(leaf, []).extend(inner)

    # Capture entry points: name -> (positional index, keyword), grown
    # to a fixpoint by functions that forward a parameter into one.
    sinks: Dict[str, Tuple[int, str]] = dict(
        (n, (i, "fn")) for n, i in _CAPTURE_CTORS.items())
    for n in _cache_names(ws, PACKAGE, exclude):
        sinks[n] = (_CACHE_CLASSES["GraphCache"], "fn")

    def sink_arg(call: ast.Call) -> Optional[ast.AST]:
        leaf = _leaf(call.func)
        if leaf not in sinks:
            return None
        return _captured_arg(call, *sinks[leaf])

    changed = True
    while changed:
        changed = False
        for idx in indexes:
            for info in idx.functions:
                name = info.node.name
                if name in sinks:
                    continue
                params = _params(info.node)
                for node in ast.walk(info.node):
                    arg = (sink_arg(node) if isinstance(node, ast.Call)
                           else None)
                    if isinstance(arg, ast.Name) and arg.id in params:
                        i = params.index(arg.id)
                        if info.cls is not None and info.parent is None:
                            i -= 1          # called through the instance
                        sinks[name] = (i, arg.id)
                        changed = True
                        break

    # Roots: captured functions + nn.Module methods + autograd Functions.
    roots: List[_FuncInfo] = []

    def add_func_expr(expr, scope_fn, idx):
        """Resolve a captured function expression to root(s)."""
        if isinstance(expr, ast.Lambda):
            info = _FuncInfo(expr, idx.sf,
                             (scope_fn.qualname + "." if scope_fn else "")
                             + "<lambda>", None, scope_fn)
            roots.append(info)
            for n in ast.walk(expr.body):
                if isinstance(n, ast.Call) and _leaf(n.func):
                    roots.extend(resolve(_leaf(n.func), scope_fn, idx))
        elif isinstance(expr, ast.Name):
            roots.extend(resolve(expr.id, scope_fn, idx))
        elif isinstance(expr, ast.Attribute):
            # self.method / module.fn
            roots.extend(global_fns.get(expr.attr, []))
        elif isinstance(expr, ast.Call):
            # factory: programs(key, make_fn(cfg), args) — the factory's
            # returned inner function(s) are the captured program.
            name = _leaf(expr.func)
            if name is not None:
                for factory in _resolve(name, scope_fn, idx, global_fns):
                    roots.extend(_returned_nested(factory))

    for idx in indexes:
        enc = enclosing[idx.sf.relpath]
        for infos in idx.methods.values():
            for i in infos:
                if i.cls in idx.module_classes and \
                        i.node.name != "__init__":
                    roots.append(i)
                elif i.cls in idx.function_classes and \
                        i.node.name in ("forward", "backward"):
                    roots.append(i)
        for node in ast.walk(idx.sf.tree):
            if isinstance(node, ast.Call):
                arg = sink_arg(node)
                if arg is not None:
                    add_func_expr(arg, enc.get(id(node)), idx)
            elif isinstance(node, ast.With) and any(
                    _is_graph_capture(it) for it in node.items):
                scope_fn = enc.get(id(node))
                info = _FuncInfo(node, idx.sf,
                                 (scope_fn.qualname + "." if scope_fn
                                  else "") + "<graph>", None, scope_fn)
                roots.append(info)
                for stmt in node.body:
                    for n in ast.walk(stmt):
                        if isinstance(n, ast.Call) and _leaf(n.func):
                            roots.extend(resolve(_leaf(n.func), scope_fn,
                                                 idx))

    # Reachability: BFS over call-by-name edges (and nested defs passed
    # as arguments: a checkpointed region runs inside the capture).
    traced: Dict[int, _FuncInfo] = {}
    queue = list(roots)
    idx_by_file = {idx.sf.relpath: idx for idx in indexes}
    while queue:
        info = queue.pop()
        if id(info.node) in traced:
            continue
        traced[id(info.node)] = info
        idx = idx_by_file[info.sf.relpath]
        for node in ast.walk(info.node):
            if not isinstance(node, ast.Call):
                continue
            name = _leaf(node.func)
            callees = resolve(name, info, idx) if name else []
            for a in node.args:
                if isinstance(a, ast.Name):
                    f = info
                    while f is not None and a.id not in f.nested:
                        f = f.parent
                    if f is not None:
                        callees.append(f.nested[a.id])
            queue.extend(c for c in callees if id(c.node) not in traced)

    # Purity pass over every captured function (a With body is walked
    # for its statements only).
    root_ids = {id(r.node) for r in roots}
    for node_id, info in traced.items():
        checker = _TaintChecker(
            info, findings,
            _traced_params(info, is_root=node_id in root_ids))
        for stmt in info.body:
            checker.visit(stmt)

    # JIT103: .synchronize() anywhere in the package outside the
    # profiling allowlist.
    for sf in ws.glob_py(*sync_scope, exclude=tuple(exclude)):
        if sf.relpath in sync_allowed or sf.tree is None:
            continue
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    node.func.attr == "synchronize":
                root, chain = _call_name(node.func)
                dotted = ".".join(filter(None, [root] + chain))
                findings.append(Finding(
                    "JIT103", sf.relpath, node.lineno, "synchronize",
                    f"`{dotted}()` outside "
                    f"{'/'.join(sync_allowed)} — library code "
                    "must not block the host on the device; time with "
                    "the profiling utils or let the caller sync"))
    return findings
