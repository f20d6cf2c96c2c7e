"""raftlint for the port (``raft_tpu_torch/analysis``, ``python -m
raft_tpu_torch lint``) against the JAX package's (``raft_tpu/analysis``):

- parity: on every fixture of ``tests/lint_fixtures/`` and with the
  fixtures' (the JAX package's) scopes, the port's ``locks``,
  ``contracts`` and ``telemetry`` checkers give exactly the JAX
  checkers' ``(rule, path, line, detail)`` set, and the port's
  suppression handling splits the JAX ``jit`` findings as the JAX
  package does;
- the capture family (``jit``): torch fixtures written here, every
  line marked ``# JITxxx`` fires that rule and nothing else fires; the
  clean twin and a host function beside a captured one stay silent;
- the port's own additions: telemetry names forwarded through helpers,
  the README catalog, a documentation scope that starts at a heading,
  the lock scope's discovery;
- the CLI's exit codes and its JSON report, read by the JAX package's
  report loader and regression gate;
- the gate: the port's tree lints clean modulo its baseline.
"""

from __future__ import annotations

import importlib.util
import os
import re
import textwrap

import pytest

from raft_tpu.analysis import contracts as jcontracts
from raft_tpu.analysis import jit_purity as jjit
from raft_tpu.analysis import locks as jlocks
from raft_tpu.analysis import split_findings as jsplit
from raft_tpu.analysis import telemetry as jtelemetry
from raft_tpu.analysis.core import Workspace as JWorkspace
from raft_tpu.analysis.core import load_report as jload_report
from raft_tpu_torch.analysis import (BASELINE_PATH, ROOT_SCRIPTS,
                                     CHECKER_FAMILIES, Workspace,
                                     capture_purity, contracts,
                                     files_scanned, load_baseline, locks,
                                     run_checks, split_findings, telemetry)
from raft_tpu_torch.cli import lint as lint_cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "lint_fixtures")
FIXTURE_DIRS = sorted(d for d in os.listdir(FIXTURES)
                      if os.path.isdir(os.path.join(FIXTURES, d)))


def keys(findings):
    return {(f.rule, f.path, f.line, f.detail) for f in findings}


# ---------------------------------------------------------------------
# parity with the JAX package's checkers on its fixtures
# ---------------------------------------------------------------------

# family -> (JAX check, the port's check with the fixtures' scopes)
PARITY = {
    "locks": (jlocks.check,
              lambda ws: locks.check(ws, scope=jlocks.DEFAULT_SCOPE)),
    "contracts": (
        jcontracts.check,
        lambda ws: contracts.check(
            ws, cli_scope=jcontracts.CLI_SCOPE,
            doc_scope=jcontracts.DOC_SCOPE,
            config_classes=jcontracts.CONFIG_CLASSES,
            tuning_path=jcontracts.TUNING_PATH,
            knob_registries=jcontracts.KNOB_REGISTRIES)),
    "telemetry": (
        jtelemetry.check,
        lambda ws: telemetry.check(
            ws, doc_path=jtelemetry.DOC_PATH, catalogs=(),
            scope=jtelemetry.CODE_SCOPE, exclude=jtelemetry.CODE_EXCLUDE,
            gate_path=jtelemetry.GATE_PATH,
            producer_scope=jtelemetry.PRODUCER_SCOPE)),
}


@pytest.mark.parametrize("fixture", FIXTURE_DIRS)
@pytest.mark.parametrize("family", sorted(PARITY))
def test_fixture_findings_match_jax(family, fixture):
    root = os.path.join(FIXTURES, fixture)
    jax_check, port_check = PARITY[family]
    want = keys(jax_check(JWorkspace(root)))
    got = keys(port_check(Workspace(root)))
    assert got == want
    if fixture == f"{family}_violation":
        assert want
    if fixture == f"{family}_clean":
        assert not got


def test_suppression_splits_as_jax_does():
    """The ``suppressed`` fixture: ``skip-file`` drops a file from the
    port's globs, and the port's pragma handling suppresses what the JAX
    package's does."""
    root = os.path.join(FIXTURES, "suppressed")
    jws, ws = JWorkspace(root), Workspace(root)
    assert ([sf.relpath for sf in ws.glob_py("raft_tpu")]
            == [sf.relpath for sf in jws.glob_py("raft_tpu")]
            == ["raft_tpu/models/net.py"])
    findings = jjit.check(jws)
    assert findings
    want = [list(map(keys, part)) for part in [jsplit(jws, findings, {})]]
    got = [list(map(keys, part)) for part in
           [split_findings(ws, findings, {})]]
    assert got == want
    active, baselined, suppressed = split_findings(ws, findings, {})
    assert active == baselined == []
    assert [f.rule for f in suppressed] == ["JIT101"]


# ---------------------------------------------------------------------
# the capture family on torch fixtures
# ---------------------------------------------------------------------

CAPTURE_VIOLATION = {
    "raft_tpu_torch/models/net.py": '''
        """Fixture: host work inside captured code."""

        import random
        import time

        import numpy as np
        import torch
        from torch import nn


        class Net(nn.Module):
            def __init__(self):
                super().__init__()
                self.seed = np.random.rand()    # construction: legal

            def forward(self, x):
                t0 = time.perf_counter()        # JIT101
                noise = np.random.rand()        # JIT101
                v = float(x)                    # JIT102
                w = x.item()                    # JIT102
                if x > 0:                       # JIT104
                    v = v + noise + t0 + w
                return torch.tanh(x) + v


        class Square(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x):
                ctx.save_for_backward(x)
                return x * x

            @staticmethod
            def backward(ctx, g):
                (x,) = ctx.saved_tensors
                scale = 2.0 if g.sum() > 0 else 1.0   # JIT104
                return g * x * scale
    ''',
    "raft_tpu_torch/serve/slots.py": '''
        """Fixture: functions handed to a graph cache."""

        import random

        import torch

        from raft_tpu_torch.utils.graphs import GraphCache


        def _helper(y, n: int):
            z = torch.relu(y)
            if n > 1:                       # static size: legal
                z = z * n
            print(n)                        # JIT101
            return z.tolist()               # JIT102


        def _inner(y):
            h = _helper(y, 2)
            return y.cpu(), h               # JIT102


        def make_step():
            def step(a):
                return a + random.random()  # JIT101
            return step


        class Programs:
            def __init__(self):
                self._graphs = GraphCache()
                self.step = make_step()

            def run(self, key, fn, args):
                return self._graphs(key, fn, args)

            def body(self, a):
                b = self.step(a)
                return b.numpy()            # JIT102

            def drive(self, x):
                self.run("k", _inner, [x])
                self.run("b", self.body, [x])
                return self._graphs("l", lambda t: _lam(t), [x])


        def _lam(t):
            return bool(t)                  # JIT102
    ''',
    "raft_tpu_torch/utils/graphs.py": '''
        """Fixture: a graph capture's body."""

        import time

        import torch


        def capture(graph, fn, args):
            with torch.cuda.graph(graph):
                out = fn(*args)
                stamp = time.time()         # JIT101
            return out, stamp
    ''',
    "raft_tpu_torch/data/prefetch.py": '''
        """Fixture: host waits on the device (JIT103)."""

        import torch


        def wait(event):
            event.synchronize()             # JIT103
            torch.cuda.synchronize()        # JIT103
    ''',
    "raft_tpu_torch/utils/profiling.py": '''
        """Fixture: the profiling utils may wait."""

        import torch


        def timed(fn):
            torch.cuda.synchronize()
            return fn()
    ''',
}

CAPTURE_CLEAN = {
    "raft_tpu_torch/models/net.py": '''
        """Clean twin: same shapes, no host work in captured code."""

        import torch
        from torch import nn


        class Net(nn.Module):
            def forward(self, x, flow_init=None, *, iters: int = 4):
                if x.ndim == 3:                 # metadata branch
                    x = x[None]
                if flow_init is not None:       # object identity
                    x = x + flow_init
                for _ in range(iters):          # static loop bound
                    x = x + torch.tanh(x)
                if x.shape[0] > 2 and x.size(1) > 1:
                    x = x * 2
                return torch.where(x > 0, x, -x)


        class Square(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x):
                ctx.save_for_backward(x)
                return x * x

            @staticmethod
            def backward(ctx, g):
                (x,) = ctx.saved_tensors
                return g * x * 2.0


        def host_read(x):
            """Beside the captured code and never reached from it."""
            return x.item(), float(x.sum()), x.cpu().numpy()
    ''',
    "raft_tpu_torch/serve/slots.py": '''
        """Clean twin: the host loop reads back between replays."""

        import time

        import torch

        from raft_tpu_torch.utils.graphs import GraphCache


        def _inner(y):
            return torch.relu(y) * 2


        class Programs:
            def __init__(self):
                self._graphs = GraphCache()

            def run(self, key, fn, args):
                return self._graphs(key, fn, args)

            def loop(self, x, iters: int):
                t0 = time.perf_counter()
                for _ in range(iters):
                    status = self.run("k", _inner, [x]).cpu().numpy()
                    if status.any():
                        break
                return status, time.perf_counter() - t0
    ''',
    "raft_tpu_torch/utils/graphs.py": '''
        """Clean twin: a graph capture's body."""

        import torch


        def capture(graph, fn, args):
            with torch.cuda.graph(graph):
                out = fn(*args)
            return out
    ''',
    "raft_tpu_torch/utils/profiling.py": '''
        """The profiling utils may wait."""

        import torch


        def timed(fn):
            torch.cuda.synchronize()
            return fn()
    ''',
}


def _write(root, files):
    marks = set()
    for rel, text in files.items():
        text = textwrap.dedent(text).lstrip("\n")
        path = root / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(text)
        for i, line in enumerate(text.splitlines(), start=1):
            for rule in re.findall(r"# (JIT10[1-4])\b", line):
                marks.add((rule, rel, i))
    return marks


def test_capture_rules_fire_on_their_lines(tmp_path):
    marks = _write(tmp_path, CAPTURE_VIOLATION)
    findings = capture_purity.check(Workspace(str(tmp_path)))
    assert {(f.rule, f.path, f.line) for f in findings} == marks
    assert {r for r, _, _ in marks} == {"JIT101", "JIT102", "JIT103",
                                        "JIT104"}
    # one finding a mark, each detail naming its function
    assert len(findings) == len(marks)
    details = {f.detail for f in findings}
    assert {"Net.forward:time.perf_counter", "Square.backward:ifexp:g",
            "_helper:print", "Programs.body:numpy", "_lam:bool()",
            "make_step.step:random.random", "capture.<graph>:time.time",
            "synchronize"} <= details


def test_capture_clean_twin_and_host_code_are_silent(tmp_path):
    marks = _write(tmp_path, CAPTURE_CLEAN)
    assert not marks
    assert capture_purity.check(Workspace(str(tmp_path))) == []


def test_capture_pragma_suppresses(tmp_path):
    files = dict(CAPTURE_VIOLATION)
    files["raft_tpu_torch/data/prefetch.py"] = files[
        "raft_tpu_torch/data/prefetch.py"].replace(
        "event.synchronize()             # JIT103",
        "event.synchronize()  # raftlint: disable=JIT103")
    marks = _write(tmp_path, files)
    ws = Workspace(str(tmp_path))
    active, _, suppressed = split_findings(
        ws, capture_purity.check(ws), {})
    assert [(f.rule, f.path) for f in suppressed] == [
        ("JIT103", "raft_tpu_torch/data/prefetch.py")]
    assert len(active) == len(marks) == 14


# ---------------------------------------------------------------------
# the port's additions to the telemetry, contracts and lock checkers
# ---------------------------------------------------------------------

PORT_README = '''
    # A repo

    Old flags: `--jax-only-flag`, and `raft_old_total` in a table:

    | metric | type |
    |---|---|
    | `raft_old_total` | counter |

    ## PyTorch / H100 port (`raft_tpu_torch`)

    Run `--lr 1e-4` or `--phantom`.

    | metric | type |
    |---|---|
    | `raft_port_total` | counter |
    | `raft_gone_total` | counter |

    | event | fields |
    |---|---|
    | `port_event` | - |
    | `helper_event` | - |
    | `deep_event` | - |
    | `gone_event` | - |
'''

PORT_OBS = '''
    # Observability

    | event | fields |
    |---|---|
    | `jax_event` | - |
'''

PORT_CODE = '''
    """Emission through helpers."""


    class Engine:
        def _fail(self, reqs, event: str, **fields):
            self._sink.emit(event, n=len(reqs), **fields)

        def _pool_failed(self, pool, event):
            self._fail(pool, event, lanes=1)

        def cycle(self, registry, pool):
            registry.counter("raft_port_total").inc()
            self._sink.emit("port_event")
            self._sink.emit("jax_event")
            self._fail([], "helper_event")
            self._pool_failed(pool, "deep_event")
            self._fail([], event="kw_event")
'''


def test_telemetry_port_catalog_and_forwarded_names(tmp_path):
    """README's port section is a catalog of its own (the table before
    its heading is not), event names passed to helpers that forward them
    to ``emit`` (one and two levels deep, by position or keyword) count as
    emitted, and stale rows name README's own lines."""
    (tmp_path / "docs").mkdir()
    (tmp_path / "docs" / "OBSERVABILITY.md").write_text(
        textwrap.dedent(PORT_OBS))
    readme = textwrap.dedent(PORT_README).lstrip("\n")
    (tmp_path / "README.md").write_text(readme)
    pkg = tmp_path / "raft_tpu_torch" / "serve"
    pkg.mkdir(parents=True)
    code = textwrap.dedent(PORT_CODE).lstrip("\n")
    (pkg / "engine.py").write_text(code)
    kw_line = code.splitlines().index(
        '        self._fail([], event="kw_event")') + 1
    lines = readme.splitlines()
    row = {name: lines.index(next(ln for ln in lines
                                  if ln.startswith(f"| `{name}`"))) + 1
           for name in ("raft_gone_total", "gone_event")}
    got = keys(telemetry.check(Workspace(str(tmp_path))))
    path = "raft_tpu_torch/serve/engine.py"
    assert got == {
        ("TEL302", "README.md", row["raft_gone_total"], "raft_gone_total"),
        ("TEL304", "README.md", row["gone_event"], "gone_event"),
        ("TEL303", path, kw_line, "kw_event"),
    }


def test_contracts_doc_scope_starts_at_the_port_heading(tmp_path):
    readme = textwrap.dedent(PORT_README).lstrip("\n")
    (tmp_path / "README.md").write_text(readme)
    cli = tmp_path / "raft_tpu_torch" / "cli"
    cli.mkdir(parents=True)
    (cli / "train.py").write_text(textwrap.dedent('''
        import argparse


        def main(argv=None):
            p = argparse.ArgumentParser()
            p.add_argument("--lr", type=float)
            return p.parse_args(argv).lr
    '''))
    line = readme.splitlines().index(
        "Run `--lr 1e-4` or `--phantom`.") + 1
    assert keys(contracts.check(Workspace(str(tmp_path)))) == {
        ("CFG402", "README.md", line, "--phantom")}


def test_lock_scope_adds_every_module_that_creates_a_lock():
    scope = locks.default_scope(Workspace(REPO))
    assert set(locks.DEFAULT_SCOPE) <= set(scope)
    assert {"raft_tpu_torch/obs/slo.py", "raft_tpu_torch/chaos/plan.py",
            "raft_tpu_torch/utils/profiling.py"} <= set(scope)
    assert not any(p.startswith("raft_tpu_torch/analysis/")
                   for p in scope)


# ---------------------------------------------------------------------
# the CLI and its report
# ---------------------------------------------------------------------


def _load_gate():
    spec = importlib.util.spec_from_file_location(
        "check_regression",
        os.path.join(REPO, "scripts", "check_regression.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_cli_exit_codes_and_report(tmp_path, capsys, monkeypatch):
    bad, good = tmp_path / "bad", tmp_path / "good"
    n = len(_write(bad, CAPTURE_VIOLATION))
    _write(good, CAPTURE_CLEAN)
    report = str(tmp_path / "report.json")
    assert lint_cli.main(["--root", str(bad), "--only", "jit",
                          "--json", report]) == 1
    captured = capsys.readouterr()
    assert "JIT101" in captured.out and "finding(s)" in captured.err
    loaded, err = jload_report(report)
    assert err is None
    assert loaded["tool"] == "raftlint" and loaded["version"] == 1
    assert loaded["total"] == n == 15
    assert set(loaded["counts_by_rule"]) == {"JIT101", "JIT102", "JIT103",
                                             "JIT104"}
    gate = _load_gate()
    [msg] = gate.lint_gate(report)
    assert f"{n} non-baselined" in msg
    # --root auto-detected from a directory under the root
    monkeypatch.chdir(good / "raft_tpu_torch" / "models")
    assert lint_cli.main(["--only", "jit", "--json", report]) == 0
    loaded, err = jload_report(report)
    assert err is None and loaded["total"] == 0
    assert gate.lint_gate(report) == []
    assert lint_cli.main(["--only", "bogus-family"]) == 2


# ---------------------------------------------------------------------
# the gate: the port lints clean
# ---------------------------------------------------------------------


def test_port_lints_clean_modulo_baseline():
    """Tier-1 enforcement: all four families over the tree.  A new
    finding gets fixed, suppressed inline with its reason, or a justified
    entry in the port's baseline."""
    ws = Workspace(REPO)
    findings, rules_run = run_checks(ws, None)
    baseline = load_baseline(os.path.join(REPO, BASELINE_PATH))
    assert all(baseline.values()), "every baseline entry needs a reason"
    active, _baselined, suppressed = split_findings(ws, findings, baseline)
    assert active == [], (
        "the port has non-baselined lint findings:\n" + "\n".join(
            f"  {f.rule} {f.path}:{f.line}: {f.message}" for f in active))
    assert set(rules_run) == {r for _m, rules in CHECKER_FAMILIES.values()
                              for r in rules}
    # the run read every module of the package and every root script
    want = {os.path.relpath(os.path.join(d, f), REPO)
            for d, _, fs in os.walk(os.path.join(REPO, "raft_tpu_torch"))
            for f in fs if f.endswith(".py")} | set(ROOT_SCRIPTS)
    read = {rel for rel, sf in ws._cache.items() if sf is not None}
    assert want <= read
    assert files_scanned(ws) >= len(want) > 90
    # the three host waits the port needs, each suppressed with a reason
    assert sorted((f.rule, f.path) for f in suppressed) == [
        ("JIT103", "raft_tpu_torch/data/prefetch.py"),
        ("JIT103", "raft_tpu_torch/train/checkpoint.py"),
        ("JIT103", "raft_tpu_torch/train/loop.py")]
