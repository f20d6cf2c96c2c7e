"""Resumable curriculum driver (the port of ``raft_tpu/curriculum.py``):
the paper's four-stage schedule as one preemption-native job.

The reference runs chairs -> things -> sintel -> kitti as four separate
shell invocations chained by ``--restore_ckpt``.  Here the schedule is
data: a :class:`Manifest` of per-stage flag overrides over common base
flags, executed by :func:`run_curriculum` over the port's train CLI
(``raft_tpu_torch.cli.train.run``) with a :class:`StageLedger` on disk
recording each stage's status, so a kill anywhere resumes where it
stopped when the same command runs again:

- a stage marked ``complete`` is skipped;
- a stage marked ``running`` re-enters training, whose own resume
  (the newest restorable step of its run directory) continues it; the
  weights-only ``--restore_ckpt`` seed from the previous stage is still
  passed and the stage's own checkpoint wins;
- stage seeding between stages is weights-only (the train CLI's
  ``--restore_ckpt <run dir>``), so each stage starts its own LR
  schedule.

Chaos seam: the ``stage_kill`` fault (point ``curriculum.stage_boundary``,
step context = stage index) kills the driver between stages, after the
previous stage's ledger commit and before the next stage starts.

Each stage transition emits one ``curriculum_stage`` event (the JAX
package's fields) into the process-wide event sink
(``obs.events.default_sink``: the JSONL stream under
``$RAFT_TELEMETRY_DIR``, a no-op when it is unset).

CLI::

    python -m raft_tpu_torch curriculum --workdir runs/standard \
        [--manifest my.json] [extra train flags for every stage...]
"""

from __future__ import annotations

import dataclasses
import hashlib
import io
import json
import os
import os.path as osp
import sys
import time
from contextlib import redirect_stdout
from typing import Any, Callable, Dict, List, Optional, Sequence

from raft_tpu_torch import chaos

#: Ledger filename inside the curriculum workdir.
LEDGER_FILE = "curriculum_ledger.json"


@dataclasses.dataclass
class StageSpec:
    """One curriculum stage: an experiment ``name`` (the checkpoint
    subdirectory), the dataset ``stage``, and flag ``overrides``: a dict
    of the train CLI's argparse dests applied over the manifest base
    (lists for multi-value flags, bools for store_true flags)."""

    name: str
    stage: str
    overrides: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Manifest:
    """The whole schedule: common ``base`` flags + ordered stages."""

    stages: List[StageSpec]
    base: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @classmethod
    def standard(cls) -> "Manifest":
        """The paper's schedule (reference train_standard.sh:3-6): same
        stages, steps, batches, LRs, crops, decay and gamma."""
        return cls(base={}, stages=[
            StageSpec("raft-chairs", "chairs", {
                "validation": ["chairs"], "num_steps": 100000,
                "batch_size": 10, "lr": 4e-4,
                "image_size": [368, 496], "wdecay": 1e-4}),
            StageSpec("raft-things", "things", {
                "validation": ["sintel"], "num_steps": 100000,
                "batch_size": 6, "lr": 1.25e-4,
                "image_size": [400, 720], "wdecay": 1e-4}),
            StageSpec("raft-sintel", "sintel", {
                "validation": ["sintel"], "num_steps": 100000,
                "batch_size": 6, "lr": 1.25e-4,
                "image_size": [368, 768], "wdecay": 1e-5,
                "gamma": 0.85}),
            StageSpec("raft-kitti", "kitti", {
                "validation": ["kitti"], "num_steps": 50000,
                "batch_size": 6, "lr": 1e-4,
                "image_size": [288, 960], "wdecay": 1e-5,
                "gamma": 0.85}),
        ])

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Manifest":
        stages = [StageSpec(name=s["name"], stage=s["stage"],
                            overrides=dict(s.get("overrides", {})))
                  for s in d["stages"]]
        if not stages:
            raise ValueError("manifest has no stages")
        names = [s.name for s in stages]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate stage names in manifest: {names}")
        return cls(stages=stages, base=dict(d.get("base", {})))

    @classmethod
    def from_json(cls, path: str) -> "Manifest":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def to_dict(self) -> Dict[str, Any]:
        return {"base": dict(self.base),
                "stages": [{"name": s.name, "stage": s.stage,
                            "overrides": dict(s.overrides)}
                           for s in self.stages]}

    def fingerprint(self) -> str:
        """Stable identity of the schedule: a ledger written for one
        manifest refuses to resume a different one (a silently changed
        schedule mid-run would corrupt the stage chain)."""
        blob = json.dumps(self.to_dict(), sort_keys=True,
                          separators=(",", ":"))
        return hashlib.sha256(blob.encode()).hexdigest()[:16]


def argv_from_overrides(overrides: Dict[str, Any]) -> List[str]:
    """Flag-dict -> the train CLI's argv.  Bools are store_true
    flags (emitted only when True), lists/tuples multi-value flags,
    None skipped."""
    argv: List[str] = []
    for key, val in overrides.items():
        flag = f"--{key}"
        if val is None:
            continue
        if isinstance(val, bool):
            if val:
                argv.append(flag)
        elif isinstance(val, (list, tuple)):
            argv.append(flag)
            argv.extend(str(v) for v in val)
        else:
            argv.extend([flag, str(val)])
    return argv


class StageLedger:
    """The on-disk resume record: one JSON file in the workdir, updated
    with an atomic tmp+rename on every transition, so any kill leaves a
    parseable ledger whose per-stage ``status``
    (``pending``/``running``/``complete``) tells the next invocation
    exactly where to pick up (``running`` = re-enter the stage and let
    the train loop's resume find its newest step)."""

    VERSION = 1

    def __init__(self, path: str):
        self.path = path
        self.state: Dict[str, Any] = {}

    def load(self) -> Dict[str, Any]:
        try:
            with open(self.path) as f:
                self.state = json.load(f)
        except FileNotFoundError:
            self.state = {}
        return self.state

    def _write(self) -> None:
        self.state["updated_at"] = time.time()
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.state, f, indent=2, sort_keys=True)
        os.replace(tmp, self.path)

    def begin(self, manifest: Manifest) -> None:
        """Open (or create) the ledger for ``manifest``; refuses a
        ledger written for a different schedule."""
        self.load()
        fp = manifest.fingerprint()
        if self.state:
            have = self.state.get("manifest_fingerprint")
            if have != fp:
                raise ValueError(
                    f"ledger {self.path} belongs to manifest {have}, "
                    f"not {fp}: resuming a CHANGED schedule would "
                    "corrupt the stage chain; use a fresh workdir")
        else:
            self.state = {"version": self.VERSION,
                          "manifest_fingerprint": fp,
                          "status": "running",
                          "stages": {s.name: {"status": "pending",
                                              "runs": 0}
                                     for s in manifest.stages}}
        self.state["status"] = "running"
        self._write()

    def stage(self, name: str) -> Dict[str, Any]:
        return self.state["stages"].setdefault(
            name, {"status": "pending", "runs": 0})

    def update(self, name: str, **fields) -> None:
        self.stage(name).update(fields)
        self._write()

    def finish(self) -> None:
        self.state["status"] = "complete"
        self._write()

    def normalized(self) -> Dict[str, Any]:
        """The kill-point-independent view, what a chaos-killed-then-
        resumed run must reproduce exactly: overall status + per-stage
        {status, final_step} (attempt counts and timestamps legitimately
        differ between an interrupted and an uninterrupted run)."""
        return {
            "status": self.state.get("status"),
            "stages": {
                name: {"status": e.get("status"),
                       "final_step": e.get("final_step")}
                for name, e in self.state.get("stages", {}).items()},
        }


class _Tee(io.TextIOBase):
    """stdout tee: the driver both streams a stage's output and parses
    its ``Validation ...`` lines into the ledger."""

    def __init__(self):
        self.buf = io.StringIO()

    def write(self, s):
        self.buf.write(s)
        sys.__stdout__.write(s)
        return len(s)

    def flush(self):
        sys.__stdout__.flush()


def run_curriculum(manifest: Manifest, workdir: str, *,
                   extra_argv: Sequence[str] = (),
                   train_runner: Optional[Callable] = None
                   ) -> Dict[str, Any]:
    """Execute (or resume) ``manifest`` under ``workdir``; returns the
    final ledger state.

    ``extra_argv``: flags appended to every stage's train argv (after
    base and overrides, so they win): data roots, the device, tuning
    knobs.
    ``train_runner``: ``argv -> TrainState`` (default
    ``raft_tpu_torch.cli.train.run``); tests substitute a stub.
    A :class:`SystemExit` out of a stage (cooperative preemption)
    propagates with the ledger still marking the stage ``running``;
    re-invoking resumes it."""
    from raft_tpu_torch.obs.events import default_sink

    os.makedirs(workdir, exist_ok=True)
    if train_runner is None:
        from raft_tpu_torch.cli import train as train_cli

        train_runner = train_cli.run

    ledger = StageLedger(osp.join(workdir, LEDGER_FILE))
    ledger.begin(manifest)
    ckpt_root = manifest.base.get("ckpt_dir") or osp.join(workdir,
                                                          "checkpoints")
    sink = default_sink()
    prev_ckpt: Optional[str] = None
    for idx, spec in enumerate(manifest.stages):
        stage_ckpt = osp.join(ckpt_root, spec.name)
        entry = ledger.stage(spec.name)
        if entry.get("status") == "complete":
            prev_ckpt = stage_ckpt
            continue
        # the stage_kill fault: a SIGTERM landing between stages, after
        # the previous stage's ledger commit, before this stage starts
        # (step context = stage index)
        if chaos.should_inject("stage_kill", step=idx,
                               point="curriculum.stage_boundary"):
            raise SystemExit(143)

        base = dict(manifest.base)
        base.pop("ckpt_dir", None)  # pinned to ckpt_root below
        argv = (["--name", spec.name, "--stage", spec.stage,
                 "--ckpt_dir", ckpt_root]
                + argv_from_overrides(base)
                + argv_from_overrides(spec.overrides)
                + list(extra_argv))
        if prev_ckpt and "restore_ckpt" not in spec.overrides:
            # weights-only seed from the previous stage; a mid-stage
            # resume still passes it, and the stage's own newest
            # checkpoint (the train loop's resume) wins, as re-running
            # the shell script's line would
            argv += ["--restore_ckpt", prev_ckpt]

        ledger.update(spec.name, status="running", ckpt_dir=stage_ckpt,
                      stage=spec.stage, argv=argv,
                      runs=entry.get("runs", 0) + 1,
                      started_at=time.time())
        sink.emit("curriculum_stage", step=idx, name=spec.name,
                  stage=spec.stage, status="running",
                  attempt=entry.get("runs", 0))
        print(f"=== curriculum stage {idx + 1}/{len(manifest.stages)} "
              f"[{spec.name}]: train {argv}", flush=True)

        tee = _Tee()
        with redirect_stdout(tee):
            state = train_runner(argv)
        val_lines = [ln.strip() for ln in tee.buf.getvalue().splitlines()
                     if ln.startswith("Validation")]

        ledger.update(spec.name, status="complete",
                      final_step=int(state.step),
                      validation=val_lines, completed_at=time.time())
        sink.emit("curriculum_stage", step=idx, name=spec.name,
                  stage=spec.stage, status="complete",
                  final_step=int(state.step))
        prev_ckpt = stage_ckpt
    ledger.finish()
    print(f"curriculum complete: {len(manifest.stages)} stage(s); "
          f"ledger {ledger.path}", flush=True)
    return ledger.state
