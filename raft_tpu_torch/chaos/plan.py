"""Deterministic, seeded fault plans (the port's copy of
``raft_tpu/chaos/plan.py``, with the faults of the training input side
and the checkpoints).

Spec grammar (``RAFT_CHAOS_SPEC`` / the train CLI's chaos flag)::

    spec  := rule (';' rule)*
    rule  := fault '@' arg (',' arg)*
    arg   := key '=' value

    corrupt_image@step=7,p=0.01;torn_ckpt@step=50

Keys (ANDed within a rule): ``step=N`` (aliases ``batch=N``, ``call=N``)
fires when the caller's step equals N, or, at a seam without a step (the
sample read), when the rule's own check ordinal equals N; ``p=F`` fires
with probability F per check, seeded per rule from the plan's seed;
``times=K`` stops after K fires (default 1 for a ``step`` trigger,
unlimited otherwise); ``heal=M`` with ``step=N`` fires on every check in
``[N, M)``.

=================  ======================  ================================
fault              seam (point)            what happens
=================  ======================  ================================
``corrupt_image``  ``data.sample_read``    ``SampleReadError``
``worker_err``     ``data.loader_worker``  ``InjectedWorkerCrash``
``producer_err``   ``pipeline.producer``   ``InjectedProducerCrash``
``torn_ckpt``      ``ckpt.save``           the step's files torn after
                                           the commit
``restore_err``    ``ckpt.restore``        ``InjectedCheckpointCorruption``
``preempt``        ``train.preempt``       the cooperative preemption flag
                                           (exit 143 at the step boundary)
``stage_kill``     ``curriculum.stage_     ``SystemExit(143)`` before stage
                   boundary``              index N (step context = the
                                           stage index), after the
                                           previous stage's ledger commit
=================  ======================  ================================

The JAX package's other faults belong to parts of the system the port
does not have yet; a spec naming one is refused with the ROADMAP item.
"""

from __future__ import annotations

import dataclasses
import os
import re
import threading
from typing import Dict, List, Optional

import numpy as np

ENV_SPEC = "RAFT_CHAOS_SPEC"
ENV_SEED = "RAFT_CHAOS_SEED"

FAULTS = ("corrupt_image", "worker_err", "producer_err", "torn_ckpt",
          "restore_err", "preempt", "stage_kill")
# Faults of the JAX package whose seams the port does not have yet.
LATER_FAULTS = {
    "device_err": "A7 (serving)", "replica_kill": "A7 (serving)",
    "replica_hang": "A7 (serving)", "replica_slow": "A7 (serving)",
    "net_refuse": "A7 (serving)", "net_slow": "A7 (serving)",
    "net_drop": "A7 (serving)", "net_partition": "A7 (serving)"}

_FAULT_RE = re.compile(r"^[a-z][a-z0-9_]*$")


class ChaosSpecError(ValueError):
    """A malformed spec, raised when it is parsed, never from an
    injection point."""


@dataclasses.dataclass
class Rule:
    """One rule of a spec, with its check and fire counters and its
    generator (the owning plan's lock serializes access)."""

    fault: str
    step: Optional[int] = None
    p: Optional[float] = None
    times: int = 1          # -1 = unlimited
    heal: Optional[int] = None  # fire window [step, heal), then stop
    seen: int = 0
    fired: int = 0
    _rng: Optional[np.random.Generator] = None

    def check(self, ctx_step: Optional[int]) -> bool:
        """Advance the rule by one check; True when it fires.  Counters
        and the generator advance even when the rule is spent, so a plan
        of several rules stays deterministic."""
        ordinal = self.seen
        self.seen += 1
        hit = True
        if self.step is not None:
            ref = ctx_step if ctx_step is not None else ordinal
            hit = (self.step <= ref < self.heal
                   if self.heal is not None else ref == self.step)
        if self.p is not None:
            draw = float(self._rng.random()) if self._rng is not None \
                else 1.0
            hit = hit and draw < self.p
        if hit and self.times >= 0 and self.fired >= self.times:
            return False
        if hit:
            self.fired += 1
        return hit


class FaultPlan:
    """A parsed spec: rules grouped by fault, thread-safe checks, and a
    generator per rule seeded from ``seed`` and the rule's position."""

    def __init__(self, rules: List[Rule], *, seed: int = 0,
                 spec: str = ""):
        self.seed = int(seed)
        self.spec = spec
        self._lock = threading.Lock()
        self._by_fault: Dict[str, List[Rule]] = {}
        for i, rule in enumerate(rules):
            rule._rng = np.random.default_rng(
                np.random.SeedSequence([self.seed, i]))
            self._by_fault.setdefault(rule.fault, []).append(rule)

    @classmethod
    def parse(cls, spec: str, seed: int = 0) -> "FaultPlan":
        rules = []
        for part in (s.strip() for s in spec.split(";")):
            if not part:
                continue
            fault, sep, argstr = part.partition("@")
            fault = fault.strip()
            if not sep or not argstr.strip():
                raise ChaosSpecError(
                    f"rule {part!r}: expected fault@key=value[,...]")
            if not _FAULT_RE.match(fault):
                raise ChaosSpecError(f"bad fault name {fault!r}")
            if fault in LATER_FAULTS:
                raise ChaosSpecError(
                    f"fault {fault!r} has no seam in the port yet "
                    f"(ROADMAP {LATER_FAULTS[fault]}); this slice's "
                    f"faults: {', '.join(FAULTS)}")
            if fault not in FAULTS:
                raise ChaosSpecError(
                    f"unknown fault {fault!r}; known: {', '.join(FAULTS)}")
            kw: dict = {}
            for tok in argstr.split(","):
                key, eq, val = (t.strip() for t in tok.partition("="))
                if not eq:
                    raise ChaosSpecError(
                        f"rule {part!r}: bad arg {tok.strip()!r} "
                        "(expected key=value)")
                try:
                    if key in ("step", "batch", "call"):
                        kw["step"] = int(val)
                    elif key == "p":
                        kw["p"] = float(val)
                    elif key == "times":
                        kw["times"] = int(val)
                    elif key == "heal":
                        kw["heal"] = int(val)
                    else:
                        raise ChaosSpecError(
                            f"rule {part!r}: unknown key {key!r} "
                            "(step/batch/call, p, times, heal)")
                except ValueError as e:
                    if isinstance(e, ChaosSpecError):
                        raise
                    raise ChaosSpecError(
                        f"rule {part!r}: bad value for {key!r}: {val!r}")
            if "step" not in kw and "p" not in kw:
                raise ChaosSpecError(
                    f"rule {part!r}: needs a trigger (step=/batch=/"
                    "call= or p=)")
            p = kw.get("p")
            if p is not None and not 0.0 < p <= 1.0:
                raise ChaosSpecError(f"rule {part!r}: p must be in "
                                     f"(0, 1], got {p}")
            heal = kw.get("heal")
            if heal is not None:
                if "step" not in kw:
                    raise ChaosSpecError(
                        f"rule {part!r}: heal= needs step= (the "
                        "outage window is [step, heal))")
                if heal <= kw["step"]:
                    raise ChaosSpecError(
                        f"rule {part!r}: heal ({heal}) must be > "
                        f"step ({kw['step']})")
            times = kw.get("times",
                           1 if "step" in kw and heal is None else -1)
            if times == 0 or times < -1:
                raise ChaosSpecError(f"rule {part!r}: times must be "
                                     ">= 1 (or -1 = unlimited)")
            rules.append(Rule(fault=fault, step=kw.get("step"), p=p,
                              times=times, heal=heal))
        if not rules:
            raise ChaosSpecError(f"empty chaos spec {spec!r}")
        return cls(rules, seed=seed, spec=spec)

    def fires(self, fault: str, step: Optional[int] = None) -> bool:
        rules = self._by_fault.get(fault)
        if not rules:
            return False
        with self._lock:
            # a list, not any(generator): every rule advances on every
            # check
            return any([r.check(step) for r in rules])


# ---------------------------------------------------------------------------
# the process-wide plan
# ---------------------------------------------------------------------------

_active: Optional[FaultPlan] = None


def install(plan: FaultPlan) -> FaultPlan:
    """Activate ``plan`` process-wide, replacing any previous plan."""
    global _active
    _active = plan
    return plan


def uninstall() -> None:
    global _active
    _active = None


def install_from_env() -> Optional[FaultPlan]:
    """Install a plan from ``RAFT_CHAOS_SPEC`` / ``RAFT_CHAOS_SEED``; None
    when the spec is unset."""
    spec = os.environ.get(ENV_SPEC)
    if not spec:
        return None
    seed = int(os.environ.get(ENV_SEED, "0"))
    plan = install(FaultPlan.parse(spec, seed=seed))
    print(f"chaos: fault plan {spec!r} installed (seed {seed})",
          flush=True)
    return plan


def should_inject(fault: str, step: Optional[int] = None,
                  point: Optional[str] = None) -> bool:
    """Whether ``fault`` fires on this check of the installed plan (always
    False without one).  ``point`` names the seam, for the reader."""
    plan = _active
    if plan is None:
        return False
    return plan.fires(fault, step=step)
