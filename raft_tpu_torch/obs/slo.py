"""SLO specs, rolling error budgets, and multi-burn-rate alerting (the
port's copy of ``raft_tpu/obs/slo.py``).

An :class:`SLOSpec` is data: a name, an objective (the good-fraction
target, e.g. 0.99), and a burn policy — the Google-SRE multi-window
multi-burn-rate recipe.  Every SLO the stack tracks reduces to a stream
of good/bad observations fed host-side into an :class:`SLOTracker`:

- **availability**: one observation per request — bad on terminal error;
- **latency**: one observation per request — bad when wall latency
  exceeds the target (so the objective is "p99 under target" stated as
  "99% of requests under target");
- **quality**: one observation per sampled retirement — bad when the
  composite proxy score breaches its calibrated bound (obs/quality.py);
- **train goodput**: one observation per step — bad when the step was
  non-finite (or its samples quarantined);
- **MFU floor**: one observation per measured step or iteration — bad
  below the floor; the training telemetry's (``obs/train.py``, from
  ``RAFT_SLO_MFU_FLOOR``) and the serving engine's
  (``ServeConfig.slo_mfu_floor``), each only on a card whose peak
  ``obs/cost.py`` knows.

Burn rate is ``bad_frac(window) / error_budget`` where
``error_budget = 1 - objective``: rate 1.0 spends the budget exactly
over the window; 14.4 spends a 30-day budget in ~2 days.  A
:class:`BurnWindow` pairs a long and a short window with a threshold —
the alert fires only when BOTH exceed it (the short window gates reset
lag: once the failure stops, the short window clears and the alert
stops re-firing).  The classic policy is ``(1h, 5m) @ 14.4x -> page``
and ``(6h, 30m) @ 6x -> ticket``; windows are plain seconds so tests
and the incident smoke drill can run the same math at seconds scale.
A window pair is only evaluated once its long window holds
``min_events`` observations — with a 1% budget a single failed request
would otherwise read as a 100x burn and page on the spot.

Everything here is host floats and deque arithmetic — no device work,
no syncs.  Detection piggybacks on
:meth:`SLOTracker.record` (throttled to ``check_interval_s``) so burns
fire without a dedicated poller thread; gauges refresh through the
registry's collect hook at scrape time.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from raft_tpu_torch.obs.events import EventSink
from raft_tpu_torch.obs.registry import MetricRegistry

# An observation older than every window is dead weight; cap the ring
# anyway so a window misconfigured to hours on a hot serve path cannot
# grow without bound (at 64k the math still covers ~minutes of a
# saturated engine, and SLO windows that need more belong in a TSDB).
_MAX_OBSERVATIONS = 65536


@dataclasses.dataclass(frozen=True)
class BurnWindow:
    """One (long, short) window pair with its burn-rate threshold."""

    long_s: float
    short_s: float
    threshold: float          # burn-rate multiple that trips the alert
    severity: str = "page"    # "page" | "ticket"

    def __post_init__(self):
        if self.long_s <= 0 or self.short_s <= 0:
            raise ValueError("burn windows must be positive")
        if self.short_s > self.long_s:
            raise ValueError(
                f"short window {self.short_s}s exceeds long {self.long_s}s")
        if self.threshold <= 0:
            raise ValueError("burn threshold must be positive")
        if self.severity not in ("page", "ticket"):
            raise ValueError(f"severity {self.severity!r} "
                             "(expected page|ticket)")


#: The Google-SRE starting policy, hour-scale (production serve runs).
DEFAULT_POLICY: Tuple[BurnWindow, ...] = (
    BurnWindow(3600.0, 300.0, 14.4, "page"),
    BurnWindow(21600.0, 1800.0, 6.0, "ticket"),
)


def scaled_policy(scale_s: float) -> Tuple[BurnWindow, ...]:
    """The default policy with its 1h long window rescaled to
    ``scale_s`` seconds (window ratios and thresholds preserved) — the
    smoke drill and tests run the identical math at seconds scale."""
    k = float(scale_s) / 3600.0
    return tuple(BurnWindow(w.long_s * k, w.short_s * k, w.threshold,
                            w.severity) for w in DEFAULT_POLICY)


@dataclasses.dataclass(frozen=True)
class SLOSpec:
    """One service-level objective as data."""

    name: str
    objective: float                      # target good fraction (0, 1)
    description: str = ""
    windows: Tuple[BurnWindow, ...] = DEFAULT_POLICY

    def __post_init__(self):
        if not 0.0 < self.objective < 1.0:
            raise ValueError(
                f"SLO {self.name!r}: objective must be in (0, 1), got "
                f"{self.objective} (1.0 leaves a zero error budget)")
        if not self.windows:
            raise ValueError(f"SLO {self.name!r}: needs >= 1 burn window")

    @property
    def budget(self) -> float:
        """The error budget: the tolerated bad fraction."""
        return 1.0 - self.objective


class _SLOState:
    """Per-spec rolling observation ring + alert cooldown state."""

    def __init__(self, spec: SLOSpec):
        self.spec = spec
        self.max_window_s = max(w.long_s for w in spec.windows)
        # (t_mono, ok) pairs, pruned by age on every append.
        self.obs: deque = deque(maxlen=_MAX_OBSERVATIONS)
        self.good = 0
        self.bad = 0
        # Last fire time per window index (alert cooldown).
        self.last_fired: Dict[int, float] = {}
        self.burns = 0

    def prune(self, now: float) -> None:
        horizon = now - self.max_window_s
        obs = self.obs
        while obs and obs[0][0] < horizon:
            obs.popleft()

    def counts(self, window_s: float, now: float) -> Tuple[int, int]:
        """``(total, bad)`` over the trailing window."""
        horizon = now - window_s
        total = bad = 0
        for t, ok in reversed(self.obs):
            if t < horizon:
                break
            total += 1
            if not ok:
                bad += 1
        return total, bad

    def bad_frac(self, window_s: float, now: float) -> Optional[float]:
        """Bad fraction over the trailing window; None with no data."""
        total, bad = self.counts(window_s, now)
        if total == 0:
            return None
        return bad / total


class SLOTracker:
    """Rolling good/bad accounting + multi-window burn-rate alerts.

    ``record(name, ok)`` is the single feed point; detection runs
    inline (throttled) and emits ``slo_burn`` events; gauges
    ``raft_slo_burn_rate{slo}`` / ``raft_slo_budget_remaining{slo}``
    refresh via the registry collect hook.  ``clock`` is injectable so
    tests drive window edges deterministically."""

    def __init__(self, specs: Sequence[SLOSpec], *,
                 registry: Optional[MetricRegistry] = None,
                 sink: Optional[EventSink] = None,
                 check_interval_s: float = 1.0,
                 cooldown_s: Optional[float] = None,
                 min_events: int = 10,
                 clock: Callable[[], float] = time.monotonic):
        self._clock = clock
        self._sink = sink
        self._lock = threading.Lock()
        self._check_interval_s = max(float(check_interval_s), 0.0)
        # Minimum observations in the LONG window before its pair is
        # evaluated: with a 1% budget, the very first failed request
        # would otherwise read as a 100x burn and page instantly.
        self._min_events = max(int(min_events), 1)
        # Re-fire cooldown per (slo, window): default = the window's
        # short span (a still-burning SLO re-pages once per short
        # window, not once per request).
        self._cooldown_s = cooldown_s
        self._last_check: Optional[float] = None  # set on first record
        self._states: Dict[str, _SLOState] = {}
        for spec in specs:
            if spec.name in self._states:
                raise ValueError(f"duplicate SLO name {spec.name!r}")
            self._states[spec.name] = _SLOState(spec)
        self.registry = registry
        self._burn_gauge = None
        if registry is not None:
            self._burn_gauge = registry.gauge(
                "raft_slo_burn_rate",
                "worst-window error-budget burn rate per SLO "
                "(1.0 = spending the budget exactly)")
            self._budget_gauge = registry.gauge(
                "raft_slo_budget_remaining",
                "error budget remaining over the SLO's longest window "
                "(1.0 = untouched, 0.0 = exhausted)")
            self._burns_total = registry.counter(
                "raft_slo_burns_total",
                "slo_burn alerts fired (multi-window threshold crossed)")
            registry.add_collect_hook(self._collect)

    @property
    def specs(self) -> List[SLOSpec]:
        return [s.spec for s in self._states.values()]

    # -- feed ----------------------------------------------------------

    def record(self, name: str, ok: bool, n: int = 1) -> None:
        """Add ``n`` observations of one outcome to SLO ``name``
        (unknown names are ignored so feed points don't need to know
        which SLOs were configured)."""
        state = self._states.get(name)
        if state is None:
            return
        now = self._clock()
        with self._lock:
            for _ in range(max(int(n), 1)):
                state.obs.append((now, bool(ok)))
            if ok:
                state.good += n
            else:
                state.bad += n
            state.prune(now)
            if self._last_check is None:  # first record arms the timer
                self._last_check = now
                due = False
            else:
                due = now - self._last_check >= self._check_interval_s
                if due:
                    self._last_check = now
        if due:
            self.check(now)

    # -- detection -----------------------------------------------------

    def check(self, now: Optional[float] = None) -> List[dict]:
        """Run multi-window burn detection across every SLO; emit one
        ``slo_burn`` per newly tripped (slo, window) and return the
        fired alert records (tests assert on them directly)."""
        now = self._clock() if now is None else now
        fired: List[dict] = []
        with self._lock:
            for state in self._states.values():
                state.prune(now)
                spec = state.spec
                for i, w in enumerate(spec.windows):
                    long_n, long_bad = state.counts(w.long_s, now)
                    short_n, short_bad = state.counts(w.short_s, now)
                    if long_n < self._min_events or short_n == 0:
                        continue
                    long_rate = (long_bad / long_n) / spec.budget
                    short_rate = (short_bad / short_n) / spec.budget
                    if long_rate < w.threshold or short_rate < w.threshold:
                        continue
                    cooldown = (self._cooldown_s if self._cooldown_s
                                is not None else w.short_s)
                    last = state.last_fired.get(i)
                    if last is not None and now - last < cooldown:
                        continue
                    state.last_fired[i] = now
                    state.burns += 1
                    fired.append({
                        "slo": spec.name,
                        "severity": w.severity,
                        "burn_rate": round(long_rate, 4),
                        "short_burn_rate": round(short_rate, 4),
                        "threshold": w.threshold,
                        "long_window_s": w.long_s,
                        "short_window_s": w.short_s,
                        "objective": spec.objective,
                        "budget_remaining": round(
                            self._budget_remaining_locked(state, now), 4),
                    })
        for rec in fired:
            if self._burn_gauge is not None:
                self._burns_total.inc(slo=rec["slo"],
                                      severity=rec["severity"])
            if self._sink is not None:
                self._sink.emit("slo_burn", **rec)
        return fired

    # -- readout -------------------------------------------------------

    def _budget_remaining_locked(self, state: _SLOState,
                                 now: float) -> float:
        frac = state.bad_frac(state.max_window_s, now)
        if frac is None:
            return 1.0
        return max(0.0, 1.0 - frac / state.spec.budget)

    def _worst_rate_locked(self, state: _SLOState,
                           now: float) -> float:
        worst = 0.0
        for w in state.spec.windows:
            frac = state.bad_frac(w.long_s, now)
            if frac is not None:
                worst = max(worst, frac / state.spec.budget)
        return worst

    def _collect(self, _reg) -> None:
        """Registry collect hook: refresh the per-SLO gauges at scrape
        time (so /metrics and stats() see live numbers without a
        background thread)."""
        now = self._clock()
        with self._lock:
            for name, state in self._states.items():
                self._burn_gauge.set(
                    round(self._worst_rate_locked(state, now), 6),
                    slo=name)
                self._budget_gauge.set(
                    round(self._budget_remaining_locked(state, now), 6),
                    slo=name)

    def snapshot(self) -> dict:
        """Per-SLO state for ``stats()``: objective, observation
        counts, worst burn rate, budget remaining, burns fired."""
        now = self._clock()
        out = {}
        with self._lock:
            for name, state in self._states.items():
                state.prune(now)
                out[name] = {
                    "objective": state.spec.objective,
                    "good": state.good,
                    "bad": state.bad,
                    "burn_rate": round(
                        self._worst_rate_locked(state, now), 4),
                    "budget_remaining": round(
                        self._budget_remaining_locked(state, now), 4),
                    "burns": state.burns,
                }
        return out
