"""Flow-quality observability: label-free quality proxies, sampled
production scoring, and PSI-style drift detection (the port of
``raft_tpu/obs/quality.py``).

The stack observes latency, health, and cost — this module observes
whether the flow fields being served are any *good*, without labels.
Optical flow admits strong unsupervised quality proxies (the classic
occlusion/uncertainty signals of the unsupervised-flow literature —
UnFlow/ARFlow lineage), and RAFT's iterative structure contributes a
third for free:

- ``photometric`` — occlusion-masked photometric warp error: bilinear-
  warp image2 by the predicted flow and measure the charbonnier (or
  census) residual against image1, averaged over in-bounds pixels.
  Low for flow that actually explains the frame pair.
- ``cycle`` — forward-backward cycle consistency: warp the backward
  flow by the forward flow; ``fw + bw∘fw`` is ~0 wherever the flow is
  coherent and non-occluded.
- ``residual`` — the early-exit convergence residual ``delta_max``
  (max per-lane flow-update magnitude) the slot programs already
  compute (serve/slots.py); read at lane retirement with the lanes'
  status, so it costs nothing extra on the device.

The proxy math is plain PyTorch reduced to per-pair scalars, on
whatever device its tensors live on; :func:`score_pair` (the serving
engine's monitor and the fleet's canary) scores one host pair on the
CPU, off the device worker, so sampling never queues work on the card.
The host-side pieces (:class:`QualityMonitor`, :class:`DriftDetector`)
mirror the scalars through the registry and the event sink:
``raft_quality_*`` histograms and gauges, ``quality_score`` events, and
``quality_drift`` events when the rolling window's distribution walks
away from the reference quantiles (PSI score over quantile buckets).

The serving integration is ``serve/engine.py``
(``ServeConfig.quality_sample_rate``), the golden-batch rolling-update
gate ``serve/fleet.py`` (``FleetConfig.canary_proxy_budget``).
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from raft_tpu_torch.obs.events import EventSink
from raft_tpu_torch.obs.registry import MetricRegistry
from raft_tpu_torch.ops.sampler import bilinear_sampler, coords_grid

# ---------------------------------------------------------------------------
# proxy math (plain PyTorch, batched)
# ---------------------------------------------------------------------------


def charbonnier(x: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    """Smooth L1: ``sqrt(x^2 + eps^2)`` (the standard robust
    photometric penalty — quadratic near 0, linear in the tails)."""
    return torch.sqrt(x * x + eps * eps)


def census_transform(gray: torch.Tensor, radius: int = 1) -> torch.Tensor:
    """Soft census descriptor: per-pixel differences against the
    ``(2r+1)^2 - 1`` neighborhood, squashed to (-1, 1).

    Census is the illumination-robust variant of the photometric
    residual (ARFlow/DDFlow practice): comparing descriptors instead of
    intensities survives brightness/exposure shifts between frames.
    ``gray`` is ``(B, H, W)``; returns ``(B, H, W, K)``."""
    offsets = [(dy, dx)
               for dy in range(-radius, radius + 1)
               for dx in range(-radius, radius + 1)
               if (dy, dx) != (0, 0)]
    padded = F.pad(gray[:, None], (radius, radius, radius, radius),
                   mode="replicate")[:, 0]
    H, W = gray.shape[1], gray.shape[2]
    feats = []
    for dy, dx in offsets:
        shifted = padded[:, radius + dy:radius + dy + H,
                         radius + dx:radius + dx + W]
        diff = shifted - gray
        feats.append(diff / _sqrt(0.81 + diff * diff))
    return torch.stack(feats, dim=-1)


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """A correctly rounded square root: PyTorch's vectorized fp32 ``sqrt``
    on the CPU is off by one ulp on some inputs, so fp32 goes through
    fp64 (whose square root, rounded to fp32, is the exact one)."""
    if x.dtype == torch.float32:
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x)


def _to_unit(img: torch.Tensor) -> torch.Tensor:
    """Images arrive in [0, 255] float (the serve/eval contract);
    normalize so proxy scales are resolution- and exposure-comparable
    across deployments."""
    return img.to(torch.float32) * (1.0 / 255.0)


def photometric_error(image1: torch.Tensor, image2: torch.Tensor,
                      flow: torch.Tensor, census: bool = False):
    """Occlusion-masked photometric warp error, per pair.

    Warps ``image2`` backward by ``flow`` (so warped(x) = image2(x +
    flow(x))) and measures the charbonnier residual against ``image1``
    over in-bounds pixels only — pixels the flow maps outside the frame
    carry no photometric evidence (the classic out-of-bounds /
    occlusion guard).

    Args:
      image1, image2: ``(B, H, W, 3)`` in [0, 255].
      flow: ``(B, H, W, 2)`` pixel displacements, last axis (x, y).
      census: compare soft census descriptors instead of intensities
        (illumination-robust).

    Returns:
      ``(err (B,), valid_frac (B,))`` — masked mean residual and the
      in-bounds fraction.  A degenerate flow that maps *everything*
      out of bounds has ``err = 0`` with ``valid_frac = 0``; combine
      with :func:`canary_score` when one scalar must stay monotone in
      badness.
    """
    B, H, W = image1.shape[0], image1.shape[1], image1.shape[2]
    im1 = _to_unit(image1)
    im2 = _to_unit(image2)
    coords = coords_grid(B, H, W, device=flow.device) + flow
    warped, inb = bilinear_sampler(im2, coords, mask=True)
    if census:
        c1 = census_transform(torch.mean(im1, dim=-1))
        cw = census_transform(torch.mean(warped, dim=-1))
        res = torch.mean(charbonnier(cw - c1), dim=-1)
    else:
        res = torch.mean(charbonnier(warped - im1), dim=-1)
    inb_sum = torch.sum(inb, dim=(1, 2))
    err = torch.sum(res * inb, dim=(1, 2)) / torch.clamp(inb_sum, min=1.0)
    valid_frac = inb_sum / float(H * W)
    return err, valid_frac


def cycle_error(flow_fw: torch.Tensor, flow_bw: torch.Tensor):
    """Forward-backward cycle-consistency error, per pair.

    Samples the backward flow at the forward flow's target locations;
    ``fw(x) + bw(x + fw(x))`` is ~0 wherever the two passes agree
    (non-occluded, coherent motion).  Returns ``(err (B,),
    occluded_frac (B,))``: the masked mean cycle distance (pixels) and
    the fraction of pixels failing the classic occlusion test
    ``|fw + bw∘fw|^2 > 0.01 (|fw|^2 + |bw∘fw|^2) + 0.5`` (UnFlow)."""
    B, H, W = flow_fw.shape[0], flow_fw.shape[1], flow_fw.shape[2]
    coords = coords_grid(B, H, W, device=flow_fw.device) + flow_fw
    bw_w, inb = bilinear_sampler(flow_bw, coords, mask=True)
    diff_sq = torch.sum(torch.square(flow_fw + bw_w), dim=-1)
    mag_sq = (torch.sum(torch.square(flow_fw), dim=-1)
              + torch.sum(torch.square(bw_w), dim=-1))
    occ = (diff_sq > 0.01 * mag_sq + 0.5).to(torch.float32) * inb
    inb_sum = torch.clamp(torch.sum(inb, dim=(1, 2)), min=1.0)
    err = torch.sum(torch.sqrt(diff_sq) * inb, dim=(1, 2)) / inb_sum
    occluded_frac = torch.sum(occ, dim=(1, 2)) / inb_sum
    return err, occluded_frac


def canary_score(err, valid_frac):
    """One scalar monotone in badness: masked photometric error plus
    the out-of-bounds fraction.  The second term matters: weights
    degraded enough to throw every pixel out of frame would otherwise
    score a perfect masked error of 0/0."""
    return err + (1.0 - valid_frac)


def _host(x) -> torch.Tensor:
    """One unbatched host array as a batch-of-one fp32 CPU tensor."""
    return torch.from_numpy(np.ascontiguousarray(x, np.float32))[None]


def score_pair(image1, image2, flow, census: bool = False
               ) -> Dict[str, float]:
    """Host convenience: score ONE unbatched ``(H, W, 3)`` pair /
    ``(H, W, 2)`` flow on the CPU; returns python floats
    ``{photometric, valid_frac, canary}``."""
    with torch.no_grad():
        err, valid = photometric_error(_host(image1), _host(image2),
                                       _host(flow), census)
    err_f, valid_f = float(err[0]), float(valid[0])
    return {"photometric": err_f, "valid_frac": valid_f,
            "canary": err_f + (1.0 - valid_f)}


# ---------------------------------------------------------------------------
# calibration statistic
# ---------------------------------------------------------------------------


def _average_ranks(a: np.ndarray) -> np.ndarray:
    """Fractional ranks with ties averaged (what Spearman needs; no
    scipy dependency on this path)."""
    a = np.asarray(a, np.float64)
    order = np.argsort(a, kind="stable")
    ranks = np.empty(a.size, np.float64)
    ranks[order] = np.arange(1, a.size + 1, dtype=np.float64)
    _, inv, counts = np.unique(a, return_inverse=True,
                               return_counts=True)
    sums = np.zeros(counts.size, np.float64)
    np.add.at(sums, inv, ranks)
    return sums[inv] / counts[inv]


def spearman(a, b) -> float:
    """Spearman rank correlation (tie-aware), in [-1, 1]; 0.0 when
    either input is constant (no ranking to correlate)."""
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    if a.size != b.size:
        raise ValueError(f"length mismatch: {a.size} vs {b.size}")
    if a.size < 2:
        return 0.0
    ra = _average_ranks(a) - (a.size + 1) / 2.0
    rb = _average_ranks(b) - (b.size + 1) / 2.0
    denom = float(np.sqrt((ra * ra).sum() * (rb * rb).sum()))
    if denom == 0.0:
        return 0.0
    return float((ra * rb).sum() / denom)


# ---------------------------------------------------------------------------
# drift detection
# ---------------------------------------------------------------------------


class DriftDetector:
    """Windowed distribution-shift detector over one proxy's stream.

    The first ``reference`` observations freeze a set of quantile
    bucket edges (each bucket holds mass ``1/bins`` of the reference
    by construction).  After that, every observation lands in a
    rolling window of the last ``window`` values, and once the window
    is full each observation re-scores it with the Population
    Stability Index over those buckets::

        PSI = sum_i (p_i - q_i) * ln(p_i / q_i)

    with ``q_i = 1/bins`` (reference mass) and ``p_i`` the
    (epsilon-smoothed) window fraction.  PSI ~0 when the serving
    distribution still looks like the reference; it grows without
    bound as mass concentrates in buckets the reference rarely
    visited.  A score above ``threshold`` emits a ``quality_drift``
    event (edge-triggered, re-emitted at most once per ``window``
    observations while the drift persists) and bumps
    ``raft_quality_drift_total``; the current score is always live in
    the ``raft_quality_drift_score`` gauge.

    Sizing ``threshold``: under NO drift the smoothed PSI fluctuates
    around ``(bins - 1) / window`` (the chi-square/2n scale), so the
    threshold must sit a few multiples above that — the 0.5 default
    fits the default ``window=64, bins=8`` (null ~0.11); a tiny drill
    window like 8 needs ~1.0.

    Thread-safe; event emission happens outside the lock."""

    def __init__(self, proxy: str, *, reference: int = 256,
                 window: int = 64, bins: int = 8,
                 threshold: float = 0.5,
                 registry: Optional[MetricRegistry] = None,
                 sink: Optional[EventSink] = None):
        if reference < bins:
            raise ValueError(
                f"reference ({reference}) must be >= bins ({bins})")
        if window < 2:
            raise ValueError(f"window must be >= 2, got {window}")
        if threshold <= 0:
            raise ValueError(f"threshold must be > 0, got {threshold}")
        self.proxy = proxy
        self.reference = int(reference)
        self.window = int(window)
        self.bins = int(bins)
        self.threshold = float(threshold)
        self._lock = threading.Lock()
        self._ref: list = []
        self._edges: Optional[np.ndarray] = None
        self._cur: deque = deque(maxlen=self.window)
        self._score = 0.0
        self._events = 0
        self._observed = 0
        self._drifted = False
        self._since_fire = 0
        reg = registry or MetricRegistry()
        self._score_gauge = reg.gauge(
            "raft_quality_drift_score",
            "PSI drift score of the rolling proxy window vs the "
            "reference quantiles, by proxy")
        self._drift_counter = reg.counter(
            "raft_quality_drift_total",
            "quality_drift events fired (PSI above threshold), "
            "by proxy")
        self._sink = sink

    def _psi_locked(self) -> float:
        cur = np.fromiter(self._cur, np.float64)
        counts = np.zeros(self.bins, np.float64)
        idx = np.digitize(cur, self._edges)
        np.add.at(counts, idx, 1.0)
        p = (counts + 0.5) / (cur.size + 0.5 * self.bins)
        q = 1.0 / self.bins
        return float(np.sum((p - q) * np.log(p / q)))

    def observe(self, value: float) -> Optional[float]:
        """Feed one proxy observation; returns the current PSI score
        once the reference is frozen and the window is full, else
        ``None``."""
        fired = False
        with self._lock:
            v = float(value)
            self._observed += 1
            if self._edges is None:
                self._ref.append(v)
                if len(self._ref) >= self.reference:
                    qs = np.linspace(0.0, 1.0, self.bins + 1)[1:-1]
                    self._edges = np.quantile(
                        np.asarray(self._ref, np.float64), qs)
                return None
            self._cur.append(v)
            if len(self._cur) < self.window:
                return None
            score = self._psi_locked()
            self._score = score
            if score > self.threshold:
                self._since_fire += 1
                if not self._drifted or self._since_fire >= self.window:
                    fired = True
                    self._drifted = True
                    self._since_fire = 0
                    self._events += 1
            else:
                self._drifted = False
                self._since_fire = 0
        self._score_gauge.set(round(score, 4), proxy=self.proxy)
        if fired:
            self._drift_counter.inc(proxy=self.proxy)
            if self._sink is not None:
                self._sink.emit("quality_drift", proxy=self.proxy,
                                score=round(score, 4),
                                threshold=self.threshold,
                                window=self.window,
                                reference_n=self.reference)
        return score

    def state(self) -> dict:
        """JSON-able snapshot (fleet supervisor / ``/v1/stats``)."""
        with self._lock:
            return {"proxy": self.proxy,
                    "score": round(self._score, 4),
                    "drifted": self._drifted,
                    "events": self._events,
                    "observed": self._observed,
                    "reference_n": (self.reference
                                    if self._edges is not None
                                    else len(self._ref)),
                    "reference_frozen": self._edges is not None,
                    "window_n": len(self._cur),
                    "threshold": self.threshold}


# ---------------------------------------------------------------------------
# production scoring (the serve-engine vehicle)
# ---------------------------------------------------------------------------


class QualityMonitor:
    """Host-side sampled quality scoring for the serve retirement path.

    The engine calls :meth:`note_retirement` once per retired request
    (the engine's host thread).  Every retirement records the free
    convergence ``residual``; a seeded coin at ``sample_rate`` decides
    whether to additionally compute the photometric proxy (on the CPU,
    over the request's own images — off the device, costs nothing when
    unsampled).  Scored requests emit one ``quality_score`` event and
    return the scores as attributes (the JAX package hangs them on the
    request's trace span; the port's serving path opens no spans yet,
    ROADMAP A8b′).

    Cycle scoring (``cycle=True``) rides the same machinery: a scored
    request enqueues a second inference on the swapped frame pair; when
    THAT retires, :meth:`note_retirement` recognizes its future and
    folds the forward/backward pair into ``raft_quality_cycle``
    instead of scoring it as fresh traffic.

    All figures land in the engine registry (``raft_quality_*``), so
    ``/v1/stats["quality"]`` and ``GET /metrics`` read the same
    numbers.  Thread-safe: retirements happen on the engine's host
    thread while :meth:`snapshot` serves HTTP threads."""

    PROXIES = ("photometric", "residual", "cycle")

    def __init__(self, *, registry: Optional[MetricRegistry] = None,
                 sink: Optional[EventSink] = None,
                 sample_rate: float = 1.0, seed: int = 0,
                 cycle: bool = False, census: bool = False,
                 drift_reference: int = 256, drift_window: int = 64,
                 drift_threshold: float = 0.5, drift_bins: int = 8,
                 reservoir: int = 1024):
        if not 0.0 <= sample_rate <= 1.0:
            raise ValueError(
                f"sample_rate must be in [0, 1], got {sample_rate}")
        self.registry = registry or MetricRegistry()
        self._sink = sink
        self.sample_rate = float(sample_rate)
        self.cycle = bool(cycle)
        self.census = bool(census)
        # Seeded: drills and tests replay the exact sampling pattern.
        self._rng = np.random.default_rng(seed)
        self._lock = threading.Lock()
        self._scored = self.registry.counter(
            "raft_quality_scored_total",
            "requests scored with the photometric proxy (sampled)")
        self._hists = {
            "photometric": self.registry.histogram(
                "raft_quality_photometric",
                "occlusion-masked photometric warp error of sampled "
                "served requests", reservoir=reservoir),
            "residual": self.registry.histogram(
                "raft_quality_residual",
                "early-exit convergence residual (delta_max) at lane "
                "retirement", reservoir=reservoir),
            "cycle": self.registry.histogram(
                "raft_quality_cycle",
                "forward-backward cycle-consistency error of sampled "
                "served requests (pixels)", reservoir=reservoir),
        }
        self._bucket_gauge = self.registry.gauge(
            "raft_quality_bucket_mean",
            "running mean proxy score, by proxy and bucket")
        self._bucket_stats: Dict[tuple, list] = {}
        self.drift = {
            "photometric": DriftDetector(
                "photometric", reference=drift_reference,
                window=drift_window, threshold=drift_threshold,
                bins=drift_bins, registry=self.registry, sink=sink),
            "residual": DriftDetector(
                "residual", reference=drift_reference,
                window=drift_window, threshold=drift_threshold,
                bins=drift_bins, registry=self.registry, sink=sink),
        }
        # In-flight cycle passes: backward-request future ->
        # (forward flow, bucket).  Bounded: a dropped backward pass
        # (engine stopping, backpressure) must not leak entries.
        self._pending_cycle: Dict[int, tuple] = {}
        self._cycle_order: deque = deque()

    # -- proxy recording ------------------------------------------------

    def _note_bucket(self, proxy: str, bucket: Optional[str],
                     value: float) -> None:
        if bucket is None:
            return
        with self._lock:
            st = self._bucket_stats.setdefault((proxy, bucket),
                                               [0, 0.0])
            st[0] += 1
            st[1] += value
            mean = st[1] / st[0]
        self._bucket_gauge.set(round(mean, 5), proxy=proxy,
                               bucket=bucket)

    def record_residual(self, residual: float,
                        bucket: Optional[str] = None) -> None:
        """Record the free convergence residual for one retirement.
        ``delta_max`` is -1 when the lane never ran an iteration —
        skip those (no signal)."""
        v = float(residual)
        if v < 0:
            return
        self._hists["residual"].observe(v)
        self._note_bucket("residual", bucket, v)
        self.drift["residual"].observe(v)

    def sample(self) -> bool:
        """Seeded coin at ``sample_rate`` (the engine's host thread)."""
        if self.sample_rate <= 0.0:
            return False
        if self.sample_rate >= 1.0:
            return True
        return float(self._rng.random()) < self.sample_rate

    def score(self, image1, image2, flow, *,
              bucket: Optional[str] = None,
              residual: Optional[float] = None,
              converged: Optional[bool] = None,
              iters: Optional[int] = None) -> Dict[str, float]:
        """Photometric-score one retired request (already sampled).
        Records histograms/gauges, feeds the drift detector, emits one
        ``quality_score`` event, and returns trace-span attrs."""
        s = score_pair(image1, image2, flow, census=self.census)
        self._scored.inc()
        self._hists["photometric"].observe(s["photometric"])
        self._note_bucket("photometric", bucket, s["photometric"])
        self.drift["photometric"].observe(s["photometric"])
        fields = {"photometric": round(s["photometric"], 5),
                  "valid_frac": round(s["valid_frac"], 4),
                  "canary": round(s["canary"], 5)}
        if residual is not None and residual >= 0:
            fields["residual"] = round(float(residual), 5)
        if converged is not None:
            fields["converged"] = bool(converged)
        if iters is not None:
            fields["iters"] = int(iters)
        if self._sink is not None:
            self._sink.emit("quality_score", bucket=bucket, **fields)
        attrs = {"quality_photometric": fields["photometric"],
                 "quality_valid_frac": fields["valid_frac"]}
        if "residual" in fields:
            attrs["quality_residual"] = fields["residual"]
        return attrs

    # -- cycle bookkeeping ----------------------------------------------

    def begin_cycle(self, future, flow_fw: np.ndarray,
                    bucket: Optional[str], limit: int = 64) -> None:
        """Register a submitted backward pass; its retirement closes
        the loop in :meth:`note_retirement`."""
        with self._lock:
            while len(self._cycle_order) >= limit:
                stale = self._cycle_order.popleft()
                self._pending_cycle.pop(stale, None)
            self._pending_cycle[id(future)] = (flow_fw, bucket)
            self._cycle_order.append(id(future))

    def _take_cycle(self, future) -> Optional[tuple]:
        with self._lock:
            entry = self._pending_cycle.pop(id(future), None)
            if entry is not None:
                try:
                    self._cycle_order.remove(id(future))
                except ValueError:
                    pass
            return entry

    def finish_cycle(self, flow_fw: np.ndarray, flow_bw: np.ndarray,
                     bucket: Optional[str]) -> None:
        with torch.no_grad():
            err, occ = cycle_error(_host(flow_fw), _host(flow_bw))
        err_f, occ_f = float(err[0]), float(occ[0])
        self._hists["cycle"].observe(err_f)
        self._note_bucket("cycle", bucket, err_f)
        if self._sink is not None:
            self._sink.emit("quality_score", bucket=bucket,
                            proxy="cycle", cycle=round(err_f, 5),
                            occluded_frac=round(occ_f, 4))

    # -- the engine hook -------------------------------------------------

    def note_retirement(self, *, future, image1, image2, flow,
                        bucket: Optional[str] = None,
                        residual: float = -1.0,
                        converged: Optional[bool] = None,
                        iters: Optional[int] = None
                        ) -> Optional[Dict[str, float]]:
        """One retired request.  Returns trace-span attrs when the
        request was sampled and scored, else ``None``.  A retirement
        recognized as a pending cycle backward pass closes the cycle
        measurement and is NOT scored as fresh traffic."""
        pending = self._take_cycle(future)
        if pending is not None:
            flow_fw, fwd_bucket = pending
            try:
                self.finish_cycle(flow_fw, flow, fwd_bucket)
            except Exception:
                pass  # cycle scoring must never fail a retirement
            return None
        self.record_residual(residual, bucket=bucket)
        if not self.sample():
            return None
        return self.score(image1, image2, flow, bucket=bucket,
                          residual=residual, converged=converged,
                          iters=iters)

    # -- introspection ---------------------------------------------------

    def _percentiles(self, name: str) -> dict:
        count, _total, window = self._hists[name].collect()
        if not window:
            return {"count_total": int(count), "window_count": 0,
                    "p50": 0.0, "p95": 0.0, "mean": 0.0}
        vals = np.asarray(window, np.float64)
        p50, p95 = np.percentile(vals, [50, 95])
        return {"count_total": int(count),
                "window_count": int(vals.size),
                "p50": round(float(p50), 5),
                "p95": round(float(p95), 5),
                "mean": round(float(vals.mean()), 5)}

    def drift_snapshot(self) -> Dict[str, dict]:
        return {name: det.state() for name, det in self.drift.items()}

    def snapshot(self) -> dict:
        """``/v1/stats["quality"]``: sampling config, per-proxy
        percentile summaries, and drift-detector state."""
        out = {"enabled": True,
               "sample_rate": self.sample_rate,
               "cycle": self.cycle,
               "scored_total": int(self._scored.value()),
               "drift": self.drift_snapshot()}
        for name in self.PROXIES:
            out[name] = self._percentiles(name)
        return out
