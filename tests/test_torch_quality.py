"""The port's flow-quality proxies (``raft_tpu_torch/obs/quality.py``)
and ``bilinear_sampler`` against the JAX package's on the same seeded
numpy inputs (fp32, 1e-5 relative; census on integer-valued images and
``spearman`` / ``DriftDetector`` exact), the monitor's bookkeeping, and
the serving engine's quality knobs on the CPU (twins of
tests/test_quality.py's engine cases).
"""

import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.obs import quality as jq
from raft_tpu.obs.registry import MetricRegistry as JaxRegistry
from raft_tpu.ops.sampler import bilinear_sampler as jax_sampler
from raft_tpu_torch.config import RAFTConfig
from raft_tpu_torch.models.raft import RAFT
from raft_tpu_torch.obs import MetricRegistry
from raft_tpu_torch.obs import quality as q
from raft_tpu_torch.ops.sampler import bilinear_sampler
from raft_tpu_torch.serve import InferenceEngine, ServeConfig

CFG = RAFTConfig.small_model()
ITERS = 2
SHAPE = (36, 52)                # -> bucket (40, 56)
RTOL = 1e-5


class _RecordingSink:
    def __init__(self):
        self.events = []

    def emit(self, event, step=None, **fields):
        self.events.append((event, fields))

    def of(self, event):
        return [f for e, f in self.events if e == event]


def _wait_for(pred, timeout_s, what):
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        if pred():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


def _smooth(rng, h, w, pad, k=5):
    base = rng.uniform(0.0, 255.0, (h + 2 * pad, w + 2 * pad, 3))
    kern = np.ones(k) / k
    for ax in (0, 1):
        base = np.apply_along_axis(
            lambda v: np.convolve(v, kern, mode="same"), ax, base)
    base -= base.min()
    return base * (255.0 / max(base.max(), 1e-6))


def _shifted_pair(rng, shift=2, pad=12):
    h, w = SHAPE
    base = _smooth(rng, h, w, pad)
    im1 = base[pad:pad + h, pad:pad + w]
    im2 = base[pad:pad + h, pad - shift:pad - shift + w]
    return im1.astype(np.float32), im2.astype(np.float32)


def _batch(seed, b=2, integer=False):
    rng = np.random.default_rng(seed)
    h, w = SHAPE
    im = rng.uniform(0, 255, (2, b, h, w, 3))
    if integer:
        im = np.round(im)
    flow = (rng.standard_normal((b, h, w, 2)) * 6).astype(np.float32)
    flow[0, :3] = 500.0                      # rows out of frame
    return im[0].astype(np.float32), im[1].astype(np.float32), flow


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(got, want, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=atol)


# ---------------------------------------------------------------------------
# the sampler and the proxy math against JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("channels", [1, 3])
def test_bilinear_sampler_matches_jax(channels):
    """Zero padding and the strict in-bounds mask; coordinates cover the
    inside, the borders, far outside and exact integers."""
    rng = np.random.default_rng(channels)
    img = rng.standard_normal((2, 9, 13, channels)).astype(np.float32)
    coords = rng.uniform(-3, 16, (2, 7, 5, 2)).astype(np.float32)
    coords[0, 0] = [[0, 0], [12, 8], [-1, 4], [13, 9], [6, 3]]
    out, inb = bilinear_sampler(_t(img), _t(coords), mask=True)
    jout, jinb = jax_sampler(jnp.asarray(img), jnp.asarray(coords),
                             mask=True)
    _close(out, jout, atol=1e-6)
    np.testing.assert_array_equal(inb.numpy(), np.asarray(jinb))
    _close(bilinear_sampler(_t(img), _t(coords)), jout, atol=1e-6)


def test_charbonnier_and_census_match_jax():
    """Charbonnier to 1e-5; the census descriptor of integer-valued
    images exact."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 17)).astype(np.float32)
    _close(q.charbonnier(_t(x)), jq.charbonnier(jnp.asarray(x)))
    gray = np.round(rng.uniform(0, 255, (2, 11, 14))).astype(np.float32)
    for radius in (1, 2):
        np.testing.assert_array_equal(
            q.census_transform(_t(gray), radius).numpy(),
            np.asarray(jq.census_transform(jnp.asarray(gray), radius)))


@pytest.mark.parametrize("census", [False, True])
def test_photometric_error_matches_jax(census):
    im1, im2, flow = _batch(1, integer=census)
    err, valid = q.photometric_error(_t(im1), _t(im2), _t(flow), census)
    jerr, jvalid = jq.photometric_error(jnp.asarray(im1), jnp.asarray(im2),
                                        jnp.asarray(flow), census)
    _close(err, jerr)
    _close(valid, jvalid)
    _close(q.canary_score(err, valid), jq.canary_score(jerr, jvalid))


def test_cycle_error_matches_jax():
    _, _, fw = _batch(2)
    bw = -fw + np.random.default_rng(3).standard_normal(fw.shape).astype(
        np.float32)
    err, occ = q.cycle_error(_t(fw), _t(bw))
    jerr, jocc = jq.cycle_error(jnp.asarray(fw), jnp.asarray(bw))
    _close(err, jerr)
    _close(occ, jocc)


def test_score_pair_matches_jax_and_ranks_flow():
    rng = np.random.default_rng(7)
    im1, im2 = _shifted_pair(rng, shift=2)
    for fx in (2.0, 0.0, -2.0, 500.0):
        flow = np.zeros(SHAPE + (2,), np.float32)
        flow[..., 0] = fx
        got, want = q.score_pair(im1, im2, flow), jq.score_pair(im1, im2,
                                                                flow)
        assert set(got) == set(want)
        for k in got:
            _close(got[k], want[k])
    good = q.score_pair(im1, im2, np.full(SHAPE + (2,), 0, np.float32))
    assert good["valid_frac"] > 0.85


def test_spearman_identical():
    rng = np.random.default_rng(4)
    cases = [([1, 2, 3], [10, 20, 30]), ([1, 2, 2, 3], [1, 2, 3, 4]),
             ([1.0, 1.0, 1.0], [1, 2, 3]), ([2.0], [3.0]),
             (rng.standard_normal(40), rng.standard_normal(40)),
             (np.round(rng.uniform(0, 5, 30)), rng.uniform(0, 1, 30))]
    for a, b in cases:
        assert q.spearman(a, b) == jq.spearman(a, b)
    with pytest.raises(ValueError):
        q.spearman([1, 2], [1, 2, 3])


def test_drift_detector_identical_to_jax():
    """The same observation stream through both detectors: the same
    scores, states and events, observation by observation."""
    rng = np.random.default_rng(0)
    stream = ([float(rng.normal(0.5, 0.1)) for _ in range(72)]
              + [float(rng.normal(5.0, 0.1)) for _ in range(32)]
              + [float(rng.normal(0.5, 0.1)) for _ in range(12)])
    sinks = (_RecordingSink(), _RecordingSink())
    ours = q.DriftDetector("photometric", reference=32, window=8, bins=4,
                           threshold=1.0, registry=MetricRegistry(),
                           sink=sinks[0])
    theirs = jq.DriftDetector("photometric", reference=32, window=8,
                              bins=4, threshold=1.0,
                              registry=JaxRegistry(), sink=sinks[1])
    for v in stream:
        assert ours.observe(v) == theirs.observe(v)
        assert ours.state() == theirs.state()
    assert sinks[0].events == sinks[1].events
    assert ours.state()["events"] == 4
    for kw in ({"reference": 4, "bins": 8}, {"window": 1},
               {"threshold": 0.0}):
        with pytest.raises(ValueError):
            q.DriftDetector("p", **kw)


def test_monitor_matches_jax_on_one_sequence():
    """Both monitors fed the same retirements (scored, residual-only, a
    cycle): the same sampling, events and snapshot, scores to 1e-5."""
    rng = np.random.default_rng(7)
    im1, im2 = _shifted_pair(rng)
    flow = np.zeros(SHAPE + (2,), np.float32)
    flow[..., 0] = 2.0
    mons, sinks = [], []
    for mod, reg in ((q, MetricRegistry()), (jq, JaxRegistry())):
        sinks.append(_RecordingSink())
        mons.append(mod.QualityMonitor(registry=reg, sink=sinks[-1],
                                       sample_rate=0.5, seed=3,
                                       drift_reference=8, drift_window=4))
    futs = [object() for _ in range(6)]
    for m in mons:
        for i, f in enumerate(futs[:4]):
            m.note_retirement(future=f, image1=im1, image2=im2,
                              flow=flow * (1 + 0.1 * i), bucket="40x56",
                              residual=0.1 * i - 0.05, converged=i % 2 == 0,
                              iters=2)
        m.begin_cycle(futs[4], flow, "40x56")
        assert m.note_retirement(future=futs[4], image1=im2, image2=im1,
                                 flow=-flow, bucket="40x56") is None
    ours, theirs = (m.snapshot() for m in mons)
    assert ours["scored_total"] == theirs["scored_total"]
    assert ours["drift"] == theirs["drift"]
    for proxy in q.QualityMonitor.PROXIES:
        assert ours[proxy]["count_total"] == theirs[proxy]["count_total"]
        for k in ("p50", "p95", "mean"):
            _close(ours[proxy][k], theirs[proxy][k], atol=1e-5)
    assert [e for e, _ in sinks[0].events] == [e for e, _ in sinks[1].events]
    with pytest.raises(ValueError):
        q.QualityMonitor(sample_rate=1.5)


# ---------------------------------------------------------------------------
# the serving engine's quality knobs (twins of tests/test_quality.py)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def state_dict():
    return RAFT(CFG, seed=0).state_dict()


def test_engine_slot_sampled_scoring(state_dict):
    """Slot mode at sample rate 1 with cycle scoring: every retirement is
    scored (residual + photometric), each scored request's backward pass
    folds into the cycle histogram, and ``stats()["quality"]`` carries
    it; the quality SLO observes each scored retirement."""
    torch.set_num_threads(1)
    rng = np.random.default_rng(4)
    sink = _RecordingSink()
    eng = InferenceEngine(state_dict, CFG, ServeConfig(
        iters=ITERS, batching="slot", slots=2, max_wait_ms=5,
        quality_sample_rate=1.0, quality_cycle=True,
        slo_quality_bound=10.0), sink=sink, device="cpu")
    n = 4
    with eng:
        futs = [eng.submit(*_shifted_pair(rng)) for _ in range(n)]
        for f in futs:
            assert f.result(timeout=60).shape == SHAPE + (2,)
        _wait_for(lambda: eng.stats()["quality"]["cycle"]["window_count"]
                  >= n, 30, "the cycle passes")
        stats = eng.stats()
    qs = stats["quality"]
    assert qs["enabled"] and qs["sample_rate"] == 1.0 and qs["cycle"]
    assert qs["scored_total"] == n
    for proxy in ("photometric", "residual", "cycle"):
        assert qs[proxy]["window_count"] == n
        assert qs[proxy]["p95"] >= qs[proxy]["p50"] >= 0.0
    assert qs["drift"]["photometric"]["observed"] == n
    assert not qs["drift"]["photometric"]["reference_frozen"]
    assert eng.quality_drift()["residual"]["observed"] == n
    scored = [f for f in sink.of("quality_score") if "photometric" in f]
    cycles = [f for f in sink.of("quality_score")
              if f.get("proxy") == "cycle"]
    assert len(scored) == n and len(cycles) == n
    for f in scored:
        assert f["bucket"] == "40x56" and f["residual"] >= 0.0
        assert "canary" in f and "valid_frac" in f
    assert stats["slo"]["quality"]["good"] == n


def test_engine_rate_zero_is_zero_overhead(state_dict):
    """The default: no monitor, no quality telemetry, no SLO tracker."""
    rng = np.random.default_rng(4)
    sink = _RecordingSink()
    eng = InferenceEngine(state_dict, CFG, ServeConfig(
        iters=ITERS, batching="slot", slots=2, max_wait_ms=5), sink=sink,
        device="cpu")
    with eng:
        assert eng.infer(*_shifted_pair(rng), timeout=60).shape == \
            SHAPE + (2,)
        assert eng._quality is None and eng.quality_drift() is None
        stats = eng.stats()
    assert stats["quality"] == {"enabled": False}
    assert stats["slo"] == {"enabled": False}
    assert sink.of("quality_score") == [] and sink.of("quality_drift") == []


def test_serve_config_quality_validation():
    for kw in (dict(quality_sample_rate=1.5), dict(quality_sample_rate=-0.1),
               dict(quality_sample_rate=0.5, quality_drift_window=1),
               dict(quality_sample_rate=0.5, quality_drift_threshold=0.0)):
        with pytest.raises(ValueError):
            ServeConfig(**kw)


# ---------------------------------------------------------------------------
# calibration against ground truth (twin of tests/test_quality.py's)
# ---------------------------------------------------------------------------


def test_quality_proxies_match_jax(monkeypatch):
    """``evaluate_quality_proxies`` of both packages on the same seeded
    weights and the same difficulty-graded labeled fixture (the JAX
    test's): the same per-proxy Spearman rank correlation with the true
    EPE (the photometric one >= 0.6, the JAX test's bar; the residual's
    rank depends on the weights, and is the same in both packages), the
    same sample count, and the EPE and proxy means within 1e-3 relative
    (the two forwards' fp32 reordering through 4 iterations)."""
    from raft_tpu import evaluate as jev
    from raft_tpu.config import RAFTConfig as JaxRAFTConfig
    from raft_tpu_torch import evaluate as tev

    from test_quality import _GradedDataset
    from test_torch_fixtures import small_raft_variables

    torch.set_num_threads(1)
    monkeypatch.setenv("RAFT_TUNING", "0")
    variables, sd = small_raft_variables(0)
    for mod in (jev, tev):
        monkeypatch.setitem(mod.EARLY_EXIT_DATASETS, "chairs",
                            lambda **kw: _GradedDataset())
    kw = dict(dataset="chairs", iters=4, batch_size=4, bucket=False,
              cycle=True)
    want = jev.evaluate_quality_proxies(variables,
                                        JaxRAFTConfig.small_model(), **kw)
    got = tev.evaluate_quality_proxies(sd, CFG, device="cpu", **kw)
    assert got["n"] == want["n"] == 8 and got["dataset"] == "chairs"
    assert got["spearman"] == want["spearman"]
    assert got["spearman"]["photometric"] >= 0.6
    np.testing.assert_allclose(got["epe_mean"], want["epe_mean"],
                               rtol=1e-3)
    assert set(got["proxy_means"]) == {"photometric", "residual", "cycle"}
    for k, v in want["proxy_means"].items():
        np.testing.assert_allclose(got["proxy_means"][k], v, rtol=1e-3,
                                   atol=1e-5, err_msg=k)
    with pytest.raises(ValueError):
        tev.evaluate_quality_proxies(sd, CFG, dataset="nope", device="cpu")
