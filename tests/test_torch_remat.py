"""Rematerialization (``remat``, ``remat_policy``, ``remat_upsample``) of the
port: every policy against remat off, what autograd keeps under each, and
how often the lookup runs.

On the CPU a recomputed region repeats the same operations on the same
inputs, so loss and every gradient must be bit-equal to remat off.  The
kernel configurations run their plain versions here; the lookups are
counted by wrapping the functions the model calls.  One policy against
JAX's same policy: ``test_torch_small.py::test_small_train_step_matches_
jax[save_corr]`` (JAX's default ``save_corr`` on both sides).
"""

import numpy as np
import pytest
import torch

from raft_tpu_torch.config import RAFTConfig
from raft_tpu_torch.models import raft as raft_mod
from raft_tpu_torch.models import update as update_mod
from raft_tpu_torch.models.raft import RAFT

B, H, W, ITERS = 1, 32, 48, 2
POLICIES = ("full", "dots", "save_corr", "save_corr_upsample")
KERNEL = dict(corr_impl="allpairs_pallas", upsample_loss_kernel="pallas")
FUSED = dict(KERNEL, fused_lookup_encoder=True)
ONDEMAND = dict(corr_impl="pallas", fused_gru=True,
                upsample_loss_kernel="pallas")


@pytest.fixture(autouse=True)
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    img = [torch.from_numpy(rng.uniform(0, 255, (B, H, W, 3)).astype(
        np.float32)) for _ in range(2)]
    gt = torch.from_numpy((3 * rng.standard_normal((B, H, W, 2))).astype(
        np.float32))
    valid = torch.from_numpy((rng.random((B, H, W)) > 0.1).astype(
        np.float32))
    return img, (gt, valid, 400.0)


def _loss_and_grads(cfg, saved=None):
    """Loss (the γ-weighted per-iteration terms) and every parameter's
    gradient of one train-mode forward and backward; ``saved`` collects
    ``(data_ptr, bytes)`` of what autograd keeps."""
    model = RAFT(cfg, seed=3).train()
    (i1, i2), targets = _inputs()
    if saved is None:
        per, _ = model(i1, i2, iters=ITERS, loss_targets=targets)
    else:
        def pack(t):
            saved[t.untyped_storage().data_ptr()] = \
                t.untyped_storage().nbytes()
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            per, _ = model(i1, i2, iters=ITERS, loss_targets=targets)
    loss = torch.sum(0.8 ** torch.arange(ITERS - 1, -1, -1.0) * per)
    loss.backward()
    return loss.detach(), {n: p.grad for n, p in model.named_parameters()}


def _assert_bit_equal(got, want):
    (lg, gg), (lw, gw) = got, want
    assert torch.equal(lg, lw), (float(lg), float(lw))
    assert set(gg) == set(gw)
    for k in gw:     # None on both sides: fnet under a quantized pyramid
        assert (gg[k] is None and gw[k] is None) or torch.equal(gg[k],
                                                                gw[k]), k


@pytest.mark.parametrize("policy,remat_upsample", [
    (p, u) for p in (None, *POLICIES) for u in (False, True)
    if p is not None or u])
def test_policy_matches_no_remat(policy, remat_upsample):
    """The shipped kernel configuration (full model): loss and gradients
    bit-equal with and without recomputation."""
    want = _loss_and_grads(RAFTConfig.full(**KERNEL))
    cfg = RAFTConfig.full(remat=policy is not None,
                          remat_policy=policy or "save_corr",
                          remat_upsample=remat_upsample, **KERNEL)
    _assert_bit_equal(_loss_and_grads(cfg), want)


@pytest.mark.parametrize("model,extra", [
    ("full", FUSED), ("full", ONDEMAND), ("small", KERNEL),
    ("small", dict(FUSED, corr_dtype="int8")), ("small", ONDEMAND)],
    ids=["fused", "ondemand", "small", "small_int8_fused",
         "small_ondemand"])
@pytest.mark.parametrize("policy", ["save_corr", "full"])
def test_policy_matches_no_remat_other_configs(model, extra, policy):
    """The fused lookup + ``convc1`` (its output is what ``save_corr``
    keeps), the on-demand lookup with fused gates, and the small model."""
    mk = RAFTConfig.small_model if model == "small" else RAFTConfig.full
    want = _loss_and_grads(mk(**extra))
    got = _loss_and_grads(mk(remat=True, remat_policy=policy, **extra))
    _assert_bit_equal(got, want)


def test_saved_bytes_order():
    """What autograd keeps (distinct storages seen by a saved-tensor hook
    around the forward; a checkpointed region shows its inputs):
    ``none`` > ``save_corr`` > ``full``, and ``remat_upsample`` keeps
    less than without it."""
    sizes = {}
    for label, kw in (("none", {}),
                      ("save_corr", dict(remat=True)),
                      ("full", dict(remat=True, remat_policy="full")),
                      ("save_corr+up", dict(remat=True,
                                            remat_upsample=True))):
        saved = {}
        _loss_and_grads(RAFTConfig.full(**KERNEL, **kw), saved)
        sizes[label] = sum(saved.values())
    assert sizes["none"] > sizes["save_corr"] > sizes["full"], sizes
    assert sizes["save_corr+up"] < sizes["save_corr"], sizes


def _counting(monkeypatch, module, name):
    calls = []
    fn = getattr(module, name)

    def wrapped(*a, **k):
        calls.append(name)
        return fn(*a, **k)

    monkeypatch.setattr(module, name, wrapped)
    return calls


@pytest.mark.parametrize("extra,module,name", [
    (KERNEL, raft_mod, "pyramid_lookup_nchw"),
    (FUSED, update_mod, "pyramid_lookup_encode"),
    (ONDEMAND, raft_mod, "corr_lookup_ondemand_nchw")],
    ids=["pyramid", "fused", "ondemand"])
def test_lookup_runs_once_under_save_corr_twice_under_full(
        monkeypatch, extra, module, name):
    """The lookup (the plain versions counting here, as the kernels'
    counters do on the card) runs once an iteration under ``save_corr``
    and again in backward under ``full`` and ``dots``."""
    counts = {}
    for policy in (None, "save_corr", "full", "dots"):
        calls = _counting(monkeypatch, module, name)
        _loss_and_grads(RAFTConfig.full(remat=policy is not None,
                                        remat_policy=policy or "save_corr",
                                        **extra))
        counts[policy] = len(calls)
        monkeypatch.undo()
    assert counts == {None: ITERS, "save_corr": ITERS, "full": 2 * ITERS,
                      "dots": 2 * ITERS}


def test_remat_only_when_recording_gradients(monkeypatch):
    """Test mode and ``no_grad`` run no checkpoint at all."""
    calls = _counting(monkeypatch, raft_mod, "_checkpoint")
    model = RAFT(RAFTConfig.full(remat=True, remat_policy="full",
                                 remat_upsample=True)).eval()
    (i1, i2), _ = _inputs()
    with torch.no_grad():
        model(i1, i2, iters=ITERS, test_mode=True)
        model(i1, i2, iters=ITERS)
    assert not calls
    model(i1, i2, iters=ITERS)
    assert len(calls) == ITERS + 1


def test_unknown_policy_raises():
    with pytest.raises(ValueError, match="unknown remat_policy: 'everything'"):
        RAFTConfig.full(remat=True, remat_policy="everything")
