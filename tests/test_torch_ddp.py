"""The port's data-parallel training on the CPU: 2 gloo ranks against the
JAX package's ``data``-sharded step and against the port's straight run.

One spawn of ``tests/_torch_ddp_child.py`` as 2 ranks (free ports, torch
only) serves every check but the last, and runs the straight reference
steps and the train CLI too; it starts before the JAX step compiles
here.  The full model at 32x48, 2 iterations, 2 pairs a rank, fp32, from
the seeded weights of ``test_torch_fixtures``:

1. two split chairs steps (batch norm trained on the global batch)
   against JAX's ``make_train_step(..., mesh=make_mesh(num_data=2))``
   on the same global batches;
2. the same against the port's straight steps on the global batch, and
   ``accum_steps=2`` (ranks bit-identical; batch norm couples within a
   microbatch there, so no straight twin); with channel dropout, the
   straight step on the global batch in the data-parallel row order;
3. ranks bit-identical, also after a NaN batch on rank 1 only: both skip
   the update and both count it;
4. a chaos ``preempt`` on rank 1 only: both ranks exit 143 after the same
   step, rank 0's checkpoint holds it, and the resumed 2-rank run equals
   the uninterrupted one bit for bit;
5. the 2-rank checkpoint restored on 1 rank: the loader continues the
   same global sample stream, the topology stamp and ``verify-ckpt``
   report world 2, and the finished run is within the bounds of 2;
6. the train CLI with ``--distributed --device cpu --validation chairs``
   at world 2 (rank 0 validates while rank 1 waits at the barrier).

Tolerances.  Loss and metrics: split against straight (2, 5) rtol 1e-5;
against JAX (1; the encoder's folded layout adds a few 1e-5 relative,
``test_torch_train.py``) rtol 1e-4 at the first step, 1e-3 at the second.
Batch-norm statistics: 1e-6 against straight after steps from the same
parameters (2), 1e-5 against JAX, 1e-5 plus 1e-4 relative after steps
from parameters that already differed in their last bits (5).
Parameters are held by what the step did to them, per parameter by norm
(``_torch_ddp_child.leaf_agreement``), with the straight run's twin on
the reversed rows as the noise floor: the global gradient, read from
Adam's first moment after the first step, within ``GRAD_TOL`` (rtol,
floor on the global norm); and the change of each parameter after each
step within ``CHANGE_TOL``.  Each case also shows that twice the change
and no change fail the bound.
"""

import json
import os
import shutil
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from raft_tpu.config import RAFTConfig as JaxRAFTConfig
from raft_tpu.config import TrainConfig as JaxTrainConfig
from raft_tpu.models.raft import RAFT as JaxRAFT
from raft_tpu.parallel import make_mesh as jax_make_mesh
from raft_tpu.parallel import replicated_sharding, shard_batch
from raft_tpu.train import optim as joptim
from raft_tpu.train.state import TrainState as JaxTrainState
from raft_tpu.train.step import make_train_step as jax_make_train_step
from raft_tpu_torch.config import RAFTConfig, TrainConfig
from raft_tpu_torch.convert import state_dict_from_flax
from raft_tpu_torch.data import frame_utils
from raft_tpu_torch.data.datasets import ShardedLoader
from raft_tpu_torch.models.raft import RAFT
from raft_tpu_torch.train import loop
from raft_tpu_torch.train.checkpoint import CheckpointManager
from raft_tpu_torch.train.step import init_state, make_train_step

import _torch_ddp_child as child
from test_torch_fixtures import full_raft_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
CHILD_TIMEOUT_S = 300
# (rtol, floor) of ``child.leaf_agreement``, per reference
GRAD_TOL = {"straight": (1e-5, 1e-6), "jax": (2e-3, 5e-4)}
CHANGE_TOL = {"straight": (1e-3, 1e-3), "jax": (0.15, 2e-3)}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread here, as each rank has: the test runner runs
    several workers at once, and 8 threads a worker on the same cores
    spend most of their time waiting on each other."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _env(**extra):
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    env.pop("RAFT_CHAOS_SPEC", None)
    env.update({k: str(v) for k, v in extra.items()})
    return env


def _chairs_tree(root, n=8, hw=(64, 96)):
    rng = np.random.default_rng(0)
    data = os.path.join(root, "datasets", "FlyingChairs_release", "data")
    os.makedirs(data)
    for i in range(n):
        for s in (1, 2):
            Image.fromarray(rng.integers(0, 255, size=(*hw, 3),
                                         dtype=np.uint8)).save(
                os.path.join(data, f"{i:05d}_img{s}.ppm"), format="PPM")
        frame_utils.write_flo(os.path.join(data, f"{i:05d}_flow.flo"),
                              rng.normal(size=(*hw, 2)).astype(np.float32))
    with open(os.path.join(root, "chairs_split.txt"), "w") as f:
        f.write("1\n" * (n - 1) + "2\n")


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """The 2-rank spawn, started (with the chairs tree of its CLI run)."""
    root = str(tmp_path_factory.mktemp("ddp"))
    weights = os.path.join(root, "w.pt")
    torch.save(full_raft_variables(0)[1], weights)
    _chairs_tree(root)
    port, cli_port = _free_port(), _free_port()
    ranks = [subprocess.Popen(
        [sys.executable, os.path.join(REPO, "tests", "_torch_ddp_child.py"),
         root, weights, str(r), str(WORLD), str(port), str(cli_port)],
        cwd=REPO, env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    yield {"root": root, "ranks": ranks}
    for p in ranks:
        if p.poll() is None:
            p.kill()
            p.wait()


@pytest.fixture(scope="module")
def jax_steps(spawned):
    """JAX's two steps on the 2-device ``data`` mesh, from the fixture
    weights: each step's loss and metrics and the state after each as a
    port ``state_dict``, and Adam's first moment after the first step
    (compiled while the ranks run: a test that needs both asks for this
    fixture first)."""
    saved = os.environ.get("RAFT_TUNING")
    os.environ["RAFT_TUNING"] = "0"
    try:
        variables, _ = full_raft_variables(0)
        jcfg = JaxTrainConfig(batch_size=WORLD * child.B, **child.TRAIN_KW)
        tx = joptim.make_optimizer(jcfg.lr, jcfg.num_steps, jcfg.wdecay,
                                   jcfg.epsilon, jcfg.clip)
        state = JaxTrainState(step=jnp.zeros((), jnp.int32),
                              params=variables["params"],
                              batch_stats=variables["batch_stats"],
                              opt_state=tx.init(variables["params"]),
                              nonfinite_steps=jnp.zeros((), jnp.int32))
        mesh = jax_make_mesh(num_data=WORLD)
        # placed as the step returns it, so that the second step reuses
        # the first one's program
        state = jax.device_put(state, replicated_sharding(mesh))
        step_fn = jax_make_train_step(
            JaxRAFT(JaxRAFTConfig.full(remat=False, remat_upsample=False)),
            tx, jcfg, mesh, donate=False)
        out, mu = [], None
        for s in (0, 1):
            batch = shard_batch({k: jnp.asarray(v) for k, v in
                                 child.global_batch(s, WORLD).items()}, mesh)
            state, met = step_fn(state, batch, jax.random.PRNGKey(0))
            out.append((
                {k: np.asarray(v) for k, v in met.items()},
                state_dict_from_flax({"params": state.params,
                                      "batch_stats": state.batch_stats})))
            if mu is None:          # optax's (clip, (adam, ...)) chain
                mu = state_dict_from_flax(
                    {"params": state.opt_state[1][0].mu,
                     "batch_stats": state.batch_stats})
        return out, mu
    finally:
        if saved is None:
            os.environ.pop("RAFT_TUNING", None)
        else:
            os.environ["RAFT_TUNING"] = saved


@pytest.fixture(scope="module")
def ranks(spawned):
    """What each rank of the spawn wrote."""
    for p in spawned["ranks"]:
        out, _ = p.communicate(timeout=CHILD_TIMEOUT_S)
        assert p.returncode == 0, out[-4000:]
    return [torch.load(os.path.join(spawned["root"], f"rank{r}.pt"),
                       weights_only=False) for r in range(WORLD)]


@pytest.fixture(scope="module")
def reference(ranks):
    """The straight steps (rank 0 ran them), the parameter names, and the
    noise floors from their twin on the reversed rows (rank 1): of the
    first moment after the first step, and of each step's change."""
    names = child.param_names()
    start = full_raft_variables(0)[1]
    (snaps, mets), (twin, _) = ranks[0]["straight"], ranks[1]["reversed"]
    return {
        "snaps": snaps, "mets": mets, "names": names, "start": start,
        "grad_noise": child.noise_of(child.first_moments(twin[0], names),
                                     child.first_moments(snaps[0], names)),
        "change_noise": [child.noise_of(
            child.changes(t["model"], start, names),
            child.changes(s["model"], start, names))
            for t, s in zip(twin, snaps)]}


def _same_state(a, b) -> bool:
    return (a["step"] == b["step"] and a["nonfinite"] == b["nonfinite"]
            and a["model"].keys() == b["model"].keys()
            and all(torch.equal(a["model"][k], b["model"][k])
                    for k in a["model"])
            and a["opt"].keys() == b["opt"].keys()
            and all(torch.equal(a["opt"][k], b["opt"][k]) for k in a["opt"]))


def _close_stats(got, want, tol, err="", rtol=0.0):
    """The batch-norm statistics."""
    for k, w in want.items():
        if "running" in k:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(w),
                                       rtol=rtol, atol=tol,
                                       err_msg=f"{err}{k}")


def _agree(got, want, tol, noise=None, err=""):
    """``got`` within ``tol`` of ``want`` per parameter, and ``want``
    doubled, and zero, not: the bound can tell a step from none."""
    ratio, name = child.leaf_agreement(got, want, *tol, noise=noise)
    assert ratio <= 1.0, f"{err}{name}: {ratio:.3g} of the bound"
    for label, wrong in (("twice", 2.0), ("none", 0.0)):
        ratio, name = child.leaf_agreement(
            {n: wrong * v for n, v in want.items()}, want, *tol,
            noise=noise)
        assert ratio > 1.0, f"{err}{label}: {name} {ratio:.3g}"


def _agree_steps(snaps, want_models, want_moments, ref, which, err=""):
    """The first moment after step 1 within ``GRAD_TOL[which]``; each
    step's change within ``CHANGE_TOL[which]``."""
    names, start = ref["names"], ref["start"]
    _agree(child.first_moments(snaps[0], names), want_moments,
           GRAD_TOL[which], ref["grad_noise"], f"{err}gradient: ")
    for i, (snap, want) in enumerate(zip(snaps, want_models)):
        _agree(child.changes(snap["model"], start, names),
               child.changes(want, start, names), CHANGE_TOL[which],
               ref["change_noise"][i], f"{err}step {i} change: ")


def _close_metrics(got, want, rtol, err=""):
    for k in ("loss", "epe", "1px", "3px", "5px", "loss_iter", "epe_iter"):
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                   rtol=rtol, atol=1e-7, err_msg=f"{err}{k}")


def test_split_step_matches_jax_data_mesh(jax_steps, ranks, reference):
    """Case 1: the 2-rank split chairs step against JAX's data=2 mesh:
    metrics, statistics, the global gradient and each step's change."""
    snaps, mets, launches = ranks[0]["split"]
    assert launches == [{}, {}]          # the plain configuration
    steps, mu = jax_steps
    for i, (jmet, jsd) in enumerate(steps):
        _close_metrics(mets[i], jmet, 1e-4 if i == 0 else 1e-3,
                       f"step {i}: ")
        _close_stats(snaps[i]["model"], jsd, 1e-5, f"step {i}: ")
    _agree_steps(snaps, [jsd for _, jsd in steps],
                 {n: mu[n] for n in reference["names"]}, reference, "jax")
    # batch norm trained: the statistics moved, the same on both sides
    k = "cnet.norm1.running_var"
    assert not np.allclose(snaps[-1]["model"][k].numpy(),
                           full_raft_variables(0)[1][k].numpy())


def test_split_step_matches_straight_and_ranks_agree(ranks, reference):
    """Case 2: split against the port's straight steps; the ranks bit for
    bit, also under ``accum_steps=2``."""
    for r in range(1, WORLD):
        assert all(_same_state(a, b) for a, b in
                   zip(ranks[0]["split"][0], ranks[r]["split"][0]))
        assert _same_state(ranks[0]["accum"], ranks[r]["accum"])
    assert ranks[0]["accum"]["step"] == 2
    assert not torch.equal(ranks[0]["accum"]["model"]["cnet.conv1.weight"],
                           ranks[0]["split"][0][-1]["model"][
                               "cnet.conv1.weight"])
    snaps, mets, _ = ranks[0]["split"]
    for i, (smet, ssnap) in enumerate(zip(reference["mets"],
                                          reference["snaps"])):
        _close_metrics(mets[i], smet, 1e-5, f"step {i}: ")
        _close_stats(snaps[i]["model"], ssnap["model"], 1e-6,
                     f"step {i}: ")
        assert snaps[i]["step"] == ssnap["step"] == i + 1
    _agree_steps(snaps, [s["model"] for s in reference["snaps"]],
                 child.first_moments(reference["snaps"][0],
                                     reference["names"]),
                 reference, "straight")


def test_dropout_mask_is_the_global_batch_s(ranks, reference):
    """Channel dropout 0.3: each rank keeps its rows of the mask drawn for
    the global batch, so the split step equals the straight step on the
    global batch in the data-parallel row order (the bounds of 2), and
    differs from the same step without dropout."""
    (want,), (met,) = ranks[0]["dropout_straight"]
    (snap,), (smet,) = ranks[0]["dropout"]
    _close_metrics(smet, met, 1e-5)
    _close_stats(snap["model"], want["model"], 1e-6)
    _agree_steps([snap], [want["model"]],
                 child.first_moments(want, reference["names"]), reference,
                 "straight")
    assert not np.isclose(float(smet["loss"]),
                          float(ranks[0]["split"][1][0]["loss"]), rtol=1e-3)


def test_nan_on_one_rank_skips_on_all(ranks):
    """Case 3: rank 1's second batch holds a NaN: both ranks skip that
    update (their state after it is their state before it, bit for bit),
    both count it, and the ranks stay bit-identical."""
    for r in range(WORLD):
        snaps, mets = ranks[r]["nan"]
        assert [float(m["nonfinite"]) for m in mets] == [0.0, 1.0, 0.0]
        assert [(s["step"], s["nonfinite"]) for s in snaps] == [
            (1, 0), (2, 1), (3, 1)]
        a, b = snaps[0], snaps[1]
        assert all(torch.equal(a["model"][k], b["model"][k])
                   for k in a["model"])
        assert all(torch.equal(a["opt"][k], b["opt"][k]) for k in a["opt"])
    assert all(_same_state(a, b) for a, b in
               zip(ranks[0]["nan"][0], ranks[1]["nan"][0]))


def test_preempt_on_one_rank_stops_all_at_one_step(ranks, spawned):
    """Case 4: ``preempt@step=2`` on rank 1 only: both exit 143 before
    step 2, rank 0's checkpoint holds step 2 (stamped world 2), and the
    resumed run equals the uninterrupted one bit for bit on each rank."""
    assert [r["cut_exit"] for r in ranks] == [143, 143]
    assert ranks[0]["cut_ckpts"] == ["2", "topology.json"]
    for r in range(WORLD):
        assert ranks[r]["resumed"]["step"] == child.LOOP_STEPS
        assert _same_state(ranks[r]["resumed"], ranks[r]["whole"])
    assert _same_state(ranks[0]["whole"], ranks[1]["whole"])
    mgr = CheckpointManager(os.path.join(spawned["root"], "ckpt", "cut"))
    assert mgr.all_steps() == [2, 4]
    assert mgr.saved_topology(2)["world_size"] == 2
    assert mgr.saved_topology(2)["mesh"] == {"data": 2, "spatial": 1}


def test_two_rank_checkpoint_restores_on_one_rank(ranks, spawned, reference,
                                                  tmp_path, capsys):
    """Case 5: step 2 of the preempted 2-rank run, restored by a 1-rank
    run with the same global batch: the sample stream it continues is the
    2-rank stream's (rank r's row j is row ``j * 2 + r``, bit for bit), the
    stamps say world 2 then 1, ``verify-ckpt`` reports world 2, and the
    finished state is within the bounds of the 2-rank run's."""
    from raft_tpu_torch.cli.verify_ckpt import main as verify_main

    run = tmp_path / "run"
    shutil.copytree(os.path.join(spawned["root"], "ckpt", "cut"), run)
    shutil.rmtree(run / "4")
    ds = child.synth_dataset()
    one = next(ShardedLoader(ds, WORLD * child.B, seed=3, num_workers=1)
               .batches_from_step(child.PREEMPT_AT))
    two = [next(ShardedLoader(ds, child.B, seed=3, num_hosts=WORLD,
                              host_id=r, num_workers=1)
                .batches_from_step(child.PREEMPT_AT)) for r in range(WORLD)]
    for k in one:
        for r in range(WORLD):
            assert np.array_equal(one[k][r::WORLD], two[r][k]), k

    cfg = child.loop_cfg(str(tmp_path), "run")
    capsys.readouterr()
    state = loop.train(RAFTConfig.full(), cfg,
                       loader=ShardedLoader(ds, WORLD * child.B, seed=3,
                                            num_workers=1),
                       device="cpu", log=lambda line: None)
    assert "resumed from step 2 (saved on 1 x cpu, world 2)" in \
        capsys.readouterr().out
    assert state.step == child.LOOP_STEPS
    whole = ranks[0]["whole"]["model"]
    _close_stats(state.model.state_dict(), whole, 1e-5, rtol=1e-4)
    start = RAFT(RAFTConfig.full(), seed=cfg.seed).state_dict()
    names = reference["names"]
    _agree(child.changes(state.model.state_dict(), start, names),
           child.changes(whole, start, names), CHANGE_TOL["straight"])
    mgr = CheckpointManager(str(run))
    assert mgr.saved_topology(2)["world_size"] == 2
    assert mgr.saved_topology(4)["world_size"] == 1
    assert verify_main([str(run), "--json"]) == 0
    rep = json.loads(capsys.readouterr().out.strip())
    assert {s["step"]: s["topology"]["world_size"]
            for s in rep["steps"]} == {2: 2, 4: 1}


def test_train_cli_distributed_world_2(ranks, spawned):
    """Case 6: the train CLI with ``--distributed --device cpu
    --validation chairs`` under the variables ``torchrun`` sets, at world
    2: both ranks exit 0 after rank 0 validated at step 2 (the other at
    the barrier), rank 0 alone prints, and the checkpoint of step 2 says
    world 2."""
    outs = []
    for r in range(WORLD):
        with open(os.path.join(spawned["root"], f"cli{r}.log")) as f:
            out = f.read()
        with open(os.path.join(spawned["root"], f"cli{r}.json")) as f:
            assert json.load(f)["exit"] == 0, out[-4000:]
        outs.append(out)
    assert "Parameter Count" in outs[0]
    assert "Validation Chairs EPE" in outs[0]
    assert outs[1] == ""
    mgr = CheckpointManager(os.path.join(spawned["root"], "cli_ckpt", "cli"))
    assert mgr.all_steps() == [2]
    assert mgr.saved_topology(2)["world_size"] == 2
    assert [r["ok"] for r in mgr.verify_all()] == [True]


def test_train_cli_world_2_counts_the_step_cost(ranks, spawned):
    """Case 6's telemetry: at world 2 each rank counts its first step
    (the counting modes step aside around the collectives), so rank 0's
    stream holds the train step's ``cost_report`` and its
    ``flops_per_pair`` is world 1's: the same step of the global batch in
    one process, counted the same way."""
    from raft_tpu_torch.obs import cost as cost_mod
    from raft_tpu_torch.train.step import step_cost

    path = os.path.join(spawned["root"], "cli_tel", "telemetry-p0.jsonl")
    with open(path) as f:
        events = [json.loads(line) for line in f]
    [report] = [e for e in events if e.get("event") == "cost_report"
                and e.get("program") == "train_step"]
    [run] = [e for e in events if e.get("event") == "run_config"]
    assert run["num_devices"] == WORLD
    # the CLI's chairs stage on the CPU: corr_impl auto is allpairs
    cfg = TrainConfig(batch_size=child.B * WORLD, **child.TRAIN_KW)
    state = init_state(RAFTConfig.full(corr_impl="allpairs"), cfg,
                       device="cpu", state_dict=full_raft_variables(0)[1])
    step_fn = make_train_step(cfg, device="cpu")
    with cost_mod.counting() as counted:
        step_fn(state, child.global_batch(0))
    one = step_cost(counted, cfg.batch_size, 1, kind="cpu")
    assert one.flops_per_pair > 0
    np.testing.assert_allclose(report["flops_per_pair"], one.flops_per_pair,
                               rtol=1e-6)
    assert report["source"] == "counted"


def test_world_one_mesh_is_the_plain_step():
    """A mesh of one gloo rank all-reduces (a sum of one, a division by
    1): two steps bit for bit the plain step's parameters, optimizer
    state, loss and metrics, each step's metrics its own after the next
    step reused the reduction buffer."""
    import torch.distributed as dist

    from raft_tpu_torch.parallel import make_mesh, shutdown

    dist.init_process_group("gloo", init_method=f"tcp://localhost:"
                            f"{_free_port()}", rank=0, world_size=1)
    try:
        mesh = make_mesh()
        assert mesh.distributed and mesh.world == 1
        assert mesh.mesh_shape() == {"data": 1, "spatial": 1}
        cfg = TrainConfig(batch_size=child.B, **child.TRAIN_KW)
        arms = []
        for m in (None, mesh):
            state = init_state(RAFTConfig.full(), cfg, device="cpu",
                               state_dict=full_raft_variables(0)[1])
            step_fn = make_train_step(cfg, device="cpu", mesh=m)
            mets = [step_fn(state, child.rows(child.global_batch(s), 0))[1]
                    for s in (0, 1)]
            arms.append((child.snapshot(state), mets))
    finally:
        shutdown()
    (plain, pm), (split, sm) = arms
    assert _same_state(plain, split)
    for a, b in zip(pm, sm):
        assert a.keys() == b.keys()
        for k in ("loss", "loss_iter", "grad_norm", "nonfinite"):
            assert torch.equal(a[k], b[k]), k
        for k in ("epe", "1px", "3px", "5px", "epe_iter"):
            np.testing.assert_allclose(b[k].numpy(), a[k].numpy(),
                                       rtol=1e-6, err_msg=k)
    assert not torch.equal(sm[0]["loss"], sm[1]["loss"])
