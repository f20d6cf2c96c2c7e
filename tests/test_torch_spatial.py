"""The port's spatially sharded training on the CPU: 4 gloo ranks of a
``data 2 x spatial 2`` mesh against the JAX package's spatially sharded
step and against the port's straight run.

One spawn of ``tests/_torch_spatial_child.py`` as 4 ranks (free ports,
torch only) serves every case but the CLI refusals: rank ``d * 2 + s``
holds rows ``[s*16, (s+1)*16)`` of data index d's 2 pairs; the spatial
groups and the world are exercised together.  It starts before the JAX
step compiles here.  The full model at 32x48 (a 1/8-resolution shard
holds 2 rows, so ``convf1``'s 7x7 reads beyond its neighbour), 2
iterations, 2 pairs a data index, fp32, from the seeded weights of
``test_torch_fixtures``:

(a) two sharded chairs steps (``allpairs``; batch norm trained on the
    global batch) against JAX's ``make_train_step(..., make_mesh(
    num_data=2, num_spatial=2), shard_spatial=True)`` (the first step's
    metrics and statistics) and JAX's step on the ``data 2`` mesh (both
    steps, the gradient and the changes) on the same global batches;
    and one sharded step at 64x96 against JAX's spatially sharded step,
    gradient and change (JAX's partitioned backward is wrong at 32x48,
    where a convolution reads more rows than a neighbour's shard holds;
    ROADMAP C);
(b) the same against the port's straight steps on the global batch;
(c) ``allpairs_pallas`` and ``pallas`` (their plain versions here)
    against their own straight steps, and their losses against (b)'s;
(d) the halo exchange and the row all-gather, forward equal to the whole
    image's rows and ``gradcheck`` in fp64, with halos of 1, 3 and 6
    rows over shards of 4 (taller than a shard); an int8 pyramid of a
    shard's queries (its scales the spatial group's);
(e) instance norm over the spatial group against ``F.instance_norm`` on
    the whole image, and the feature encoder in fp64 against the whole
    image's;
(f) ``train --distributed --shard_spatial 2 --device cpu --small`` at
    world 4 (the twin of ``tests/test_cli.py::
    test_train_cli_spatial_sharding``);
(g) its ``{data: 2, spatial: 2}`` checkpoint restored on one rank, and a
    one-rank checkpoint resumed under the sharded mesh;
(h) the JAX CLI's two refusals (and the port's: ``--distributed``);
(i) every remat policy under the mesh, its recompute on another thread
    than the forward, against the same step's gradients without remat.

Tolerances.  Loss and metrics: against straight rtol 1e-5, against JAX
rtol 1e-4 at the first step and 1e-3 at the second (the tolerances of
``test_torch_ddp.py::test_split_step_matches_jax_data_mesh``).
Batch-norm statistics 1e-6 against straight, 1e-5 against JAX.
Parameters by what the step did to them, per parameter by norm
(``_torch_ddp_child.leaf_agreement``; its noise, per parameter, the
larger of the straight run's differences from its twin on reversed rows
and from its twin that sums instance norm's moments over the row
shards, the sharded step's order: some gradients are sums that cancel
to a small part of their terms, where that reordering shows), the
global gradient (Adam's first moment
after step 1) within ``GRAD_TOL`` and each step's change within
``CHANGE_TOL``; a doubled and a zero change must fail the bound.
"""

import json
import os
import shutil
import socket
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.config import RAFTConfig as JaxRAFTConfig
from raft_tpu.config import TrainConfig as JaxTrainConfig
from raft_tpu.models.raft import RAFT as JaxRAFT
from raft_tpu.parallel import make_mesh as jax_make_mesh
from raft_tpu.parallel import replicated_sharding, shard_batch
from raft_tpu.train import optim as joptim
from raft_tpu.train.state import TrainState as JaxTrainState
from raft_tpu.train.step import make_train_step as jax_make_train_step
from raft_tpu_torch.cli import train as train_cli
from raft_tpu_torch.config import RAFTConfig
from raft_tpu_torch.data.datasets import ShardedLoader
from raft_tpu_torch.train import loop
from raft_tpu_torch.train.checkpoint import CheckpointManager
from raft_tpu_torch.train.step import init_state

import _torch_ddp_child as ddp
import _torch_spatial_child as child
from test_torch_ddp import _chairs_tree, _close_metrics, _close_stats, _env
from test_torch_fixtures import full_raft_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
D = WORLD // child.N
CHILD_TIMEOUT_S = 300
# (rtol, floor) of ``ddp.leaf_agreement``, per reference
GRAD_TOL = {"straight": (1e-5, 1e-6), "jax": (2e-3, 5e-4)}
CHANGE_TOL = {"straight": (1e-3, 1e-3), "jax": (0.15, 2e-3)}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread here, as each rank has."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """The 4-rank spawn, started: the chairs tree of its CLI run and the
    one-rank checkpoint (step 1) its loop resumes are written first."""
    root = str(tmp_path_factory.mktemp("spatial"))
    weights = os.path.join(root, "w.pt")
    sd = full_raft_variables(0)[1]
    torch.save(sd, weights)
    _chairs_tree(root, hw=child.CLI_HW)
    cfg = child.loop_cfg(os.path.join(root, "one_rank"))
    state = init_state(RAFTConfig.full(), cfg, device="cpu", state_dict=sd)
    state.step = 1
    mgr = CheckpointManager(os.path.join(cfg.ckpt_dir, cfg.name))
    mgr.save(1, state)
    mgr.close()
    port, cli_port = _free_port(), _free_port()
    ranks = [subprocess.Popen(
        [sys.executable, os.path.join(REPO, "tests",
                                      "_torch_spatial_child.py"),
         root, weights, str(r), str(WORLD), str(port), str(cli_port)],
        cwd=REPO, env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    yield {"root": root, "ranks": ranks}
    for p in ranks:
        if p.poll() is None:
            p.kill()
            p.wait()


# what the JAX fixture runs: (spatially sharded, image size, steps)
JAX_RUNS = {"spatial": (True, (ddp.H, ddp.W), 2),
            "data": (False, (ddp.H, ddp.W), 2),
            "spatial_big": (True, child.JAX_HW, 1)}


def _jax_run(which):
    """JAX's chairs steps (``corr_impl='allpairs'``) of ``JAX_RUNS[which]``
    on the ``data 2 x spatial 2`` mesh with ``shard_spatial=True`` or on
    the ``data 2`` mesh, from the fixture weights on global batches 0,
    1, ...: each step's metrics and state as a port ``state_dict``, and
    Adam's first moment after the first step."""
    from raft_tpu_torch.convert import state_dict_from_flax

    os.environ["RAFT_TUNING"] = "0"
    spatial, hw, steps = JAX_RUNS[which]
    mesh = jax_make_mesh(num_data=D, num_spatial=child.N if spatial else 1)
    variables, _ = full_raft_variables(0)
    jcfg = JaxTrainConfig(batch_size=D * child.B,
                          **dict(ddp.TRAIN_KW, image_size=hw))
    tx = joptim.make_optimizer(jcfg.lr, jcfg.num_steps, jcfg.wdecay,
                               jcfg.epsilon, jcfg.clip)
    # placed as the step returns it, so that the second step runs the
    # first one's program
    state = jax.device_put(
        JaxTrainState(step=jnp.zeros((), jnp.int32),
                      params=variables["params"],
                      batch_stats=variables["batch_stats"],
                      opt_state=tx.init(variables["params"]),
                      nonfinite_steps=jnp.zeros((), jnp.int32)),
        replicated_sharding(mesh))
    step_fn = jax_make_train_step(
        JaxRAFT(JaxRAFTConfig.full(corr_impl="allpairs", remat=False,
                                   remat_upsample=False)),
        tx, jcfg, mesh, donate=False, shard_spatial=spatial)
    out, mu, compiled = [], None, None
    key = jax.random.PRNGKey(0)
    for s in range(steps):
        batch = shard_batch({k: jnp.asarray(v) for k, v in
                             ddp.global_batch(s, D, hw=hw).items()}, mesh,
                            spatial=spatial)
        if compiled is None:
            # LLVM's optimizations off: the same program and results,
            # compiled in less time
            compiled = step_fn.lower(state, batch, key).compile(
                compiler_options={"xla_backend_optimization_level": 0})
        state, met = compiled(state, batch, key)
        out.append((
            {k: np.asarray(v) for k, v in met.items()},
            state_dict_from_flax({"params": state.params,
                                  "batch_stats": state.batch_stats})))
        if mu is None:          # optax's (clip, (adam, ...)) chain
            mu = state_dict_from_flax(
                {"params": state.opt_state[1][0].mu,
                 "batch_stats": state.batch_stats})
    return out, mu


@pytest.fixture(scope="module")
def jax_steps(spawned):
    """JAX's two steps on the ``data 2 x spatial 2`` mesh with
    ``shard_spatial=True`` and, on the same global batches, on the
    ``data 2`` mesh, and one step with ``shard_spatial=True`` at
    ``child.JAX_HW`` (each as :func:`_jax_run` returns them; compiled
    while the ranks run, each in a process of its own: tests that need
    both ask for this fixture first)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    with ProcessPoolExecutor(
            len(JAX_RUNS),
            mp_context=multiprocessing.get_context("spawn")) as pool:
        runs = {k: pool.submit(_jax_run, k) for k in JAX_RUNS}
        return {k: f.result() for k, f in runs.items()}


@pytest.fixture(scope="module")
def ranks(spawned):
    """What each rank of the spawn wrote; a rank that fails ends the
    others at once (its peers would wait on it in a collective)."""
    procs = spawned["ranks"]
    deadline = time.monotonic() + CHILD_TIMEOUT_S
    while any(p.poll() is None for p in procs):
        if any(p.poll() not in (None, 0) for p in procs) \
                or time.monotonic() > deadline:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            break
        time.sleep(0.2)
    for p in procs:
        out, _ = p.communicate()
        assert p.returncode == 0, out[-4000:]
    return [torch.load(os.path.join(spawned["root"], f"rank{r}.pt"),
                       weights_only=False) for r in range(WORLD)]


def _max_noise(twins, ref, of):
    """Per parameter, the largest of the twins' differences from the
    reference, each taken through ``of``."""
    noises = [ddp.noise_of(of(t), of(ref)) for t in twins]
    return {n: max(x[n] for x in noises) for n in noises[0]}


@pytest.fixture(scope="module")
def reference(ranks):
    """The parameter names, the start, and the noise floors of the
    straight run (rank 0's ``allpairs``): per parameter the larger of
    its differences from its twin on reversed rows and from its twin
    with instance norm's sums taken over the row shards (rank 3)."""
    names = ddp.param_names()
    start = full_raft_variables(0)[1]
    snaps = ranks[0]["straight"][0]
    twins = [ranks[3]["reversed"][0], ranks[3]["row_shards"][0]]
    return {
        "names": names, "start": start,
        "grad_noise": _max_noise([t[0] for t in twins], snaps[0],
                                 lambda s: ddp.first_moments(s, names)),
        "change_noise": [_max_noise(
            [t[i] for t in twins], snaps[i],
            lambda s: ddp.changes(s["model"], start, names))
            for i in range(len(snaps))]}


def _agree(got, want, tol, noise=None, err=""):
    """``got`` within ``tol`` of ``want`` per parameter, and ``want``
    doubled, and zero, not."""
    ratio, name = ddp.leaf_agreement(got, want, *tol, noise=noise)
    assert ratio <= 1.0, f"{err}{name}: {ratio:.3g} of the bound"
    for label, wrong in (("twice", 2.0), ("none", 0.0)):
        ratio, name = ddp.leaf_agreement(
            {n: wrong * v for n, v in want.items()}, want, *tol,
            noise=noise)
        assert ratio > 1.0, f"{err}{label}: {name} {ratio:.3g}"


def _agree_steps(snaps, want_models, want_moments, ref, which, err=""):
    names, start = ref["names"], ref["start"]
    _agree(ddp.first_moments(snaps[0], names), want_moments,
           GRAD_TOL[which], ref["grad_noise"], f"{err}gradient: ")
    for i, (snap, want) in enumerate(zip(snaps, want_models)):
        _agree(ddp.changes(snap["model"], start, names),
               ddp.changes(want, start, names), CHANGE_TOL[which],
               ref["change_noise"][i], f"{err}step {i} change: ")


def _same_state(a, b) -> bool:
    return (a["step"] == b["step"]
            and all(torch.equal(a["model"][k], b["model"][k])
                    for k in a["model"])
            and all(torch.equal(a["opt"][k], b["opt"][k]) for k in a["opt"]))


def test_sharded_step_matches_jax_spatial_mesh(jax_steps, ranks, reference):
    """(a) The data 2 x spatial 2 step against JAX's at 32x48: the first
    step's metrics and statistics against JAX's spatially sharded step;
    the metrics and statistics of both steps, the global gradient and
    each step's change against JAX's step on the same global batches on
    the data 2 mesh, which computes the function that the spatial step
    is to compute.  (JAX's spatially sharded backward departs from it
    here, where a 1/8-resolution shard holds 2 rows and ``convf1``'s 7x7
    reads 3 beyond it: its first moment of ``cnet.conv2.weight`` is 67%
    of that gradient's norm away, while its forward agrees to 1e-7; at
    64x96 it agrees, see the next test; ROADMAP C.)  Every rank holds
    the same state, bit for bit."""
    snaps, mets, launches = ranks[0]["split"]["allpairs"]
    assert launches == [{}, {}]          # plain versions on the CPU
    assert ranks[0]["mesh_shape"] == {"data": 2, "spatial": 2}
    for r in range(1, WORLD):
        assert all(_same_state(a, b) for a, b in zip(
            snaps, ranks[r]["split"]["allpairs"][0])), r
    (jmet, jsd), _ = jax_steps["spatial"][0]
    _close_metrics(mets[0], jmet, 1e-4, "spatial mesh step 0: ")
    _close_stats(snaps[0]["model"], jsd, 1e-5, "spatial mesh step 0: ")
    steps, mu = jax_steps["data"]
    for i, (jmet, jsd) in enumerate(steps):
        _close_metrics(mets[i], jmet, 1e-4 if i == 0 else 1e-3,
                       f"step {i}: ")
        _close_stats(snaps[i]["model"], jsd, 1e-5, f"step {i}: ")
    _agree_steps(snaps, [jsd for _, jsd in steps],
                 {n: mu[n] for n in reference["names"]}, reference, "jax")


def test_sharded_step_matches_jax_spatial_step_where_halos_fit(
        jax_steps, ranks):
    """(a) At ``child.JAX_HW`` (64x96, where every shard holds the rows a
    convolution reads beyond it), one data 2 x spatial 2 step against
    JAX's spatially sharded step on the same global batch: metrics rtol
    1e-4, statistics 1e-5, the global gradient and the change within
    ``GRAD_TOL`` / ``CHANGE_TOL`` of ``"jax"``, the noise floor that of
    the port's straight step at that size against its twins on reversed
    rows, with instance norm's sums over the row shards and with batch
    norm's moments in two passes (at this size ``torch.var_mean``'s
    rounding alone moves ``cnet``'s lower gradients ~1.6e-3 of their
    norm); and the sharded step within the straight bounds of that
    straight step."""
    names = ddp.param_names()
    start = full_raft_variables(0)[1]
    (snap,), (met,), _ = ranks[0]["split_big"]
    for r in range(1, WORLD):
        assert _same_state(snap, ranks[r]["split_big"][0][0]), r
    (want,), (wmet,) = ranks[1]["straight_big"]
    twins = [ranks[1]["reversed_big"][0][0],
             ranks[2]["row_shards_big"][0][0],
             ranks[3]["two_pass_big"][0][0]]
    ref = {"names": names, "start": start,
           "grad_noise": _max_noise(twins, want,
                                    lambda s: ddp.first_moments(s, names)),
           "change_noise": [_max_noise(
               twins, want, lambda s: ddp.changes(s["model"], start,
                                                  names))]}
    _close_metrics(met, wmet, 1e-5, "straight: ")
    _close_stats(snap["model"], want["model"], 1e-6, "straight: ")
    _agree_steps([snap], [want["model"]], ddp.first_moments(want, names),
                 ref, "straight", "straight: ")
    ((jmet, jsd),), mu = jax_steps["spatial_big"]
    _close_metrics(met, jmet, 1e-4, "jax: ")
    _close_stats(snap["model"], jsd, 1e-5, "jax: ")
    _agree_steps([snap], [jsd], {n: mu[n] for n in names}, ref, "jax",
                 "jax: ")


@pytest.mark.parametrize("impl", child.IMPLS)
def test_sharded_step_matches_straight(ranks, reference, impl):
    """(b), (c) Each correlation configuration's sharded steps against its
    straight steps on the global batch (metrics rtol 1e-5, statistics
    1e-6, gradient and changes within ``GRAD_TOL`` / ``CHANGE_TOL``), and
    its loss against ``allpairs``' straight loss (the three compute one
    function)."""
    snaps, mets, _ = ranks[0]["split"][impl]
    want_snaps, want_mets = ranks[child.IMPLS.index(impl)]["straight"]
    for i, (smet, ssnap) in enumerate(zip(want_mets, want_snaps)):
        _close_metrics(mets[i], smet, 1e-5, f"{impl} step {i}: ")
        _close_stats(snaps[i]["model"], ssnap["model"], 1e-6,
                     f"{impl} step {i}: ")
        assert snaps[i]["step"] == ssnap["step"] == i + 1
    _agree_steps(snaps, [s["model"] for s in want_snaps],
                 ddp.first_moments(want_snaps[0], reference["names"]),
                 reference, "straight", f"{impl}: ")
    np.testing.assert_allclose(
        float(mets[0]["loss"]),
        float(ranks[0]["straight"][1][0]["loss"]), rtol=1e-5)


def test_halo_and_gather_collectives(ranks):
    """(d) On every rank: the halo exchange (1, 3 and 6 rows, the last
    taller than a shard) and the row all-gather (NCHW and NHWC) equal the
    whole image's rows, and pass ``gradcheck`` in fp64; a shard's int8
    pyramid holds the whole volume's codes of its queries and the whole
    volume's scales (the largest magnitude over the spatial group)."""
    for r in range(WORLD):
        res = ranks[r]["collectives"]
        assert len(res) == 10 and all(res.values()), (r, res)


def test_instance_norm_over_the_spatial_group(ranks):
    """(e) Instance norm over the spatial group against
    ``F.instance_norm`` of the whole image in fp32 (forward 1e-5 and
    input gradient 1e-5 of its scale), and the feature encoder's halo
    convolutions and norms in fp64: output 1e-12, every parameter's
    gradient within 1e-10 of the whole image's, relative to the whole
    gradient's norm."""
    for r in range(WORLD):
        res = ranks[r]["instance"]
        assert res["norm fwd"] < 1e-5, res
        assert res["norm grad"] < 1e-5 * res["norm scale"], res
        assert res["encoder fp64 fwd"] < 1e-12, res
        assert res["encoder fp64 grad rel"] < 1e-10, res


def test_remat_recomputes_under_the_mesh(ranks):
    """(i) Under the mesh, each remat policy with ``remat_upsample``
    gives every rank the loss's gradients of the run without remat
    (each parameter within 1e-6 of its gradient's norm), with the
    backward on another thread than the forward, where no mesh is
    active, as autograd runs a CUDA backward."""
    for r in range(WORLD):
        res = ranks[r]["remat"]
        assert sorted(res) == sorted(child.REMAT_POLICIES), res
        assert all(v <= 1e-6 for v in res.values()), (r, res)


def test_one_rank_checkpoint_resumes_sharded(ranks):
    """(g) A one-rank checkpoint (step 1) resumed under the data 2 x
    spatial 2 mesh to step 2: every rank the same state, within the
    bounds of (b) of the one-rank resume of the same checkpoint."""
    whole = ranks[0]["loop_straight"]
    for r in range(WORLD):
        got = ranks[r]["loop"]
        assert got["step"] == whole["step"] == 2
        assert _same_state(got, ranks[0]["loop"])
    names = ddp.param_names()
    start = full_raft_variables(0)[1]
    _agree(ddp.changes(ranks[0]["loop"]["model"], start, names),
           ddp.changes(whole["model"], start, names), CHANGE_TOL["straight"])
    _close_stats(ranks[0]["loop"]["model"], whole["model"], 1e-6)


def test_train_cli_spatial_sharding_world_4(ranks, spawned):
    """(f) ``train --distributed --shard_spatial 2 --device cpu --small``
    at world 4: every rank exits 0, rank 0 alone prints, and the
    checkpoint of step 1 says world 4, ``{data: 2, spatial: 2}``."""
    outs = []
    for r in range(WORLD):
        with open(os.path.join(spawned["root"], f"cli{r}.log")) as f:
            out = f.read()
        with open(os.path.join(spawned["root"], f"cli{r}.json")) as f:
            assert json.load(f)["exit"] == 0, out[-4000:]
        outs.append(out)
    assert "Parameter Count" in outs[0]
    assert outs[1:] == [""] * (WORLD - 1)
    mgr = CheckpointManager(os.path.join(spawned["root"], "cli_ckpt",
                                         "spatial"))
    assert mgr.all_steps() == [1]
    topo = mgr.saved_topology(1)
    assert topo["world_size"] == 4
    assert topo["mesh"] == {"data": 2, "spatial": 2}
    assert [r["ok"] for r in mgr.verify_all()] == [True]


def test_sharded_checkpoint_restores_on_one_rank(ranks, spawned, tmp_path,
                                                 capsys):
    """(g) The CLI's ``{data: 2, spatial: 2}`` checkpoint restored by a
    one-rank run of the small model, which finishes its second step;
    ``verify-ckpt`` prints the mesh of each step."""
    from raft_tpu_torch.cli.verify_ckpt import main as verify_main
    from raft_tpu_torch.config import TrainConfig

    run = tmp_path / "spatial"
    shutil.copytree(os.path.join(spawned["root"], "cli_ckpt", "spatial"),
                    run)
    ds = ddp.synth_dataset()
    cfg = TrainConfig(name="spatial", batch_size=4, val_freq=2, log_freq=2,
                      ckpt_dir=str(tmp_path),
                      **dict(ddp.TRAIN_KW, num_steps=2))
    capsys.readouterr()
    state = loop.train(RAFTConfig.small_model(), cfg,
                       loader=ShardedLoader(ds, 4, seed=3, num_workers=1),
                       device="cpu", log=lambda line: None)
    assert "resumed from step 1 (saved on 1 x cpu, world 4)" in \
        capsys.readouterr().out
    assert state.step == 2
    mgr = CheckpointManager(str(run))
    assert mgr.saved_topology(2)["mesh"] == {"data": 1, "spatial": 1}
    assert verify_main([str(run)]) == 0
    out = capsys.readouterr().out
    assert "step 1: ok  [saved on 1 x cpu, world 4] mesh data 2 x spatial " \
        "2" in out
    assert "step 2: ok  [saved on 1 x cpu, world 1] mesh data 1 x spatial " \
        "1" in out


@pytest.mark.parametrize("argv,env,match", [
    (["--shard_spatial", "2", "--image_size", "64", "96"], {},
     "--shard_spatial 2 needs --distributed"),
    (["--distributed", "--shard_spatial", "2", "--image_size", "64", "96"],
     {"WORLD_SIZE": "3"}, "--shard_spatial 2 must divide the 3-rank world"),
    (["--distributed", "--shard_spatial", "2", "--image_size", "72", "96"],
     {"WORLD_SIZE": "4"}, "--shard_spatial 2 needs image height 72 "
                          "divisible by 16")])
def test_cli_refuses_as_jax(argv, env, match, monkeypatch):
    """(h) The JAX CLI's refusals (``raft_tpu/cli/train.py:357-365``):
    the world not divisible by N, the image height not a multiple of
    ``8 * N``; and the port's: rows are split over a process group, so
    ``--distributed``.  Each before any rank joins a group."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(SystemExit, match=match):
        train_cli.run([*argv, "--device", "cpu"])
