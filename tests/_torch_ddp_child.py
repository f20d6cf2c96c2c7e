"""One rank of the 2-rank gloo runs of ``tests/test_torch_ddp.py`` (torch
only: it imports neither JAX nor ``raft_tpu``).

    python tests/_torch_ddp_child.py OUT WEIGHTS RANK WORLD PORT [CLI_PORT]

joins the process group at ``localhost:PORT`` through
``raft_tpu_torch.parallel.init_from_env`` (the ``torchrun`` variables set
here) and runs, from the port ``state_dict`` in ``WEIGHTS``:

- ``split``: two data-parallel chairs steps (batch norm trained) on this
  rank's rows of :func:`global_batch` 0 and 1;
- ``accum``: the same two steps with ``accum_steps=2``;
- ``dropout``: one step of the model with channel dropout 0.3;
- ``nan``: three steps whose second batch holds a NaN on rank 1 only;
- ``loop``: :func:`raft_tpu_torch.train.loop.train` on a loader stride of
  :class:`Synth`, uninterrupted to step 4; then a run preempted by a
  chaos ``preempt`` at step 2 on rank 1 only, and its resume to step 4;
- ``straight`` (rank 0): the same two steps in one process on the
  global batches, and the dropout step on the global batch in the
  data-parallel row order; ``reversed`` (rank 1): the two straight steps
  with the global batches' rows reversed, which sum the same terms in
  another order (the reference's own rounding noise);

and writes what the parent compares to ``OUT/rank<RANK>.pt``.  Then,
given ``CLI_PORT``, it runs the train CLI's ``main`` with
``--distributed --device cpu --validation chairs`` on the chairs tree
under ``OUT`` (rank 0 validates while rank 1 waits), its standard output
in ``OUT/cli<RANK>.log`` and its exit code in ``OUT/cli<RANK>.json``.

    python tests/_torch_ddp_child.py OUT WEIGHTS RANK WORLD PORT cuda

shares the card between the ranks over gloo and runs only ``split``, in
:data:`CUDA_KW`'s kernel configuration (fp32, TF32 off), with each
step's kernel launch counts (``tests/test_torch_cuda.py``).
"""

import contextlib
import json
import os
import sys

import numpy as np
import torch

B, H, W, ITERS = 2, 32, 48, 2      # B: one rank's batch
TRAIN_KW = dict(lr=2e-4, num_steps=100, image_size=(H, W), iters=ITERS)
LOOP_STEPS, PREEMPT_AT = 4, 2
# the card's configuration: every kernel of the data-parallel chairs path
CUDA_KW = dict(corr_impl="allpairs_pallas", upsample_loss_kernel="pallas",
               fused_gru=True)


def global_batch(seed, world=2, b=B):
    """The global batch ``seed`` of ``world * b`` pairs; rank r takes rows
    ``r*b:(r+1)*b`` (the JAX package's ``data`` shards)."""
    n = world * b
    rng = np.random.default_rng(seed)
    return {"image1": rng.uniform(0, 255, (n, H, W, 3)).astype(np.float32),
            "image2": rng.uniform(0, 255, (n, H, W, 3)).astype(np.float32),
            "flow": (3 * rng.standard_normal((n, H, W, 2))).astype(
                np.float32),
            "valid": (rng.random((n, H, W)) > 0.1).astype(np.float32)}


def rows(batch, rank, b=B):
    return {k: v[rank * b:(rank + 1) * b] for k, v in batch.items()}


def interleaved(batch, world=2, b=B):
    """``batch`` in the data-parallel global row order
    (``raft_tpu_torch/parallel/mesh.py``): row ``i`` is row ``i // world``
    of rank ``i % world``."""
    order = [(i % world) * b + i // world for i in range(world * b)]
    return {k: v[order] for k, v in batch.items()}


def synth_dataset(n=13):
    """A dataset of seeded frames: sample i is f(i) plus a draw of the
    loader's per-sample generator."""
    from raft_tpu_torch.data.datasets import FlowDataset

    class Synth(FlowDataset):
        def __init__(self):
            super().__init__()
            self.image_list = [("a", "b")] * n

        def load(self, index, rng=None):
            base = np.random.default_rng(index).uniform(0, 255, (H, W, 3))
            img1 = np.clip(base + rng.normal(0, 4, base.shape), 0, 255)
            flow = np.full((H, W, 2), 0.5 * (index % 3), np.float32)
            return {"image1": img1.astype(np.float32),
                    "image2": np.roll(img1, 1, axis=1).astype(np.float32),
                    "flow": flow, "valid": np.ones((H, W), np.float32)}

    return Synth()


def loop_cfg(ckpt_dir, name, world=2):
    """The loop's configuration: the global batch of ``world`` ranks."""
    from raft_tpu_torch.config import TrainConfig

    return TrainConfig(name=name, batch_size=B * world, val_freq=2,
                       log_freq=2, ckpt_dir=ckpt_dir,
                       **dict(TRAIN_KW, num_steps=LOOP_STEPS))


def snapshot(state):
    opt = state.optimizer.state_dict()["state"]
    return {"model": {k: v.detach().cpu().clone()
                      for k, v in state.model.state_dict().items()},
            "opt": {f"{i}.{k}": v.detach().cpu().clone()
                    for i, s in opt.items() for k, v in s.items()},
            "step": state.step, "nonfinite": int(state.nonfinite_steps)}


def param_names(model_cfg=None):
    """The model's parameter names in the optimizer's order."""
    from raft_tpu_torch.config import RAFTConfig
    from raft_tpu_torch.models.raft import RAFT

    return [n for n, _ in RAFT(model_cfg or RAFTConfig.full())
            .named_parameters()]


def first_moments(snap, names):
    """Adam's first moment of each parameter in a :func:`snapshot` taken
    after the first step: ``1 - beta1`` times the clipped global
    gradient."""
    return {n: snap["opt"][f"{i}.exp_avg"] for i, n in enumerate(names)}


def changes(model, start, names):
    """Each parameter's change from ``start`` (both ``state_dict``s)."""
    return {n: torch.as_tensor(model[n]) - torch.as_tensor(start[n])
            for n in names}


NOISE_K = 4


def leaf_agreement(got, want, rtol, floor, noise=None):
    """Per parameter, ``|got - want|`` (the norm over its entries) against
    ``rtol * |want| + NOISE_K * noise[name] + floor * |all of want|``,
    as a ratio (<= 1 passes); the worst ratio and its parameter.
    ``noise``: the reference's own difference from a twin run that sums
    the same terms in another order.  Adam moves an entry by about
    ``lr * sign(g)`` at first, so a gradient entry within rounding of
    zero (a bias before a batch norm has no gradient but rounding) may
    move either way: the noise and the floor hold those, ``rtol`` the
    rest."""
    total = float(torch.sqrt(sum(w.double().square().sum()
                                 for w in want.values())))
    ratio = {n: float((got[n] - w).norm()) / (
        rtol * float(w.norm()) + NOISE_K * (noise or {}).get(n, 0.0)
        + floor * total) for n, w in want.items()}
    worst = max(ratio, key=ratio.get)
    return ratio[worst], worst


def noise_of(twin, ref):
    """Per parameter, the norm of ``twin - ref``."""
    return {n: float((twin[n] - ref[n]).norm()) for n in ref}


def cli_args(root, world=2):
    """The train CLI's flags: 2 chairs steps of the global batch at
    32x48 with one validation, on the tree under ``root``."""
    return ["--distributed", "--device", "cpu", "--name", "cli",
            "--stage", "chairs", "--num_steps", "2",
            "--batch_size", str(B * world), "--image_size", str(H), str(W),
            "--iters", str(ITERS), "--precision", "fp32", "--val_freq",
            "2", "--validation", "chairs", "--num_workers", "1",
            "--data_root", os.path.join(root, "datasets"),
            "--chairs_split", os.path.join(root, "chairs_split.txt"),
            "--ckpt_dir", os.path.join(root, "cli_ckpt")]


def main(out, weights, rank, world, port, device="cpu", cli_port=None):
    torch.set_num_threads(1)
    # on the card both ranks share GPU 0
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK="0" if device == "cuda" else str(rank),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    from raft_tpu_torch import chaos, config, ops
    from raft_tpu_torch.config import RAFTConfig, TrainConfig
    from raft_tpu_torch.data.datasets import ShardedLoader
    from raft_tpu_torch.parallel import init_from_env, shutdown
    from raft_tpu_torch.train import loop
    from raft_tpu_torch.train.step import init_state, make_train_step

    mesh = init_from_env(device, backend="gloo")
    assert (mesh.world, mesh.rank, mesh.backend) == (world, rank, "gloo")
    sd = torch.load(weights, weights_only=True)
    model_cfg = RAFTConfig.full()
    if device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        config.CONV_TF32 = False
        model_cfg = RAFTConfig.full(**CUDA_KW)
    res = {}

    def run_steps(batches, mcfg=None, **kw):
        cfg = TrainConfig(batch_size=B * world, **TRAIN_KW, **kw)
        state = init_state(mcfg or model_cfg, cfg, device=mesh.device,
                           state_dict=sd)
        step_fn = make_train_step(cfg, device=mesh.device, mesh=mesh)
        snaps, mets, launches = [], [], []
        for batch in batches:
            before = ops.launch_counts()
            state, m = step_fn(state, batch)
            after = ops.launch_counts()
            launches.append({k: after[k] - before[k] for k in after
                             if after[k] != before[k]})
            snaps.append(snapshot(state))
            mets.append({k: v.detach().cpu().clone() for k, v in m.items()})
        return snaps, mets, launches

    res["split"] = run_steps([rows(global_batch(s, world), rank)
                              for s in (0, 1)])
    if device == "cuda":
        shutdown()
        torch.save(res, os.path.join(out, f"rank{rank}.pt"))
        return
    res["accum"] = run_steps([rows(global_batch(s, world), rank)
                              for s in (0, 1)], accum_steps=2)[0][-1]
    res["dropout"] = run_steps([rows(global_batch(0, world), rank)],
                               RAFTConfig.full(dropout=0.3))[:2]
    bad = rows(global_batch(1, world), rank)
    if rank == 1:
        bad["image1"][0, 3, 3, 0] = np.nan
    res["nan"] = run_steps([rows(global_batch(s, world), rank) if s != -1
                            else bad for s in (0, -1, 2)])[:2]

    ckpt = os.path.join(out, "ckpt")
    ds = synth_dataset()

    def loader():
        return ShardedLoader(ds, B, seed=3, num_hosts=world, host_id=rank,
                             num_workers=1)

    whole = loop.train(RAFTConfig.full(), loop_cfg(ckpt, "whole", world),
                       loader=loader(), device="cpu", mesh=mesh,
                       log=lambda line: None)
    res["whole"] = snapshot(whole)
    if rank == 1:
        chaos.install(chaos.FaultPlan.parse(f"preempt@step={PREEMPT_AT}"))
    try:
        loop.train(RAFTConfig.full(), loop_cfg(ckpt, "cut", world),
                   loader=loader(), device="cpu", mesh=mesh,
                   log=lambda line: None)
        res["cut_exit"] = 0
    except SystemExit as e:
        res["cut_exit"] = e.code
    chaos.uninstall()
    res["cut_ckpts"] = sorted(os.listdir(os.path.join(ckpt, "cut")))
    resumed = loop.train(RAFTConfig.full(), loop_cfg(ckpt, "cut", world),
                         loader=loader(), device="cpu", mesh=mesh,
                         log=lambda line: None)
    res["resumed"] = snapshot(resumed)
    shutdown()

    def straight(batches, mcfg=None):
        cfg = TrainConfig(batch_size=B * world, **TRAIN_KW)
        state = init_state(mcfg or model_cfg, cfg, device="cpu",
                           state_dict=sd)
        step_fn = make_train_step(cfg, device="cpu")
        snaps, mets = [], []
        for batch in batches:
            state, m = step_fn(state, batch)
            snaps.append(snapshot(state))
            mets.append({k: v.clone() for k, v in m.items()})
        return snaps, mets

    if rank == 0:
        res["straight"] = straight([global_batch(s, world) for s in (0, 1)])
        res["dropout_straight"] = straight(
            [interleaved(global_batch(0, world), world)],
            RAFTConfig.full(dropout=0.3))
    else:
        res["reversed"] = straight(
            [{k: v[::-1].copy() for k, v in global_batch(s, world).items()}
             for s in (0, 1)])
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))

    if cli_port is not None:
        from raft_tpu_torch.cli import train as train_cli

        os.environ["MASTER_PORT"] = str(cli_port)
        with open(os.path.join(out, f"cli{rank}.log"), "w") as f, \
                contextlib.redirect_stdout(f):
            try:
                code = train_cli.main(cli_args(out, world))
            except SystemExit as e:
                code = e.code
        with open(os.path.join(out, f"cli{rank}.json"), "w") as f:
            json.dump({"exit": code}, f)


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    out, weights, rank, world, port = sys.argv[1:6]
    extra = sys.argv[6:7]
    if extra and extra[0] != "cuda":
        main(out, weights, int(rank), int(world), int(port),
             cli_port=int(extra[0]))
    else:
        main(out, weights, int(rank), int(world), int(port), *extra)
