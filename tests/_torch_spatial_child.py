"""One rank of the spatially sharded gloo runs of
``tests/test_torch_spatial.py`` (torch only: it imports neither JAX nor
``raft_tpu``).

    python tests/_torch_spatial_child.py OUT WEIGHTS RANK WORLD PORT CLI_PORT

joins a ``data (WORLD / 2) x spatial 2`` mesh at ``localhost:PORT``
through ``raft_tpu_torch.parallel.init_from_env(spatial=2)`` (rank
``d * 2 + s`` holds rows ``[s*H/2, (s+1)*H/2)`` of data index ``d``'s
samples) and runs, from the port ``state_dict`` in ``WEIGHTS``:

- ``split``: two chairs steps (batch norm trained) of ``corr_impl``
  ``allpairs``, ``allpairs_pallas`` and ``pallas`` (their plain versions
  on the CPU) on this rank's rows of its data index's samples of
  :func:`_torch_ddp_child.global_batch` 0 and 1 (data index d takes the
  samples ``d*B:(d+1)*B``, the JAX package's ``data`` shards);
- ``split_big``: one ``allpairs`` step at :data:`JAX_HW` the same way
  (global batch 0 at that size);
- ``collectives``: :func:`halo_rows` and :func:`all_gather_rows` forward
  against the whole image's zero-padded rows and through ``gradcheck``
  in fp64, including a halo taller than a shard;
- ``instance``: instance norm over the spatial group against
  ``F.instance_norm`` on the whole image (forward and input gradient),
  and the feature encoder in fp64 against the whole image's;
- ``remat``: the loss's gradients under each remat policy (and
  ``remat_upsample``) with the backward on another thread, against the
  same without remat (:func:`_remat`);
- ``loop``: :func:`raft_tpu_torch.train.loop.train` resuming a one-rank
  checkpoint (``OUT/one_rank``, written by the parent at step 1) under
  the sharded mesh to step 2;
- ``straight`` (after leaving the group, one configuration a rank): the
  two steps in one process on the global batches: rank 0 ``allpairs``,
  rank 1 ``allpairs_pallas``, rank 2 ``pallas``, rank 0 also the
  one-rank resume of ``loop``; rank 3 the reference's own rounding
  noise, ``allpairs`` on the batches with their rows reversed
  (``reversed``) and with instance norm's sums taken over the row
  shards (``row_shards``, :func:`instance_norm_over_row_shards`); at
  :data:`JAX_HW` rank 1 the straight step and its reversed twin
  (``straight_big``, ``reversed_big``), rank 2 its row-shards twin,
  rank 3 its twin with batch norm's moments in the sharded step's two
  passes (``two_pass_big``, :func:`batch_norm_in_two_passes`);

and writes what the parent compares to ``OUT/rank<RANK>.pt``.  Then it
runs the train CLI's ``main`` with ``--distributed --shard_spatial 2
--device cpu --small`` on the chairs tree under ``OUT`` (the port's twin
of ``tests/test_cli.py::test_train_cli_spatial_sharding``), its
standard output in ``OUT/cli<RANK>.log`` and its exit code in
``OUT/cli<RANK>.json``.

    python tests/_torch_spatial_child.py OUT WEIGHTS RANK 2 PORT cuda

shares the card between 2 ranks over gloo (``data 1 x spatial 2``) and
runs only ``split`` in :data:`CUDA_KW`'s kernel configuration (fp32, TF32
off), with each step's kernel launch counts, and its first step again
with ``remat`` (``full``) and ``remat_upsample`` (``split_remat``;
``tests/test_torch_cuda.py``).
"""

import contextlib
import json
import os
import sys

import numpy as np
import torch

import _torch_ddp_child as ddp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
# the straight run's twin with instance norm's sums over the row shards
from chip_smoke import instance_norm_over_row_shards  # noqa: E402

B, H, W, ITERS = ddp.B, ddp.H, ddp.W, ddp.ITERS   # B: a data index's
N = 2                                              # the spatial ranks
IMPLS = ("allpairs", "allpairs_pallas", "pallas")
CUDA_KW = ddp.CUDA_KW
CLI_HW = (64, 96)
# where every 1/8-resolution shard holds the 3 rows that convf1's 7x7
# reads beyond it: JAX's partitioned backward is right only there
JAX_HW = (64, 96)


@contextlib.contextmanager
def batch_norm_in_two_passes():
    """Batch norm's moments as the sharded step takes them (the sum, then
    the squared deviations: ``layers._global_moments``) in place of
    ``torch.var_mean``: the straight run's twin whose difference from it
    is fp32 rounding alone.  At 64x96 the two orders put ``cnet``'s lower
    layers' gradients ~1.6e-3 of their norm apart (in fp64 they agree
    to 1e-15)."""
    real = torch.var_mean

    def two_pass(x, dim, correction=0):
        n = 1
        for d in dim:
            n *= x.shape[d]
        mean = x.sum(dim=dim, keepdim=True) / n
        var = ((x - mean) ** 2).sum(dim=dim) / n
        return var, mean.reshape(var.shape)

    torch.var_mean = two_pass
    try:
        yield
    finally:
        torch.var_mean = real


def rows(batch, d, s, b=B, n=N):
    """Rank ``(d, s)``'s part of a global batch: data index ``d``'s
    samples, spatial shard ``s``'s rows."""
    h = batch["image1"].shape[1] // n
    return {k: np.ascontiguousarray(v[d * b:(d + 1) * b, s * h:(s + 1) * h])
            for k, v in batch.items()}


def cli_args(root, world):
    """The train CLI's flags: one small-model chairs step of a global
    batch of 4 at 64x96, split over the data indices and 2 row shards."""
    return ["--distributed", "--shard_spatial", str(N), "--device", "cpu",
            "--small", "--name", "spatial", "--stage", "chairs",
            "--num_steps", "1", "--batch_size", "4", "--image_size",
            *map(str, CLI_HW), "--iters", "2", "--precision", "fp32",
            "--num_workers", "1",
            "--data_root", os.path.join(root, "datasets"),
            "--chairs_split", os.path.join(root, "chairs_split.txt"),
            "--ckpt_dir", os.path.join(root, "cli_ckpt")]


def loop_cfg(ckpt_dir, name="resume"):
    from raft_tpu_torch.config import TrainConfig

    return TrainConfig(name=name, batch_size=B * 2, val_freq=2, log_freq=2,
                       ckpt_dir=ckpt_dir,
                       **dict(ddp.TRAIN_KW, num_steps=2))


def _collectives(mesh):
    """Case (d): the halo exchange and the row all-gather on ``(1, 2, h,
    3)`` fp64 shards of a seeded image (h = 4), forward equal to the
    whole image's rows, and ``gradcheck`` of the sharded function of the
    whole (replicated) input, whose output is the whole gathered result:
    a halo of 1, 3 (rows beyond the neighbour) and 6 rows (taller than a
    shard) above and below; and an int8 pyramid of the shard's queries
    against the whole ``fmap2``, the whole volume's codes and scales."""
    from raft_tpu_torch.parallel import mesh as mesh_mod

    s, n = mesh.spatial_index, mesh.spatial
    gen = torch.Generator().manual_seed(10 + mesh.data_index)
    h = 4
    whole = torch.randn(1, 2, h * n, 3, generator=gen, dtype=torch.float64)

    class Slice(torch.autograd.Function):
        """The rank's rows of a replicated input.  Every rank runs the
        same check, so the gathered output's gradient arrives once from
        each rank: the input's gradient is the ranks' sum over ``n``."""

        @staticmethod
        def forward(ctx, t):
            return t[:, :, s * h:(s + 1) * h].clone()

        @staticmethod
        def backward(ctx, g):
            full = g.new_zeros((*g.shape[:2], h * n, g.shape[3]))
            full[:, :, s * h:(s + 1) * h] = g
            return mesh_mod.all_reduce_sum(full, mesh, True) / n

    res = {}
    for top, bottom in ((1, 1), (3, 2), (6, 5)):
        got = mesh_mod.halo_rows(whole[:, :, s * h:(s + 1) * h], top,
                                 bottom, mesh)
        pad = torch.nn.functional.pad(whole, (0, 0, top, bottom))
        want = pad[:, :, s * h:s * h + h + top + bottom]
        res[f"halo {top},{bottom} fwd"] = bool(torch.equal(got, want))

        def f(t, top=top, bottom=bottom):
            # the gathered result: every rank's halo'd shard, whole
            y = mesh_mod.halo_rows(Slice.apply(t), top, bottom, mesh)
            return mesh_mod.all_gather_rows(y, mesh) / n

        res[f"halo {top},{bottom} gradcheck"] = torch.autograd.gradcheck(
            f, (whole.clone().requires_grad_(True),), raise_exception=False)
    got = mesh_mod.all_gather_rows(whole[:, :, s * h:(s + 1) * h], mesh)
    res["gather fwd"] = bool(torch.equal(got, whole))
    res["gather gradcheck"] = torch.autograd.gradcheck(
        lambda t: mesh_mod.all_gather_rows(Slice.apply(t), mesh) / n,
        (whole.clone().requires_grad_(True),), raise_exception=False)
    nhwc = whole.permute(0, 2, 3, 1).contiguous()
    got = mesh_mod.all_gather_rows(nhwc[:, s * h:(s + 1) * h], mesh, dim=1)
    res["gather NHWC fwd"] = bool(torch.equal(got, nhwc))
    # an int8 pyramid of the shard's queries against the whole fmap2: the
    # whole volume's codes of its rows and the whole volume's scales
    from raft_tpu_torch.ops.corr import build_corr_pyramid

    f1 = torch.randn(2, 4 * n, 6, 32, generator=gen)
    f2 = torch.randn(2, 4 * n, 6, 32, generator=gen)
    want = build_corr_pyramid(f1, f2, 2, "int8")
    with mesh_mod.use(mesh):
        got = build_corr_pyramid(f1[:, 4 * s:4 * (s + 1)].contiguous(), f2,
                                 2, "int8")
    rows = slice(4 * 6 * s, 4 * 6 * (s + 1))       # the shard's queries
    res["int8 pyramid"] = all(
        torch.equal(g.values, w.values[:, rows])
        and torch.equal(g.scale, w.scale) for g, w in zip(got, want))
    return res


def _instance(mesh):
    """Case (e): instance norm over the spatial group against
    ``F.instance_norm`` of the whole image (fp32: forward and the input
    gradient of a seeded weighted sum, max abs), and the feature encoder
    (halo convs + instance norms) in fp64 against the whole image's,
    its output and every parameter's gradient (the largest difference
    over the norm of the whole gradient)."""
    import torch.nn.functional as F

    from raft_tpu_torch.models import layers
    from raft_tpu_torch.models.extractor import BasicEncoder
    from raft_tpu_torch.parallel import mesh as mesh_mod

    s, n = mesh.spatial_index, mesh.spatial
    gen = torch.Generator().manual_seed(20 + mesh.data_index)
    x = torch.randn(2, 8, 8 * n, 6, generator=gen) * 3 + 1
    w = torch.randn(x.shape, generator=gen)
    sl = slice(s * 8, (s + 1) * 8)
    xw = x.clone().requires_grad_(True)
    yw = F.instance_norm(xw, eps=1e-5)
    (gw,) = torch.autograd.grad((w * yw).sum(), xw)
    xs = x[:, :, sl].clone().requires_grad_(True)
    with mesh_mod.use(mesh):
        ys = layers.Norm("instance", 8)(xs)
    (gs,) = torch.autograd.grad((w[:, :, sl] * ys).sum(), xs)
    res = {"norm fwd": float((ys - yw[:, :, sl]).abs().max()),
           "norm grad": float((gs - gw[:, :, sl]).abs().max()),
           "norm scale": float(gw.abs().max())}

    # the encoder in fp64: Norm computes in fp32, so its instance branch
    # runs here in the input's dtype, through the same moments
    def norm64(self, x, freeze_bn=False):
        m = mesh_mod.active_spatial()
        if m is None:
            return F.instance_norm(x, eps=1e-5)
        mean, var = layers._spatial_moments(x, m)
        return (x - mean[..., None, None]) * torch.rsqrt(
            var + 1e-5)[..., None, None]

    enc = BasicEncoder(256, "instance")
    g = torch.Generator().manual_seed(0)
    for m in enc.modules():
        if isinstance(m, (layers.Conv, layers.Norm)):
            m.init_(g)
    enc = enc.double().train()
    x = torch.randn(2, 3, 16 * n, 24, generator=gen, dtype=torch.float64)
    w = torch.randn(2, 256, 2 * n, 3, generator=gen, dtype=torch.float64)
    saved = layers.Norm.forward
    layers.Norm.forward = norm64
    try:
        yw = enc(x)
        (w * yw).sum().backward()
        whole = {k: p.grad.clone() for k, p in enc.named_parameters()}
        enc.zero_grad()
        with mesh_mod.use(mesh):
            ys = enc(x[:, :, s * 16:(s + 1) * 16])
            (w[:, :, 2 * s:2 * (s + 1)] * ys).sum().backward()
    finally:
        layers.Norm.forward = saved
    # each parameter's difference over the whole gradient's norm (a conv
    # bias ahead of a norm has a zero gradient, rounding noise alone)
    total = float(torch.sqrt(sum(g.square().sum() for g in whole.values())))
    worst = 0.0
    for k, p in enc.named_parameters():
        t = mesh_mod.all_reduce_sum(p.grad, mesh, True)
        worst = max(worst, float((t - whole[k]).norm()) / total)
    res["encoder fp64 fwd"] = float(
        (ys - yw[:, :, 2 * s:2 * (s + 1)]).abs().max())
    res["encoder fp64 grad rel"] = worst
    return res


REMAT_POLICIES = ("full", "dots", "save_corr")


def _remat(mesh, sd, batch):
    """Case (i): under the mesh, the loss's gradients on this rank with
    ``remat`` (each of :data:`REMAT_POLICIES`) and ``remat_upsample``
    against the same without remat, the forward on this thread and the
    backward on another, as autograd runs a CUDA backward (on its own
    thread, where no mesh is active, it re-runs the checkpointed
    convolutions): per policy the largest difference of a parameter's
    gradient over that parameter's gradient's norm."""
    import threading

    from raft_tpu_torch.config import RAFTConfig, TrainConfig
    from raft_tpu_torch.parallel import mesh as mesh_mod
    from raft_tpu_torch.train.step import init_state, make_loss_fn

    cfg = TrainConfig(batch_size=B * mesh.data_size, **ddp.TRAIN_KW)
    batch = {k: torch.as_tensor(v, dtype=torch.float32)
             for k, v in batch.items()}

    def grads(**kw):
        model = init_state(RAFTConfig.full(**kw), cfg, device="cpu",
                           state_dict=sd).model.train()
        with mesh_mod.use(mesh):
            loss, _ = make_loss_fn(cfg)(model, batch)
        worker = threading.Thread(target=loss.backward)
        worker.start()
        worker.join()
        return {n: p.grad.clone() for n, p in model.named_parameters()
                if p.grad is not None}

    want = grads()
    res = {}
    for policy in REMAT_POLICIES:
        got = grads(remat=True, remat_policy=policy, remat_upsample=True)
        res[policy] = max(float(
            (got.get(n, torch.zeros_like(w)) - w).norm()
            / w.norm().clamp_min(1e-30)) for n, w in want.items())
    return res


def main(out, weights, rank, world, port, device="cpu", cli_port=None):
    torch.set_num_threads(1)
    # on the card both ranks share GPU 0
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK="0" if device == "cuda" else str(rank),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    from raft_tpu_torch import config, ops
    from raft_tpu_torch.config import RAFTConfig, TrainConfig
    from raft_tpu_torch.data.datasets import ShardedLoader
    from raft_tpu_torch.parallel import init_from_env, shutdown
    from raft_tpu_torch.train import loop
    from raft_tpu_torch.train.step import init_state, make_train_step

    mesh = init_from_env(device, backend="gloo", spatial=N)
    assert (mesh.world, mesh.rank, mesh.spatial) == (world, rank, N)
    d, s, D = mesh.data_index, mesh.spatial_index, mesh.data_size
    sd = torch.load(weights, weights_only=True)
    if device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        config.CONV_TF32 = False
    res = {"mesh_shape": mesh.mesh_shape()}

    def run_steps(batches, mcfg, dev, m=None, **kw):
        cfg = TrainConfig(batch_size=B * D, **dict(ddp.TRAIN_KW, **kw))
        state = init_state(mcfg, cfg, device=dev, state_dict=sd)
        step_fn = make_train_step(cfg, device=dev, mesh=m)
        snaps, mets, launches = [], [], []
        for batch in batches:
            before = ops.launch_counts()
            state, met = step_fn(state, batch)
            after = ops.launch_counts()
            launches.append({k: after[k] - before[k] for k in after
                             if after[k] != before[k]})
            snaps.append(ddp.snapshot(state))
            mets.append({k: v.detach().cpu().clone() for k, v in
                         met.items()})
        return snaps, mets, launches

    mine = [rows(ddp.global_batch(k, D), d, s) for k in (0, 1)]
    if device == "cuda":
        res["split"] = run_steps(mine, RAFTConfig.full(**CUDA_KW),
                                 mesh.device, mesh)
        # the first step again with every remat region recomputed on
        # autograd's device thread
        res["split_remat"] = run_steps(
            mine[:1], RAFTConfig.full(**CUDA_KW, remat=True,
                                      remat_policy="full",
                                      remat_upsample=True),
            mesh.device, mesh)
        shutdown()
        torch.save(res, os.path.join(out, f"rank{rank}.pt"))
        return
    res["split"] = {impl: run_steps(mine, RAFTConfig.full(corr_impl=impl),
                                    "cpu", mesh) for impl in IMPLS}
    big = [ddp.global_batch(0, D, hw=JAX_HW)]
    res["split_big"] = run_steps([rows(big[0], d, s)], RAFTConfig.full(),
                                 "cpu", mesh, image_size=JAX_HW)
    res["collectives"] = _collectives(mesh)
    res["instance"] = _instance(mesh)
    res["remat"] = _remat(mesh, sd, mine[0])

    ckpt = os.path.join(out, "one_rank")
    ds = ddp.synth_dataset()
    lines = []
    resumed = loop.train(RAFTConfig.full(), loop_cfg(ckpt), loader=(
        ShardedLoader(ds, B, seed=3, num_hosts=D, host_id=d,
                      num_workers=1)), device="cpu", mesh=mesh,
        log=lambda line: None)
    res["loop"] = ddp.snapshot(resumed)
    shutdown()

    # the straight references, one a rank (rank 3: the noise twins)
    whole = [ddp.global_batch(k, D) for k in (0, 1)]
    if rank < len(IMPLS):
        res["straight"] = run_steps(
            whole, RAFTConfig.full(corr_impl=IMPLS[rank]), "cpu")[:2]
    if rank == 1:           # at JAX_HW: the straight step and its twins
        res["straight_big"] = run_steps(big, RAFTConfig.full(), "cpu",
                                        image_size=JAX_HW)[:2]
        res["reversed_big"] = run_steps(
            [{k: v[::-1].copy() for k, v in big[0].items()}],
            RAFTConfig.full(), "cpu", image_size=JAX_HW)[:2]
    elif rank == 2:
        with instance_norm_over_row_shards():
            res["row_shards_big"] = run_steps(
                big, RAFTConfig.full(), "cpu", image_size=JAX_HW)[:2]
    if rank == 3:
        with batch_norm_in_two_passes():
            res["two_pass_big"] = run_steps(
                big, RAFTConfig.full(), "cpu", image_size=JAX_HW)[:2]
        res["reversed"] = run_steps(
            [{k: v[::-1].copy() for k, v in b.items()} for b in whole],
            RAFTConfig.full(), "cpu")[:2]
        with instance_norm_over_row_shards():
            res["row_shards"] = run_steps(whole, RAFTConfig.full(),
                                          "cpu")[:2]
    if rank == 0:
        # the one-rank resume of the same checkpoint, in a copy
        import shutil

        ref = os.path.join(out, "one_rank_ref")
        shutil.copytree(ckpt, ref)
        shutil.rmtree(os.path.join(ref, "resume", "2"), ignore_errors=True)
        state = loop.train(RAFTConfig.full(), loop_cfg(ref), loader=(
            ShardedLoader(ds, B * D, seed=3, num_workers=1)), device="cpu",
            log=lines.append)
        res["loop_straight"] = ddp.snapshot(state)
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))

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
    out, weights, rank, world, port, extra = sys.argv[1:7]
    if extra == "cuda":
        main(out, weights, int(rank), int(world), int(port), "cuda")
    else:
        main(out, weights, int(rank), int(world), int(port),
             cli_port=int(extra))
