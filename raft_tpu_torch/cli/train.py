"""Training CLI (the port of ``raft_tpu/cli/train.py``), with the JAX
CLI's flags::

    python -m raft_tpu_torch train --name raft-chairs --stage chairs \\
        --validation chairs --num_steps 100000 --batch_size 8 \\
        --lr 0.0004 --image_size 368 496 --wdecay 0.0001

It trains on the card unless ``--device cpu``; without CUDA it raises.
``--corr_impl auto`` is ``allpairs_pallas`` (the pyramid lookup kernel) on
the card and ``allpairs`` on the CPU.  The run directory is
``<ckpt_dir>/<name>``: a run that finds checkpoints there resumes from the
newest restorable step, and SIGTERM makes it save the last completed step
and exit with code 143.  ``--restore_ckpt`` takes such a run directory and
seeds the weights only.  ``--small`` trains the small model.

``--remat {none,full,dots,save_corr,save_corr_upsample}`` and
``--remat_upsample {0,1}`` take the JAX CLI's values.  Their defaults
here are ``none`` and ``0``, chosen on the H100 (PERF.md, the remat
table): the activations fit in the card's memory at every stage's crop,
and recomputing them costs step time.  The JAX package defaults to
``save_corr`` and ``1``, chosen on a TPU.  The CLI prints one line naming
the policy in force.

``--corr_precision`` takes the JAX CLI's values (``auto`` / ``default`` /
``high`` / ``highest``): the precision of the correlation's matrix
products, TF32 on the card for ``high`` and ``default``.  The step runs as
one captured CUDA graph per batch shape on the card and eagerly on the
CPU; there is no flag for it.

``--distributed`` trains data-parallel over the ranks ``torchrun``
describes (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``), one GPU a rank (NCCL; gloo with ``--device cpu``)::

    torchrun --nproc_per_node 4 -m raft_tpu_torch train --distributed \
        --name raft-chairs --stage chairs --batch_size 8 ...

``--batch_size`` is the global batch, rounded up to a multiple of the
world size with the learning rate scaled alike (the JAX CLI's rule);
``--batch_per_chip`` is a rank's.  Each rank reads its own stride of the
shuffle; rank 0 writes the checkpoints, validates and logs; SIGTERM on
any rank stops every rank after the same step.

A JAX flag that the port cannot honour yet raises ``SystemExit`` naming
its ROADMAP item whenever it is set away from its default; never a silent
ignore.  ``--scan_unroll`` has no counterpart and is refused with its
reason: the captured graph already holds every iteration.
"""

from __future__ import annotations

import argparse
import functools
import os
import os.path as osp
import signal

from raft_tpu_torch.config import (QUANTIZED_CORR_DTYPES,
                                   validate_corr_dtype,
                                   validate_corr_precision)

# flag -> (the JAX default, the ROADMAP item that ports what it does)
UNPORTED = {
    "shard_spatial": (1, "A6 (spatial sharding)"),
    "profile_dir": (None, "A8 (observability)"),
    "telemetry_dir": (None, "A8 (observability)"),
    "trace_sample_rate": (None, "A8 (observability)"),
    "watchdog_timeout": (0.0, "A8 (observability)"),
    "watchdog_exit": (False, "A8 (observability)"),
    "profile_steps": (None, "A8 (observability)"),
    "forensic_keep": (8, "A8 (observability; the forensics ring)"),
}


def _corr_dtype_arg(value: str) -> str:
    try:
        return validate_corr_dtype(value)
    except ValueError as e:
        raise argparse.ArgumentTypeError(str(e))


def _corr_precision_arg(value: str) -> str:
    try:
        return validate_corr_precision(value)
    except ValueError as e:
        raise argparse.ArgumentTypeError(str(e))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="RAFT training (PyTorch port)")
    p.add_argument("--name", default="raft", help="experiment name")
    p.add_argument("--stage", default="chairs",
                   choices=["chairs", "things", "sintel", "kitti"])
    p.add_argument("--restore_ckpt", default=None,
                   help="run directory of a previous stage (weights only)")
    p.add_argument("--small", action="store_true")
    p.add_argument("--validation", nargs="+", default=[],
                   choices=["chairs", "sintel", "kitti"])
    p.add_argument("--lr", type=float, default=4e-4)
    p.add_argument("--num_steps", type=int, default=100000)
    p.add_argument("--batch_size", type=int, default=6)
    p.add_argument("--batch_per_chip", type=int, default=None,
                   help="the batch of one rank (one GPU); overrides "
                        "--batch_size")
    p.add_argument("--image_size", type=int, nargs=2, default=[384, 512])
    p.add_argument("--precision", default="bf16", choices=["bf16", "fp32"])
    p.add_argument("--iters", type=int, default=12)
    p.add_argument("--wdecay", type=float, default=1e-4)
    p.add_argument("--epsilon", type=float, default=1e-8)
    p.add_argument("--clip", type=float, default=1.0)
    p.add_argument("--dropout", type=float, default=0.0)
    p.add_argument("--gamma", type=float, default=0.8,
                   help="exponential loss weighting")
    p.add_argument("--add_noise", action="store_true")
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--val_freq", type=int, default=5000,
                   help="checkpoint + validation cadence in steps")
    p.add_argument("--remat", default="none",
                   choices=["save_corr", "save_corr_upsample", "full",
                            "dots", "none"],
                   help="backward rematerialization of the refinement step "
                        "(default none: the activations fit on the card; "
                        "PERF.md)")
    p.add_argument("--remat_upsample", type=int, default=0, choices=[0, 1],
                   help="rematerialize the mask head and upsample (+ loss) "
                        "in backward")
    p.add_argument("--corr_levels", type=int, default=None)
    p.add_argument("--corr_radius", type=int, default=None)
    p.add_argument("--scan_unroll", type=int, default=None)
    p.add_argument("--corr_dtype", default="auto", type=_corr_dtype_arg,
                   help="storage dtype of the materialized correlation "
                        "pyramid (auto / float32 / bfloat16 / int8 / "
                        "float8_e4m3fn / float8_e5m2)")
    p.add_argument("--corr_precision", default="auto",
                   type=_corr_precision_arg,
                   help="precision of the correlation's matrix products "
                        "(auto / default / high / highest)")
    p.add_argument("--corr_impl", default="auto",
                   choices=["auto", "allpairs", "allpairs_pallas",
                            "chunked", "pallas"],
                   help="'auto' = allpairs_pallas on the card (the pyramid "
                        "lookup kernel), allpairs on the CPU")
    p.add_argument("--data_root", default="datasets")
    p.add_argument("--chairs_split", default="chairs_split.txt")
    p.add_argument("--ckpt_dir", default="checkpoints")
    p.add_argument("--tensorboard_dir", default=None)
    p.add_argument("--profile_dir", default=None)
    p.add_argument("--telemetry_dir", "--telemetry-dir", default=None)
    p.add_argument("--num_workers", type=int, default=0,
                   help="loader threads; 0 = min(16, usable CPUs)")
    p.add_argument("--accum_steps", "--accum-steps", type=int, default=1,
                   help="gradient-accumulation microbatches per step")
    p.add_argument("--prefetch_batches", "--prefetch-batches", type=int,
                   default=0,
                   help="loader decode window in batches; 0 = "
                        "max(2*batch, 2*workers) samples")
    p.add_argument("--device_prefetch", "--device-prefetch", type=int,
                   default=2,
                   help="batches prepared and copied to the device ahead "
                        "of the step; 0 = the serial path")
    p.add_argument("--ckpt_commit_window", "--ckpt-commit-window",
                   type=int, default=2,
                   help="background checkpoint commits in flight")
    p.add_argument("--nonfinite_guard", "--nonfinite-guard", type=int,
                   default=1, choices=[0, 1],
                   help="skip the update of a step whose loss or gradients "
                        "are not finite")
    p.add_argument("--forensic_keep", "--forensic-keep", type=int,
                   default=8)
    p.add_argument("--watchdog_timeout", "--watchdog-timeout",
                   type=float, default=0.0, metavar="SECONDS")
    p.add_argument("--watchdog_exit", "--watchdog-exit",
                   action="store_true")
    p.add_argument("--trace_sample_rate", "--trace-sample-rate",
                   type=float, default=None, metavar="RATE")
    p.add_argument("--profile_steps", "--profile-steps", default=None,
                   metavar="A:B")
    p.add_argument("--shard_spatial", type=int, default=1, metavar="N")
    p.add_argument("--distributed", action="store_true",
                   help="data parallel over the ranks torchrun starts "
                        "(rank, world size and rendezvous from the "
                        "environment)")
    p.add_argument("--chaos", default=None,
                   help="fault-injection spec, e.g. "
                        "'corrupt_image@step=7;torn_ckpt@step=50'; "
                        "default $RAFT_CHAOS_SPEC")
    p.add_argument("--chaos-seed", type=int, default=None,
                   help="seed of probabilistic chaos rules (default "
                        "$RAFT_CHAOS_SEED or 0)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def check_unported(args) -> None:
    """``SystemExit`` naming the ROADMAP item for a flag set away from its
    JAX default that the port cannot honour yet, or the reason a flag has
    no counterpart."""
    if args.scan_unroll is not None:
        raise SystemExit(
            f"--scan_unroll {args.scan_unroll!r}: no counterpart in the "
            "PyTorch port: the train step runs as one captured CUDA graph "
            "that already holds every iteration, so there is no scan to "
            "unroll; leave it unset")
    for flag, (default, item) in UNPORTED.items():
        value = getattr(args, flag)
        if value != default:
            raise SystemExit(
                f"--{flag} {value!r}: not in the PyTorch port yet "
                f"(ROADMAP {item}); leave it at its default {default!r}")


def remat_kwargs(args, say=print) -> dict:
    """The ``RAFTConfig`` remat fields of ``--remat`` and
    ``--remat_upsample`` (the JAX CLI's map), after one line naming the
    policy in force (through ``say``)."""
    say(f"remat: --remat {args.remat} --remat_upsample "
        f"{args.remat_upsample}"
        + (" (the port's defaults, chosen on the H100)"
           if (args.remat, args.remat_upsample) == ("none", 0) else ""),
        flush=True)
    return dict(remat=args.remat != "none",
                remat_policy=(args.remat if args.remat != "none"
                              else "save_corr"),
                remat_upsample=bool(args.remat_upsample))


def resolve_batch(batch_size, batch_per_chip, num_devices, lr):
    """``(global batch, lr)`` on ``num_devices`` ranks (the JAX CLI's
    rule): ``batch_per_chip`` pins a rank's batch; otherwise a global
    ``batch_size`` that the ranks do not divide is rounded up to the
    next multiple and the learning rate scaled with the batch."""
    if batch_per_chip is not None:
        if batch_per_chip <= 0:
            raise SystemExit(f"--batch_per_chip must be > 0, got "
                             f"{batch_per_chip}")
        return batch_per_chip * num_devices, lr
    if batch_size <= 0:
        raise SystemExit(f"--batch_size must be > 0, got {batch_size}")
    rounded = -(-batch_size // num_devices) * num_devices
    if rounded != batch_size:
        lr = lr * (rounded / batch_size)
    return rounded, lr


def run(argv=None):
    """Parse flags, build the stage and train; returns the final
    ``TrainState``."""
    args = parse_args(argv)
    check_unported(args)
    from raft_tpu_torch.parallel import mesh as mesh_mod

    mesh = None
    if args.distributed:
        try:
            mesh = mesh_mod.init_from_env(args.device)
        except RuntimeError as e:
            raise SystemExit(f"--distributed: {e}")
    try:
        return _run(args, mesh)
    finally:
        if mesh is not None:
            mesh_mod.shutdown()


def _run(args, mesh):
    from raft_tpu_torch import chaos

    if args.chaos:
        os.environ[chaos.ENV_SPEC] = args.chaos
    if args.chaos_seed is not None:
        os.environ[chaos.ENV_SEED] = str(args.chaos_seed)
    try:
        chaos.install_from_env()
    except chaos.ChaosSpecError as e:
        raise SystemExit(f"--chaos: {e}")

    from raft_tpu_torch import evaluate
    from raft_tpu_torch.config import RAFTConfig, TrainConfig
    from raft_tpu_torch.data.datasets import ShardedLoader, fetch_dataset
    from raft_tpu_torch.train.checkpoint import CheckpointManager
    from raft_tpu_torch.train.loop import request_preemption, train

    device = mesh.device if mesh is not None else \
        evaluate.resolve_device(args.device)
    world = 1 if mesh is None else mesh.world
    rank = 0 if mesh is None else mesh.rank
    compute_dtype = "bfloat16" if args.precision == "bf16" else "float32"
    corr_impl = args.corr_impl
    if corr_impl == "auto":
        corr_impl = ("allpairs_pallas" if device.type == "cuda"
                     else "allpairs")
    if (args.corr_dtype in QUANTIZED_CORR_DTYPES
            and corr_impl in ("chunked", "pallas")):
        raise SystemExit(
            f"--corr_dtype {args.corr_dtype} requires a materialized "
            f"correlation pyramid (--corr_impl allpairs or "
            f"allpairs_pallas); the on-demand {corr_impl!r} path never "
            "stores the volume, so there is nothing to quantize")
    mk = RAFTConfig.small_model if args.small else RAFTConfig.full
    model_cfg = mk(
        dropout=args.dropout, corr_impl=corr_impl,
        compute_dtype=compute_dtype, corr_dtype=args.corr_dtype,
        corr_precision=args.corr_precision,
        **remat_kwargs(args, print if rank == 0 else lambda *a, **k: None),
        **{k: v for k, v in (("corr_levels", args.corr_levels),
                             ("corr_radius", args.corr_radius))
           if v is not None})
    batch_size, lr = resolve_batch(args.batch_size, args.batch_per_chip,
                                   world, args.lr)
    if (batch_size, lr) != (args.batch_size, args.lr) and rank == 0:
        print(f"batch {args.batch_size} -> {batch_size} over {world} "
              f"rank(s)" + (f", lr {args.lr:g} -> {lr:g} (linear "
                            f"scaling)" if lr != args.lr else ""),
              flush=True)
    if args.accum_steps < 1:
        raise SystemExit(f"--accum_steps must be >= 1, got "
                         f"{args.accum_steps}")
    per_rank_batch = batch_size // world
    if per_rank_batch % args.accum_steps:
        raise SystemExit(
            f"--accum_steps {args.accum_steps} must divide the per-rank "
            f"batch size {per_rank_batch} (global {batch_size} over "
            f"{world} rank(s)) evenly — pick a batch size that is a "
            f"multiple of accum_steps * ranks")
    if args.prefetch_batches < 0 or args.device_prefetch < 0:
        raise SystemExit("--prefetch_batches / --device_prefetch must "
                         "be >= 0")
    if args.num_workers < 0:
        raise SystemExit(f"--num_workers must be >= 0, got "
                         f"{args.num_workers}")
    cfg = TrainConfig(
        name=args.name, stage=args.stage, restore_ckpt=args.restore_ckpt,
        validation=tuple(args.validation), lr=lr,
        num_steps=args.num_steps, batch_size=batch_size,
        image_size=tuple(args.image_size), iters=args.iters,
        wdecay=args.wdecay, epsilon=args.epsilon, clip=args.clip,
        gamma=args.gamma, add_noise=args.add_noise, seed=args.seed,
        val_freq=args.val_freq,
        freeze_bn=args.stage != "chairs",  # reference train.py:147-148
        accum_steps=args.accum_steps,
        prefetch_batches=args.prefetch_batches,
        device_prefetch=args.device_prefetch,
        nonfinite_guard=bool(args.nonfinite_guard),
        ckpt_dir=args.ckpt_dir,
        ckpt_commit_window=max(args.ckpt_commit_window, 1))
    dataset = fetch_dataset(args.stage, tuple(args.image_size),
                            root=args.data_root,
                            split_file=args.chairs_split)
    num_workers = args.num_workers or min(16, len(os.sched_getaffinity(0)))
    loader = ShardedLoader(dataset, per_rank_batch, seed=args.seed,
                           num_hosts=world, host_id=rank,
                           num_workers=num_workers,
                           prefetch_batches=args.prefetch_batches)

    restore = None
    if args.restore_ckpt:
        restore = CheckpointManager(args.restore_ckpt).restore_params()
        if restore is None:
            raise SystemExit(f"--restore_ckpt: no checkpoint in "
                             f"{args.restore_ckpt}")
        print(f"restored weights from {args.restore_ckpt}", flush=True)

    roots = {
        "chairs": dict(root=osp.join(args.data_root,
                                     "FlyingChairs_release/data"),
                       split_file=args.chairs_split),
        "sintel": dict(root=osp.join(args.data_root, "Sintel")),
        "kitti": dict(root=osp.join(args.data_root, "KITTI")),
    }
    val_iters = {"chairs": 24, "sintel": 32, "kitti": 24}
    validators = {
        name: functools.partial(
            evaluate.VALIDATORS[name], model_cfg=model_cfg,
            iters=val_iters[name],
            eval_fn=evaluate.make_eval_fn(model_cfg, val_iters[name],
                                          device=device),
            device=device, **roots[name])
        for name in (args.validation if rank == 0 else ())
    }

    # SIGTERM -> the cooperative flag: the loop exits at the next step
    # boundary (across ranks: the first one any rank's flag reaches) with
    # a checkpoint of the last completed step
    previous = signal.signal(signal.SIGTERM,
                             lambda signum, frame: request_preemption())
    try:
        return train(model_cfg, cfg, loader=loader,
                     validators=validators or None, restore_params=restore,
                     tensorboard_dir=args.tensorboard_dir, device=device,
                     mesh=mesh)
    finally:
        signal.signal(signal.SIGTERM, previous)


def main(argv=None):
    run(argv)
    return 0


if __name__ == "__main__":
    main()
