#!/usr/bin/env python3
"""Data-parallel scaling of the port's chairs train step over the GPUs of
one host: NCCL, the step captured as a CUDA graph with its all-reduces.

    python3 ddp_scale.py                        # worlds 1, 2, 4 (<= GPUs)
    python3 ddp_scale.py --out build/ddp_scale.json
    python3 ddp_scale.py --device cpu --worlds 1 4 --hw 32 48 --iters 2 \\
        --batch 4 --steps 4                     # gloo ranks on the CPU
    python3 ddp_scale.py --spatial 2 --hw 448 1024 --batch 2
                                                # rows split over 2 ranks

For each world size W, W processes (one a GPU) join a process group at a
free ``localhost`` port and train the chairs stage (368x496, 12
iterations, bf16, the train CLI's defaults: the pyramid lookup kernel,
batch norm trained) from the same seeded weights, through
``make_train_step(cfg, mesh=...)``, in two settings:

- ``weak``: ``--batch`` pairs a rank (global ``W * batch``);
- ``strong``: a global batch of ``--batch`` pairs, ``batch / W`` a rank
  (the same global batches at every W).

Each setting runs ``--steps`` steps (the first eager, the second the
capture), then ``--timed`` timed steps.  Rank 0 reports ms/step, global
pairs/s, device busy and idle share over two replays (``torch.profiler``)
and the device ms of the NCCL kernels in them, the all-reduce's share of
the step; every rank reports its parameters' checksum, which must agree
(the ranks stay bit for bit one another), and the losses, which the
strong setting holds against world 1 within 2e-3 relative (bf16).  One
JSON line per (W, setting), then the card's name and power limit.

``--spatial N`` splits each image's rows over N ranks as well
(``train --shard_spatial``): a world of W > 1 ranks forms W / N data
indices, and the batches above count a data index's pairs where they
count a rank's (weak: ``--batch`` a data index; strong: ``--batch / (W /
N)``); world 1 stays the unsharded step, so the strong setting's losses
are held against the whole images.  The profile then also reports the
NCCL share of the halo exchanges and gathers with the gradient's.

On the CPU (``--device cpu``) the ranks use gloo and run eagerly: a
rehearsal of the same code at a small size; its times say nothing of the
card.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import statistics
import subprocess
import sys
import time


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _batch(seed: int, n: int, hw, device):
    import numpy as np
    import torch

    rng = np.random.default_rng(200 + seed)
    H, W = hw
    b = {"image1": rng.uniform(0, 255, (n, H, W, 3)),
         "image2": rng.uniform(0, 255, (n, H, W, 3)),
         "flow": 8.0 * rng.standard_normal((n, H, W, 2)),
         "valid": np.ones((n, H, W))}
    return {k: torch.from_numpy(v.astype(np.float32)).to(device)
            for k, v in b.items()}


def _nccl_ms(prof) -> float:
    return sum((e.time_range.end - e.time_range.start) / 1e3
               for e in prof.events()
               if getattr(e.device_type, "name", "") == "CUDA"
               and "nccl" in e.name.lower())


def _setting(args, mesh, global_b: int, per_rank: int) -> dict:
    """One setting on this rank: steps, timed steps, a profile."""
    import torch

    from raft_tpu_torch.config import RAFTConfig, TrainConfig
    from raft_tpu_torch.models.raft import RAFT
    from raft_tpu_torch.train.step import init_state, make_train_step

    dev = mesh.device
    cuda = dev.type == "cuda"
    d, n = mesh.data_index, mesh.spatial
    h = args.hw[0] // n
    cfg = TrainConfig(lr=2.5e-4, num_steps=120000, batch_size=global_b,
                      image_size=tuple(args.hw), iters=args.iters)
    mcfg = RAFTConfig.full(corr_impl="allpairs_pallas" if cuda
                           else "allpairs",
                           compute_dtype="bfloat16" if cuda else "float32")
    sd = RAFT(RAFTConfig.full(), seed=0).state_dict()
    state = init_state(mcfg, cfg, device=dev, state_dict=sd)
    step_fn = make_train_step(cfg, device=dev, mesh=mesh)
    s0 = mesh.spatial_index * h
    batches = [{k: v[d * per_rank:(d + 1) * per_rank, s0:s0 + h]
                .contiguous() for k, v in
                _batch(s, global_b, args.hw, dev).items()}
               for s in range(args.steps)]
    losses = []
    for b in batches:
        losses.append(float(step_fn(state, b)[1]["loss"]))
    times = []
    for _ in range(args.timed):
        t0 = time.perf_counter()
        step_fn(state, batches[0])
        if cuda:
            torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    out = dict(losses=losses, ms_all=times,
               ms_per_step=statistics.median(times),
               captures=state.programs.counter.total(),
               checksum=float(sum(p.double().sum() for p in
                                  state.model.state_dict().values())))
    if cuda:
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(2):
                step_fn(state, batches[0])
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / 2
        spans = sorted((e.time_range.start, e.time_range.end)
                       for e in prof.events()
                       if getattr(e.device_type, "name", "") == "CUDA")
        busy, end = 0.0, None
        for a, b in spans:
            if end is None or a > end:
                busy, end = busy + b - a, b
            elif b > end:
                busy, end = busy + b - end, b
        busy_ms = busy / 2 / 1e3
        out.update(busy_ms=busy_ms, idle_share=max(0.0, 1 - busy_ms / wall),
                   nccl_ms=_nccl_ms(prof) / 2)
    return out


def _rank(args, rank: int, world: int, port: int, out: str) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    import torch

    from raft_tpu_torch import config
    from raft_tpu_torch.parallel import init_from_env, shutdown

    if args.device == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    config.CONV_TF32 = False
    spatial = args.spatial if world > 1 else 1
    mesh = init_from_env(args.device, spatial=spatial)
    data = world // spatial
    res = {"world": world, "rank": rank, "backend": mesh.backend,
           "mesh": mesh.mesh_shape()}
    res["weak"] = _setting(args, mesh, args.batch * data, args.batch)
    if world > 1:
        res["strong"] = _setting(args, mesh, args.batch,
                                 args.batch // data)
    shutdown()
    with open(os.path.join(out, f"w{world}_r{rank}.json"), "w") as f:
        json.dump(res, f)


def _run_world(args, world: int, out: str) -> list:
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--_rank", str(r),
         "--_world", str(world), "--_port", str(port), "--_out", out,
         "--device", args.device, "--hw", *map(str, args.hw), "--iters",
         str(args.iters), "--batch", str(args.batch), "--steps",
         str(args.steps), "--timed", str(args.timed), "--spatial",
         str(args.spatial)],
        env=dict(os.environ, PYTHONPATH=os.path.dirname(
            os.path.abspath(__file__)))) for r in range(world)]
    deadline = time.monotonic() + args.timeout
    while any(p.poll() is None for p in procs):
        if any(p.poll() not in (None, 0) for p in procs) \
                or time.monotonic() > deadline:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            raise SystemExit(f"world {world}: ranks ended "
                             f"{[p.poll() for p in procs]}")
        time.sleep(0.2)
    if any(p.returncode for p in procs):
        raise SystemExit(f"world {world}: exit codes "
                         f"{[p.returncode for p in procs]}")
    res = []
    for r in range(world):
        with open(os.path.join(out, f"w{world}_r{r}.json")) as f:
            res.append(json.load(f))
    return res


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--worlds", type=int, nargs="+", default=None,
                   help="world sizes (default 1, 2, 4 up to the GPUs)")
    p.add_argument("--hw", type=int, nargs=2, default=[368, 496])
    p.add_argument("--iters", type=int, default=12)
    p.add_argument("--batch", type=int, default=8,
                   help="pairs a rank (weak) and global pairs (strong)")
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--timed", type=int, default=10)
    p.add_argument("--timeout", type=float, default=600)
    p.add_argument("--spatial", type=int, default=1,
                   help="ranks that split each image's rows (worlds > 1)")
    p.add_argument("--out", default=None, help="also write the lines here")
    for name, kind in (("_rank", int), ("_world", int), ("_port", int),
                       ("_out", str)):
        p.add_argument(f"--{name}", type=kind, default=None,
                       help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args._rank is not None:
        _rank(args, args._rank, args._world, args._port, args._out)
        return 0

    import tempfile

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("ddp_scale: no CUDA device (use --device cpu)", file=sys.stderr)
        return 2
    n = torch.cuda.device_count() if args.device == "cuda" else 8
    if args.device == "cuda":
        from raft_tpu_torch.ops import build

        build.build()           # once, before the ranks load it
    worlds = args.worlds or [w for w in (1, 2, 4) if w <= n]
    lines, base = [], None
    with tempfile.TemporaryDirectory() as out:
        for world in worlds:
            data = world // args.spatial if world > 1 else 1
            if world > 1 and world % args.spatial:
                raise SystemExit(f"--spatial {args.spatial} must divide "
                                 f"world {world}")
            if args.batch % data:
                raise SystemExit(f"--batch {args.batch} must divide by "
                                 f"{data} data indices")
            ranks = _run_world(args, world, out)
            for setting in ("weak", "strong"):
                if setting not in ranks[0]:
                    continue
                r0 = ranks[0][setting]
                sums = {r[setting]["checksum"] for r in ranks}
                glob = args.batch * (data if setting == "weak" else 1)
                line = dict(world=world, setting=setting,
                            backend=ranks[0]["backend"],
                            mesh=ranks[0]["mesh"],
                            global_batch=glob,
                            ms_per_step=r0["ms_per_step"],
                            pairs_per_s=glob / r0["ms_per_step"] * 1e3,
                            ranks_agree=len(sums) == 1,
                            losses=r0["losses"], captures=r0["captures"],
                            **{k: r0[k] for k in ("busy_ms", "idle_share",
                                                  "nccl_ms") if k in r0})
                if "nccl_ms" in r0:
                    line["nccl_share"] = r0["nccl_ms"] / r0["busy_ms"]
                if world == 1:
                    base = r0
                elif setting == "strong" and base is not None:
                    line["loss_rel_to_world1"] = max(
                        abs(a - b) / abs(b)
                        for a, b in zip(r0["losses"], base["losses"]))
                lines.append(line)
                print(json.dumps(line), flush=True)
    bad = [ln for ln in lines if not ln["ranks_agree"]
           or ln.get("loss_rel_to_world1", 0.0) > 2e-3]
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(lines, f, indent=1)
    if args.device == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip())
    if bad:
        print(f"ddp_scale: FAILED {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
