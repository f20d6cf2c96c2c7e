"""``python -m raft_tpu_torch cost``: per-program FLOPs / bytes / roofline
table (the port of ``raft_tpu/cli/cost.py``).

Builds the stack's programs (the train step, the inference forward, and
the serving engine's ``enc`` / ``iter`` slot pair) at one configuration
and prints each program's work accounting from ``obs/cost.py``: FLOPs,
bytes, arithmetic intensity, the compute-vs-memory roofline verdict
against the device's peak, and the world-invariant ``flops_per_pair``.

The JAX CLI reads these off compiled executables without running them.
The port has no compiler analysis: it runs each program ONCE, eagerly,
under ``obs.cost.counting()`` (the aten operators' FLOPs and an unfused
upper bound of their bytes, plus the analytic formulas that the fused
gate and lookup-encode wrappers add; the other hand-written kernels
count zero, as a Pallas call does in the JAX counts).  So it runs on the
card unless ``--device cpu`` is given, and without CUDA it raises.

    python -m raft_tpu_torch cost --tiny --device cpu   # CPU smoke
    python -m raft_tpu_torch cost                       # chairs shapes
    python -m raft_tpu_torch cost --image-size 368x768 --batch 4 --json

The full configuration is the port's shipped training one (the full
model in bf16, the pyramid-lookup and upsample-loss kernels); the
inference and serving programs take the inference override, as the
validators and the engine do.  Weights are seeded random: the counts do
not depend on them.
"""

from __future__ import annotations

import argparse
import json


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m raft_tpu_torch cost",
        description="counted FLOPs/bytes/roofline per program (each run "
                    "once, eagerly: on the card unless --device cpu)")
    p.add_argument("--tiny", action="store_true",
                   help="small model at test shapes — seconds on the "
                        "CPU (the test-suite smoke config)")
    p.add_argument("--image-size", default=None, metavar="HxW",
                   help="train/inference image size "
                        "(default 368x496; --tiny: 48x64)")
    p.add_argument("--batch", type=int, default=None,
                   help="train batch size (default 8; --tiny: 2)")
    p.add_argument("--iters", type=int, default=None,
                   help="refinement iterations for the train step and "
                        "the inference forward (default 12; --tiny: 2)")
    p.add_argument("--serve-bucket", default=None, metavar="HxW",
                   help="serve program bucket shape "
                        "(default 440x1024; --tiny: 40x56)")
    p.add_argument("--lanes", type=int, default=None,
                   help="serve slot lanes (default 4; --tiny: 2)")
    p.add_argument("--json", action="store_true",
                   help="emit the table as one JSON object instead of "
                        "the human layout")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu: where each program runs "
                        "its one counted call")
    return p.parse_args(argv)


def _parse_hw(s, default):
    if s is None:
        return default
    h, w = s.lower().split("x")
    return int(h), int(w)


def _fmt(v, unit=1.0, digits=3):
    if v is None:
        return "-"
    if unit != 1.0:
        return f"{v / unit:.{digits}f}"
    return f"{v:.{digits}f}" if isinstance(v, float) else str(v)


def collect_costs(model_cfg, train_hw, batch, iters, bucket, lanes,
                  device="cuda"):
    """The table rows: one :class:`~raft_tpu_torch.obs.cost.ProgramCost`
    per program, each counted over one eager call on ``device`` (one
    rank: ``flops_per_pair`` is the same at any world size)."""
    import numpy as np

    from raft_tpu_torch.config import TrainConfig
    from raft_tpu_torch.evaluate import (make_eval_fn, make_inference_model,
                                         resolve_device)
    from raft_tpu_torch.obs import cost as cost_mod
    from raft_tpu_torch.serve.slots import SlotPrograms, SlotSet
    from raft_tpu_torch.train.step import (init_state, make_train_step,
                                           step_cost)

    dev = resolve_device(device)
    kind = "cpu" if dev.type == "cpu" else None
    H, W = train_hw
    rng = np.random.default_rng(0)
    costs = []

    # --- train step (forward + backward + optimizer update) ----------
    tcfg = TrainConfig(num_steps=100, batch_size=batch,
                       image_size=(H, W), iters=iters)
    state = init_state(model_cfg, tcfg, device=dev)
    step_fn = make_train_step(tcfg, device=dev, graphs=False)
    train_batch = {
        "image1": rng.uniform(0, 255, (batch, H, W, 3)).astype(np.float32),
        "image2": rng.uniform(0, 255, (batch, H, W, 3)).astype(np.float32),
        "flow": rng.normal(0, 4, (batch, H, W, 2)).astype(np.float32),
        "valid": np.ones((batch, H, W), np.float32)}
    with cost_mod.counting() as count:
        step_fn(state, train_batch)
    costs.append(step_cost(count, batch, 1, kind=kind))
    state_dict = state.model.state_dict()
    del state, step_fn

    # --- inference forward (test mode, the eval / demo math) ---------
    fwd = make_eval_fn(model_cfg, iters, device=dev, graphs=False)
    img = rng.uniform(0, 255, (1, H, W, 3)).astype(np.float32)
    costs.append(fwd.capture_cost(state_dict, img, img))

    # --- serve slot programs (the engine's enc / iter cost book) -----
    book = cost_mod.CostBook()
    programs = SlotPrograms(
        make_inference_model(model_cfg, state_dict, device=dev),
        cost_book=book)
    slots = SlotSet(programs, bucket, lanes)
    bh, bw = bucket
    frames = rng.uniform(0, 255, (lanes, bh, bw, 3)).astype(np.float32)
    slots.encode(frames, frames, slots.admit_all,
                 np.full((lanes,), 1, np.int32))
    slots.iterate(0.0)
    for prog in ("enc", "iter"):
        costs.append(book.get(((bh, bw), lanes, prog)))
    return costs


def main(argv=None) -> int:
    args = parse_args(argv)
    from raft_tpu_torch.config import RAFTConfig
    from raft_tpu_torch.evaluate import resolve_device
    from raft_tpu_torch.obs import cost as cost_mod

    dev = resolve_device(args.device)
    if args.tiny:
        # the reduced correlation pyramid of the JAX CLI's preset
        model_cfg = RAFTConfig.small_model(corr_levels=2, corr_radius=2)
        train_hw = _parse_hw(args.image_size, (48, 64))
        batch = args.batch or 2
        iters = args.iters or 2
        bucket = _parse_hw(args.serve_bucket, (40, 56))
        lanes = args.lanes or 2
    else:
        model_cfg = RAFTConfig.full(corr_impl="allpairs_pallas",
                                    upsample_loss_kernel="pallas",
                                    compute_dtype="bfloat16")
        train_hw = _parse_hw(args.image_size, (368, 496))
        batch = args.batch or 8
        iters = args.iters or 12
        bucket = _parse_hw(args.serve_bucket, (440, 1024))
        lanes = args.lanes or 4

    costs = collect_costs(model_cfg, train_hw, batch, iters, bucket,
                          lanes, device=dev)
    spec = cost_mod.peak_spec(costs[0].device_kind)
    if args.json:
        print(json.dumps({
            "device_kind": costs[0].device_kind,
            "peak_tflops": spec.tflops,
            "peak_hbm_gbps": spec.hbm_gbps,
            "ridge_flops_per_byte": spec.ridge,
            "programs": [c.as_record() for c in costs]}))
        return 0

    print(f"device_kind: {costs[0].device_kind}   "
          f"peak: {_fmt(spec.tflops)} bf16 TFLOP/s, "
          f"{_fmt(spec.hbm_gbps)} GB/s HBM   "
          f"ridge: {_fmt(spec.ridge, digits=1)} flop/byte")
    hdr = (f"{'program':<24} {'GFLOPs':>10} {'MB':>10} "
           f"{'flop/byte':>10} {'bound_by':>9} {'flops/pair':>12} "
           f"{'source':>8}")
    print(hdr)
    print("-" * len(hdr))
    for c in costs:
        print(f"{c.program:<24} {_fmt(c.flops, 1e9):>10} "
              f"{_fmt(c.bytes, 1e6):>10} "
              f"{_fmt(c.arithmetic_intensity):>10} {c.bound_by:>9} "
              f"{_fmt(c.flops_per_pair, 1e0, 0):>12} {c.source:>8}")
    if spec.tflops is None:
        print("(unknown device peak — MFU/BW utilization are only "
              "derivable on known hardware, e.g. the H100)")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
