"""Evaluation CLI (the port of ``raft_tpu/cli/evaluate.py``): a validator
over a dataset tree, printing the JAX validator's line.

    python -m raft_tpu_torch.cli.evaluate --model weights.pth \\
        --dataset sintel --alternate_corr

``--model`` is a ``.pth`` holding the port's own ``state_dict`` or a
reference-format one, or a training run directory (``<ckpt_dir>/<name>``
of the train CLI), whose newest restorable step gives the weights.
``--alternate_corr`` runs the kernel configuration: the on-demand
correlation lookup (the CUDA kernel on the card) and the fused GRU gates.
``--epe_delta float32,int8`` runs the validator once per correlation
storage dtype and prints the deltas against the first.
``--early_exit_threshold 0.05,0.2`` sweeps early-exit thresholds
against the full-iteration baseline through the serving engine's slot
programs and prints the record as one JSON line.
``--quality-proxies`` (with ``--quality-cycle``) scores every image with
the label-free quality proxies of the serving path and prints each
proxy's Spearman rank correlation with the true EPE as one JSON line.
``--telemetry_dir`` writes the JSONL events (the per-batch forward
spans, one ``cost_report`` a forward shape, the ``eval`` record) there.
``--corr_precision`` takes the JAX CLI's values (``auto`` / ``default`` /
``high`` / ``highest``): the precision of the correlation's matrix
products, TF32 on the card for ``high`` and ``default``.  It runs on the
card unless ``--device cpu``; without CUDA it raises.
"""

from __future__ import annotations

import argparse

from raft_tpu_torch.config import (validate_corr_dtype,
                                   validate_corr_precision)

DEFAULT_ITERS = {"chairs": 24, "sintel": 32, "kitti": 24}


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


def _epe_delta_arg(value: str):
    dtypes = [d.strip() for d in value.split(",") if d.strip()]
    if len(dtypes) < 2:
        raise argparse.ArgumentTypeError(
            f"--epe_delta needs a comma list of >= 2 corr dtypes "
            f"(e.g. 'float32,int8'), got {value!r}")
    try:
        return [validate_corr_dtype(d, flag="--epe_delta") for d in dtypes]
    except ValueError as e:
        raise argparse.ArgumentTypeError(str(e))


def _early_exit_arg(value: str):
    parts = [t.strip() for t in value.split(",") if t.strip()]
    if not parts:
        raise argparse.ArgumentTypeError(
            f"--early_exit_threshold needs a comma list of >= 1 "
            f"float, got {value!r}")
    try:
        thrs = [float(t) for t in parts]
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"--early_exit_threshold values must be floats, "
            f"got {value!r}")
    if any(t < 0 for t in thrs):
        raise argparse.ArgumentTypeError(
            f"--early_exit_threshold values must be >= 0, got {value!r}")
    return thrs


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="RAFT evaluation (PyTorch port)")
    p.add_argument("--model", required=True,
                   help=".pth state dict (the port's or reference format) "
                        "or a training run directory")
    p.add_argument("--dataset", required=True,
                   choices=["chairs", "sintel", "kitti"])
    p.add_argument("--small", action="store_true", help="the small model")
    p.add_argument("--precision", default="bf16", choices=["bf16", "fp32"])
    p.add_argument("--corr_dtype", default="auto", type=_corr_dtype_arg,
                   help="storage dtype of the materialized correlation "
                        "pyramid (auto / float32 / bfloat16 / int8 / "
                        "float8_e4m3fn / float8_e5m2)")
    p.add_argument("--corr_precision", default="auto",
                   type=_corr_precision_arg,
                   help="precision of the correlation's matrix products "
                        "(auto / default / high / highest)")
    p.add_argument("--epe_delta", default=None, type=_epe_delta_arg,
                   metavar="DTYPE,DTYPE[,...]",
                   help="run the validator under each corr storage dtype "
                        "and print per-metric deltas against the first; "
                        "overrides --corr_dtype")
    p.add_argument("--early_exit_threshold", default=None,
                   type=_early_exit_arg, metavar="T[,T...]",
                   help="accuracy gate of adaptive early exit: each "
                        "convergence threshold against the full-iteration "
                        "baseline (threshold 0) on the same weights, per "
                        "arm the EPE delta and iters_used p50/p95 (the "
                        "serving knob it gates is "
                        "ServeConfig.early_exit_threshold)")
    p.add_argument("--quality-proxies", "--quality_proxies",
                   action="store_true", dest="quality_proxies",
                   help="calibration of the unsupervised quality proxies "
                        "(obs/quality.py): score every image with the "
                        "label-free photometric and retirement-residual "
                        "proxies the serving sampler records and report "
                        "each proxy's Spearman rank correlation with the "
                        "true EPE")
    p.add_argument("--quality-cycle", "--quality_cycle",
                   action="store_true", dest="quality_cycle",
                   help="with --quality-proxies: also score "
                        "forward-backward cycle consistency (a second "
                        "pass on swapped frames, twice the forward cost)")
    p.add_argument("--alternate_corr", action="store_true",
                   help="on-demand correlation lookup and fused GRU gates "
                        "(the CUDA kernels on the card)")
    p.add_argument("--iters", type=int, default=None,
                   help="refinement iterations (default: 24 chairs, 32 "
                        "sintel, 24 kitti)")
    p.add_argument("--data_root", default="datasets")
    p.add_argument("--chairs_split", default="chairs_split.txt")
    p.add_argument("--eval_batch", type=int, default=4,
                   help="images per forward (one batch shape a split)")
    p.add_argument("--no_bucket", action="store_true",
                   help="KITTI: pad each image to its own /8 shape, one "
                        "image a batch, instead of one bucket shape")
    p.add_argument("--telemetry_dir", "--telemetry-dir", default=None,
                   help="write JSONL telemetry events (per-batch forward "
                        "spans, one cost_report a forward shape, the eval "
                        "record) into this directory; default "
                        "$RAFT_TELEMETRY_DIR, unset = disabled")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    return p.parse_args(argv)


def load_model_state_dict(path: str, model_cfg):
    """The weights of ``--model``: a ``.pth`` file, or the newest
    restorable step of a training run directory."""
    import os

    from raft_tpu_torch.convert import load_state_dict_file
    from raft_tpu_torch.train.checkpoint import CheckpointManager

    if not os.path.isdir(path):
        return load_state_dict_file(path, model_cfg)
    sd = CheckpointManager(path).restore_params()
    if sd is None:
        raise SystemExit(f"--model {path}: no checkpoint in this run "
                         "directory")
    return {k: v.float() if v.is_floating_point() else v
            for k, v in sd.items()}


def main(argv=None):
    args = parse_args(argv)

    import os
    import os.path as osp

    if args.telemetry_dir:
        # the eval spans write through the process-default sink, which
        # binds to this variable on first use (obs/events.py)
        os.environ["RAFT_TELEMETRY_DIR"] = args.telemetry_dir
        from raft_tpu_torch.obs import reset_default_sink

        reset_default_sink()

    from raft_tpu_torch import evaluate
    from raft_tpu_torch.config import RAFTConfig

    evaluate.resolve_device(args.device)
    compute_dtype = "bfloat16" if args.precision == "bf16" else "float32"
    mk = RAFTConfig.small_model if args.small else RAFTConfig.full
    common = dict(compute_dtype=compute_dtype, corr_dtype=args.corr_dtype,
                  corr_precision=args.corr_precision)
    if args.alternate_corr:
        model_cfg = mk(fused_gru=True,
                       corr_impl=evaluate.default_alternate_corr_impl(
                           args.device), **common)
    else:
        model_cfg = mk(**common)
    state_dict = load_model_state_dict(args.model, model_cfg)
    iters = args.iters or DEFAULT_ITERS[args.dataset]

    kwargs = {
        "chairs": dict(root=osp.join(args.data_root,
                                     "FlyingChairs_release/data"),
                       split_file=args.chairs_split),
        "sintel": dict(root=osp.join(args.data_root, "Sintel")),
        "kitti": dict(root=osp.join(args.data_root, "KITTI"),
                      bucket=not args.no_bucket),
    }[args.dataset]
    if args.early_exit_threshold:
        import json

        result = evaluate.evaluate_early_exit_delta(
            state_dict, model_cfg, args.early_exit_threshold,
            dataset=args.dataset, iters=iters, batch_size=args.eval_batch,
            device=args.device, **kwargs)
        # the JAX CLI's bench-format record of the sweep
        print(json.dumps({
            "metric": f"eval_early_exit_{args.dataset}_iters{iters}",
            "value": 1.0, "unit": "pass", "vs_baseline": 0.0,
            "config": {
                "early_exit_delta_vs_full": result["delta_vs_full"],
                "thresholds": result["thresholds"],
                "per_threshold": result["per_threshold"]}}))
        return result
    if args.quality_proxies:
        import json

        result = evaluate.evaluate_quality_proxies(
            state_dict, model_cfg, dataset=args.dataset, iters=iters,
            batch_size=args.eval_batch, cycle=args.quality_cycle,
            device=args.device, **kwargs)
        # the JAX CLI's bench-format record of the calibration
        print(json.dumps({
            "metric": f"eval_quality_proxies_{args.dataset}",
            "value": 1.0, "unit": "pass", "vs_baseline": 0.0,
            "config": {
                "quality_spearman": result["spearman"],
                "proxy_means": result["proxy_means"],
                "epe_mean": result["epe_mean"],
                "n": result["n"]}}))
        return result
    if args.epe_delta:
        return evaluate.evaluate_epe_delta(
            state_dict, model_cfg, args.epe_delta, dataset=args.dataset,
            iters=iters, batch_size=args.eval_batch, device=args.device,
            **kwargs)
    return evaluate.VALIDATORS[args.dataset](
        state_dict, model_cfg, iters=iters, batch_size=args.eval_batch,
        device=args.device, **kwargs)


if __name__ == "__main__":
    main()
