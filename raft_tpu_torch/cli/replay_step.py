"""``python -m raft_tpu_torch replay-step``: re-run a forensic bundle's
training step (the port of ``scripts/replay_step.py``, the same flags,
steps and report).

When the train step's non-finite guard skips an update, the port's loop
writes a bundle (``telemetry_dir/forensics/stepNNNNNNNN.npz``: the host
batch after the noise, the step, the dropout generator's state before it,
the step's metrics and the run's configurations; ``obs/health.py``).  This
tool replays that step (the same batch, the same generator state, the
same loss, ``train.step.make_loss_fn``, differentiated eagerly by
autograd with no captured graph and no guard, so that non-finite
gradients stay visible) against a checkpoint of the run, on the card
unless ``--device cpu``::

    python -m raft_tpu_torch replay-step \\
        --bundle runs/t/forensics/step00000042.npz \\
        --ckpt checkpoints/raft-chairs
    # {"reproduced": true, "loss": Infinity, "nonfinite_grad_leaves":
    #  {"fnet/conv1/kernel": 123, ...}, ...}

The leaf names are JAX's (``convert.flax_path`` of the port's parameter
names), so a report reads as the JAX tool's does.  ``--ckpt`` should hold
the run's checkpoint at (or before) the offending step: with the guard
on, the parameters at a flagged step are the last checkpoint's plus the
finite updates since, so the newest checkpoint before the blow-up
usually reproduces it; ``--random-init`` (the model seeded from the
run's seed) only answers "is the batch itself poisoned" (inf / NaN
pixels, absurd flows), which the report counts first either way.

The dropout draws replay only from a generator of the bundle's device
type: a CUDA generator's state cannot be set on a CPU generator.  Where
the model draws dropout and the devices differ, the replay raises and
names both; it never draws a substitute mask.  A checkpoint, which holds
the run's generator too, restores only on a device of the type that
saved it (``train/checkpoint.py``): a card run replays on the card.

Exit status: 0 normally; with ``--expect-nonfinite`` (the incident
runbook's mode), 1 when the replay comes out finite.
"""

from __future__ import annotations

import argparse
import json
import sys


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m raft_tpu_torch replay-step",
        description="replay a non-finite-step forensic bundle")
    p.add_argument("--bundle", required=True,
                   help="forensics .npz written by the train loop")
    p.add_argument("--ckpt", default=None,
                   help="checkpoint dir of the run (ckpt_dir/name); the "
                        "newest restorable step is restored")
    p.add_argument("--random-init", action="store_true",
                   help="replay from a fresh seeded init instead of a "
                        "checkpoint (batch-poisoning check only)")
    p.add_argument("--expect-nonfinite", action="store_true",
                   help="exit 1 if the replay does NOT reproduce a "
                        "non-finite loss/grad")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu: where the step re-runs")
    return p.parse_args(argv)


def _tuplify(cfg_dict, keys):
    out = dict(cfg_dict)
    for k in keys:
        if k in out and isinstance(out[k], list):
            out[k] = tuple(out[k])
    return out


def _generator_device(rng: dict, state: bytes) -> str:
    """The device type of the bundle's generator: recorded by the loop,
    else told by the state's size (a CUDA generator's is its seed and
    offset, 16 bytes; a CPU generator's the Mersenne Twister's)."""
    return rng.get("device") or ("cuda" if len(state) == 16 else "cpu")


def _restore_generator(state, meta: dict, draws: bool, dev) -> None:
    """Put the step's generator state into ``state.generator``; where
    the devices differ, raise if the model draws dropout (nothing to
    replay otherwise)."""
    import torch

    rng = meta.get("rng") or {}
    hexed = rng.get("generator_state")
    if hexed is None:
        if draws:
            raise SystemExit(
                "the bundle records no generator state, and the model "
                "draws dropout: its mask cannot be replayed")
        return
    raw = bytes.fromhex(hexed)
    saved_on = _generator_device(rng, raw)
    if saved_on != dev.type:
        if draws:
            raise SystemExit(
                f"the bundle's dropout generator is a {saved_on} "
                f"generator and this replay runs on {dev.type}: its state "
                f"cannot be set here; replay with --device {saved_on}")
        return
    state.generator.set_state(torch.frombuffer(bytearray(raw),
                                               dtype=torch.uint8))


def replay(bundle_path: str, ckpt: str = None, random_init: bool = False,
           device="cuda") -> dict:
    import numpy as np
    import torch

    from raft_tpu_torch.config import RAFTConfig, TrainConfig, entry_precision
    from raft_tpu_torch.convert import flax_path
    from raft_tpu_torch.evaluate import resolve_device
    from raft_tpu_torch.obs.health import load_forensic_bundle
    from raft_tpu_torch.train.step import BATCH_KEYS, init_state, make_loss_fn

    batch, meta = load_forensic_bundle(bundle_path)
    if batch is None:
        raise SystemExit(
            f"{bundle_path}: bundle has no batch arrays (the host batch "
            "was already evicted from the forensics ring when the flag "
            "was observed) — lower log_freq or raise forensic_keep on "
            "the next run to capture it")
    step = int(meta["step"])
    model_cfg = RAFTConfig(**meta["model_cfg"])
    cfg = TrainConfig(**_tuplify(meta["train_cfg"],
                                 ("image_size", "validation",
                                  "profile_steps")))

    # Batch-level poisoning first: no model needed to spot an inf pixel.
    batch_nonfinite = {
        k: int(np.size(v) - np.isfinite(v).sum()) for k, v in batch.items()
    }

    dev = resolve_device(device)
    state = init_state(model_cfg, cfg, device=dev)
    restored_step = None
    if ckpt and not random_init:
        from raft_tpu_torch.train.checkpoint import CheckpointManager

        if CheckpointManager(ckpt).restore_latest(state) is None:
            raise SystemExit(f"no checkpoint under {ckpt!r}")
        restored_step = int(state.step)
    _restore_generator(state, meta, model_cfg.dropout > 0, dev)

    model = state.model.train()
    model.zero_grad(set_to_none=True)
    tbatch = {k: torch.as_tensor(batch[k], dtype=torch.float32, device=dev)
              for k in BATCH_KEYS}
    with entry_precision():
        loss, _ = make_loss_fn(cfg)(model, tbatch, state.generator)
        loss.backward()

    keys = model.state_dict().keys()
    bad_leaves = {}
    for name, p in model.named_parameters():
        if p.grad is None:          # unreached: JAX's gradient is zero
            continue
        n = int(p.grad.numel() - torch.isfinite(p.grad).sum())
        if n:
            bad_leaves["/".join(flax_path(name, p.ndim, keys)[1:])] = n
    loss = float(loss.detach())
    reproduced = (not np.isfinite(loss)) or bool(bad_leaves)
    return {
        "bundle": bundle_path,
        "step": step,
        "restored_step": restored_step,
        "reproduced": reproduced,
        "loss": loss,
        "batch_nonfinite_elements": batch_nonfinite,
        "nonfinite_grad_leaves": bad_leaves,
        "metrics_at_capture": meta.get("metrics", {}),
    }


def main(argv=None) -> int:
    args = parse_args(argv)
    if not args.ckpt and not args.random_init:
        raise SystemExit("pass --ckpt <dir> (or --random-init for the "
                         "batch-poisoning check)")
    report = replay(args.bundle, ckpt=args.ckpt,
                    random_init=args.random_init, device=args.device)
    print(json.dumps(report))
    if args.expect_nonfinite and not report["reproduced"]:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
