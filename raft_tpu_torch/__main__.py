"""``python -m raft_tpu_torch <subcommand>``: the port's multi-tool, with
the subcommands the port has::

    python -m raft_tpu_torch train --name raft-chairs --stage chairs
    python -m raft_tpu_torch curriculum --workdir runs/standard
    python -m raft_tpu_torch verify-ckpt checkpoints/raft-chairs
    python -m raft_tpu_torch evaluate --model weights.pth --dataset sintel
    python -m raft_tpu_torch demo --model weights.pth --path demo-frames
    python -m raft_tpu_torch lk-compare --model weights.pth \
        --image1 a.png --image2 b.png
    python -m raft_tpu_torch serve --random-init --port 8080
    python -m raft_tpu_torch cost --tiny --device cpu
    python -m raft_tpu_torch incidents list --telemetry-dir runs/tel
"""

from __future__ import annotations

import importlib
import sys

_SUBCOMMANDS = {
    "train": ("raft_tpu_torch.cli.train", "train one curriculum stage"),
    "curriculum": ("raft_tpu_torch.cli.curriculum",
                   "the multi-stage schedule as one resumable job"),
    "verify-ckpt": ("raft_tpu_torch.cli.verify_ckpt",
                    "check a run directory's checkpoints restore"),
    "evaluate": ("raft_tpu_torch.cli.evaluate",
                 "validation on Sintel / KITTI / FlyingChairs"),
    "demo": ("raft_tpu_torch.cli.demo", "flow visualization over a frame dir"),
    "lk-compare": ("raft_tpu_torch.cli.lk_compare",
                   "RAFT against Lucas-Kanade, side by side"),
    "serve": ("raft_tpu_torch.cli.serve", "HTTP inference server"),
    "cost": ("raft_tpu_torch.cli.cost",
             "per-program FLOPs/bytes/roofline table"),
    "incidents": ("raft_tpu_torch.cli.incidents",
                  "browse incident bundles (list/show/timeline)"),
}


def _usage() -> str:
    lines = ["usage: python -m raft_tpu_torch <subcommand> [args...]", "",
             "subcommands:"]
    for name, (_, desc) in _SUBCOMMANDS.items():
        lines.append(f"  {name:<12} {desc}")
    lines.append("")
    lines.append("run a subcommand with --help for its flags")
    return "\n".join(lines)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(_usage())
        return 0
    cmd, rest = argv[0], argv[1:]
    if cmd not in _SUBCOMMANDS:
        print(f"unknown subcommand {cmd!r}\n\n{_usage()}", file=sys.stderr)
        return 2
    rc = importlib.import_module(_SUBCOMMANDS[cmd][0]).main(rest)
    return rc if isinstance(rc, int) else 0


if __name__ == "__main__":
    sys.exit(main())
