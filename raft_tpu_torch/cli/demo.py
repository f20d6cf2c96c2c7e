"""Inference demo (the port of ``raft_tpu/cli/demo.py``): run RAFT on
consecutive frame pairs from a directory and write, per pair,
``<out>/<name>_flow.png`` -- the first frame stacked over the color-wheel
flow image.

    python -m raft_tpu_torch.cli.demo --model weights.pth --path demo-frames

``--model`` is a ``.pth`` holding the port's own ``state_dict`` or a
reference-format one; ``--small`` reads the small model's.
``--alternate_corr`` runs the kernel configuration:
the on-demand correlation lookup (the CUDA kernel on the card) and the
fused GRU gates.  The demo runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import glob
import os
import os.path as osp


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="RAFT demo (PyTorch port)")
    p.add_argument("--model", required=True,
                   help=".pth state dict (the port's or reference format)")
    p.add_argument("--path", default="demo-frames",
                   help="directory of frames (sorted, consecutive pairs)")
    p.add_argument("--out", default="demo-out", help="output directory")
    p.add_argument("--small", action="store_true")
    p.add_argument("--precision", default="bf16", choices=["bf16", "fp32"])
    p.add_argument("--alternate_corr", action="store_true")
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    import numpy as np
    import torch
    from PIL import Image

    from raft_tpu_torch.config import RAFTConfig
    from raft_tpu_torch.convert import load_state_dict_file
    from raft_tpu_torch.data.frame_utils import read_image
    from raft_tpu_torch.evaluate import (default_alternate_corr_impl,
                                         make_eval_fn)
    from raft_tpu_torch.ops.pad import InputPadder
    from raft_tpu_torch.utils.flow_viz import flow_to_image

    compute_dtype = "bfloat16" if args.precision == "bf16" else "float32"
    mk = RAFTConfig.small_model if args.small else RAFTConfig.full
    if args.alternate_corr:
        model_cfg = mk(compute_dtype=compute_dtype, fused_gru=True,
                       corr_impl=default_alternate_corr_impl(args.device))
    else:
        model_cfg = mk(compute_dtype=compute_dtype)
    eval_fn = make_eval_fn(model_cfg, args.iters, device=args.device)
    state_dict = load_state_dict_file(args.model, model_cfg)

    frames = sorted(glob.glob(osp.join(args.path, "*.png"))
                    + glob.glob(osp.join(args.path, "*.jpg")))
    if len(frames) < 2:
        raise SystemExit(f"need >= 2 frames in {args.path}")
    os.makedirs(args.out, exist_ok=True)

    written = []
    for file1, file2 in zip(frames[:-1], frames[1:]):
        img1 = torch.from_numpy(read_image(file1)).float()[None]
        img2 = torch.from_numpy(read_image(file2)).float()[None]
        padder = InputPadder(img1.shape)
        img1p, img2p = padder.pad(img1, img2)
        _, flow_up = eval_fn(state_dict, img1p, img2p)
        flow = padder.unpad(flow_up)[0].cpu().numpy()

        viz = flow_to_image(flow)
        stacked = np.concatenate([img1[0].numpy().astype(np.uint8), viz],
                                 axis=0)
        name = osp.splitext(osp.basename(file1))[0]
        out_path = osp.join(args.out, f"{name}_flow.png")
        Image.fromarray(stacked).save(out_path)
        written.append(out_path)
        print(f"{file1} -> {out_path}  |flow| max "
              f"{np.abs(flow).max():.1f}px", flush=True)
    return written


if __name__ == "__main__":
    main()
