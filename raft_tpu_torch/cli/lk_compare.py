"""Lucas-Kanade against RAFT (the port of ``raft_tpu/cli/lk_compare.py``,
the reference's ``a_lk_vs_raft.py``).

Sparse LK tracks (FAST keypoints + ``cv2.calcOpticalFlowPyrLK``) drawn
over the dense RAFT flow visualization, and an agreement statistic: the
median end-point difference between the LK tracks and the dense flow at
the same keypoints.  Writes a side-by-side PNG (first frame with the
tracks | flow image with the tracks)::

    python -m raft_tpu_torch lk-compare --model weights.pth \
        --image1 demo-frames/frame_0000.png \
        --image2 demo-frames/frame_0001.png --out lk_vs_raft.png

``--model`` is a ``.pth`` (the port's or the reference format) or a
training run directory.  RAFT runs in bf16 on the card unless
``--device cpu``.
"""

from __future__ import annotations

import argparse
import os.path as osp


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="LK vs RAFT comparison "
                                            "(PyTorch port)")
    p.add_argument("--model", required=True,
                   help=".pth state dict or a training run directory")
    p.add_argument("--image1", required=True)
    p.add_argument("--image2", required=True)
    p.add_argument("--out", default="lk_vs_raft.png")
    p.add_argument("--small", action="store_true")
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--max_corners", type=int, default=200)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def lk_tracks(img1_rgb, img2_rgb, max_corners=200):
    """FAST keypoints on frame 1 tracked into frame 2 with pyramidal LK;
    ``(p0, p1)`` float32 arrays of the matched ``(x, y)`` points."""
    import cv2
    import numpy as np

    g1 = cv2.cvtColor(img1_rgb, cv2.COLOR_RGB2GRAY)
    g2 = cv2.cvtColor(img2_rgb, cv2.COLOR_RGB2GRAY)
    fast = cv2.FastFeatureDetector_create(threshold=25)
    kps = fast.detect(g1, None)
    kps = sorted(kps, key=lambda k: -k.response)[:max_corners]
    if not kps:
        return (np.zeros((0, 2), np.float32),) * 2
    p0 = np.float32([k.pt for k in kps]).reshape(-1, 1, 2)
    p1, st, _ = cv2.calcOpticalFlowPyrLK(
        g1, g2, p0, None, winSize=(21, 21), maxLevel=3)
    ok = st.reshape(-1) == 1
    return p0.reshape(-1, 2)[ok], p1.reshape(-1, 2)[ok]


def main(argv=None):
    """Returns ``(flow (H, W, 2), median |LK - RAFT| or None)``."""
    args = parse_args(argv)

    import cv2
    import numpy as np
    import torch

    from raft_tpu_torch.cli.evaluate import load_model_state_dict
    from raft_tpu_torch.config import RAFTConfig
    from raft_tpu_torch.data.frame_utils import read_image
    from raft_tpu_torch.evaluate import make_eval_fn
    from raft_tpu_torch.ops.pad import InputPadder
    from raft_tpu_torch.utils.flow_viz import flow_to_image

    mk = RAFTConfig.small_model if args.small else RAFTConfig.full
    model_cfg = mk(compute_dtype="bfloat16")
    eval_fn = make_eval_fn(model_cfg, args.iters, device=args.device)
    state_dict = load_model_state_dict(args.model, model_cfg)

    img1 = read_image(args.image1)
    img2 = read_image(args.image2)
    t1 = torch.from_numpy(img1).float()[None]
    t2 = torch.from_numpy(img2).float()[None]
    padder = InputPadder(t1.shape)
    _, flow_up = eval_fn(state_dict, *padder.pad(t1, t2))
    flow = padder.unpad(flow_up)[0].float().cpu().numpy()

    p0, p1 = lk_tracks(img1, img2, args.max_corners)
    viz = flow_to_image(flow).copy()
    overlay = img1.copy()
    for (x0, y0), (x1, y1) in zip(p0, p1):
        a, b = (int(round(x0)), int(round(y0))), (int(round(x1)),
                                                  int(round(y1)))
        cv2.arrowedLine(overlay, a, b, (0, 255, 0), 1, tipLength=0.3)
        cv2.arrowedLine(viz, a, b, (0, 0, 0), 1, tipLength=0.3)

    median = None
    if len(p0):
        xi = np.clip(p0[:, 0].round().astype(int), 0, flow.shape[1] - 1)
        yi = np.clip(p0[:, 1].round().astype(int), 0, flow.shape[0] - 1)
        diff = np.linalg.norm((p1 - p0) - flow[yi, xi], axis=1)
        median = float(np.median(diff))
        print(f"{len(p0)} LK tracks; median |LK - RAFT| = {median:.2f}px",
              flush=True)

    side = np.concatenate([overlay, viz], axis=1)
    cv2.imwrite(args.out, cv2.cvtColor(side, cv2.COLOR_RGB2BGR))
    print(f"wrote {osp.abspath(args.out)}", flush=True)
    return flow, median


if __name__ == "__main__":
    main()
