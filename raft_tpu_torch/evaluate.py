"""Inference entry points, validation and leaderboard submissions (the port
of ``raft_tpu/evaluate.py``).

- ``validate_chairs``: EPE at 24 iterations;
- ``validate_sintel``: clean and final EPE and 1/3/5 px at 32 iterations;
- ``validate_kitti``: EPE and F1-all (``epe > 3 and epe / |gt| > 0.05``)
  at 24 iterations, every resolution padded to one bucket;
- ``create_sintel_submission``: ``.flo`` files of the test split, with
  an optional warm start (the previous frame's 1/8 flow forward-warped
  along itself into the next frame's ``flow_init``);
- ``create_kitti_submission``: 16-bit PNG flow of the test split;
- ``evaluate_epe_delta``: one validator under several ``corr_dtype``s;
- ``evaluate_early_exit_delta``: early-exit thresholds against the full
  iteration count, through the serving engine's slot programs;
- ``evaluate_quality_proxies``: the label-free quality proxies' Spearman
  rank correlation with the true EPE, through the same slot programs.

Images stream through the test-mode forward in batches of one shape:
each batch is decoded and padded on the host, moved to the device by the
forward, and its flows come back with ``.cpu()``; the metrics are NumPy.

Every inference path goes through :func:`make_inference_model` /
:func:`make_eval_fn`.  They run on the card (``device="cuda"``) unless the
caller asks for the CPU; without CUDA and without an explicit CPU request
they raise.  The configuration goes through the per-hardware tuning
registry (``tuning.py``) first, then the one fixed inference override of
the JAX package (the training-only ``allpairs_pallas`` lookup maps to
``allpairs``, and the fused lookup + ``convc1`` kernel, which needs it,
is turned off with it; a quantized pyramid is then sampled by the plain
``corr_lookup``, as in JAX).

Telemetry (``RAFT_TELEMETRY_DIR`` or the CLI's ``--telemetry_dir``): the
spans ``raft_eval_pad``, ``raft_eval_forward`` (one event a batch) and
``raft_eval_epe``, one ``eval`` event a validator, and one
``cost_report`` a distinct forward shape (``RAFT_TELEMETRY_COST=0``
turns it off), counted on the forward's first call of that shape.
"""

from __future__ import annotations

import os
import os.path as osp
from typing import Dict, Mapping, Optional, Union

import numpy as np
import torch

from raft_tpu_torch.config import (RAFTConfig, backend_flags,
                                   entry_precision, validate_corr_dtype)
from raft_tpu_torch.data import datasets, frame_utils
from raft_tpu_torch.models.raft import RAFT
from raft_tpu_torch.obs import cost as cost_mod
from raft_tpu_torch.obs import default_sink, span
from raft_tpu_torch.ops.pad import InputPadder, max_bucket_hw
from raft_tpu_torch.utils.graphs import GraphCache
from raft_tpu_torch.utils.warp import forward_interpolate

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device without CUDA raises
    (the port never moves to the CPU on its own)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the port on "
            "the CPU")
    return dev


def default_alternate_corr_impl(device: DeviceLike = "cuda") -> str:
    """The ``--alternate_corr`` implementation for a device: the on-demand
    CUDA kernel on the card, its plain blockwise version on the CPU."""
    return "pallas" if torch.device(device).type == "cuda" else "chunked"


def make_inference_model(model_cfg: RAFTConfig,
                         state_dict: Optional[Mapping] = None,
                         device: DeviceLike = "cuda", *,
                         bucket_hw=None, batch=None,
                         tuning_kind=("eval",)) -> RAFT:
    """The RAFT module with the inference override applied, in eval mode
    on ``device``, holding ``state_dict`` when one is given.

    The per-hardware tuning registry (``tuning.py``) is consulted first
    for ``tuning_kind`` (default 'eval'; the serving engine passes
    ('serve', 'eval')): knobs left at their RAFTConfig defaults take the
    tuned winner for ``(bucket_hw, batch)``, or the nearest /
    most-recent entry when the shape is not known yet.  The inference
    override is applied AFTER tuning, so it holds unconditionally."""
    from raft_tpu_torch import tuning

    dev = resolve_device(device)
    model_cfg, _ = tuning.resolve_config(model_cfg, tuning_kind,
                                         bucket_hw, batch)
    if model_cfg.corr_impl == "allpairs_pallas":
        model_cfg = model_cfg.replace(corr_impl="allpairs",
                                      fused_lookup_encoder=False)
    model = RAFT(model_cfg).eval()
    if state_dict is not None:
        model.load_state_dict(state_dict)
    return model.to(dev)


def make_eval_fn(model_cfg: RAFTConfig, iters: int,
                 device: DeviceLike = "cuda", graphs: Optional[bool] = None):
    """``eval_fn(state_dict, image1, image2, flow_init=None) -> (flow_low,
    flow_up)``: the test-mode forward under ``torch.inference_mode()`` and
    :func:`entry_precision`.

    Images are ``(B, H, W, 3)`` in [0, 255] (tensors or arrays, moved to
    the device); ``flow_init`` is ``(B, H/8, W/8, 2)``.  Outputs are fp32
    on the device.  The weights are loaded when ``state_dict`` is a
    different object from the previous call's, so a caller that mutates
    one dict in place passes a new dict to reload it.

    On the card (``graphs`` default) each key (the images' and
    ``flow_init``'s shapes, with or without ``flow_init``, the cuDNN and
    cuBLAS flags)
    runs as one captured CUDA graph, the counterpart of the JAX package's
    two ``jax.jit`` entries; weights load in place, so a reload reaches
    the graphs.  ``eval_fn.captures`` is the :class:`CaptureCounter` of
    its captures (the JAX ``make_eval_fn``'s compiled keys).
    ``graphs=False`` runs eagerly (for comparisons); the CPU always does.

    ``eval_fn.capture_cost(state_dict, image1, image2)`` counts one
    eager no-init forward (``obs/cost.py``) and returns its
    ``ProgramCost``; with the event sink on, the first no-init call of
    each shape is counted the same way and emits one ``cost_report``
    (``RAFT_TELEMETRY_COST=0`` turns it off).  The hand-written kernels
    count zero but where their wrappers add the JAX package's formula
    (the fused gates), as in the JAX package's counts.
    """
    dev = resolve_device(device)
    graphs = dev.type == "cuda" if graphs is None else graphs
    if graphs and dev.type != "cuda":
        raise ValueError("graphs=True needs a CUDA device")
    model = make_inference_model(model_cfg, device=dev)
    loaded = {"sd": None}
    programs = GraphCache()

    def forward(image1, image2, flow_init=None):
        return model(image1, image2, iters=iters, flow_init=flow_init,
                     test_mode=True)

    def load(state_dict):
        if state_dict is not loaded["sd"]:
            model.load_state_dict(state_dict)
            loaded["sd"] = state_dict

    def run(args):
        if not graphs:
            return forward(*args)
        return programs(("test_mode", iters, len(args) == 3,
                         backend_flags()), forward, args)

    def capture_cost(state_dict, image1, image2):
        """The counted cost (``obs/cost.py``) of one eager no-init
        forward at this shape, named ``inference_<H>x<W>`` (the cost CLI
        calls this directly)."""
        load(state_dict)
        with torch.inference_mode(), entry_precision():
            args = [torch.as_tensor(x, dtype=torch.float32, device=dev)
                    for x in (image1, image2)]
            with cost_mod.counting() as count:
                forward(*args)
        return _inference_cost(count, args[0].shape, dev)

    # One cost_report per distinct forward shape when telemetry is on
    # (the validators stream constant-shape batches, so this fires once
    # a split), counted on the shape's first call, which runs eagerly
    # (the graph cache's warm-up call on the card); RAFT_TELEMETRY_COST=0
    # skips it.
    cost_seen: set = set()
    cost_on = os.environ.get("RAFT_TELEMETRY_COST", "1") == "1"

    def eval_fn(state_dict, image1, image2, flow_init=None):
        load(state_dict)
        with torch.inference_mode(), entry_precision():
            args = [torch.as_tensor(x, dtype=torch.float32, device=dev)
                    for x in (image1, image2, flow_init) if x is not None]
            shape = tuple(args[0].shape)
            if not (cost_on and flow_init is None
                    and shape not in cost_seen):
                return run(args)
            cost_seen.add(shape)
            sink = default_sink()
            if not sink.enabled:
                return run(args)
            with cost_mod.counting() as count:
                out = run(args)
        sink.emit("cost_report",
                  **_inference_cost(count, shape, dev).as_record())
        return out

    eval_fn.captures = programs.counter
    eval_fn.capture_cost = capture_cost
    return eval_fn


def _inference_cost(count, shape, dev: torch.device):
    """The ``inference_<H>x<W>`` cost of a forward over images of
    ``shape`` ``(B, H, W, 3)`` counted on ``dev``."""
    return cost_mod.counted_cost(
        count, program=f"inference_{shape[1]}x{shape[2]}",
        pairs_per_call=shape[0],
        kind="cpu" if dev.type == "cpu" else None)


def _peek_hw(path: str):
    """Image (H, W) from the file header only (no pixel decode)."""
    from PIL import Image

    with Image.open(path) as im:
        w, h = im.size
    return h, w


_BUCKET_CACHE: Dict[tuple, tuple] = {}


def _bucket_hw(ds) -> tuple:
    """One /8-aligned bucket shape covering every image of ``ds``.

    KITTI's resolutions vary (375x1242, 370x1224, ...); padding all of
    them to the largest lets the split stream through batches of one
    shape.  Edge-replicate padding repeats the border, so pixels inside
    the frame see the same receptive fields; what changes is the instance
    norm's statistics over the larger canvas.  The header peeks are
    cached per set of image paths (validators build a fresh dataset on
    every call)."""
    key = tuple(p1 for (p1, _) in ds.image_list)
    hit = _BUCKET_CACHE.get(key)
    if hit is None:
        if len(_BUCKET_CACHE) >= 64:
            _BUCKET_CACHE.clear()
        hit = _BUCKET_CACHE[key] = max_bucket_hw(_peek_hw(p) for p in key)
    return hit


def _batched_flows(state_dict, eval_fn, ds, mode: str, batch_size: int,
                   target=None):
    """Stream ``ds`` through ``eval_fn`` in batches of one shape; yields
    ``(sample, flow (H, W, 2) float32 array)`` per image, unpadded.

    Every image is padded to ``target`` (or to its own /8 shape, so then
    all images must share a resolution); the batch is stacked on the host
    and the forward moves it to its device.  The final partial batch
    repeats its last image, whose outputs are dropped."""
    n = len(ds)
    for start in range(0, n, batch_size):
        idxs = list(range(start, min(start + batch_size, n)))
        samples = [ds.load(i) for i in idxs]
        with span("raft_eval_pad", dataset=mode):
            padders = [InputPadder(s["image1"].shape, mode=mode,
                                   target=target) for s in samples]
            im1 = [p.pad_np(s["image1"]) for p, s in zip(padders, samples)]
            im2 = [p.pad_np(s["image2"]) for p, s in zip(padders, samples)]
            pad_n = batch_size - len(idxs)
            if pad_n:
                im1 += [im1[-1]] * pad_n
                im2 += [im2[-1]] * pad_n
            batch1, batch2 = np.stack(im1), np.stack(im2)
        # the forward span covers the launch AND the read back below, so
        # it measures the device time of the batch (one event a batch
        # when telemetry is on)
        with span("raft_eval_forward", dataset=mode, emit=True):
            _, flow_up = eval_fn(state_dict, batch1, batch2)
            flow_up = flow_up.cpu().numpy()
        for j, (s, p) in enumerate(zip(samples, padders)):
            yield s, p.unpad(flow_up[j])


def _epe(flow: np.ndarray, gt: np.ndarray) -> np.ndarray:
    return np.sqrt(np.sum((flow - gt) ** 2, axis=-1))


def validate_chairs(state_dict, model_cfg: RAFTConfig = RAFTConfig.full(),
                    iters: int = 24,
                    root: str = "datasets/FlyingChairs_release/data",
                    split_file: str = "chairs_split.txt",
                    eval_fn=None, batch_size: int = 4,
                    device: DeviceLike = "cuda") -> Dict[str, float]:
    """FlyingChairs validation-split EPE (384x512 images, one shape)."""
    eval_fn = eval_fn or make_eval_fn(model_cfg, iters, device=device)
    ds = datasets.FlyingChairs(split="validation", root=root,
                               split_file=split_file)
    epe_list = []
    for sample, flow in _batched_flows(state_dict, eval_fn, ds, "chairs",
                                       batch_size):
        with span("raft_eval_epe", dataset="chairs"):
            epe_list.append(_epe(flow, sample["flow"]).reshape(-1))
    epe = float(np.mean(np.concatenate(epe_list)))
    print(f"Validation Chairs EPE: {epe:.3f}", flush=True)
    default_sink().emit("eval", dataset="chairs", chairs=epe)
    return {"chairs": epe}


def validate_sintel(state_dict, model_cfg: RAFTConfig = RAFTConfig.full(),
                    iters: int = 32, root: str = "datasets/Sintel",
                    eval_fn=None, batch_size: int = 2,
                    device: DeviceLike = "cuda") -> Dict[str, float]:
    """Sintel training-split clean and final EPE, 1/3/5 px (436x1024
    frames, padded to 440x1024)."""
    eval_fn = eval_fn or make_eval_fn(model_cfg, iters, device=device)
    results = {}
    for dstype in ("clean", "final"):
        ds = datasets.MpiSintel(split="training", dstype=dstype, root=root)
        epe_list = []
        for sample, flow in _batched_flows(state_dict, eval_fn, ds,
                                           "sintel", batch_size,
                                           target=_bucket_hw(ds)):
            with span("raft_eval_epe", dataset="sintel"):
                epe_list.append(_epe(flow, sample["flow"]).reshape(-1))
        epe_all = np.concatenate(epe_list)
        epe = float(np.mean(epe_all))
        px1 = float(np.mean(epe_all < 1))
        px3 = float(np.mean(epe_all < 3))
        px5 = float(np.mean(epe_all < 5))
        print(f"Validation ({dstype}) EPE: {epe:.3f}, 1px: {px1:.3f}, "
              f"3px: {px3:.3f}, 5px: {px5:.3f}", flush=True)
        default_sink().emit("eval", dataset=f"sintel-{dstype}", epe=epe,
                            px1=px1, px3=px3, px5=px5)
        results[dstype] = epe
    return results


def validate_kitti(state_dict, model_cfg: RAFTConfig = RAFTConfig.full(),
                   iters: int = 24, root: str = "datasets/KITTI",
                   eval_fn=None, batch_size: int = 4, bucket: bool = True,
                   device: DeviceLike = "cuda") -> Dict[str, float]:
    """KITTI-15 training-split EPE and F1-all over the valid pixels.

    ``bucket=True`` pads every resolution to one shape and streams
    batches of ``batch_size``; ``bucket=False`` pads each image to its
    own /8 shape, one image a batch (the reference's padding)."""
    eval_fn = eval_fn or make_eval_fn(model_cfg, iters, device=device)
    ds = datasets.KITTI(split="training", root=root)
    target, bs = (_bucket_hw(ds), batch_size) if bucket else (None, 1)
    epe_list, out_list = [], []
    for sample, flow in _batched_flows(state_dict, eval_fn, ds, "kitti", bs,
                                       target=target):
        with span("raft_eval_epe", dataset="kitti"):
            epe = _epe(flow, sample["flow"])
            mag = np.sqrt(np.sum(sample["flow"] ** 2, axis=-1))
            val = sample["valid"] >= 0.5
            out = (epe > 3.0) & ((epe / np.maximum(mag, 1e-12)) > 0.05)
            epe_list.append(epe[val].mean())
            out_list.append(out[val])
    epe = float(np.mean(epe_list))
    f1 = 100.0 * float(np.mean(np.concatenate(out_list)))
    print(f"Validation KITTI: {epe:.3f}, {f1:.3f}", flush=True)
    default_sink().emit("eval", dataset="kitti", epe=epe, f1=f1)
    return {"kitti-epe": epe, "kitti-f1": f1}


def create_sintel_submission(state_dict,
                             model_cfg: RAFTConfig = RAFTConfig.full(),
                             iters: int = 32, warm_start: bool = False,
                             root: str = "datasets/Sintel",
                             output_path: str = "sintel_submission",
                             eval_fn=None, batch_size: int = 4,
                             device: DeviceLike = "cuda") -> None:
    """Write the test split's ``.flo`` predictions,
    ``<output_path>/<dstype>/<scene>/frame%04d.flo``.

    Each batch lane carries one sequence, so the warm start chains frames
    within a lane while lanes share one forward.  ``warm_start`` seeds
    each frame with the previous frame's 1/8 flow forward-warped along
    itself (on the host), for the lanes still active; a finished or
    padding lane gets a zero ``flow_init``, which equals no warm start.
    Finished lanes repeat their last frame and padding lanes mirror the
    last real lane; their outputs are never written."""
    eval_fn = eval_fn or make_eval_fn(model_cfg, iters, device=device)
    for dstype in ("clean", "final"):
        ds = datasets.MpiSintel(split="test", dstype=dstype, root=root)
        seq_frames: Dict[str, list] = {}
        for i, (scene, frame) in enumerate(ds.extra_info):
            seq_frames.setdefault(scene, []).append((frame, i))
        lanes_all = [[i for _, i in sorted(v)] for v in seq_frames.values()]
        if not lanes_all:
            continue
        B = min(batch_size, len(lanes_all))
        for g0 in range(0, len(lanes_all), B):
            real = lanes_all[g0:g0 + B]
            lanes = real + [[]] * (B - len(real))
            flow_prev = None
            cache = [None] * B  # (sample, padder) of a finished lane
            for t in range(max(len(ln) for ln in real)):
                samples, padders = [], []
                for j, ln in enumerate(lanes):
                    if t < len(ln):
                        s = ds.load(ln[t])
                        p = InputPadder(s["image1"].shape, mode="sintel")
                        cache[j] = (s, p)
                    elif cache[j] is not None:
                        s, p = cache[j]
                    else:
                        s, p = samples[len(real) - 1], padders[len(real) - 1]
                    samples.append(s)
                    padders.append(p)
                im1 = np.stack([p.pad_np(s["image1"])
                                for p, s in zip(padders, samples)])
                im2 = np.stack([p.pad_np(s["image2"])
                                for p, s in zip(padders, samples)])
                flow_low, flow_up = eval_fn(state_dict, im1, im2, flow_prev)
                flow_up = flow_up.cpu().numpy()
                if warm_start:
                    low = flow_low.cpu().numpy()
                    flow_prev = np.stack([
                        forward_interpolate(low[j])
                        if t + 1 < len(lanes[j]) else np.zeros_like(low[j])
                        for j in range(B)])
                for j, (ln, s, p) in enumerate(zip(lanes, samples, padders)):
                    if t >= len(ln):
                        continue
                    scene, frame = s["extra_info"]
                    out_dir = osp.join(output_path, dstype, scene)
                    os.makedirs(out_dir, exist_ok=True)
                    frame_utils.write_flo(
                        osp.join(out_dir, f"frame{frame + 1:04d}.flo"),
                        p.unpad(flow_up[j]))


def create_kitti_submission(state_dict,
                            model_cfg: RAFTConfig = RAFTConfig.full(),
                            iters: int = 24, root: str = "datasets/KITTI",
                            output_path: str = "kitti_submission",
                            eval_fn=None, batch_size: int = 4,
                            bucket: bool = False,
                            device: DeviceLike = "cuda") -> None:
    """Write the test split's 16-bit PNG flow, ``<output_path>/<frame>``.

    ``bucket=False`` (the default) pads each image exactly, one image a
    batch, as the uploaded artifact is; ``bucket=True`` streams the split
    in batches of one bucket shape, as the validator does."""
    eval_fn = eval_fn or make_eval_fn(model_cfg, iters, device=device)
    ds = datasets.KITTI(split="testing", root=root)
    os.makedirs(output_path, exist_ok=True)
    target, bs = (_bucket_hw(ds), batch_size) if bucket else (None, 1)
    for sample, flow in _batched_flows(state_dict, eval_fn, ds, "kitti", bs,
                                       target=target):
        (frame_id,) = sample["extra_info"]
        frame_utils.write_flow_kitti(osp.join(output_path, frame_id), flow)


VALIDATORS = {
    "chairs": validate_chairs,
    "sintel": validate_sintel,
    "kitti": validate_kitti,
}


def evaluate_epe_delta(state_dict, model_cfg: RAFTConfig, dtypes,
                       dataset: str = "chairs", iters: int = 24,
                       batch_size: int = 4, **validator_kwargs) -> Dict:
    """One checkpoint, one dataset, N correlation storage dtypes: runs
    the validator once per ``corr_dtype`` (nothing else differs) and
    reports each arm's metrics and their deltas against the first.

    Returns ``{"dataset", "dtypes", "per_dtype": {dtype: metrics},
    "delta_vs_<base>": {dtype: {metric: delta}}}``."""
    dtypes = [validate_corr_dtype(d) for d in dtypes]
    if len(dtypes) < 2:
        raise ValueError(f"--epe_delta needs >= 2 dtypes, got {dtypes}")
    validator = VALIDATORS[dataset]
    per_dtype: Dict[str, Dict[str, float]] = {}
    for dt in dtypes:
        cfg = model_cfg.replace(corr_dtype=dt)
        print(f"--- corr_dtype={dt} ---", flush=True)
        per_dtype[dt] = validator(state_dict, cfg, iters=iters,
                                  batch_size=batch_size, **validator_kwargs)
    base = dtypes[0]
    deltas = {
        dt: {k: round(per_dtype[dt][k] - per_dtype[base][k], 6)
             for k in per_dtype[base]}
        for dt in dtypes[1:]
    }
    for dt, d in deltas.items():
        line = ", ".join(f"{k}: {v:+.4f}" for k, v in d.items())
        print(f"EPE delta {dt} - {base} [{dataset}]: {line}", flush=True)
    return {"dataset": dataset, "dtypes": list(dtypes),
            "per_dtype": per_dtype, f"delta_vs_{base}": deltas}


# The datasets the early-exit sweep can stream (a seam tests patch, like
# VALIDATORS): name -> constructor.
EARLY_EXIT_DATASETS = {
    "chairs": lambda **kw: datasets.FlyingChairs(split="validation", **kw),
    "sintel": lambda **kw: datasets.MpiSintel(split="training",
                                              dstype="clean", **kw),
    "kitti": lambda **kw: datasets.KITTI(split="training", **kw),
}


def _early_exit_flows(state_dict, runner, ds, mode: str, batch_size: int,
                      iters: int, threshold: float, target=None):
    """Stream ``ds`` through an
    :class:`~raft_tpu_torch.serve.slots.EarlyExitRunner` in batches of
    one shape; yields ``(sample, flow (H, W, 2) unpadded, iters_used,
    residual)`` per image (the early-exit counterpart of
    :func:`_batched_flows`; ``residual`` is the lane's ``delta_max`` at
    its retirement)."""
    n = len(ds)
    for start in range(0, n, batch_size):
        idxs = list(range(start, min(start + batch_size, n)))
        samples = [ds.load(i) for i in idxs]
        padders = [InputPadder(s["image1"].shape, mode=mode, target=target)
                   for s in samples]
        im1 = [p.pad_np(s["image1"]) for p, s in zip(padders, samples)]
        im2 = [p.pad_np(s["image2"]) for p, s in zip(padders, samples)]
        pad_n = batch_size - len(idxs)
        if pad_n:  # keep the batch shape on the final chunk
            im1 += [im1[-1]] * pad_n
            im2 += [im2[-1]] * pad_n
        with span("raft_eval_forward", dataset=mode, emit=True):
            flow_up, used, resid = runner.run(
                state_dict, np.stack(im1), np.stack(im2), iters, threshold,
                return_residuals=True)
        for j, (s, p) in enumerate(zip(samples, padders)):
            yield s, p.unpad(flow_up[j]), int(used[j]), float(resid[j])


def evaluate_early_exit_delta(state_dict, model_cfg: RAFTConfig,
                              thresholds, dataset: str = "chairs",
                              iters: int = 24, batch_size: int = 4,
                              bucket: bool = True,
                              device: DeviceLike = "cuda",
                              **dataset_kwargs) -> Dict:
    """One checkpoint, one dataset, N early-exit thresholds against the
    full-iteration baseline: the accuracy gate of the serving engine's
    ``early_exit_threshold``.

    Arm 0 is always the baseline (threshold 0: every lane runs all
    ``iters``); each requested threshold re-streams the same samples
    through the same :class:`~raft_tpu_torch.serve.slots.EarlyExitRunner`
    (the serving engine's slot programs).  Per arm: the EPE, its delta
    against the baseline, ``iters_used`` mean / p50 / p95 and the
    retirement residual's mean and p50.

    Returns ``{"dataset", "iters", "thresholds", "per_threshold": {thr:
    {...}}, "delta_vs_full": {thr: epe_delta}}`` with the thresholds as
    strings, and emits an ``eval_early_exit_delta`` event."""
    from raft_tpu_torch.serve.slots import EarlyExitRunner

    thrs = [float(t) for t in thresholds]
    if not thrs:
        raise ValueError("--early_exit_threshold needs >= 1 threshold")
    if any(t < 0 for t in thrs):
        raise ValueError(f"thresholds must be >= 0: {thrs}")
    try:
        make_ds = EARLY_EXIT_DATASETS[dataset]
    except KeyError:
        raise ValueError(f"unknown dataset {dataset!r}; choose from "
                         f"{sorted(EARLY_EXIT_DATASETS)}")
    arms, seen = [], set()
    for t in [0.0] + thrs:          # baseline first, dedup after
        if t not in seen:
            seen.add(t)
            arms.append(t)
    runner = EarlyExitRunner(model_cfg, device=device)
    ds = make_ds(**dataset_kwargs)
    target = _bucket_hw(ds) if bucket else None
    per: Dict[str, Dict[str, float]] = {}
    base_epe = None
    for t in arms:
        epes, used_all, resid_all = [], [], []
        print(f"--- early_exit_threshold={t:g} ---", flush=True)
        for sample, flow, used, resid in _early_exit_flows(
                state_dict, runner, ds, dataset, batch_size, iters, t,
                target=target):
            epes.append(_epe(flow, sample["flow"]).reshape(-1))
            used_all.append(used)
            resid_all.append(resid)
        epe = float(np.mean(np.concatenate(epes)))
        used_np = np.asarray(used_all, np.float64)
        resid_np = np.asarray(resid_all, np.float64)
        if base_epe is None:
            base_epe = epe
        per[f"{t:g}"] = {
            "epe": round(epe, 6),
            "epe_delta": round(epe - base_epe, 6),
            "iters_mean": round(float(used_np.mean()), 3),
            "iters_p50": float(np.percentile(used_np, 50)),
            "iters_p95": float(np.percentile(used_np, 95)),
            "residual_mean": round(float(resid_np.mean()), 6),
            "residual_p50": round(float(np.percentile(resid_np, 50)), 6),
        }
        print(f"early-exit thr={t:g} [{dataset}]: EPE {epe:.4f} "
              f"(delta {epe - base_epe:+.4f}), iters p50 "
              f"{per[f'{t:g}']['iters_p50']:g} p95 "
              f"{per[f'{t:g}']['iters_p95']:g}", flush=True)
    deltas = {k: v["epe_delta"] for k, v in per.items() if k != "0"}
    default_sink().emit("eval_early_exit_delta", dataset=dataset,
                        iters=iters, thresholds=[f"{t:g}" for t in arms],
                        deltas=deltas)
    return {"dataset": dataset, "iters": iters,
            "thresholds": [f"{t:g}" for t in arms],
            "per_threshold": per, "delta_vs_full": deltas}


def evaluate_quality_proxies(state_dict, model_cfg: RAFTConfig,
                             dataset: str = "chairs", iters: int = 24,
                             batch_size: int = 4, bucket: bool = True,
                             cycle: bool = False,
                             device: DeviceLike = "cuda",
                             **dataset_kwargs) -> Dict:
    """Calibrate the unsupervised quality proxies
    (:mod:`raft_tpu_torch.obs.quality`) against ground truth: stream a
    labeled dataset through the serving engine's
    :class:`~raft_tpu_torch.serve.slots.EarlyExitRunner`, score every
    sample with the label-free proxies the serving path records, and
    report the Spearman rank correlation of each proxy with the true
    per-image EPE.

    Serving scores live traffic with these proxies
    (``ServeConfig.quality_sample_rate``) and the fleet gates weight
    rollouts on them (``canary_proxy_budget``); neither ever sees a
    label.  This is the check that the proxies RANK bad flow as bad.

    Proxies scored per image:

    - ``photometric``: occlusion-masked charbonnier warp error
      (:func:`raft_tpu_torch.obs.quality.score_pair`), the statistic the
      serving sampler records;
    - ``residual``: the convergence ``delta_max`` at lane retirement;
    - ``cycle`` (``cycle=True`` only, twice the forward cost): a second
      pass on swapped frames, forward-backward consistency
      (:func:`raft_tpu_torch.obs.quality.cycle_error`).

    Returns ``{"dataset", "iters", "n", "epe_mean", "spearman": {proxy:
    rho}, "proxy_means": {proxy: mean}}`` and emits an
    ``eval_quality_proxies`` event with the same payload."""
    try:
        make_ds = EARLY_EXIT_DATASETS[dataset]
    except KeyError:
        raise ValueError(f"unknown dataset {dataset!r}; choose from "
                         f"{sorted(EARLY_EXIT_DATASETS)}")
    from raft_tpu_torch.obs import quality
    from raft_tpu_torch.serve.slots import EarlyExitRunner

    runner = EarlyExitRunner(model_cfg, device=device)
    ds = make_ds(**dataset_kwargs)
    target = _bucket_hw(ds) if bucket else None
    epes, photo, resids, flows_fw = [], [], [], []
    for sample, flow, _used, resid in _early_exit_flows(
            state_dict, runner, ds, dataset, batch_size, iters, 0.0,
            target=target):
        epes.append(float(_epe(flow, sample["flow"]).mean()))
        scores = quality.score_pair(sample["image1"], sample["image2"],
                                    flow)
        photo.append(scores["photometric"])
        resids.append(resid)
        if cycle:
            flows_fw.append(flow)
    proxies = {"photometric": photo, "residual": resids}
    if cycle:
        cyc = []
        swapped = _SwappedPairs(ds)
        for k, (_s, flow_bw, _u, _r) in enumerate(_early_exit_flows(
                state_dict, runner, swapped, dataset, batch_size, iters,
                0.0, target=target)):
            err, _occ = quality.cycle_error(
                torch.from_numpy(np.ascontiguousarray(flows_fw[k][None])),
                torch.from_numpy(np.ascontiguousarray(flow_bw[None])))
            cyc.append(float(err[0]))
        proxies["cycle"] = cyc
    spear = {k: round(quality.spearman(v, epes), 4)
             for k, v in proxies.items()}
    rec = {
        "dataset": dataset, "iters": iters, "n": len(epes),
        "epe_mean": round(float(np.mean(epes)), 6),
        "spearman": spear,
        "proxy_means": {k: round(float(np.mean(v)), 6)
                        for k, v in proxies.items()},
    }
    default_sink().emit("eval_quality_proxies", **rec)
    for k, rho in spear.items():
        print(f"quality proxy [{dataset}] {k}: spearman(EPE) "
              f"{rho:+.4f}", flush=True)
    return rec


class _SwappedPairs:
    """Frame-swapped view of an eval dataset: ``image1`` and ``image2``
    exchanged (flow passed through untouched), so a second
    :func:`_early_exit_flows` pass yields the BACKWARD flow for the
    cycle-consistency proxy."""

    def __init__(self, ds):
        self._ds = ds

    def __len__(self):
        return len(self._ds)

    def load(self, i):
        s = dict(self._ds.load(i))
        s["image1"], s["image2"] = s["image2"], s["image1"]
        return s
