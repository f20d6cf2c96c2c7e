"""``python -m raft_tpu_torch autotune``: sweep the ``RAFTConfig`` knob
surface on the card and persist the winner in the per-hardware tuning
registry (the port of ``scripts/autotune.py``, the same flags, grid
rules, point order, cache and record).

It times a seeded, time-boxed cross-product of the knobs with the port's
own entry points (synthetic inputs, warm-up calls that cover the eager
call and the capture of the CUDA graph, then steady-state calls closed by
one wait on the card) and writes the winner into ``tuning.py``'s
registry, keyed by ``(kind, device_kind, bucket_hw, batch)``.  From then
on every train / eval / serve entry point that leaves those knobs at
their defaults runs the tuned configuration on this card::

    python -m raft_tpu_torch autotune                  # train, chairs crop
    python -m raft_tpu_torch autotune --kind eval --image 440x1024 \\
        --batch-per-chip 1                             # test-mode forward
    python -m raft_tpu_torch autotune --kind serve     # engine dispatcher
    python -m raft_tpu_torch autotune --tiny --device cpu   # CPU smoke

- ``--kind train`` times ``train.step.make_train_step`` (pairs/s),
  ``--kind eval`` ``evaluate.make_eval_fn`` (frames/s), ``--kind serve``
  an ``InferenceEngine`` on a closed loop of ``batch`` concurrent
  requests a wave (pairs/s; request mode ignores the slot knobs, so
  those points collapse to one).  Every point runs on one card in bf16;
  the port's data parallel is one process a rank, so a point times world 1.
- On the card the kernel axes take both values (``corr_impl``,
  ``fused_lookup_encoder``, ``fused_gru``, ``upsample_loss_kernel``); on
  the CPU they take one each, since the kernels reach only their plain
  versions there.  A point the port's ``RAFTConfig`` refuses
  (``fused_lookup_encoder`` without ``corr_impl='allpairs_pallas'``) is
  dropped after the shuffle, never timed, and counted in
  ``points_refused``.  There is no fallback: a point whose kernel fails
  to build or launch fails the sweep.
- A finished sweep records its ``sweep_id`` (the grid, the timing
  parameters, the tool's version and the hash of the kernel sources that
  ``ops/build.py`` keys its libraries by); the same sweep against the
  same registry is a cache hit (``--force`` re-measures).  The registry
  is switched off while it runs (``RAFT_TUNING=0``), so no earlier
  winner replaces the knobs under test; each point's model, state,
  graphs or engine are dropped, then ``gc`` and ``empty_cache`` run,
  before the next one.
- ``--tiny`` is the CPU smoke: a 2-point sweep on a toy shape, a second
  call that must hit the cache, and a tiny train step (``--kind eval``:
  a forward; ``--kind serve``: an engine's request) that must consume
  the entry.
- ``--seed-known`` writes the winners measured by this tool's full
  sweeps on an NVIDIA H100 80GB HBM3 (PERF.md) into the registry, with
  that card and its power limit as provenance.  On any other device kind
  it exits 2: H100 winners written for another card would pass for that
  card's own.
- Quantized correlation storage (``int8``) stays out of the eval grid
  unless ``--allow-quantized``: gate it with ``python -m raft_tpu_torch
  evaluate ... --epe_delta float32,int8`` first.
"""

from __future__ import annotations

import argparse
import gc
import hashlib
import itertools
import json
import os
import random
import subprocess
import tempfile
import time
from typing import Dict, List, Optional

_AUTOTUNE_VERSION = 1
TOOL = "raft_tpu_torch autotune"
UNITS = {"train": "image-pairs/sec/chip", "eval": "frames/sec/chip",
         "serve": "pairs/sec/chip"}
SERVE_KNOBS = ("batching", "slots", "early_exit_threshold")


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m raft_tpu_torch autotune",
        description="sweep the RAFTConfig knob surface on the card, "
                    "persist the winner in the per-hardware tuning "
                    "registry")
    p.add_argument("--kind", default="train",
                   choices=["train", "eval", "serve"],
                   help="workload to tune: the captured training step, "
                        "the test-mode eval forward, or the serving "
                        "engine's dispatcher knobs")
    p.add_argument("--image", default="368x496",
                   help="input HxW (the registry bucket key); default "
                        "is the chairs training crop")
    p.add_argument("--batch-per-chip", "--batch_per_chip", type=int,
                   default=16, help="per-device batch (registry key)")
    p.add_argument("--iters", type=int, default=None,
                   help="refinement iterations (default: 12 train / "
                        "32 eval and serve)")
    p.add_argument("--steps", type=int, default=8,
                   help="timed steps per sweep point")
    p.add_argument("--warmup", type=int, default=2,
                   help="untimed warm-up calls per point (at least the "
                        "eager call and the capture on the card)")
    p.add_argument("--time-box", type=float, default=900.0,
                   help="sweep wall-clock budget in seconds; points are "
                        "visited in seeded-shuffled order and the sweep "
                        "stops STARTING new points at the deadline (at "
                        "least one point always completes)")
    p.add_argument("--seed", type=int, default=0,
                   help="seed for the sweep-order shuffle and the "
                        "synthetic inputs")
    p.add_argument("--out", default=None,
                   help="registry file (default: $RAFT_TUNING_REGISTRY "
                        "or ~/.cache/raft_tpu/tuning.json)")
    p.add_argument("--force", action="store_true",
                   help="re-measure even when the registry already "
                        "holds this exact sweep (same sweep_id)")
    p.add_argument("--allow-quantized", action="store_true",
                   help="include int8 corr storage in the eval grid "
                        "(run the EPE-delta gate first)")
    p.add_argument("--tiny", action="store_true",
                   help="smoke: 2-point sweep on a toy shape, cache-hit "
                        "re-invocation, and a tiny consumer of the "
                        "written entry")
    p.add_argument("--seed-known", action="store_true",
                   help="no sweep: write the winners this tool measured "
                        "on an NVIDIA H100 80GB HBM3 into the registry, "
                        "provenance-labeled as seeded (refused on any "
                        "other device kind)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu: where every point runs")
    return p.parse_args(argv)


# The winners of this tool's full sweeps on the card below, with their
# rates (PERF.md: the three sweeps, every point's rate).  ``--seed-known``
# installs them as the starting table of a card of the same kind; a real
# sweep later re-measures (a seeded entry has no sweep_id, so it is never
# a hit).  The serve entry is the best point whose answers are exact
# (early_exit_threshold 0): on the sweep's random weights a slot retires
# after a few iterations, so early exit's rate there says nothing of
# trained weights, and a seeded threshold would change every answer.
KNOWN_DEVICE = "NVIDIA H100 80GB HBM3"
KNOWN_POWER_LIMIT = "700.00 W"
KNOWN_WINNERS = {
    ("train", (368, 496), 8): ({
        "corr_impl": "allpairs_pallas",
        "corr_dtype": "auto",
        "remat": False,
        "remat_upsample": False,
        "fused_lookup_encoder": False,
        "fused_gru": True,
        "upsample_loss_kernel": "pallas",
    }, 88.714),
    ("eval", (440, 1024), 1): ({
        "corr_impl": "pallas",
        "corr_dtype": "float32",
    }, 39.505),
    ("serve", (368, 496), 16): ({
        "batching": "request",
        "fused_gru": True,
    }, 64.034),
}


def card_identity(dev) -> Dict[str, Optional[str]]:
    """``{"device_kind", "power_limit"}`` of the ``torch.device`` a sweep
    runs on: the card's name and the power limit ``nvidia-smi`` reports
    (None where it cannot say), or ``cpu``."""
    import torch

    if dev.type != "cuda":
        return {"device_kind": "cpu", "power_limit": None}
    index = dev.index if dev.index is not None else 0
    limit = None
    try:
        out = subprocess.run(
            ["nvidia-smi", "-i", str(index),
             "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        if out.returncode == 0 and out.stdout.strip():
            limit = out.stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        pass
    return {"device_kind": torch.cuda.get_device_name(index),
            "power_limit": limit}


def seed_known(out=None) -> List[str]:
    """Write :data:`KNOWN_WINNERS` as seeded registry entries for
    :data:`KNOWN_DEVICE` (provenance mode 'seed-known').  Returns the
    keys."""
    from raft_tpu_torch import tuning

    keys = []
    for (kind, hw, batch), (knobs, value) in KNOWN_WINNERS.items():
        keys.append(tuning.save_entry(
            kind, hw, batch, knobs,
            provenance={"tool": TOOL, "mode": "seed-known",
                        "source": "the full sweeps of this tool on the "
                                  "card (PERF.md)",
                        "card": KNOWN_DEVICE,
                        "power_limit": KNOWN_POWER_LIMIT,
                        "best_value": value, "unit": UNITS[kind]},
            path=out, device=KNOWN_DEVICE))
    return keys


def grid(kind: str, tiny: bool = False, allow_quantized: bool = False,
         device="cuda") -> Dict[str, list]:
    """The knob cross-product for one workload on ``device``: JAX's
    on-TPU grid on the card, less the knobs the port's ``RAFTConfig``
    does not have (``scan_unroll``, ``fuse_upsample_in_scan``), and JAX's
    off-TPU grid on the CPU, where the kernel axes take one value each."""
    import torch

    on_card = torch.device(device).type == "cuda"
    fused_axis = [False, True] if on_card else [False]
    if kind == "serve":
        if tiny:
            return {"batching": ["request", "slot"], "slots": [2]}
        return {
            "batching": ["request", "slot"],
            "slots": [4, 8, 16],
            "early_exit_threshold": [0.0, 0.05, 0.2],
            "fused_gru": fused_axis,
        }
    if tiny:
        # 2 points: one fused knob rides the sweep -> save_entry ->
        # resolve_config loop (on the CPU it reaches the plain gates:
        # plumbing coverage, not a kernel measurement)
        return {"fused_lookup_encoder": [False],
                "fused_gru": [False, True]}
    if kind == "eval":
        g = {
            "corr_impl": (["allpairs", "allpairs_pallas", "pallas"]
                          if on_card else ["allpairs", "chunked"]),
            "corr_dtype": ["auto", "float32"],
        }
        if allow_quantized:
            g["corr_dtype"].append("int8")
        return g
    g = {
        "corr_impl": (["allpairs_pallas", "allpairs"] if on_card
                      else ["allpairs"]),
        "corr_dtype": ["auto", "float32"],
        "remat": [False, True],
        "remat_upsample": [False, True],
        "fused_lookup_encoder": fused_axis,
        "fused_gru": fused_axis,
    }
    if on_card:
        g["upsample_loss_kernel"] = ["xla", "pallas"]
    return g


kind_grid = grid     # run_sweep's own ``grid`` argument shadows the name


def _cross(g: dict, seed: int) -> List[dict]:
    """JAX's ``_points``: the cross-product, the serve-mode collapse (a
    request-mode point drops the slot-only knobs), the seeded shuffle."""
    keys = sorted(g)
    pts = [dict(zip(keys, vals))
           for vals in itertools.product(*(g[k] for k in keys))]
    if "batching" in g:
        slot_only = ("slots", "early_exit_threshold")
        seen, uniq = set(), []
        for p in pts:
            if p.get("batching") == "request":
                p = {k: v for k, v in p.items() if k not in slot_only}
            key = json.dumps(p, sort_keys=True)
            if key not in seen:
                seen.add(key)
                uniq.append(p)
        pts = uniq
    random.Random(seed).shuffle(pts)
    return pts


def _model_cfg(knobs: dict, tiny: bool, compute_dtype="bfloat16"):
    from raft_tpu_torch import tuning
    from raft_tpu_torch.config import RAFTConfig

    mk = RAFTConfig.small_model if tiny else RAFTConfig.full
    return mk(compute_dtype=compute_dtype,
              **{k: v for k, v in knobs.items() if k in tuning.TUNABLE_KNOBS})


def refusal(knobs: dict) -> Optional[str]:
    """Why the port's configuration refuses ``knobs``, or None (the
    rules do not depend on the model preset)."""
    from raft_tpu_torch.serve.engine import ServeConfig

    try:
        _model_cfg(knobs, tiny=False)
        ServeConfig(**{k: knobs[k] for k in SERVE_KNOBS if k in knobs})
    except ValueError as e:
        return str(e)
    return None


def points(g: dict, seed: int) -> List[dict]:
    """JAX's point order with the points the port refuses removed."""
    return [p for p in _cross(g, seed) if refusal(p) is None]


def kernel_digest() -> str:
    """Hash of the kernel sources as ``ops/build.py`` keys its libraries
    (each source with the shared headers and the flags)."""
    from raft_tpu_torch.ops import build

    names = " ".join(build.library_path(n).name for n in build.SOURCES)
    return hashlib.sha256(names.encode()).hexdigest()[:16]


def sweep_id(kind, g, hw, batch, iters, steps, warmup, seed,
             kernels: Optional[str] = None) -> str:
    blob = json.dumps({"v": _AUTOTUNE_VERSION, "kind": kind,
                       "grid": {k: list(v) for k, v in sorted(g.items())},
                       "hw": list(hw), "batch": batch, "iters": iters,
                       "steps": steps, "warmup": warmup, "seed": seed,
                       "kernels": kernels or kernel_digest()},
                      sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def _synth_batch(hw, batch, seed):
    import numpy as np

    H, W = hw
    rng = np.random.default_rng(seed)
    return {
        "image1": rng.uniform(0, 255, (batch, H, W, 3)).astype(np.float32),
        "image2": rng.uniform(0, 255, (batch, H, W, 3)).astype(np.float32),
        "flow": (8.0 * rng.standard_normal((batch, H, W, 2))
                 ).astype(np.float32),
        "valid": np.ones((batch, H, W), np.float32),
    }


def _calls(fn, n: int, dev) -> float:
    """Seconds of ``n`` calls of ``fn``, closed by one wait on the card."""
    from raft_tpu_torch.utils.profiling import device_sync

    device_sync(dev)
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    device_sync(dev)
    return time.perf_counter() - t0


def _time_train_point(knobs, hw, batch, iters, steps, warmup, seed, tiny,
                      dev) -> float:
    """pairs/s of one knob point: the captured train step on a reused
    synthetic batch, after warm-up steps (the eager call and the
    capture)."""
    import torch

    from raft_tpu_torch.config import TrainConfig
    from raft_tpu_torch.train.step import init_state, make_train_step

    cfg = TrainConfig(num_steps=max(steps * 4, 100), batch_size=batch,
                      image_size=tuple(hw), iters=iters)
    state = init_state(_model_cfg(knobs, tiny), cfg, device=dev)
    step_fn = make_train_step(cfg, device=dev)
    data = {k: torch.as_tensor(v, device=dev)
            for k, v in _synth_batch(hw, batch, seed).items()}

    def step():
        step_fn(state, data)

    _calls(step, max(warmup, 2 if step_fn.graphs else 1), dev)
    return steps * batch / _calls(step, steps, dev)


def _time_eval_point(knobs, hw, batch, iters, steps, warmup, seed, tiny,
                     dev) -> float:
    """frames/s of one knob point on the test-mode forward."""
    import numpy as np
    import torch

    from raft_tpu_torch.evaluate import make_eval_fn
    from raft_tpu_torch.models.raft import RAFT

    model_cfg = _model_cfg(knobs, tiny)
    H, W = hw
    rng = np.random.default_rng(seed)
    img1, img2 = (torch.as_tensor(
        rng.uniform(0, 255, (batch, H, W, 3)).astype(np.float32),
        device=dev) for _ in range(2))
    sd = RAFT(model_cfg, seed=0).state_dict()
    fwd = make_eval_fn(model_cfg, iters, device=dev)

    def call():
        fwd(sd, img1, img2)

    _calls(call, max(warmup, 2 if dev.type == "cuda" else 1), dev)
    return steps * batch / _calls(call, steps, dev)


def _time_serve_point(knobs, hw, batch, iters, steps, warmup, seed, tiny,
                      dev) -> float:
    """pairs/s of one ServeConfig knob point through an
    ``InferenceEngine`` on a closed loop (``batch`` concurrent requests
    a wave, ``steps`` timed waves); model-level knobs (``fused_gru``)
    configure the engine's model."""
    import numpy as np

    from raft_tpu_torch.models.raft import RAFT
    from raft_tpu_torch.serve.engine import InferenceEngine, ServeConfig

    model_cfg = _model_cfg(knobs, tiny)
    H, W = hw
    cfg = ServeConfig(iters=int(knobs.get("iters", iters)),
                      max_batch=batch, batch_sizes=(batch,),
                      max_wait_ms=2.0,
                      **{k: knobs[k] for k in SERVE_KNOBS if k in knobs})
    rng = np.random.default_rng(seed)
    pairs = [(rng.uniform(0, 255, (H, W, 3)).astype(np.float32),
              rng.uniform(0, 255, (H, W, 3)).astype(np.float32))
             for _ in range(batch)]
    eng = InferenceEngine(RAFT(model_cfg, seed=0).state_dict(), model_cfg,
                          cfg, device=dev)
    with eng:
        eng.warmup([hw])

        def wave():
            futs = [eng.submit(a, b) for a, b in pairs]
            for f in futs:
                f.result(timeout=600)

        for _ in range(max(warmup, 1)):
            wave()
        t0 = time.perf_counter()
        for _ in range(steps):
            wave()
        dt = time.perf_counter() - t0
    return steps * len(pairs) / dt


TIMERS = {"train": _time_train_point, "eval": _time_eval_point,
          "serve": _time_serve_point}


def _release(dev) -> Optional[float]:
    """Drop what the last point left (its cycles too) and give the card's
    free blocks back; the reserved memory after, in GiB (None off the
    card)."""
    import torch

    gc.collect()
    if dev.type != "cuda":
        return None
    torch.cuda.empty_cache()
    return torch.cuda.memory_reserved(dev) / 2.0 ** 30


def run_sweep(kind, hw, batch_per_chip, iters, steps, warmup, time_box,
              seed, out, force=False, tiny=False, allow_quantized=False,
              device="cuda", grid=None):
    """Sweep -> persist winner.  Returns the result record (one JSON
    line, JAX's schema) without printing it.  ``grid`` replaces the
    kind's grid (a sub-grid for a short check)."""
    from raft_tpu_torch import ops, tuning
    from raft_tpu_torch.evaluate import resolve_device

    dev = resolve_device(device)
    g = kind_grid(kind, tiny, allow_quantized, dev) if grid is None else grid
    sid = sweep_id(kind, g, hw, batch_per_chip, iters, steps, warmup,
                   seed)
    out = out or tuning.default_registry_path()
    card = card_identity(dev)
    metric = f"autotune_{kind}_{hw[0]}x{hw[1]}_b{batch_per_chip}"
    existing = tuning.lookup(kind, tuple(hw), batch_per_chip,
                             device=card["device_kind"], path=out)
    if (existing is not None and existing[2]
            and existing[1].get("provenance", {}).get("sweep_id") == sid
            and not force):
        return {
            "metric": metric,
            "value": existing[1]["provenance"].get("best_value"),
            "unit": existing[1]["provenance"].get("unit", ""),
            "vs_baseline": 0.0,
            "config": {"cache_hit": True, "key": existing[0],
                       "knobs": existing[1]["knobs"],
                       "sweep_id": sid, "registry": out},
        }

    timer, unit = TIMERS[kind], UNITS[kind]
    pts = points(g, seed)
    refused = len(_cross(g, seed)) - len(pts)
    # the sweep measures each point's own knobs: a registry consult in
    # the entry points would put the previous winner in their place
    prev_disable = os.environ.get(tuning.ENV_DISABLE)
    os.environ[tuning.ENV_DISABLE] = "0"
    results = []
    deadline = time.monotonic() + time_box
    t_start = time.monotonic()
    try:
        for i, knobs in enumerate(pts):
            if results and time.monotonic() > deadline:
                print(f"time box hit after {len(results)}/{len(pts)} "
                      "points", flush=True)
                break
            before = ops.launch_counts()
            value = timer(knobs, hw, batch_per_chip, iters, steps, warmup,
                          seed, tiny, dev)
            launches = {k: v - before.get(k, 0)
                        for k, v in ops.launch_counts().items()
                        if v != before.get(k, 0)}
            reserved = _release(dev)
            results.append({"knobs": knobs, "value": value,
                            "reserved_gib": reserved,
                            "launches": launches})
            print(f"[{i + 1}/{len(pts)}] {json.dumps(knobs)} -> "
                  f"{value:.3f} {unit}" + (
                      "" if reserved is None else
                      f" (reserved after release {reserved:.3f} GiB)"),
                  flush=True)
    finally:
        if prev_disable is None:
            os.environ.pop(tuning.ENV_DISABLE, None)
        else:
            os.environ[tuning.ENV_DISABLE] = prev_disable
    best = max(results, key=lambda r: r["value"])
    key = tuning.save_entry(
        kind, tuple(hw), batch_per_chip, best["knobs"],
        provenance={"tool": TOOL, "seed": seed, "sweep_id": sid,
                    "points_tried": len(results),
                    "points_total": len(pts), "points_refused": refused,
                    "steps": steps, "warmup": warmup, "iters": iters,
                    "best_value": round(best["value"], 3), "unit": unit,
                    "time_box_s": time_box, "card": card["device_kind"],
                    "power_limit": card["power_limit"],
                    "elapsed_s": round(time.monotonic() - t_start, 1)},
        path=out, device=card["device_kind"])
    return {
        "metric": metric,
        "value": round(best["value"], 3),
        "unit": unit,
        "vs_baseline": 0.0,
        "config": {"cache_hit": False, "key": key, "knobs": best["knobs"],
                   "points_tried": len(results),
                   "points_total": len(pts), "points_refused": refused,
                   "sweep_id": sid, "registry": out,
                   "card": card, "results": results},
    }


def _consume(kind, out, hw, batch, iters, dev) -> Dict[str, object]:
    """A tiny consumer of the written entry, with every knob at its
    default: the train step, the eval forward or an engine's request.
    Returns ``{"key": the entry it consumed or None, "ran": the
    configuration it ran, "finite": its output finite}``."""
    import numpy as np
    import torch

    from raft_tpu_torch import tuning
    from raft_tpu_torch.config import RAFTConfig, TrainConfig

    model_cfg = RAFTConfig.small_model()
    prev = os.environ.get(tuning.ENV_REGISTRY)
    os.environ[tuning.ENV_REGISTRY] = out
    try:
        if kind == "train":
            from raft_tpu_torch.train.step import init_state, make_train_step

            cfg = TrainConfig(num_steps=10, batch_size=batch,
                              image_size=hw, iters=iters)
            state = init_state(model_cfg, cfg, device=dev)
            step_fn = make_train_step(cfg, device=dev)
            state, metrics = step_fn(state, _synth_batch(hw, batch, 0))
            info, ran = step_fn.tuning_info, state.model.config
            finite = bool(torch.isfinite(metrics["loss"]))
        elif kind == "eval":
            from raft_tpu_torch.evaluate import make_eval_fn
            from raft_tpu_torch.models.raft import RAFT

            ran, info = tuning.resolve_config(model_cfg, "eval", hw, batch)
            fwd = make_eval_fn(model_cfg, iters, device=dev)
            b = _synth_batch(hw, batch, 0)
            _, up = fwd(RAFT(model_cfg, seed=0).state_dict(),
                        b["image1"], b["image2"])
            finite = bool(torch.isfinite(up).all())
        else:
            from raft_tpu_torch.models.raft import RAFT
            from raft_tpu_torch.serve.engine import (InferenceEngine,
                                                     ServeConfig)

            eng = InferenceEngine(RAFT(model_cfg, seed=0).state_dict(),
                                  model_cfg, ServeConfig(iters=iters),
                                  device=dev)
            with eng:
                b = _synth_batch(hw, 1, 0)
                flow = eng.infer(b["image1"][0], b["image2"][0],
                                 timeout=600)
            info, ran = eng.serve_tuning_info, eng.cfg
            finite = bool(np.isfinite(np.asarray(flow)).all())
    finally:
        if prev is None:
            os.environ.pop(tuning.ENV_REGISTRY, None)
        else:
            os.environ[tuning.ENV_REGISTRY] = prev
    return {"key": info.key if info is not None and info.tuned else None,
            "ran": ran, "finite": finite}


def _tiny_main(args, dev) -> int:
    """The smoke: sweep -> cache hit -> consumption, one run."""
    from raft_tpu_torch import tuning

    hw, batch, iters, steps, warmup = (48, 64), 2, 2, 2, 1
    out = args.out or os.path.join(
        tempfile.mkdtemp(prefix="raft_autotune_"), "tuning.json")
    common = dict(kind=args.kind, hw=hw, batch_per_chip=batch, iters=iters,
                  steps=steps, warmup=warmup, time_box=args.time_box,
                  seed=args.seed, out=out, tiny=True, device=dev)
    first = run_sweep(**common)
    second = run_sweep(**common)       # must be served from the registry
    winner = first["config"]["knobs"]
    ok = (not first["config"]["cache_hit"]
          and second["config"]["cache_hit"]
          and second["config"]["knobs"] == winner)
    got = _consume(args.kind, out, hw, batch, iters, dev)
    consumed = (got["key"] == first["config"]["key"]
                and all(getattr(got["ran"], k, v) == v
                        for k, v in winner.items()))
    consumer = {"train": "train_step", "eval": "eval_fn",
                "serve": "engine"}[args.kind]
    passed = ok and consumed and got["finite"]
    print(json.dumps({
        "metric": "autotune_tiny",
        "value": 1.0 if passed else 0.0,
        "unit": "pass",
        "vs_baseline": 0.0,
        "config": {
            "kind": args.kind,
            "registry": out,
            "winner": winner,
            "first_cache_hit": first["config"]["cache_hit"],
            "second_cache_hit": second["config"]["cache_hit"],
            f"consumed_by_{consumer}": bool(consumed),
            "consumed_key": got["key"],
            "tiny_output_finite": got["finite"],
            "registry_hash": tuning.registry_file_hash(out),
        },
    }))
    return 0 if passed else 1


def main(argv=None) -> int:
    import sys

    args = parse_args(argv)
    if args.seed_known:
        from raft_tpu_torch import tuning

        here = tuning.device_kind()
        if here != KNOWN_DEVICE:
            print(f"autotune --seed-known: the known winners were measured "
                  f"on {KNOWN_DEVICE!r}, this device is {here!r}; run a "
                  "sweep here instead", file=sys.stderr)
            return 2
        keys = seed_known(args.out)
        print(json.dumps({
            "metric": "autotune_seed_known",
            "value": float(len(keys)),
            "unit": "entries",
            "vs_baseline": 0.0,
            "config": {"keys": keys,
                       "registry": args.out
                       or tuning.default_registry_path()},
        }))
        return 0

    from raft_tpu_torch.evaluate import resolve_device

    dev = resolve_device(args.device)
    if args.tiny:
        return _tiny_main(args, dev)
    hw = tuple(int(x) for x in args.image.split("x"))
    iters = args.iters or (12 if args.kind == "train" else 32)
    rec = run_sweep(args.kind, hw, args.batch_per_chip, iters, args.steps,
                    args.warmup, args.time_box, args.seed, args.out,
                    force=args.force, allow_quantized=args.allow_quantized,
                    device=dev)
    print(json.dumps(rec))
    return 0
