"""A reduced training loop (the port of ``raft_tpu/train/loop.py:94-116``):
host batches from an iterator, optional image noise, the step, and a log
line every ``log_freq`` steps.  Checkpointing, telemetry, prefetch and the
data loader are later items of the port."""

from __future__ import annotations

import itertools
from typing import Callable, Dict, Iterable, Mapping, Optional

import numpy as np

from raft_tpu_torch.config import RAFTConfig, TrainConfig
from raft_tpu_torch.evaluate import DeviceLike, resolve_device
from raft_tpu_torch.train.state import TrainState
from raft_tpu_torch.train.step import init_state, make_train_step


def add_image_noise(rng: np.random.Generator, batch: Mapping) -> Dict:
    """Gaussian noise with stdv ~ U(0, 5), one draw for both frames,
    clipped to [0, 255]."""
    out = dict(batch)
    stdv = rng.uniform(0.0, 5.0)
    for k in ("image1", "image2"):
        out[k] = np.clip(
            batch[k] + stdv * rng.standard_normal(batch[k].shape)
            .astype(np.float32), 0.0, 255.0)
    return out


def train(model_cfg: RAFTConfig, cfg: TrainConfig,
          batches: Iterable[Mapping], device: DeviceLike = "cuda",
          state_dict: Optional[Mapping] = None,
          log: Callable[[str], None] = print) -> TrainState:
    """Run up to ``cfg.num_steps`` steps over ``batches`` (dicts of NHWC
    numpy arrays: ``image1``, ``image2``, ``flow``, ``valid``) and return
    the state.  Every ``cfg.log_freq`` steps ``log`` gets the mean of the
    scalar metrics over the window."""
    dev = resolve_device(device)
    state = init_state(model_cfg, cfg, device=dev, state_dict=state_dict)
    step_fn = make_train_step(cfg, device=dev)
    rng = np.random.default_rng(cfg.seed)
    window = []
    for batch in itertools.islice(batches, cfg.num_steps):
        if cfg.add_noise:
            batch = add_image_noise(rng, batch)
        state, metrics = step_fn(state, batch)
        window.append({k: v for k, v in metrics.items() if v.dim() == 0})
        if state.step % cfg.log_freq == 0:
            means = {k: float(sum(float(m[k]) for m in window) / len(window))
                     for k in window[0]}
            log(f"step {state.step} lr {state.schedule(state.step - 1):.3e} "
                + " ".join(f"{k} {v:.4f}" for k, v in sorted(means.items())))
            window = []
    return state
