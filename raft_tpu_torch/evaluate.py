"""Inference entry points (the port of ``raft_tpu/evaluate.py:40-134``).

Every inference path goes through :func:`make_inference_model` /
:func:`make_eval_fn`.  They run on the card (``device="cuda"``) unless the
caller asks for the CPU; without CUDA and without an explicit CPU request
they raise.  There is no tuning registry in the port: the configuration
is used as given, apart from the one fixed inference override of the JAX
package (the training-only ``allpairs_pallas`` lookup maps to
``allpairs``, and the fused lookup + ``convc1`` kernel, which needs it,
is turned off with it; a quantized pyramid is then sampled by the plain
``corr_lookup``, as in JAX).
"""

from __future__ import annotations

from typing import Mapping, Optional, Union

import torch

from raft_tpu_torch.config import RAFTConfig
from raft_tpu_torch.models.raft import RAFT

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
                         device: DeviceLike = "cuda") -> RAFT:
    """The RAFT module with the inference override applied, in eval mode
    on ``device``, holding ``state_dict`` when one is given."""
    dev = resolve_device(device)
    if model_cfg.corr_impl == "allpairs_pallas":
        model_cfg = model_cfg.replace(corr_impl="allpairs",
                                      fused_lookup_encoder=False)
    model = RAFT(model_cfg).eval()
    if state_dict is not None:
        model.load_state_dict(state_dict)
    return model.to(dev)


def make_eval_fn(model_cfg: RAFTConfig, iters: int,
                 device: DeviceLike = "cuda"):
    """``eval_fn(state_dict, image1, image2, flow_init=None) -> (flow_low,
    flow_up)``: the test-mode forward under ``torch.inference_mode()``.

    Images are ``(B, H, W, 3)`` in [0, 255] (tensors or arrays, moved to
    the device); ``flow_init`` is ``(B, H/8, W/8, 2)``.  Outputs are fp32
    on the device.  The weights are loaded when ``state_dict`` is a
    different object from the previous call's, so a caller that mutates
    one dict in place passes a new dict to reload it.
    """
    dev = resolve_device(device)
    model = make_inference_model(model_cfg, device=dev)
    loaded = {"sd": None}

    def eval_fn(state_dict, image1, image2, flow_init=None):
        if state_dict is not loaded["sd"]:
            model.load_state_dict(state_dict)
            loaded["sd"] = state_dict
        with torch.inference_mode():
            image1 = torch.as_tensor(image1, dtype=torch.float32, device=dev)
            image2 = torch.as_tensor(image2, dtype=torch.float32, device=dev)
            if flow_init is not None:
                flow_init = torch.as_tensor(flow_init, dtype=torch.float32,
                                            device=dev)
            return model(image1, image2, iters=iters, flow_init=flow_init,
                         test_mode=True)

    return eval_fn
