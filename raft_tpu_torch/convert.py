"""Weight bridge for the port.

- :func:`state_dict_from_flax` / :func:`flax_from_state_dict`: the JAX
  package's ``{'params', 'batch_stats'}`` tree (nested dicts of numpy
  arrays) to and from the port's ``state_dict``.  The port's names are
  the flax paths joined with dots, so the map is mechanical: conv kernels
  HWIO <-> OIHW, ``kernel``/``scale`` <-> ``weight``, the auto-named
  ``BatchNorm_0`` scope dropped, ``batch_stats``
  ``mean``/``var`` <-> ``running_mean``/``running_var``.  The fused
  double-width ``convzr*`` GRU conv stays one conv, and the
  ``upsampler/mask_head`` scope is the port's mask head.
- :func:`load_reference_pth`: a reference-format ``.pth`` (``module.``-
  prefixed keys from ``nn.DataParallel``), through the port's own copy of
  the key map of ``raft_tpu/convert.py:58-125``, including the merge of
  the separate z/r gate convs into ``convzr*`` (z first).

Every function takes the model configuration (the full preset by
default, or ``RAFTConfig.small_model()``, whose reference ``ConvGRU``
gates ``convz`` / ``convr`` merge into ``convzr``), and every conversion
is checked against that model's own parameter shapes: each entry is
written exactly once, with its shape, and nothing is left over.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch.config import RAFTConfig
from raft_tpu_torch.models.raft import RAFT



def template_shapes(cfg: RAFTConfig = RAFTConfig.full()
                    ) -> Dict[str, Tuple[int, ...]]:
    """``{state_dict key: shape}`` of the port's model for ``cfg``."""
    with torch.device("meta"):
        model = RAFT(cfg)
    return {k: tuple(v.shape) for k, v in model.state_dict().items()}


def _check(sd: Mapping[str, Any], cfg: RAFTConfig) -> None:
    want = template_shapes(cfg)
    missing = sorted(set(want) - set(sd))
    extra = sorted(set(sd) - set(want))
    if missing or extra:
        raise ValueError(f"state_dict does not match the model: missing "
                         f"{missing[:10]}, unexpected {extra[:10]}")
    for k, shape in want.items():
        if tuple(sd[k].shape) != shape:
            raise ValueError(f"shape mismatch for {k}: {tuple(sd[k].shape)} "
                             f"vs model {shape}")


def _flatten(tree, prefix=()) -> Dict[Tuple[str, ...], Any]:
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _unflatten(flat: Mapping[Tuple[str, ...], Any]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for path, v in flat.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return tree


def _port_leaf(coll: str, path: Tuple[str, ...], arr: np.ndarray):
    """One flax leaf -> (port key, array in the port's layout)."""
    module = [p for p in path[:-1] if p != "BatchNorm_0"]
    leaf = path[-1]
    if coll == "params" and leaf == "kernel":
        name, arr = "weight", arr.transpose(3, 2, 0, 1)   # HWIO -> OIHW
    elif coll == "params" and leaf in ("scale", "bias"):
        name = "weight" if leaf == "scale" else "bias"
    elif coll == "batch_stats" and leaf in ("mean", "var"):
        name = "running_" + leaf
    else:
        raise KeyError(f"unrecognized flax leaf {coll}/{'/'.join(path)}")
    return ".".join(module + [name]), arr


def state_dict_from_flax(variables: Mapping[str, Any],
                         cfg: RAFTConfig = RAFTConfig.full()
                         ) -> Dict[str, torch.Tensor]:
    """The JAX ``{'params', 'batch_stats'}`` tree -> the port's
    ``state_dict`` (fp32 CPU tensors)."""
    out: Dict[str, torch.Tensor] = {}
    for coll in ("params", "batch_stats"):
        for path, arr in _flatten(variables.get(coll, {})).items():
            key, arr = _port_leaf(coll, path, np.asarray(arr, np.float32))
            if key in out:
                raise ValueError(f"duplicate write to {key}")
            out[key] = torch.from_numpy(np.ascontiguousarray(arr))
    _check(out, cfg)
    return out


def flax_from_state_dict(state_dict: Mapping[str, torch.Tensor]
                         ) -> Dict[str, Any]:
    """Inverse of :func:`state_dict_from_flax`: the port's ``state_dict``
    -> ``{'params': ..., 'batch_stats': ...}`` of numpy arrays."""
    flat: Dict[Tuple[str, ...], np.ndarray] = {}
    for key, t in state_dict.items():
        arr = t.detach().cpu().numpy()
        *module, leaf = key.split(".")
        mod = ".".join(module)
        module = tuple(module)
        is_bn = f"{mod}.running_mean" in state_dict
        if leaf in ("running_mean", "running_var"):
            path = ("batch_stats",) + module + ("BatchNorm_0", leaf[8:])
        elif is_bn and leaf in ("weight", "bias"):
            path = ("params",) + module + (
                "BatchNorm_0", "scale" if leaf == "weight" else "bias")
        elif leaf == "weight" and arr.ndim == 4:
            path = ("params",) + module + ("kernel",)
            arr = arr.transpose(2, 3, 1, 0)                # OIHW -> HWIO
        elif leaf == "bias":
            path = ("params",) + module + ("bias",)
        else:
            raise KeyError(f"unrecognized state_dict key {key}")
        flat[path] = np.ascontiguousarray(arr)
    tree = _unflatten(flat)
    return {"params": tree.get("params", {}),
            "batch_stats": tree.get("batch_stats", {})}


def _reference_key(key: str) -> Optional[str]:
    """Reference state-dict key -> the port's key, or None to skip (the
    ``downsample.1`` norm alias, batch counters)."""
    parts = re.sub(r"^module\.", "", key).split(".")
    if parts[-1] == "num_batches_tracked":
        return None
    if "downsample" in parts:
        i = parts.index("downsample")
        if parts[i + 1] == "1":
            return None
        parts = parts[:i] + ["downsample_conv"] + parts[i + 2:]
    merged = []
    for p in parts:                                    # layerX.Y -> layerX_Y
        if merged and re.fullmatch(r"layer\d+", merged[-1]) \
                and re.fullmatch(r"\d+", p):
            merged[-1] = f"{merged[-1]}_{p}"
        else:
            merged.append(p)
    parts = merged
    if "mask" in parts:
        i = parts.index("mask")
        conv = {"0": "mask_conv1", "2": "mask_conv2"}[parts[i + 1]]
        parts = ["upsampler", "mask_head", conv] + parts[i + 2:]
    if parts[0] == "update_block":
        parts = ["refine"] + parts
    return ".".join(parts)


def state_dict_from_reference(ref: Mapping[str, Any],
                              cfg: RAFTConfig = RAFTConfig.full()
                              ) -> Dict[str, torch.Tensor]:
    """A reference-format state dict -> the port's ``state_dict``."""
    ref = {k: torch.as_tensor(v) for k, v in ref.items()}
    for key in list(ref):
        m = re.fullmatch(r"(.*\.gru\.)convz(\d*)\.(weight|bias)", key)
        if m:
            prefix, idx, leaf = m.groups()
            rkey = f"{prefix}convr{idx}.{leaf}"
            ref[f"{prefix}convzr{idx}.{leaf}"] = torch.cat(
                [ref.pop(key), ref.pop(rkey)], dim=0)
    out: Dict[str, torch.Tensor] = {}
    for key, t in ref.items():
        port = _reference_key(key)
        if port is None:
            continue
        if port in out:
            raise ValueError(f"duplicate write to {port} (from {key})")
        out[port] = t.detach().float().contiguous()
    _check(out, cfg)
    return out


def load_reference_pth(path: str, cfg: RAFTConfig = RAFTConfig.full()
                       ) -> Dict[str, torch.Tensor]:
    """Read a reference-format ``.pth`` into the port's ``state_dict``."""
    return state_dict_from_reference(
        torch.load(path, map_location="cpu", weights_only=True), cfg)


def load_state_dict_file(path: str, cfg: RAFTConfig = RAFTConfig.full()
                         ) -> Dict[str, torch.Tensor]:
    """A ``.pth`` holding either the port's own ``state_dict`` or a
    reference-format one -> the port's ``state_dict``."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if set(sd) == set(template_shapes(cfg)):
        _check(sd, cfg)
        return {k: v.float() for k, v in sd.items()}
    return state_dict_from_reference(sd, cfg)
