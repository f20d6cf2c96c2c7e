"""Persisted per-hardware tuning registry for the performance knob surface
(the port of ``raft_tpu/tuning.py``, the same file format and rules).

Knob winners are HARDWARE facts, not code facts — an H100 picks
differently from a TPU or a CPU dev box — so a sweep on the local machine
persists its winners here, keyed by

    (kind, device_kind, bucket_hw, batch)

where ``kind`` is the workload ('train' | 'eval' | 'serve'),
``device_kind`` is :func:`raft_tpu_torch.obs.cost.device_kind`
(``torch.cuda.get_device_name(0)``, e.g. 'NVIDIA H100 80GB HBM3', or
'cpu'), ``bucket_hw`` the /8-aligned input shape and ``batch`` the
per-device batch.  Every entry carries provenance (tool, time, host,
measured throughput, sweep id).

Consumers — ``make_train_step`` (``train/step.py``), ``train``
(``train/loop.py``, whose ``run_config`` event carries the stamp),
``make_inference_model`` (``evaluate.py``) and the serving engine
(``serve/engine.py``) — consult the registry BY DEFAULT through
:func:`resolve_config`: a knob is overridden only while it still sits at
its ``RAFTConfig`` class default (i.e. the user left it alone); anything
the user pinned wins unconditionally.  Precedence, highest first::

    explicit user knob  >  registry entry  >  RAFTConfig default

Lookup falls back to the NEAREST bucket of the same (kind, device_kind)
— bucket winners are smooth in shape — but never across device kinds.

The JAX package's registry file is read as is: an entry that carries a
knob the port's ``RAFTConfig`` does not have (``scan_unroll``,
``lookup_block_q``, ``upsample_group``, ``upsample_unroll``,
``fuse_upsample_in_scan``, ``pallas_offtpu``) falls under the rule for
unknown knobs: ignored with a warning.

Environment overrides:

- ``RAFT_TUNING=0``     — disable all registry consultation (A/B).
- ``RAFT_TUNING_REGISTRY=/path.json`` — registry file (default
  ``~/.cache/raft_tpu/tuning.json``).

The file is plain JSON, written atomically (tmp + rename), merge-on-save
so concurrent tools only ever lose a race, not the file.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import socket
import time
import warnings
from typing import Dict, Optional, Sequence, Tuple, Union

from raft_tpu_torch.config import RAFTConfig

ENV_REGISTRY = "RAFT_TUNING_REGISTRY"
ENV_DISABLE = "RAFT_TUNING"

REGISTRY_VERSION = 1

# The knob surface the registry may set: the JAX package's tunable
# knobs that the port's RAFTConfig has.  Anything else in an entry is
# ignored with a warning — a registry written by another build (or by
# the JAX package, whose TPU knobs have no counterpart here) degrades,
# it doesn't crash.
TUNABLE_KNOBS = (
    "corr_impl", "corr_dtype", "corr_precision", "corr_block_size",
    "remat", "remat_policy", "remat_upsample", "upsample_dtype",
    "upsample_loss_kernel", "fused_lookup_encoder", "fused_gru",
)

# ServeConfig-level knobs a kind='serve' entry may additionally carry
# (the continuous-batching dispatcher surface — batching mode, slot
# count, early-exit cut, iteration budget).  They resolve through
# :func:`resolve_serve_config`, never through :func:`resolve_config`
# (which only touches RAFTConfig).
SERVE_TUNABLE_KNOBS = ("batching", "slots", "early_exit_threshold",
                       "iters")

_CONFIG_DEFAULTS = {f.name: f.default
                    for f in dataclasses.fields(RAFTConfig)}

_warned_paths = set()


@dataclasses.dataclass(frozen=True)
class TuningInfo:
    """What :func:`resolve_config` did — the provenance stamp carried
    into telemetry ``config`` blocks (``tuned`` / ``tuning_key`` /
    ``tuning_registry_hash``)."""

    tuned: bool
    key: Optional[str] = None
    exact: bool = True
    applied: Dict[str, object] = dataclasses.field(default_factory=dict)
    pinned: Dict[str, object] = dataclasses.field(default_factory=dict)
    registry_path: Optional[str] = None
    registry_hash: Optional[str] = None

    def stamp(self) -> Dict[str, object]:
        """The three provenance fields every emitted config block
        carries (the ``run_config`` event, ``scripts/telemetry_summary.py``)."""
        out = {"tuned": self.tuned}
        if self.tuned:
            out["tuning_key"] = self.key
            out["tuning_registry_hash"] = self.registry_hash
            if not self.exact:
                out["tuning_fallback"] = "nearest-bucket"
        return out


def enabled() -> bool:
    """Registry consultation on?  ``RAFT_TUNING=0`` turns it off."""
    return os.environ.get(ENV_DISABLE, "1") not in ("0", "off", "false")


def device_kind() -> str:
    """The local accelerator identity the winners are keyed by
    (:func:`raft_tpu_torch.obs.cost.device_kind`)."""
    from raft_tpu_torch.obs.cost import device_kind as kind

    return kind()


def default_registry_path() -> str:
    env = os.environ.get(ENV_REGISTRY)
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache", "raft_tpu",
                        "tuning.json")


def registry_key(kind: str, device: str,
                 bucket_hw: Optional[Tuple[int, int]],
                 batch: Optional[int]) -> str:
    hw = "anyhw" if bucket_hw is None else f"{bucket_hw[0]}x{bucket_hw[1]}"
    b = "anyb" if batch is None else f"b{batch}"
    return "|".join((kind, device, hw, b))


def load_registry(path: Optional[str] = None) -> dict:
    """The parsed registry file ({'version', 'entries': {key: entry}});
    missing or corrupt files yield an empty registry (corrupt warns once
    per path — silently ignoring a half-written file would look exactly
    like 'the autotuner never ran')."""
    path = path or default_registry_path()
    if not os.path.exists(path):
        return {"version": REGISTRY_VERSION, "entries": {}}
    try:
        with open(path) as f:
            data = json.load(f)
        if not isinstance(data.get("entries"), dict):
            raise ValueError("no 'entries' mapping")
        return data
    except (OSError, ValueError) as e:
        if path not in _warned_paths:
            _warned_paths.add(path)
            warnings.warn(f"tuning registry {path!r} unreadable "
                          f"({type(e).__name__}: {e}); ignoring it")
        return {"version": REGISTRY_VERSION, "entries": {}}


def registry_file_hash(path: Optional[str] = None) -> Optional[str]:
    """Short content hash of the registry file (provenance stamp), or
    None when the file doesn't exist."""
    path = path or default_registry_path()
    try:
        with open(path, "rb") as f:
            return hashlib.sha256(f.read()).hexdigest()[:12]
    except OSError:
        return None


def save_entry(kind: str, bucket_hw: Tuple[int, int], batch: int,
               knobs: Dict[str, object],
               provenance: Optional[Dict[str, object]] = None,
               path: Optional[str] = None,
               device: Optional[str] = None) -> str:
    """Merge one winner into the registry file (atomic tmp+rename).

    Returns the entry key.  Unknown knob names are rejected here — the
    WRITE side is strict so the tolerant read side never has anything to
    tolerate from our own tools.  ``kind='serve'`` entries may carry the
    ServeConfig knob surface (:data:`SERVE_TUNABLE_KNOBS`) on top of the
    model knobs."""
    allowed = set(TUNABLE_KNOBS)
    if kind == "serve":
        allowed |= set(SERVE_TUNABLE_KNOBS)
    bad = sorted(set(knobs) - allowed)
    if bad:
        raise ValueError(f"unknown tunable knob(s) {bad}; allowed: "
                         f"{', '.join(sorted(allowed))}")
    path = path or default_registry_path()
    device = device or device_kind()
    key = registry_key(kind, device, bucket_hw, batch)
    reg = load_registry(path)
    reg["version"] = REGISTRY_VERSION
    reg["entries"][key] = {
        "kind": kind,
        "device_kind": device,
        "bucket_hw": list(bucket_hw),
        "batch": int(batch),
        "knobs": dict(knobs),
        "provenance": dict(provenance or {}, host=socket.gethostname(),
                           updated=time.time()),
    }
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(reg, f, indent=2, sort_keys=True)
    os.replace(tmp, path)
    return key


def _bucket_distance(a: Sequence[int], b: Tuple[int, int]) -> float:
    """Log-area distance plus a mild aspect penalty: the 368x496 entry
    should beat the 288x960 one for a 400x720 query even though their
    areas straddle it."""
    import math

    area = math.log(max(a[0] * a[1], 1) / max(b[0] * b[1], 1))
    aspect = math.log((a[1] / max(a[0], 1)) / (b[1] / max(b[0], 1)))
    return abs(area) + 0.5 * abs(aspect)


# Nearest-bucket fallback is only trusted within this distance (log-area
# + aspect units; ~4.5x area), the JAX package's cutoff.  Knob winners
# are smooth ACROSS NEARBY crops — chairs (368x496) transfers to things
# (400x720, d≈0.60) — but not across regimes (beyond-memory shapes, toy
# shapes, whose d from chairs is >= 3).  Beyond the cutoff the config
# defaults are the safer guess.
_MAX_FALLBACK_DISTANCE = 1.5


def lookup(kind: Union[str, Sequence[str]],
           bucket_hw: Optional[Tuple[int, int]] = None,
           batch: Optional[int] = None,
           device: Optional[str] = None,
           path: Optional[str] = None):
    """Best registry entry for this workload on this hardware.

    Returns ``(key, entry, exact)`` or ``None``.  ``kind`` may be a
    preference list (the serve engine tries 'serve' then 'eval').
    Exact ``(kind, device, bucket, batch)`` hits win; otherwise the
    NEAREST bucket/batch of the same (kind, device) — never another
    device kind.  ``bucket_hw=None`` / ``batch=None`` match the most
    recently updated entry of the kind (shape-agnostic consumers like
    ``make_eval_fn``, which captures per streamed shape)."""
    kinds = (kind,) if isinstance(kind, str) else tuple(kind)
    device = device or device_kind()
    entries = load_registry(path)["entries"]
    for k in kinds:
        if bucket_hw is not None and batch is not None:
            exact_key = registry_key(k, device, bucket_hw, batch)
            if exact_key in entries:
                return exact_key, entries[exact_key], True
        cands = [(key, e) for key, e in entries.items()
                 if e.get("kind") == k and e.get("device_kind") == device]
        if not cands:
            continue
        if bucket_hw is None:
            best = max(cands, key=lambda kv: kv[1].get(
                "provenance", {}).get("updated", 0))
            return best[0], best[1], False

        def score(kv):
            e = kv[1]
            d = _bucket_distance(e.get("bucket_hw", (1, 1)), bucket_hw)
            if batch is not None and e.get("batch"):
                import math

                d += 0.1 * abs(math.log(e["batch"] / batch))
            return d

        best = min(cands, key=score)
        exact = (tuple(best[1].get("bucket_hw", ())) == tuple(bucket_hw)
                 and (batch is None or best[1].get("batch") == batch))
        if not exact and score(best) > _MAX_FALLBACK_DISTANCE:
            continue   # too far to trust the transfer; try the next kind
        return best[0], best[1], exact
    return None


def resolve_config(model_cfg: RAFTConfig,
                   kind: Union[str, Sequence[str]],
                   bucket_hw: Optional[Tuple[int, int]] = None,
                   batch: Optional[int] = None,
                   path: Optional[str] = None
                   ) -> Tuple[RAFTConfig, TuningInfo]:
    """Apply the registry to every knob the user left at its default.

    A knob whose current value differs from the ``RAFTConfig`` class
    default was pinned by the user (or an upstream resolve) and is left
    alone — so calling this twice is idempotent, and CLI flags always
    beat the registry.  Disabled (``RAFT_TUNING=0``) or no matching
    entry -> the config comes back untouched with ``tuned=False``."""
    if not enabled():
        return model_cfg, TuningInfo(tuned=False)
    hit = lookup(kind, bucket_hw, batch, path=path)
    if hit is None:
        return model_cfg, TuningInfo(tuned=False)
    key, entry, exact = hit
    applied, pinned, unknown = {}, {}, []
    for knob, value in entry.get("knobs", {}).items():
        if knob not in TUNABLE_KNOBS or knob not in _CONFIG_DEFAULTS:
            unknown.append(knob)
            continue
        current = getattr(model_cfg, knob)
        if current != _CONFIG_DEFAULTS[knob]:
            pinned[knob] = current     # user (or caller) pinned it
        elif current != value:
            applied[knob] = value
    if unknown:
        warnings.warn(f"tuning entry {key!r} carries unknown knob(s) "
                      f"{sorted(unknown)} (newer registry?); ignored")
    reg_path = path or default_registry_path()
    info = TuningInfo(tuned=True, key=key, exact=exact, applied=applied,
                      pinned=pinned, registry_path=reg_path,
                      registry_hash=registry_file_hash(reg_path))
    if applied:
        model_cfg = model_cfg.replace(**applied)
    return model_cfg, info


def resolve_serve_config(serve_cfg,
                         bucket_hw: Optional[Tuple[int, int]] = None,
                         batch: Optional[int] = None,
                         path: Optional[str] = None):
    """Apply a ``kind='serve'`` registry entry's ServeConfig knobs
    (:data:`SERVE_TUNABLE_KNOBS`) to every knob the user left at its
    dataclass default — same precedence as :func:`resolve_config`
    (explicit user knob > registry > default), same idempotence.

    Returns ``(serve_cfg, TuningInfo)``.  Model knobs in the same entry
    are ignored here (the engine resolves those onto RAFTConfig
    separately); a registry value that fails ServeConfig validation is
    dropped with a warning rather than crashing the engine."""
    if not enabled():
        return serve_cfg, TuningInfo(tuned=False)
    hit = lookup("serve", bucket_hw, batch, path=path)
    if hit is None:
        return serve_cfg, TuningInfo(tuned=False)
    key, entry, exact = hit
    defaults = {f.name: f.default
                for f in dataclasses.fields(type(serve_cfg))}
    applied, pinned = {}, {}
    for knob, value in entry.get("knobs", {}).items():
        if knob not in SERVE_TUNABLE_KNOBS or knob not in defaults:
            continue  # model knob or unknown: not ours
        current = getattr(serve_cfg, knob)
        if current != defaults[knob]:
            pinned[knob] = current     # user (or caller) pinned it
        elif current != value:
            applied[knob] = value
    reg_path = path or default_registry_path()
    info = TuningInfo(tuned=True, key=key, exact=exact, applied=applied,
                      pinned=pinned, registry_path=reg_path,
                      registry_hash=registry_file_hash(reg_path))
    if applied:
        try:
            serve_cfg = dataclasses.replace(serve_cfg, **applied)
        except (ValueError, TypeError) as e:
            warnings.warn(f"tuning entry {key!r} serve knobs {applied} "
                          f"rejected by ServeConfig ({e}); ignored")
            info = dataclasses.replace(info, applied={})
    return serve_cfg, info
