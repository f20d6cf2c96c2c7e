"""Warm-start manifests: a replica's first request captures nothing (the
port's counterpart of ``raft_tpu/serve/aot.py``).

The JAX package serializes its compiled executables and imports them
into a fresh engine, which then serves its first request with zero JIT
compiles.  A CUDA graph cannot be serialized, and it binds the device
addresses it captured (the slot state it reads and writes in place), so
the port cannot ship the programs themselves.  What it ships is the list
of them: a manifest of the ``(bucket, lanes, program)`` keys an engine
has captured.  An engine built with ``ServeConfig(aot_dir=...)`` reads
the manifest and captures every listed key during ``start()``, before
it reports ready, so its first request captures nothing:
``CaptureCounter`` counts no event on the request path.  That is the
port's form of "zero compiles": the captures move off the request path
(and in a fleet onto the restarting or warming replica), they do not
disappear.

Layout (one directory)::

    manifest.json    # format, fingerprint, environment, keys, checksum

Compatibility gate: the manifest is refused (:class:`AOTImportError`)
unless its fingerprint matches the importing engine's: the model
configuration, the ``state_dict``'s keys, shapes and dtypes, ``iters``,
the precision (the compute dtype and the cuDNN TF32 flag), the torch and
CUDA versions and the device name.  A refused, missing or torn manifest
is a warm-start miss (the engine's ``aot_import_error`` event), then lazy
capture: a key is never run through a program captured for another.
The weights' values are not part of the fingerprint: the same manifest
warm-starts an engine with new weights (a rolling update).

The file is written atomically (a temporary file, then ``os.replace``),
and its ``sha256`` field covers everything else in it, so a reader never
acts on a torn write.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import tempfile
from typing import List, Mapping, Sequence, Tuple

MANIFEST = "manifest.json"
FORMAT_VERSION = 1
PROGRAMS = ("enc", "iter", "up", "stash", "wenc")


class AOTImportError(RuntimeError):
    """The manifest is missing, torn or made for another engine: the
    engine falls back to lazy capture."""


def _env_stamp(device) -> dict:
    import torch

    dev = torch.device(device)
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else dev.type)
    return {"torch": torch.__version__, "cuda": torch.version.cuda,
            "device": name}


def model_fingerprint(model_cfg, state_dict: Mapping, iters: int,
                      device="cpu") -> str:
    """Hash of everything that must match for a manifest's keys to be
    the right programs for an engine: the model configuration, each
    ``state_dict`` entry's name, shape and dtype, ``iters``, the cuDNN
    TF32 flag, and the environment stamp (torch and CUDA versions, the
    device name)."""
    from raft_tpu_torch import config

    payload = json.dumps({
        "config": {k: repr(v) for k, v in sorted(
            dataclasses.asdict(model_cfg).items())},
        "state": [(k, tuple(v.shape), str(v.dtype))
                  for k, v in sorted(state_dict.items())],
        "iters": int(iters),
        "conv_tf32": bool(config.CONV_TF32),
        "env": _env_stamp(device),
    }, sort_keys=True)
    return hashlib.sha256(payload.encode()).hexdigest()[:16]


def _checksum(body: dict) -> str:
    return hashlib.sha256(
        json.dumps(body, sort_keys=True).encode()).hexdigest()


def _atomic_write(path: str, data: bytes) -> None:
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path),
                               prefix=".aot-tmp-")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def write_manifest(directory: str, keys: Sequence[tuple], *,
                   fingerprint: str) -> dict:
    """Write the manifest of ``keys`` (``((H, W), lanes, program)``) into
    ``directory`` atomically; returns it.  Rewriting it as an engine
    captures more keys is fine."""
    if not keys:
        raise ValueError("nothing to export: no captured program (warm "
                         "the engine up first)")
    os.makedirs(directory, exist_ok=True)
    body = {"format_version": FORMAT_VERSION, "fingerprint": fingerprint,
            "keys": [{"bucket": [int(k[0][0]), int(k[0][1])],
                      "lanes": int(k[1]), "program": str(k[2])}
                     for k in sorted(keys)]}
    manifest = dict(body, sha256=_checksum(body))
    _atomic_write(os.path.join(directory, MANIFEST),
                  json.dumps(manifest, indent=1).encode())
    return manifest


def read_manifest(directory: str, *, fingerprint: str
                  ) -> List[Tuple[Tuple[int, int], int, str]]:
    """The keys of the manifest in ``directory``, gated on the checksum,
    the format and ``fingerprint``; raises :class:`AOTImportError` on
    any miss (never a partial list)."""
    path = os.path.join(directory, MANIFEST)
    try:
        with open(path, "rb") as f:
            manifest = json.loads(f.read())
    except OSError as e:
        raise AOTImportError(f"no warm-start manifest at {path}: {e}")
    except ValueError as e:
        raise AOTImportError(f"torn warm-start manifest {path}: {e}")
    if not isinstance(manifest, dict):
        raise AOTImportError(f"warm-start manifest {path} is not an object")
    body = {k: v for k, v in manifest.items() if k != "sha256"}
    if manifest.get("sha256") != _checksum(body):
        raise AOTImportError(f"warm-start manifest {path}: checksum "
                             "mismatch (torn write?)")
    if manifest.get("format_version") != FORMAT_VERSION:
        raise AOTImportError(
            f"warm-start manifest format {manifest.get('format_version')!r}"
            f" != supported {FORMAT_VERSION}")
    if manifest.get("fingerprint") != fingerprint:
        raise AOTImportError(
            f"warm-start manifest fingerprint mismatch: it has "
            f"{manifest.get('fingerprint')!r}, this engine needs "
            f"{fingerprint!r} (another model, precision, iters, torch, "
            "CUDA or device)")
    keys = []
    for e in manifest.get("keys", ()):
        if e.get("program") not in PROGRAMS:
            raise AOTImportError(f"warm-start manifest {path}: unknown "
                                 f"program {e.get('program')!r}")
        keys.append(((int(e["bucket"][0]), int(e["bucket"][1])),
                     int(e["lanes"]), str(e["program"])))
    if not keys:
        raise AOTImportError(f"warm-start manifest {path} lists no key")
    return keys
