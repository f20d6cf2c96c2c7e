"""Error types of injected faults, and the torn-write simulator (the
port's copy of the parts of ``raft_tpu/chaos/errors.py`` that the loader,
the device pipeline and the checkpoints use).

Each injected error subclasses what the real failure raises, so the
hardened paths handle an injection exactly as they handle the fault it
models.
"""

from __future__ import annotations

import os


class InjectedWorkerCrash(RuntimeError):
    """``worker_err``: a loader worker crash that is not a sample decode
    error; it must propagate and end the run, as a loader bug would."""


class InjectedProducerCrash(RuntimeError):
    """``producer_err``: the device pipeline's producer dies mid-stream;
    the consumer's ``next()`` must re-raise it."""


class InjectedCheckpointCorruption(RuntimeError):
    """``restore_err``: a checkpoint step that fails to restore (a torn
    write, without touching the files)."""


def tear_files(directory: str, keep_frac: float = 0.5) -> list:
    """Truncate every regular file under ``directory`` to ``keep_frac`` of
    its size: what a host that dies mid-write leaves behind (the
    directory intact, the contents cut short).  Returns the torn paths."""
    torn = []
    for root, _dirs, files in os.walk(directory):
        for name in files:
            path = os.path.join(root, name)
            size = os.path.getsize(path)
            with open(path, "r+b") as f:
                f.truncate(int(size * keep_frac))
            torn.append(path)
    return sorted(torn)
