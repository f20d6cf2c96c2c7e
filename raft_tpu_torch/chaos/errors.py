"""Error types of injected faults, the serving engine's retry policy and
the torn-write simulator (the port's copy of ``raft_tpu/chaos/
errors.py`` without its XLA message markers).

Each injected error subclasses what the real failure raises, so the
hardened paths handle an injection exactly as they handle the fault it
models.

:func:`is_transient_error` decides what the serving engine retries.  The
JAX package also retries XLA runtime errors whose message names a
transient status; the port has no counterpart: a CUDA error leaves the
context unusable, so a retry on it cannot succeed, and it is never
transient.
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


class InjectedDeviceError(RuntimeError):
    """``device_err``: a transient device dispatch failure, explicitly
    marked retryable."""

    transient = True


class InjectedReplicaKill(RuntimeError):
    """``replica_kill``: the engine's device worker dies mid-batch and the
    engine with it.  Not transient for the engine's own retry (the
    replica is gone), but a failover signal for a router in front of
    several replicas."""

    transient = False
    replica_fatal = True


class ReplicaWedgedInterrupt(RuntimeError):
    """Raised in an engine's device worker when a ``replica_hang`` wedge
    is interrupted by the engine stopping: the hung batch's requests fail
    with it."""

    transient = False
    replica_fatal = True


def is_transient_error(exc: BaseException) -> bool:
    """True when ``exc`` is worth a retry on the same device: an error
    that says so (a ``transient`` attribute, as the injected faults
    carry) or a bare ``TimeoutError``.  Everything else fails fast: a
    ``ConnectionError`` indicts the host, and a CUDA error (or any other
    deterministic error) does not go away on a second try."""
    flagged = getattr(exc, "transient", None)
    if flagged is not None:
        return bool(flagged)
    return isinstance(exc, TimeoutError)


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
