"""Deterministic fault injection (the port's copy of the parts of
``raft_tpu/chaos/`` that the training input side and the checkpoints use).

``RAFT_CHAOS_SPEC='corrupt_image@step=7;torn_ckpt@step=50'`` installs a
seeded :class:`FaultPlan`; the named injection points of the loader, the
device pipeline, the checkpoints and the train loop then fire those faults
deterministically, so the self-healing paths (sample quarantine,
checkpoint fallback, preemption) run on purpose.  With no plan installed
each point is one ``None`` check.
"""

from raft_tpu_torch.chaos.errors import (
    InjectedCheckpointCorruption,
    InjectedProducerCrash,
    InjectedWorkerCrash,
    tear_files,
)
from raft_tpu_torch.chaos.plan import (
    FAULTS,
    ChaosSpecError,
    ENV_SEED,
    ENV_SPEC,
    FaultPlan,
    install,
    install_from_env,
    should_inject,
    uninstall,
)

__all__ = [
    "ChaosSpecError",
    "ENV_SEED",
    "ENV_SPEC",
    "FAULTS",
    "FaultPlan",
    "InjectedCheckpointCorruption",
    "InjectedProducerCrash",
    "InjectedWorkerCrash",
    "install",
    "install_from_env",
    "should_inject",
    "tear_files",
    "uninstall",
]
