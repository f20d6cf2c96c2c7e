"""Data parallelism over ``torch.distributed`` ranks: the mesh, the
environment's process group and the differentiable all-reduce."""

from raft_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    active,
    all_reduce_sum,
    init_from_env,
    make_mesh,
    shutdown,
    use,
)
