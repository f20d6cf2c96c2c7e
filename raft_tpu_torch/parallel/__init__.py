"""Data and spatial parallelism over ``torch.distributed`` ranks: the
mesh, the environment's process group, the differentiable all-reduce and
the spatial group's row collectives."""

from raft_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    active,
    active_spatial,
    all_gather_rows,
    all_reduce_sum,
    halo_rows,
    init_from_env,
    make_mesh,
    shutdown,
    use,
)
