"""Data parallelism over ``torch.distributed`` ranks (the port of
``raft_tpu/parallel/mesh.py``).

The JAX package shards the batch over the ``data`` axis of a device mesh
and lets GSPMD insert the reductions.  The port runs one process per GPU
and writes the two reductions that sharding gives for free by hand:

- the gradient mean over the global batch: one all-reduce of a flat
  buffer inside the train step (``train/step.py``), after the
  microbatch accumulation and before the clip and the guard;
- batch-norm statistics over the global batch (``models/layers.py``
  ``Norm``): an all-reduce of the per-channel sums, with a gradient that
  flows through it (:func:`all_reduce_sum`).

A :class:`Mesh` names the run's ranks and groups.  Its ``group`` carries
the tensors (NCCL on the card, gloo on the CPU; gloo on the card where
the caller asks for it, as two ranks sharing one GPU must), its
``host_group`` (gloo) the host-side agreement (the preemption flag, the
restored step, barriers), so that the agreement never waits on the
device.  Each rank feeds its own stride of the shuffle through
``ShardedLoader(num_hosts=world, host_id=rank)``: rank r's batch k is
``perm[r::W][k*b:(k+1)*b]`` and the union over the ranks is
``perm[k*W*b:(k+1)*W*b]``, so the global sample set of step k does not
depend on the world size.  That interleaved order is the global batch's
row order here: global row ``i`` is row ``i // W`` of rank ``i % W``.

The step, the norms and the dropout see the mesh through :func:`active`,
set around the step's device work: the model's own signature stays as
it is.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
from typing import Dict, Iterator, Optional

import torch
import torch.distributed as dist

DATA_AXIS = "data"
SPATIAL_AXIS = "spatial"

# What torchrun sets for every rank.
ENV_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ranks of one data-parallel run, as seen by one of them."""

    world: int
    rank: int
    local_rank: int
    device: torch.device
    backend: str                       # of ``group``: 'nccl' or 'gloo'
    group: Optional[object] = None     # tensor collectives; None at world 1
    host_group: Optional[object] = None  # gloo, host-side agreement

    def mesh_shape(self) -> Dict[str, int]:
        """``{'data': world, 'spatial': 1}``: the topology stamp a
        checkpoint records (``raft_tpu.parallel.mesh_shape``)."""
        return {DATA_AXIS: self.world, SPATIAL_AXIS: 1}

    @property
    def distributed(self) -> bool:
        """Whether a process group backs this mesh (the train step then
        all-reduces its gradients, even at world 1)."""
        return self.group is not None

    def any_host(self, flag: bool) -> bool:
        """Whether ``flag`` is set on any rank (a MAX all-reduce on the
        host group; every rank must call it at the same point)."""
        if self.host_group is None:
            return bool(flag)
        t = torch.tensor([int(bool(flag))], dtype=torch.int32)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.host_group)
        return bool(t.item())

    def broadcast_object(self, obj, src: int = 0):
        """Rank ``src``'s ``obj`` on every rank."""
        if self.host_group is None:
            return obj
        box = [obj]
        dist.broadcast_object_list(box, src=src, group=self.host_group)
        return box[0]

    def barrier(self) -> None:
        if self.host_group is not None:
            dist.barrier(group=self.host_group)


def make_mesh(device: torch.device = torch.device("cpu")) -> Mesh:
    """The mesh of the process group this process belongs to (its
    default group), or a single-rank mesh without one."""
    device = torch.device(device)
    if not (dist.is_available() and dist.is_initialized()):
        return Mesh(world=1, rank=0, local_rank=0, device=device,
                    backend="none")
    group = dist.group.WORLD
    backend = str(dist.get_backend(group))
    host = (group if backend == "gloo"
            else dist.new_group(backend="gloo"))
    return Mesh(world=dist.get_world_size(), rank=dist.get_rank(),
                local_rank=int(os.environ.get("LOCAL_RANK", 0)),
                device=device, backend=backend, group=group,
                host_group=host)


def init_from_env(device: str = "cuda",
                  backend: Optional[str] = None) -> Mesh:
    """Join the process group that ``torchrun`` describes (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) and
    return its mesh.  On ``cuda`` the rank takes ``cuda:LOCAL_RANK`` and
    NCCL (``backend='gloo'`` for ranks that share one GPU, whose
    collectives then run eagerly through the host); on ``cpu`` gloo.
    Raises ``RuntimeError`` naming what is missing."""
    missing = [k for k in ENV_VARS if k not in os.environ]
    if missing:
        raise RuntimeError(
            f"distributed training needs {', '.join(missing)} in the "
            "environment (torchrun sets them: torchrun --nproc_per_node N "
            "-m raft_tpu_torch train --distributed ...)")
    kind = torch.device(device).type
    local_rank = int(os.environ["LOCAL_RANK"])
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("distributed training on cuda needs a GPU")
        dev = torch.device("cuda", local_rank)
        torch.cuda.set_device(dev)
    else:
        dev = torch.device(kind)
    backend = backend or ("nccl" if kind == "cuda" else "gloo")
    kwargs = dict(backend=backend, init_method="env://",
                  rank=int(os.environ["RANK"]),
                  world_size=int(os.environ["WORLD_SIZE"]))
    if backend == "nccl":
        kwargs["device_id"] = dev       # the communicator now, not lazily
    dist.init_process_group(**kwargs)
    return make_mesh(dev)


def shutdown() -> None:
    """Leave the process group, if this process is in one."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


# -- the mesh a step's device work runs under ---------------------------

_ACTIVE = threading.local()


@contextlib.contextmanager
def use(mesh: Optional[Mesh]) -> Iterator[None]:
    """Make ``mesh`` the one :func:`active` returns on this thread."""
    saved = getattr(_ACTIVE, "mesh", None)
    _ACTIVE.mesh = mesh
    try:
        yield
    finally:
        _ACTIVE.mesh = saved


def active() -> Optional[Mesh]:
    """The mesh of the running step when it spans more than one rank,
    else None: what the norms and the dropout consult."""
    mesh = getattr(_ACTIVE, "mesh", None)
    return mesh if mesh is not None and mesh.world > 1 else None


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks; the gradient of each rank's input is the sum
    of the ranks' output gradients (the global loss is their sum)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``t`` summed over ``mesh``'s ranks, differentiably (only
    ``all_reduce``: gloo on CUDA tensors has no ``all_gather``)."""
    return _AllReduceSum.apply(t, mesh.group)
