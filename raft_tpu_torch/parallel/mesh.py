"""Data and spatial parallelism over ``torch.distributed`` ranks (the
port of ``raft_tpu/parallel/mesh.py``).

The JAX package shards the batch over the ``data`` axis of a device mesh
(and, with ``shard_spatial``, image height over its ``spatial`` axis) and
lets GSPMD insert the collectives.  The port runs one process per GPU
and writes the collectives that sharding gives for free by hand:

- the gradient mean over the global batch: one all-reduce of a flat
  buffer inside the train step (``train/step.py``), after the
  microbatch accumulation and before the clip and the guard;
- batch-norm statistics over the global batch (``models/layers.py``
  ``Norm``): an all-reduce of the per-channel sums, with a gradient that
  flows through it (:func:`all_reduce_sum`);
- with ``spatial = N > 1``, over the N ranks that share samples: the
  rows a convolution reads beyond its shard (:func:`halo_rows`), the
  instance-norm sums (:func:`all_reduce_sum` on ``spatial_group``) and
  the whole ``fmap2`` that local queries correlate against
  (:func:`all_gather_rows`).

Layout (JAX's ``devices.reshape(num_data, num_spatial)``): rank ``r`` is
data index ``r // N`` and spatial index ``r % N``; the N ranks of data
index ``d`` (``d*N .. d*N + N - 1``) form one spatial group and hold the
same samples, rank ``d*N + s`` their rows ``[s*H/N, (s+1)*H/N)``.

A :class:`Mesh` names the run's ranks and groups.  Its ``group`` carries
the tensors (NCCL on the card, gloo on the CPU; gloo on the card where
the caller asks for it, as two ranks sharing one GPU must), its
``host_group`` (gloo) the host-side agreement (the preemption flag, the
restored step, barriers), so that the agreement never waits on the
device.  Each data index feeds its own stride of the shuffle through
``ShardedLoader(num_hosts=D, host_id=d)``: data index d's batch k is
``perm[d::D][k*b:(k+1)*b]`` and the union over the data indices is
``perm[k*D*b:(k+1)*D*b]``, so the global sample set of step k does not
depend on the mesh.  That interleaved order is the global batch's row
order here: global row ``i`` is row ``i // D`` of data index ``i % D``.

The step, the convolutions, the norms, the correlation and the dropout
see the mesh through :func:`active`, set around the step's device work:
the model's own signature stays as it is.

The spatial collectives are ``all_gather`` and ``reduce_scatter`` of
contiguous buffers, which NCCL runs inside a captured graph.  Gloo has
neither for CUDA tensors (only ``all_reduce``): there each rank writes
its piece into a zeroed buffer of the whole and one all-reduce sums it,
which moves N times the bytes and runs eagerly, as a gloo mesh does.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
from typing import Dict, Iterator, Optional

import torch
import torch.distributed as dist

from raft_tpu_torch.obs.cost import uncounted

DATA_AXIS = "data"
SPATIAL_AXIS = "spatial"

# What torchrun sets for every rank.
ENV_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ranks of one run, as seen by one of them: ``world // spatial``
    data indices of ``spatial`` ranks each."""

    world: int
    rank: int
    local_rank: int
    device: torch.device
    backend: str                       # of ``group``: 'nccl' or 'gloo'
    group: Optional[object] = None     # tensor collectives; None at world 1
    host_group: Optional[object] = None  # gloo, host-side agreement
    spatial: int = 1                   # ranks that split one sample's rows
    spatial_group: Optional[object] = None   # this rank's; None at 1

    @property
    def data_size(self) -> int:
        return self.world // self.spatial

    @property
    def data_index(self) -> int:
        return self.rank // self.spatial

    @property
    def spatial_index(self) -> int:
        return self.rank % self.spatial

    def mesh_shape(self) -> Dict[str, int]:
        """``{'data': world // spatial, 'spatial': spatial}``: the
        topology stamp a checkpoint records
        (``raft_tpu.parallel.mesh_shape``)."""
        return {DATA_AXIS: self.data_size, SPATIAL_AXIS: self.spatial}

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


def make_mesh(device: torch.device = torch.device("cpu"),
              spatial: int = 1) -> Mesh:
    """The mesh of the process group this process belongs to (its
    default group), or a single-rank mesh without one.  ``spatial``: the
    ranks that split each sample's rows (it must divide the world);
    every rank makes every spatial group, as ``new_group`` requires."""
    device = torch.device(device)
    if not (dist.is_available() and dist.is_initialized()):
        if spatial != 1:
            raise ValueError(f"spatial={spatial} needs a process group")
        return Mesh(world=1, rank=0, local_rank=0, device=device,
                    backend="none")
    group = dist.group.WORLD
    backend = str(dist.get_backend(group))
    world, rank = dist.get_world_size(), dist.get_rank()
    if spatial < 1 or world % spatial:
        raise ValueError(f"spatial={spatial} must divide the world size "
                         f"{world}")
    host = (group if backend == "gloo"
            else dist.new_group(backend="gloo"))
    own = None
    if spatial > 1:
        for d in range(world // spatial):
            g = dist.new_group(list(range(d * spatial, (d + 1) * spatial)),
                               backend=backend)
            if d == rank // spatial:
                own = g
    return Mesh(world=world, rank=rank,
                local_rank=int(os.environ.get("LOCAL_RANK", 0)),
                device=device, backend=backend, group=group,
                host_group=host, spatial=spatial, spatial_group=own)


def init_from_env(device: str = "cuda",
                  backend: Optional[str] = None, spatial: int = 1) -> Mesh:
    """Join the process group that ``torchrun`` describes (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) and
    return its mesh.  On ``cuda`` the rank takes ``cuda:LOCAL_RANK`` and
    NCCL (``backend='gloo'`` for ranks that share one GPU, whose
    collectives then run eagerly through the host); on ``cpu`` gloo.
    ``spatial``: as for :func:`make_mesh`.  Raises ``RuntimeError``
    naming what is missing."""
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
    return make_mesh(dev, spatial)


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


def active_spatial() -> Optional[Mesh]:
    """The running step's mesh when it splits rows (``spatial > 1``),
    else None: what the convolutions and the correlation consult."""
    mesh = active()
    return mesh if mesh is not None and mesh.spatial > 1 else None


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks; the gradient of each rank's input is the sum
    of the ranks' output gradients (the global loss is their sum)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        with uncounted():
            out = t.clone()
            dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        with uncounted():
            grad = grad.contiguous().clone()
            dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(t: torch.Tensor, mesh: Mesh,
                   spatial: bool = False) -> torch.Tensor:
    """``t`` summed over ``mesh``'s ranks (with ``spatial``, over this
    rank's spatial group), differentiably."""
    return _AllReduceSum.apply(t, mesh.spatial_group if spatial
                               else mesh.group)


def spatial_max_(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``t`` replaced in place by its maximum over the spatial group (no
    gradient: a calibration, such as a quantized level's scale)."""
    with uncounted():
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.spatial_group)
    return t


# -- the spatial group's collectives ------------------------------------

# the non-deprecated names where this torch has them
_GATHER = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
_SCATTER = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor


# The profiler's names of the spatial collectives (``chip_smoke.py`` reads
# the halo exchange's share of a step from them); a label costs nothing
# while no profiler runs.
HALO_LABEL, GATHER_LABEL = "spatial_halo_rows", "spatial_all_gather_rows"


def _gather(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``(N * n, ...)``: the contiguous ``(n, ...)`` pieces of the
    spatial group's ranks, in spatial order."""
    N, s = mesh.spatial, mesh.spatial_index
    with uncounted():
        out = torch.empty((N * x.shape[0], *x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        if mesh.backend == "gloo" and x.is_cuda:
            out.zero_()
            out[s * x.shape[0]:(s + 1) * x.shape[0]].copy_(x)
            dist.all_reduce(out, group=mesh.spatial_group)
        else:
            _GATHER(out, x, group=mesh.spatial_group)
    return out


def _reduce_scatter(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``(n, ...)``: piece ``spatial_index`` of ``x`` ``(N * n, ...)``
    summed over the spatial group (the adjoint of :func:`_gather`)."""
    N, s = mesh.spatial, mesh.spatial_index
    n = x.shape[0] // N
    with uncounted():
        if mesh.backend == "gloo" and x.is_cuda:
            t = x.clone()
            dist.all_reduce(t, group=mesh.spatial_group)
            return t[s * n:(s + 1) * n].clone()
        out = torch.empty((n, *x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        _SCATTER(out, x.contiguous(), group=mesh.spatial_group)
    return out


class _AllGatherRows(torch.autograd.Function):
    """The spatial group's shards joined along ``dim``; the gradient of
    each shard is the sum over the ranks of their gradients' rows of it
    (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        with torch.profiler.record_function(GATHER_LABEL):
            rows = x.movedim(dim, 0).contiguous()
            return _gather(rows, mesh).movedim(0, dim).contiguous()

    @staticmethod
    def backward(ctx, grad):
        with torch.profiler.record_function(GATHER_LABEL):
            rows = grad.movedim(ctx.dim, 0).contiguous()
            return (_reduce_scatter(rows, ctx.mesh).movedim(0, ctx.dim)
                    .contiguous(), None, None)


def all_gather_rows(x: torch.Tensor, mesh: Mesh,
                    dim: int = 2) -> torch.Tensor:
    """The whole image from this rank's rows: ``x`` (rows along ``dim``)
    joined with the other shards of its spatial group in spatial order,
    differentiably (the backward is a reduce-scatter)."""
    return _AllGatherRows.apply(x, mesh, dim)


def _halo_plan(h: int, top: int, bottom: int, N: int, s: int):
    """Where each halo row comes from.  Each rank sends a strip of its
    first ``mt = min(bottom, h)`` and last ``mb = min(top, h)`` rows
    (what the ranks above and below read of it); the strips are
    gathered, rank r's at ``r * (mt + mb)``.  Returns ``(mt, mb, pieces
    of the top halo, pieces of the bottom halo)``, a piece ``(start in
    the gathered strips, rows)`` or ``(None, rows)`` for zeros beyond the
    image's edge."""
    mt, mb = min(bottom, h), min(top, h)

    def pieces(g0, g1):
        out = []
        g = g0
        while g < g1:
            r = g // h
            end = min(g1, (r + 1) * h)
            if r < 0 or r >= N:
                end = min(g1, 0) if r < 0 else g1
                out.append((None, end - g))
            else:
                l0 = g - r * h
                at = (l0 if l0 + (end - g) <= mt
                      else mt + l0 - (h - mb))
                out.append((r * (mt + mb) + at, end - g))
            g = end
        return out

    return (mt, mb, pieces(s * h - top, s * h),
            pieces((s + 1) * h, (s + 1) * h + bottom))


class _HaloRows(torch.autograd.Function):
    """``x`` with ``top`` rows of the shards above and ``bottom`` rows of
    the shards below (zeros beyond the image); the gradient of a halo row
    goes back to its owner and adds to its row."""

    @staticmethod
    def forward(ctx, x, top, bottom, mesh, dim):
        h = x.shape[dim]
        mt, mb, up, down = _halo_plan(h, top, bottom, mesh.spatial,
                                      mesh.spatial_index)
        ctx.mesh, ctx.dim, ctx.plan = mesh, dim, (h, top, mt, mb, up, down)
        rows = x.movedim(dim, 0)
        with torch.profiler.record_function(HALO_LABEL):
            strips = _gather(torch.cat([rows[:mt], rows[h - mb:]]), mesh)

            def halo(pieces):
                return [rows.new_zeros((n, *rows.shape[1:])) if at is None
                        else strips[at:at + n] for at, n in pieces]

            return torch.cat([t.movedim(0, dim) for t in halo(up)] + [x]
                             + [t.movedim(0, dim) for t in halo(down)],
                             dim=dim)

    @staticmethod
    def backward(ctx, grad):
        h, top, mt, mb, up, down = ctx.plan
        mesh, dim = ctx.mesh, ctx.dim
        rows = grad.movedim(dim, 0)
        with torch.profiler.record_function(HALO_LABEL):
            strips = rows.new_zeros((mesh.spatial * (mt + mb),
                                     *rows.shape[1:]))
            at_out = 0
            for at, n in up + [(None, h)] + down:
                if at is not None:
                    strips[at:at + n] += rows[at_out:at_out + n]
                at_out += n
            own = _reduce_scatter(strips, mesh).movedim(0, dim)
            gx = grad.narrow(dim, top, h).clone(
                memory_format=torch.contiguous_format)
            gx.narrow(dim, 0, mt).add_(own.narrow(dim, 0, mt))
            gx.narrow(dim, h - mb, mb).add_(own.narrow(dim, mt, mb))
        return gx, None, None, None, None


def halo_rows(x: torch.Tensor, top: int, bottom: int, mesh: Mesh,
              dim: int = 2) -> torch.Tensor:
    """``x`` (a shard of rows along ``dim``) with ``top`` rows above and
    ``bottom`` rows below it taken from the neighbouring shards of its
    spatial group, zeros beyond the image's edge, as a zero-padded
    convolution of the whole image reads them.  A halo taller than a
    shard takes rows from as far away as it reaches.  Differentiable:
    each halo row's gradient is added to its owner's row.  One gather of
    the ranks' edge strips forward, one reduce-scatter backward."""
    if top == 0 and bottom == 0:
        return x
    return _HaloRows.apply(x, top, bottom, mesh, dim)
