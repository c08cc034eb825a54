"""The device mesh (``mode_tpu/parallel/mesh.py``): ``data`` ranks along
the batch, ``spatial`` ranks along the cost volume's H.

The JAX package runs one program over a ``("data", "spatial")`` mesh of
devices and lets XLA reduce over the sharded batch. The port runs one
process per card (``torchrun --nproc_per_node W``), rank ``r`` at mesh
place ``(r // spatial, r % spatial)`` as ``mesh_utils.create_device_mesh``
lays the JAX mesh out row-major, and makes every cross-rank step explicit.

The ``data`` axis (training and serving): each data index holds its rows
of the global batch. The ``spatial`` axis: the ranks of one data index
split the cost volume's H (:func:`row_sharding`, :func:`constrain_spatial`);
each 3-D conv runs on its rows after a one-plane halo exchange with its
neighbours (:func:`halo_concat`, ``parallel/shard_ops.py``), and
:func:`gather_rows` assembles the rows over the spatial group.

In training every reduction over the batch runs over the group whose
ranks hold its parts (``over``: :data:`DATA` or :data:`MESH`):

- the feature extractor runs whole on every spatial rank of a data index,
  so its BatchNorm layers reduce over the data group (``DATA``): the sums
  of its spatial index's ranks already hold the global batch;
- the 3-D stack's BatchNorm layers and the losses hold a rank's rows of H
  and reduce over the whole mesh (``MESH``);
- after the backward one all-reduce over the whole mesh averages the
  gradients (:func:`allreduce_gradients`).

Every cross-rank step in the forward has its transpose as its backward:
:func:`all_sum` (an all-reduce; backward the all-reduce of the gradient
over the same group), :func:`halo_concat` (backward: each halo plane's
gradient sent back and added to the neighbour's edge row),
:func:`gather_rows` (backward: the gradient summed over the spatial group,
this rank's rows kept) and :func:`constrain_spatial` (a slice; backward:
zeros outside this rank's rows). Each rank computes the same global loss
and starts its backward from it, so every rank's gradient comes out ``W =
data x spatial`` times its share of the global gradient: on a spatial rank
even the feature extractor's gradient is a partial sum, from its own rows
of the volume. The average over all ``W`` ranks is the gradient of the
global loss (exactly, for ``W`` a power of two).

A process that ``torchrun`` did not start is a world of one with no process
group, and the code paths are the single-card ones.

:func:`all_sum`, :func:`gather_rows` (forward and backward),
:func:`allreduce_gradients` and :func:`broadcast_state` open the tracer's
span ``collective.<name>`` (``utils/profiling.py``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
import threading
from typing import Iterable, Optional

import torch
import torch.distributed as dist

from mode_tpu_torch.device import resolve_device
from mode_tpu_torch.utils.profiling import span

# where ROADMAP.md lists what training the fusion net under a spatial mesh
# needs
FUSION_SPATIAL_TRAINING_ITEM = ("the fusion net's training under --sp in "
                                "ROADMAP.md")
# the groups a reduction in training runs over (module docstring)
DATA, MESH = "data", "mesh"
# How long a collective may wait for the other ranks. The trainers' rank 0
# alone packs the fusion set before the first step and validates each
# epoch while the others wait at a barrier: far longer than the backends'
# defaults (10 minutes for NCCL, 30 for gloo).
GROUP_TIMEOUT = datetime.timedelta(hours=6)

_state = threading.local()


def local_rank() -> int:
  return int(os.environ.get("LOCAL_RANK", "0"))


def initialize_distributed(device: str | torch.device | None = None,
                           backend: str | None = None) -> bool:
  """Join the process group that ``torchrun``'s environment describes
  (:func:`join_group`). A process with no ``WORLD_SIZE`` above 1 stays a
  world of one and creates no group. Returns whether a process group
  exists (one made before is kept)."""
  if dist.is_initialized():
    return True
  if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
    return False
  join_group(device, backend)
  return True


def join_group(device: str | torch.device | None = None,
               backend: str | None = None) -> None:
  """``init_process_group`` from the environment (``RANK``,
  ``WORLD_SIZE``, ``MASTER_ADDR``/``PORT``): NCCL for the card, gloo for
  ``device="cpu"`` (or ``backend``), collectives waiting up to
  ``GROUP_TIMEOUT``. On the card the current device becomes ``device`` if
  it names one, else ``cuda:LOCAL_RANK``."""
  device = torch.device(device) if device is not None else None
  cpu = device is not None and device.type == "cpu"
  if backend is None:
    backend = "gloo" if cpu else "nccl"
  if not cpu:
    torch.cuda.set_device(device if device is not None
                          and device.index is not None else local_rank())
  dist.init_process_group(backend, init_method="env://",
                          world_size=int(os.environ["WORLD_SIZE"]),
                          rank=int(os.environ["RANK"]),
                          timeout=GROUP_TIMEOUT)


@dataclasses.dataclass
class Mesh:
  """The ranks' ``(data, spatial)`` mesh over the default process group.
  ``rank`` is this process's place on ``data`` (its rows of the batch),
  ``spatial_rank`` its place on ``spatial`` (its rows of H), ``device``
  its card. ``data_group`` is the process group of the ranks at this
  spatial index, ``spatial_group`` that of the ranks at this data index;
  None is the default group, which a group holding every rank is (the
  spatial group is not used when ``spatial == 1``). Rank r sits at ``(r //
  spatial, r % spatial)``, so data index 0 at this spatial index is global
  rank ``spatial_rank``. ``collectives`` counts the all-reduces,
  broadcasts and all-gathers issued through it."""
  data: int
  rank: int
  device: torch.device
  spatial: int = 1
  spatial_rank: int = 0
  data_group: Optional[dist.ProcessGroup] = None
  spatial_group: Optional[dist.ProcessGroup] = None
  collectives: int = 0

  @property
  def shape(self) -> dict[str, int]:
    return {"data": self.data, "spatial": self.spatial}

  @property
  def global_rank(self) -> int:
    """This rank in the process group: ``rank * spatial + spatial_rank``."""
    return self.rank * self.spatial + self.spatial_rank

  def ranks(self, over: str) -> int:
    """How many ranks a reduction ``over`` :data:`DATA` or :data:`MESH`
    sums."""
    return self.data * (self.spatial if over == MESH else 1)

  def group(self, over: str) -> Optional[dist.ProcessGroup]:
    """The process group of a reduction ``over`` :data:`DATA` (this
    spatial index's data group) or :data:`MESH` (every rank: None, the
    default group)."""
    return None if over == MESH else self.data_group


def _axis_groups(data: int, spatial: int, world: int, mine: int):
  """Make the process groups of both axes, every one on every rank in the
  same order (``new_group`` must be called so): the spatial group of each
  data index, then the data group of each spatial index. A group of the
  whole world is the default group (None). Returns this rank's
  ``(data_group, spatial_group)``."""
  def group(ranks):
    if len(ranks) == world:
      return None
    return dist.new_group(ranks, timeout=GROUP_TIMEOUT)

  spatial_groups = [group([d * spatial + s for s in range(spatial)])
                    for d in range(data)]
  data_groups = [group([d * spatial + s for d in range(data)])
                 for s in range(spatial)]
  return data_groups[mine % spatial], spatial_groups[mine // spatial]


def make_mesh(data: int | None = None, spatial: int = 1,
              device: str | torch.device | None = None) -> Mesh:
  """The mesh of this process group: ``data * spatial`` must be the world
  size (``data=None``: the world size over ``spatial``). ``device`` as
  ``device.resolve_device`` takes it (None: the current card, which
  :func:`initialize_distributed` made ``cuda:LOCAL_RANK``). With
  ``spatial > 1`` every rank must call it, in the same order as its other
  group-making calls."""
  world = dist.get_world_size() if dist.is_initialized() else 1
  if spatial < 1 or world % spatial:
    raise ValueError(
        f"--sp {spatial}: the spatial axis must divide the world size, "
        f"{world}")
  if data is None:
    data = world // spatial
  if data * spatial != world:
    what = (f"--dp {data}: the data axis must be the world size, {world}"
            if spatial == 1 else
            f"--dp {data} x --sp {spatial}: the mesh must hold the world "
            f"size, {world}")
    raise ValueError(
        f"{what}; start {data * spatial} processes (torchrun "
        f"--nproc_per_node {data * spatial}) or leave --dp out")
  mine = dist.get_rank() if dist.is_initialized() else 0
  groups = ((None, None) if spatial == 1
            else _axis_groups(data, spatial, world, mine))
  return Mesh(data=data, rank=mine // spatial, device=resolve_device(device),
              spatial=spatial, spatial_rank=mine % spatial,
              data_group=groups[0], spatial_group=groups[1])


def batch_sharding(mesh: Mesh, batch: int) -> slice:
  """This rank's rows of a global batch of ``batch``: the contiguous block
  ``[r B / D, (r + 1) B / D)`` of its data index ``r``, as ``P("data")``
  shards the leading axis."""
  if batch % mesh.data:
    raise ValueError(f"a global batch of {batch} does not split over "
                     f"{mesh.data} ranks")
  n = batch // mesh.data
  return slice(mesh.rank * n, (mesh.rank + 1) * n)


def row_sharding(mesh: Mesh, n: int) -> slice:
  """This rank's rows of an H axis of ``n``: ``[s n / S, (s + 1) n / S)``
  of its spatial index ``s``, as ``P(..., "spatial", ...)`` shards it."""
  if n % mesh.spatial:
    raise ValueError(f"an H of {n} rows does not split over the "
                     f"{mesh.spatial} ranks of the spatial axis (H % "
                     f"{mesh.spatial} != 0)")
  k = n // mesh.spatial
  return slice(mesh.spatial_rank * k, (mesh.spatial_rank + 1) * k)


def shard_batch(mesh: Optional[Mesh], tree):
  """This rank's rows of every array or tensor in ``tree`` (lists, tuples
  and dicts walked); ``tree`` itself without a mesh."""
  if mesh is None:
    return tree
  if isinstance(tree, dict):
    return {k: shard_batch(mesh, v) for k, v in tree.items()}
  if isinstance(tree, (list, tuple)):
    return type(tree)(shard_batch(mesh, v) for v in tree)
  return tree[batch_sharding(mesh, tree.shape[0])]


def _gather(local: torch.Tensor, n: int, group, mesh: Mesh) -> list:
  parts = [torch.empty_like(local) for _ in range(n)]
  dist.all_gather(parts, local.contiguous(), group=group)
  mesh.collectives += 1
  return parts


def global_batch_from_local(mesh: Mesh, local: torch.Tensor) -> torch.Tensor:
  """The global batch from every data index's rows, in order (an
  all-gather over the data group; the local tensor itself at one)."""
  if mesh.data == 1:
    return local
  return torch.cat(_gather(local, mesh.data, mesh.data_group, mesh))


class _GatherRows(torch.autograd.Function):
  """The spatial group's rows, in order; its backward sums the gradient of
  the whole over the group and keeps this rank's rows (the transpose)."""

  @staticmethod
  def forward(ctx, t, axis, mesh):
    ctx.axis, ctx.mesh, ctx.n = axis, mesh, t.shape[axis]
    with span("collective.gather_rows"):
      return torch.cat(_gather(t, mesh.spatial, mesh.spatial_group, mesh),
                       dim=axis)

  @staticmethod
  def backward(ctx, g):
    mesh = ctx.mesh
    with span("collective.gather_rows"):
      g = g.clone(memory_format=torch.contiguous_format)
      dist.all_reduce(g, group=mesh.spatial_group)
    mesh.collectives += 1
    return g.narrow(ctx.axis, mesh.spatial_rank * ctx.n, ctx.n), None, None


def gather_rows(t: torch.Tensor, axis: int, mesh: Mesh) -> torch.Tensor:
  """The spatial group's rows of ``t`` along ``axis``, in order (an
  all-gather over the spatial group; ``t`` itself at one),
  differentiable (module docstring)."""
  if mesh.spatial == 1:
    return t
  return _GatherRows.apply(t, axis, mesh)


def halo_planes(x: torch.Tensor, axis: int, mesh: Mesh):
  """The previous rank's last plane of ``x`` along ``axis`` and the next
  rank's first plane (zeros at the spatial group's ends), not
  differentiable: one all-gather of every rank's (first, last) planes over
  the spatial group, from which each rank takes its neighbours'."""
  n = x.shape[axis]
  ends = torch.stack([x.select(axis, 0), x.select(axis, n - 1)]).contiguous()
  parts = _gather(ends, mesh.spatial, mesh.spatial_group, mesh)
  s = mesh.spatial_rank
  zero = torch.zeros_like(ends[0])
  above = parts[s - 1][1] if s > 0 else zero
  below = parts[s + 1][0] if s + 1 < mesh.spatial else zero
  return above.unsqueeze(axis), below.unsqueeze(axis)


class _HaloConcat(torch.autograd.Function):
  """:func:`halo_concat`; its backward sends each halo plane's gradient
  back to the rank whose plane it is, which adds it to its edge row (one
  all-gather), and keeps the gradient of its own rows."""

  @staticmethod
  def forward(ctx, x, axis, mesh):
    ctx.axis, ctx.mesh = axis, mesh
    above, below = halo_planes(x, axis, mesh)
    return torch.cat([above, x, below], dim=axis)

  @staticmethod
  def backward(ctx, g):
    axis, n = ctx.axis, g.shape[ctx.axis] - 2
    # this rank's halo planes are its neighbours' edge rows: the gradient
    # of its upper plane goes to the rank above as that rank's last row,
    # the lower plane's to the rank below as its first row
    above, below = halo_planes(
        torch.cat([g.narrow(axis, 0, 1), g.narrow(axis, n + 1, 1)], axis),
        axis, ctx.mesh)
    dx = g.narrow(axis, 1, n).clone(memory_format=torch.contiguous_format)
    dx.narrow(axis, 0, 1).add_(above)
    dx.narrow(axis, n - 1, 1).add_(below)
    return dx, None, None


def halo_concat(x: torch.Tensor, axis: int, mesh: Mesh) -> torch.Tensor:
  """``x`` with the previous rank's last plane along ``axis`` before it and
  the next rank's first plane after it (zeros at the spatial group's ends),
  from one all-gather over the spatial group; differentiable (its backward
  is the transpose, one more all-gather)."""
  return _HaloConcat.apply(x, axis, mesh)


@contextlib.contextmanager
def activate(mesh: Optional[Mesh]):
  """Make ``mesh`` the one the BatchNorm layers read (:func:`active_mesh`)
  while the block runs, in this thread; None makes none active."""
  prev = getattr(_state, "mesh", None)
  _state.mesh = mesh
  try:
    yield
  finally:
    _state.mesh = prev


def active_mesh() -> Optional[Mesh]:
  return getattr(_state, "mesh", None)


def sharded(mesh: Optional[Mesh], over: str) -> bool:
  """Whether a reduction ``over`` :data:`DATA` or :data:`MESH` spans more
  than one rank."""
  return mesh is not None and mesh.ranks(over) > 1


def spatial_mesh() -> Optional[Mesh]:
  """The active mesh if it splits H over more than one rank, else None."""
  mesh = active_mesh()
  return mesh if mesh is not None and mesh.spatial > 1 else None


def constrain_spatial(x: torch.Tensor, h_axis: int) -> torch.Tensor:
  """This rank's rows of ``x`` along ``h_axis`` under an active mesh with
  ``spatial > 1`` (:func:`row_sharding`); ``x`` as it is otherwise."""
  mesh = spatial_mesh()
  if mesh is None:
    return x
  return x[(slice(None),) * h_axis + (row_sharding(mesh, x.shape[h_axis]),)]


class _AllSum(torch.autograd.Function):
  """The sum over the ranks of a group; its backward is the sum of the
  gradients over the same group."""

  @staticmethod
  def forward(ctx, x, mesh, over):
    ctx.mesh, ctx.over = mesh, over
    with span("collective.all_sum"):
      x = x.clone(memory_format=torch.contiguous_format)
      dist.all_reduce(x, group=mesh.group(over))
    mesh.collectives += 1
    return x

  @staticmethod
  def backward(ctx, g):
    return _AllSum.apply(g, ctx.mesh, ctx.over), None, None


def all_sum(x: torch.Tensor, mesh: Mesh, over: str) -> torch.Tensor:
  """The sum of ``x`` over the ranks of the group ``over``, differentiable
  (module docstring)."""
  return _AllSum.apply(x, mesh, over)


def all_count(n: torch.Tensor, mesh: Mesh) -> torch.Tensor:
  """The sum of a count over every rank of the mesh, without a
  gradient."""
  n = n.detach().clone()
  dist.all_reduce(n)
  mesh.collectives += 1
  return n


def broadcast_state(module: torch.nn.Module, mesh: Mesh) -> None:
  """Copy rank 0's (data index 0, spatial index 0) parameters and buffers
  to every rank of the mesh, in place."""
  with torch.no_grad(), span("collective.broadcast_state"):
    for t in [*module.parameters(), *module.buffers()]:
      dist.broadcast(t.data, src=0)
      mesh.collectives += 1


def allreduce_gradients(params: Iterable[torch.nn.Parameter],
                        mesh: Mesh) -> None:
  """Average the gradients over every rank of the mesh in place (module
  docstring): one all-reduce of a flat buffer per dtype. A parameter
  without a gradient takes zeros, so every rank sends the same layout."""
  with span("collective.allreduce_gradients"):
    _allreduce_gradients(params, mesh)


def _allreduce_gradients(params, mesh: Mesh) -> None:
  by_dtype: dict[torch.dtype, list[torch.Tensor]] = {}
  for p in params:
    if p.grad is None:
      p.grad = torch.zeros_like(p)
    by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
  for grads in by_dtype.values():
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    mesh.collectives += 1
    flat.div_(mesh.ranks(MESH))
    offset = 0
    for g in grads:
      g.copy_(flat[offset:offset + g.numel()].view_as(g))
      offset += g.numel()


def same_on_every_rank(tensors: Iterable[torch.Tensor], mesh: Mesh) -> bool:
  """Whether every rank of the mesh holds bit-equal ``tensors`` (rank 0's
  bytes, broadcast, compared on each rank; then the verdicts
  all-reduced)."""
  flat = torch.cat([t.detach().reshape(-1).view(torch.uint8)
                    for t in tensors])
  ref = flat.clone()
  dist.broadcast(ref, src=0)
  bad = torch.tensor([float(not torch.equal(ref, flat))], device=flat.device)
  dist.all_reduce(bad)
  mesh.collectives += 2
  return float(bad) == 0.0
