"""The device mesh of data-parallel training (``mode_tpu/parallel/mesh.py``).

The JAX package runs one program over a ``("data", "spatial")`` mesh of
devices and lets XLA reduce over the sharded batch. The port runs one
process per card (``torchrun --nproc_per_node W``), each on its own rows of
the global batch, and makes every reduction over the batch explicit:

- the BatchNorm layers in training normalise with the global batch's
  statistics (``models/blocks.py:TorchBatchNorm``), as ``jnp.mean`` over a
  sharded axis does;
- the losses are global masked means (``utils/losses.py``);
- after the backward one all-reduce averages the gradients
  (:func:`allreduce_gradients`).

Every cross-rank sum in the forward is :func:`all_sum`, an all-reduce whose
backward is the all-reduce of the gradient. Each rank computes the same
global loss and starts its backward from it, so every rank's gradient comes
out ``W`` times its share, and the average over ranks is the gradient of
the global loss (exactly, for ``W`` a power of two).

Only the ``data`` axis is ported; ``spatial > 1`` raises. A process that
``torchrun`` did not start is a world of one with no process group, and
the code paths are the single-card ones.
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

# where ROADMAP.md lists what the spatial axis needs
SPATIAL_ITEM = "the spatial axis of M12 in ROADMAP.md"
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
  """The ranks' mesh over the default process group: ``data`` ranks along
  the batch, one along ``spatial``. ``rank`` is this process's place on
  ``data`` and ``device`` its card. ``collectives`` counts the
  all-reduces, broadcasts and all-gathers issued through it."""
  data: int
  rank: int
  device: torch.device
  spatial: int = 1
  collectives: int = 0

  @property
  def shape(self) -> dict[str, int]:
    return {"data": self.data, "spatial": self.spatial}


def make_mesh(data: int | None = None, spatial: int = 1,
              device: str | torch.device | None = None) -> Mesh:
  """The mesh of this process group: ``data=None`` means the world size,
  any other value must equal it. ``device`` as
  ``device.resolve_device`` takes it (None: the current card, which
  :func:`initialize_distributed` made ``cuda:LOCAL_RANK``)."""
  if spatial != 1:
    raise ValueError(f"--sp {spatial}: sharding the cost volume over cards "
                     f"is not ported yet ({SPATIAL_ITEM}); use 1")
  world = dist.get_world_size() if dist.is_initialized() else 1
  if data is None:
    data = world
  if data != world:
    raise ValueError(
        f"--dp {data}: the data axis must be the world size, {world}; start "
        f"{data} processes (torchrun --nproc_per_node {data}) or leave it "
        "out")
  rank = dist.get_rank() if dist.is_initialized() else 0
  return Mesh(data=data, rank=rank, device=resolve_device(device))


def batch_sharding(mesh: Mesh, batch: int) -> slice:
  """This rank's rows of a global batch of ``batch``: the contiguous block
  ``[r B / W, (r + 1) B / W)``, as ``P("data")`` shards the leading axis."""
  if batch % mesh.data:
    raise ValueError(f"a global batch of {batch} does not split over "
                     f"{mesh.data} ranks")
  n = batch // mesh.data
  return slice(mesh.rank * n, (mesh.rank + 1) * n)


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


def global_batch_from_local(mesh: Mesh, local: torch.Tensor) -> torch.Tensor:
  """The global batch from every rank's rows, in rank order (an
  all-gather; the local tensor itself at one rank)."""
  if mesh.data == 1:
    return local
  parts = [torch.empty_like(local) for _ in range(mesh.data)]
  dist.all_gather(parts, local.contiguous())
  mesh.collectives += 1
  return torch.cat(parts)


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


def sharded(mesh: Optional[Mesh]) -> bool:
  """Whether the batch is split over more than one rank."""
  return mesh is not None and mesh.data > 1


def constrain_spatial(x: torch.Tensor, h_axis: int) -> torch.Tensor:
  """``x`` as it is: with ``spatial == 1`` nothing is sharded along H."""
  del h_axis
  return x


class _AllSum(torch.autograd.Function):
  """The sum over the ranks; its backward is the sum of the gradients."""

  @staticmethod
  def forward(ctx, x, mesh):
    ctx.mesh = mesh
    x = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(x)
    mesh.collectives += 1
    return x

  @staticmethod
  def backward(ctx, g):
    return _AllSum.apply(g, ctx.mesh), None


def all_sum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
  """The sum of ``x`` over the ranks, differentiable (module docstring)."""
  return _AllSum.apply(x, mesh)


def all_count(n: torch.Tensor, mesh: Mesh) -> torch.Tensor:
  """The sum of a count over the ranks, without a gradient."""
  n = n.detach().clone()
  dist.all_reduce(n)
  mesh.collectives += 1
  return n


def broadcast_state(module: torch.nn.Module, mesh: Mesh) -> None:
  """Copy rank 0's parameters and buffers to every rank, in place."""
  with torch.no_grad():
    for t in [*module.parameters(), *module.buffers()]:
      dist.broadcast(t.data, src=0)
      mesh.collectives += 1


def allreduce_gradients(params: Iterable[torch.nn.Parameter],
                        mesh: Mesh) -> None:
  """Average the gradients over the ranks in place: one all-reduce of a
  flat buffer per dtype. A parameter without a gradient takes zeros, so
  every rank sends the same layout."""
  by_dtype: dict[torch.dtype, list[torch.Tensor]] = {}
  for p in params:
    if p.grad is None:
      p.grad = torch.zeros_like(p)
    by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
  for grads in by_dtype.values():
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    mesh.collectives += 1
    flat.div_(mesh.data)
    offset = 0
    for g in grads:
      g.copy_(flat[offset:offset + g.numel()].view_as(g))
      offset += g.numel()


def same_on_every_rank(tensors: Iterable[torch.Tensor], mesh: Mesh) -> bool:
  """Whether every rank holds bit-equal ``tensors`` (rank 0's bytes,
  broadcast, compared on each rank; then the verdicts all-reduced)."""
  flat = torch.cat([t.detach().reshape(-1).view(torch.uint8)
                    for t in tensors])
  ref = flat.clone()
  dist.broadcast(ref, src=0)
  bad = torch.tensor([float(not torch.equal(ref, flat))], device=flat.device)
  dist.all_reduce(bad)
  mesh.collectives += 2
  return float(bad) == 0.0
