"""What each rank runs in ``tests/test_torch_spatial_train.py``: module-level
functions that ``mode_tpu_torch.parallel.launch.run_ranks`` starts in
processes of their own, on the CPU over gloo. They import the port only,
so a rank starts without JAX; arrays come in and go back as numpy."""

import numpy as np
import torch

from mode_tpu_torch import training
from mode_tpu_torch.models import blocks
from mode_tpu_torch.models.disparity import ModeDisparity
from mode_tpu_torch.ops import conv3d as conv3d_ops
from mode_tpu_torch.parallel import mesh as pmesh
from mode_tpu_torch.parallel import shard_ops
from mode_tpu_torch.utils import losses

CPU = "cpu"
H_AXIS = 2
# the 3-D training gates, which a rank may force on so that every 3-D conv
# takes the kernels' Function (their plain versions on the CPU)
GATES_3D = ("train_s1_eligible", "train_s2_eligible", "train_deconv_eligible")


def _t(a) -> torch.Tensor:
  return torch.from_numpy(np.ascontiguousarray(a))


def _rows(mesh, a: np.ndarray, axis: int) -> np.ndarray:
  return a[(slice(None),) * axis + (pmesh.row_sharding(mesh, a.shape[axis]),)]


def collectives(x: np.ndarray, gh: np.ndarray, gg: np.ndarray) -> dict:
  """``halo_concat`` and ``gather_rows`` on this rank's rows of ``x``
  (axis 2), each backward from ``sum(y * g)`` with this rank's cotangent
  (``gh[r]`` haloed rows, ``gg[r]`` the whole gathered axis): the gradient
  of its rows, on a ``(1, world)`` mesh."""
  mesh = pmesh.make_mesh(data=1, device=CPU,
                         spatial=torch.distributed.get_world_size())
  r = torch.distributed.get_rank()
  out = {}
  for name, fn, g in (
      ("halo", lambda t: pmesh.halo_concat(t, H_AXIS, mesh), gh[r]),
      ("gather", lambda t: pmesh.gather_rows(t, H_AXIS, mesh), gg[r])):
    xr = _t(_rows(mesh, x, H_AXIS)).requires_grad_(True)
    (fn(xr) * _t(g)).sum().backward()
    out[name] = xr.grad
  out["collectives"] = mesh.collectives
  return out


def sharded_convs(cases: dict) -> dict:
  """Each training conv of ``cases`` (name -> (x, weight, g, kind)) on this
  rank's rows under a ``(1, world)`` mesh: its output rows, the gradient
  of its rows of ``x`` and its share of the weight's gradient, backward
  from ``sum(y * g)`` with this rank's rows of the cotangent ``g``. The
  kinds: ``"s1"``/``"s2"`` and ``"deconv"`` the kernels' Functions
  (``conv3d_train``/``deconv3d_train`` with ``mesh``), ``"lib_s1"``,
  ``"lib_s2"`` and ``"lib_deconv"`` the library convs on the haloed rows
  (``shard_ops``)."""
  mesh = pmesh.make_mesh(data=1, device=CPU,
                         spatial=torch.distributed.get_world_size())
  out = {}
  for name, (x, w, g, kind) in cases.items():
    xr = _t(_rows(mesh, x, H_AXIS)).requires_grad_(True)
    wt = _t(w).requires_grad_(True)
    fn = {
        "s1": lambda: conv3d_ops.conv3d_train(xr, wt, 1, mesh=mesh),
        "s2": lambda: conv3d_ops.conv3d_train(xr, wt, 2, mesh=mesh),
        "deconv": lambda: conv3d_ops.deconv3d_train(xr, wt, mesh=mesh),
        "lib_s1": lambda: shard_ops.conv3d_library_sharded(xr, wt, 1,
                                                           mesh=mesh),
        "lib_s2": lambda: shard_ops.conv3d_library_sharded(xr, wt, 2,
                                                           mesh=mesh),
        "lib_deconv": lambda: shard_ops.deconv3d_library_sharded(
            xr, wt, mesh=mesh)}[kind]
    y = fn()
    (y * _t(_rows(mesh, g, H_AXIS))).sum().backward()
    out[name] = {"y": y, "dx": xr.grad, "dw": wt.grad}
  out["collectives"] = mesh.collectives
  return out


def _part(mesh, a: np.ndarray, h_axis, b_axis: int = 0) -> torch.Tensor:
  """This rank's part of ``a``: its data index's rows of the batch axis,
  then its rows of ``h_axis`` (None: the whole axis)."""
  idx = [slice(None)] * a.ndim
  idx[b_axis] = pmesh.batch_sharding(mesh, a.shape[b_axis])
  if h_axis is not None:
    idx[h_axis] = pmesh.row_sharding(mesh, a.shape[h_axis])
  return _t(a[tuple(idx)])


def reductions(x: np.ndarray, g: np.ndarray, preds: np.ndarray,
               gt: np.ndarray, mask: np.ndarray, data: int,
               spatial: int) -> dict:
  """On a ``(data, spatial)`` mesh: a 3-D stack BN (``over=MESH``) on this
  rank's rows of the batch and of H of the NCDHW ``x``, backward from its
  part of ``sum(y * g)``, its parameters' gradients summed over the
  ranks; a 2-D BN (``over=DATA``) on its data index's whole ``x[:, :,
  0]``, as every spatial rank runs the feature extractor; and the
  deep-supervision loss on its rows of ``preds`` (three heads, ``(3, B, H,
  W)``), ``gt`` and ``mask``, with the gradient of its prediction rows."""
  mesh = pmesh.make_mesh(data=data, spatial=spatial, device=CPU)
  out = {}
  for name, over, xs, gs, h_axis in (
      ("bn3d", pmesh.MESH, x, g, 3),
      ("bn2d", pmesh.DATA, x[:, :, 0], g[:, :, 0], None)):
    bn = blocks.TorchBatchNorm(x.shape[1], over=over).train()
    with torch.no_grad():
      bn.weight.uniform_(0.5, 1.5, generator=torch.Generator().manual_seed(1))
      bn.bias.uniform_(-0.5, 0.5, generator=torch.Generator().manual_seed(2))
    xr = _part(mesh, xs, h_axis).requires_grad_(True)
    with pmesh.activate(mesh):
      y = bn(xr)
    (y * _part(mesh, gs, h_axis)).sum().backward()
    for p in bn.parameters():
      torch.distributed.all_reduce(p.grad)
    out[name] = {"y": y, "dx": xr.grad, "dweight": bn.weight.grad,
                 "dbias": bn.bias.grad, "running_mean": bn.running_mean,
                 "running_var": bn.running_var}
  pr = _part(mesh, preds, 2, b_axis=1).requires_grad_(True)
  loss = losses.disparity_deep_supervision(
      tuple(pr), _part(mesh, gt, 1), _part(mesh, mask, 1), mesh)
  loss.backward()
  out["loss"] = {"value": loss, "grad": pr.grad}
  return out


def units(collective_inputs: tuple, conv_cases: dict,
          reduction_inputs: tuple, meshes: list) -> dict:
  """:func:`collectives`, :func:`sharded_convs` and :func:`reductions` (on
  each ``(data, spatial)`` of ``meshes``) in one process."""
  return {"collectives": collectives(*collective_inputs),
          "convs": sharded_convs(conv_cases),
          "reductions": {m: reductions(*reduction_inputs, *m)
                         for m in meshes}}


def _force_3d_gates() -> None:
  for name in GATES_3D:
    setattr(conv3d_ops, name, lambda *a, **k: True)


def train_steps(npz: str, maxdisp: int, runs: dict) -> dict:
  """:func:`train_step` for each ``label: (batch, data, spatial,
  sphere_type, remat_policy, kernels_3d)`` of ``runs``, in order, in one
  process (a run that forces the gates keeps them forced: put it last)."""
  return {label: train_step(npz, maxdisp, *args)
          for label, args in runs.items()}


def train_step(npz: str, maxdisp: int, batch: tuple, data: int,
               spatial: int, sphere_type: str = "Cassini",
               remat_policy: str = "save_convs",
               kernels_3d: bool = False) -> dict:
  """One stage-1 step of the trained weights on a ``(data, spatial)``
  mesh, this rank's data index's rows of the global ``batch`` (the step
  takes its rows of H): its loss, its gradients, its state after the step,
  whether every rank holds bit-equal parameters, gradients and buffers,
  and the collectives the step made. ``kernels_3d`` forces the 3-D
  training gates on, so every 3-D conv takes the kernels' Function on its
  rows."""
  from mode_tpu_torch.utils.convert import load_npz
  if kernels_3d:
    _force_3d_gates()
  mesh = pmesh.make_mesh(data=data, spatial=spatial, device=CPU)
  model = load_npz(ModeDisparity(maxdisp, "Sphere", sphere_type,
                                 remat_policy=remat_policy, device=CPU), npz)
  optimizer = training.make_optimizer(model.parameters())
  step = training.make_disparity_train_step(model, optimizer, mesh=mesh)
  rows = pmesh.shard_batch(mesh, [_t(a) for a in batch])
  built = mesh.collectives
  loss = float(step(*rows))
  params = [p for _, p in model.named_parameters()]
  out = {"loss": loss, "collectives": mesh.collectives - built,
         "grads": {n: p.grad for n, p in model.named_parameters()},
         "state": model.state_dict(),
         "place": (mesh.rank, mesh.spatial_rank)}
  out["same"] = pmesh.same_on_every_rank(
      params + [p.grad for p in params] + list(model.buffers()), mesh)
  return out
