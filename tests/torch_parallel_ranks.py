"""What each rank runs in ``tests/test_torch_parallel.py`` (and the
two-rank trainer runs of ``tests/test_torch_train_cli.py``): module-level
functions that ``mode_tpu_torch.parallel.launch.run_ranks`` starts in
processes of their own, on the CPU over gloo. They import the port only,
so a rank starts without JAX; arrays come in and go back as numpy."""

import numpy as np
import torch

from mode_tpu_torch import training
from mode_tpu_torch.models.blocks import TorchBatchNorm
from mode_tpu_torch.models.disparity import ModeDisparity
from mode_tpu_torch.models.fusion import ModeFusion
from mode_tpu_torch.parallel import mesh as pmesh
from mode_tpu_torch.utils import losses

CPU = "cpu"


def _tensors(arrays) -> list:
  return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _after_step(model, loss, mesh) -> dict:
  """What a step leaves on this rank, and whether every rank holds the
  same parameters, gradients and buffers, bit for bit."""
  params = [p for _, p in model.named_parameters()]
  return {"loss": loss,
          "grads": {n: p.grad for n, p in model.named_parameters()},
          "state": model.state_dict(),
          "same": pmesh.same_on_every_rank(
              params + [p.grad for p in params] + list(model.buffers()),
              mesh)}


def stage1_step(npz: str, maxdisp: int, batch: tuple) -> dict:
  """One stage-1 step of the trained weights on this rank's rows of the
  global ``batch`` (uint8 left, right, f32 ground truth with NaNs)."""
  from mode_tpu_torch.utils.convert import load_npz
  mesh = pmesh.make_mesh(device=CPU)
  model = load_npz(ModeDisparity(maxdisp, device=CPU), npz)
  optimizer = training.make_optimizer(model.parameters())
  step = training.make_disparity_train_step(model, optimizer, mesh=mesh)
  left, right, gt = pmesh.shard_batch(mesh, _tensors(batch))
  loss = float(step(left, right, gt))
  out = _after_step(model, loss, mesh)
  out["collectives"] = mesh.collectives
  return out


def fusion_step(state: dict, channels: tuple, max_depth: float,
                inputs: list, gt: np.ndarray) -> dict:
  """One f32 ``ModeFusion`` step from ``state`` at ``FUSION_LR`` on this
  rank's rows of the global float inputs (depths, confidences, views)."""
  mesh = pmesh.make_mesh(device=CPU)
  model = ModeFusion(max_depth, channels, device=CPU)
  model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
  optimizer = training.make_optimizer(model.parameters())
  training.set_learning_rate(optimizer, training.FUSION_LR)
  step = training.make_fusion_train_step(model, optimizer, max_depth,
                                         mesh=mesh)
  xs = pmesh.shard_batch(mesh, [_tensors(group) for group in inputs])
  loss = float(step(*xs, pmesh.shard_batch(mesh, torch.from_numpy(gt))))
  return _after_step(model, loss, mesh)


def batch_norm(x: np.ndarray, g: np.ndarray) -> dict:
  """A training BN on this rank's rows of ``x`` under the mesh, backward
  from this rank's share of ``sum(y * g)``: its output, the input's
  gradient, the parameters' gradients summed over the ranks and the
  running statistics."""
  mesh = pmesh.make_mesh(device=CPU)
  bn = TorchBatchNorm(x.shape[1]).train()
  with torch.no_grad():
    bn.weight.uniform_(0.5, 1.5, generator=torch.Generator().manual_seed(1))
    bn.bias.uniform_(-0.5, 0.5, generator=torch.Generator().manual_seed(2))
  xr, gr = pmesh.shard_batch(mesh, _tensors([x, g]))
  xr.requires_grad_(True)
  with pmesh.activate(mesh):
    y = bn(xr)
  (y * gr).sum().backward()
  for p in bn.parameters():
    torch.distributed.all_reduce(p.grad)
  return {"y": y, "dx": xr.grad, "dweight": bn.weight.grad,
          "dbias": bn.bias.grad, "running_mean": bn.running_mean,
          "running_var": bn.running_var,
          "tracked": bn.num_batches_tracked}


def global_losses(pred: np.ndarray, gt: np.ndarray, mask: np.ndarray,
                  depth: np.ndarray, depth_gt: np.ndarray) -> dict:
  """Both losses on this rank's rows under the mesh, each with the
  gradient of its prediction rows."""
  mesh = pmesh.make_mesh(device=CPU)
  pred, gt, mask, depth, depth_gt = pmesh.shard_batch(
      mesh, _tensors([pred, gt, mask, depth, depth_gt]))
  out = {}
  for name, x, fn in (
      ("smooth_l1", pred, lambda p: losses.disparity_deep_supervision(
          (p, p * 0.5, p * 2.0), gt, mask, mesh)),
      ("silog", depth, lambda d: losses.silog_loss(
          0.5, d, depth_gt, depth_gt <= 80.0, mesh))):
    x = x.clone().requires_grad_(True)
    value = fn(x)
    value.backward()
    out[name] = {"value": value, "grad": x.grad}
  return out


def mesh_checks(rows: np.ndarray) -> dict:
  """This rank's shard of ``rows``, which mesh requests raise, and the
  place of this rank on a ``(1, 2)`` mesh."""
  mesh = pmesh.make_mesh(device=CPU)
  refused = {}
  for label, kw in (("data_off_world", {"data": 1}),
                    ("data_3", {"data": 3}),
                    ("mesh_off_world", {"data": 2, "spatial": 2})):
    try:
      pmesh.make_mesh(device=CPU, **kw)
    except ValueError as e:
      refused[label] = str(e)
  spatial = pmesh.make_mesh(spatial=2, device=CPU)
  try:
    pmesh.shard_batch(mesh, rows[:3])
  except ValueError as e:
    refused["batch_3"] = str(e)
  return {"shape": mesh.shape, "rank": mesh.rank,
          "spatial_mesh": (spatial.shape, spatial.rank, spatial.spatial_rank,
                           pmesh.shard_batch(spatial, rows)),
          "rows": pmesh.shard_batch(mesh, rows), "refused": refused,
          "gathered": pmesh.global_batch_from_local(
              mesh, torch.from_numpy(pmesh.shard_batch(mesh, rows)))}


def units(inputs: dict) -> dict:
  """:func:`batch_norm`, :func:`global_losses` and :func:`mesh_checks` on
  ``inputs["bn"]``, ``["losses"]`` and ``["mesh"]``, in one process."""
  return {"bn": batch_norm(*inputs["bn"]),
          "losses": global_losses(*inputs["losses"]),
          "mesh": mesh_checks(*inputs["mesh"])}


def trainer(name: str, argv: list) -> dict:
  """A training CLI's ``main(argv)`` on this rank: its losses, and the
  files it opened to write (``open`` watched while it runs)."""
  import builtins
  from mode_tpu_torch.cli import train_disparity, train_fusion
  main = {"train_disparity": train_disparity.main,
          "train_fusion": train_fusion.main}[name]
  written, real_open = [], builtins.open

  def watched(file, mode="r", *args, **kwargs):
    if any(c in mode for c in "wax+"):
      written.append(str(file))
    return real_open(file, mode, *args, **kwargs)

  builtins.open = watched
  try:
    out = main(argv)
  finally:
    builtins.open = real_open
  return {"losses": out["losses"], "written": written}
