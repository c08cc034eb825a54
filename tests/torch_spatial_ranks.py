"""What each rank runs in ``tests/test_torch_spatial.py``: module-level
functions that ``mode_tpu_torch.parallel.launch.run_ranks`` starts in
processes of their own, on the CPU over gloo. They import the port only,
so a rank starts without JAX; arrays come in and go back as numpy."""

import numpy as np
import torch

from mode_tpu_torch.models.disparity import ModeDisparity
from mode_tpu_torch.parallel import mesh as pmesh
from mode_tpu_torch.parallel import shard_ops

CPU = "cpu"


def halo_and_gather(x: np.ndarray, axis: int, spatial: int) -> dict:
  """This rank's rows of ``x`` along ``axis`` on a ``(world / spatial,
  spatial)`` mesh, with their halo planes (``shard_ops.halo_concat``) and
  gathered back (``gather_rows``), and the mesh's places."""
  mesh = pmesh.make_mesh(spatial=spatial, device=CPU)
  rows = pmesh.row_sharding(mesh, x.shape[axis])
  local = torch.from_numpy(np.ascontiguousarray(
      x[(slice(None),) * axis + (rows,)]))
  return {"rank": mesh.rank, "spatial_rank": mesh.spatial_rank,
          "rows": (rows.start, rows.stop),
          "halo": shard_ops.halo_concat(local, axis, mesh),
          "gathered": pmesh.gather_rows(local, axis, mesh),
          "collectives": mesh.collectives}


def sharded_eval(npz: str, maxdisp: int, left: np.ndarray,
                 right: np.ndarray, data: int, spatial: int,
                 sphere_type: str = "Cassini") -> dict:
  """The trained model's eval forward on a ``(data, spatial)`` mesh: this
  rank's rows of the global batch, then of H; returns its rows and the
  whole frame assembled from every rank's (``gather_rows``, then
  ``global_batch_from_local``)."""
  from mode_tpu_torch.utils.convert import load_npz
  mesh = pmesh.make_mesh(data=data, spatial=spatial, device=CPU)
  model = load_npz(ModeDisparity(maxdisp, "Sphere", sphere_type,
                                 out_conf=True, device=CPU), npz)
  lt, rt = pmesh.shard_batch(mesh, [torch.from_numpy(left),
                                    torch.from_numpy(right)])
  with pmesh.activate(mesh):
    pred, conf = model(lt, rt)
  local = mesh.collectives
  whole = [pmesh.global_batch_from_local(mesh, pmesh.gather_rows(t, 1, mesh))
           for t in (pred, conf)]
  return {"pred": pred, "conf": conf, "whole_pred": whole[0],
          "whole_conf": whole[1], "collectives": local,
          "place": (mesh.rank, mesh.spatial_rank)}


def refusals(npz: str, maxdisp: int, left: np.ndarray) -> dict:
  """What a ``(1, world)`` mesh refuses, each with its message: rows of
  H that do not split over the spatial axis, a stride-2 conv whose rows
  would not start on an even global row, the trained model on a pair
  whose quarter-resolution H gives a rank an odd count of rows, a
  training forward, and a mesh that does not hold the world."""
  from mode_tpu_torch.models.blocks import ConvBn3d
  from mode_tpu_torch.utils.convert import load_npz
  world = torch.distributed.get_world_size()
  mesh = pmesh.make_mesh(spatial=world, device=CPU)
  model = load_npz(ModeDisparity(maxdisp, device=CPU), npz)
  conv = ConvBn3d(8, 8, 2).eval()
  pair = torch.from_numpy(left)
  cases = {
      "rows": lambda: pmesh.constrain_spatial(
          torch.zeros((1, 2 * world + 1, 4, 2)), 1),
      "stride2": lambda: conv(torch.zeros((1, 2, 3, 4, 8))),
      "model_h": lambda: model(pair, pair),
      "train": lambda: model.train()(pair, pair),
  }
  out = {}
  with pmesh.activate(mesh):
    for label, fn in cases.items():
      try:
        fn()
      except (ValueError, NotImplementedError) as e:
        out[label] = f"{type(e).__name__}: {e}"
  try:
    pmesh.make_mesh(data=2, spatial=world, device=CPU)
  except ValueError as e:
    out["mesh"] = f"{type(e).__name__}: {e}"
  return out
