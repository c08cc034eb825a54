"""What each rank runs in ``tests/test_torch_spatial.py``: module-level
functions that ``mode_tpu_torch.parallel.launch.run_ranks`` starts in
processes of their own, on the CPU over gloo. They import the port only,
so a rank starts without JAX; arrays come in and go back as numpy."""

import numpy as np
import torch

from mode_tpu_torch.models.disparity import ModeDisparity
from mode_tpu_torch.models.fusion import Baseline, ModeFusion
from mode_tpu_torch.parallel import mesh as pmesh
from mode_tpu_torch.parallel import shard_ops
from mode_tpu_torch.pipeline import TwoStagePipeline

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
  whose quarter-resolution H gives a rank an odd count of rows, the
  fusion net's training forward (stage 1 trains under the mesh), and a
  mesh that does not hold the world."""
  from mode_tpu_torch.models.blocks import ConvBn3d
  from mode_tpu_torch.utils.convert import load_npz
  world = torch.distributed.get_world_size()
  mesh = pmesh.make_mesh(spatial=world, device=CPU)
  model = load_npz(ModeDisparity(maxdisp, device=CPU), npz)
  conv = ConvBn3d(8, 8, 2).eval()
  pair = torch.from_numpy(left)
  fusion = ModeFusion(1000.0, (8, 16, 32, 64), device=CPU).train()
  maps = [torch.zeros((1, 16 * world, 8, 1))] * 6
  views = [torch.zeros((1, 16 * world, 8, 3))] * 4
  cases = {
      "rows": lambda: pmesh.constrain_spatial(
          torch.zeros((1, 2 * world + 1, 4, 2)), 1),
      "stride2": lambda: conv(torch.zeros((1, 2, 3, 4, 8))),
      "model_h": lambda: model(pair, pair),
      "train": lambda: fusion(maps, maps, views),
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


def _tensors(arrays):
  return [torch.from_numpy(a) for a in arrays]


def _fusion(state: dict, channels) -> ModeFusion:
  model = ModeFusion(1000.0, tuple(channels), device=CPU)
  model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()},
                        strict=True)
  return model.eval()


def sharded_fusion(state: dict, channels, depths, confs, rgbs, data: int,
                   spatial: int) -> dict:
  """``ModeFusion`` (weights ``state``) in eval on a ``(data, spatial)``
  mesh: this rank's rows of the batch of whole maps in, its rows of H out;
  the whole fused batch assembled from every rank's rows."""
  mesh = pmesh.make_mesh(data=data, spatial=spatial, device=CPU)
  model = _fusion(state, channels)
  inputs = [pmesh.shard_batch(mesh, _tensors(a)) for a in (depths, confs,
                                                           rgbs)]
  with pmesh.activate(mesh):
    out = model(*inputs)
  local = mesh.collectives
  whole = pmesh.global_batch_from_local(mesh, pmesh.gather_rows(out, 1, mesh))
  return {"out": out, "whole": whole, "collectives": local,
          "place": (mesh.rank, mesh.spatial_rank)}


def sharded_frame(npz: str, maxdisp: int, state: dict, lefts, rights,
                  rgbs, spatial: int) -> dict:
  """``TwoStagePipeline`` on a ``(1, spatial)`` mesh: the trained stage 1,
  the fusion net of ``state``, the whole frame on every rank."""
  from mode_tpu_torch.utils.convert import load_npz
  mesh = pmesh.make_mesh(data=1, spatial=spatial, device=CPU)
  disp = load_npz(ModeDisparity(maxdisp, out_conf=True, device=CPU), npz)
  pipe = TwoStagePipeline(disp, _fusion(state, (32, 64, 128, 256)), maxdisp,
                          1000.0, device=CPU)
  with pmesh.activate(mesh):
    fused, pred, conf = pipe(*_tensors((lefts, rights, rgbs)))
  return {"fused": fused, "pred": pred, "conf": conf,
          "collectives": mesh.collectives}


def fusion_refusals(h: int, w: int) -> dict:
  """What a ``(1, world)`` mesh refuses in stage 2 and the frame, each with
  its message: a fusion input whose H gives a rank an odd count of rows
  before a pool, a training forward of the fusion net, ``Baseline``, and a
  frame on a ``(world, 1)`` mesh."""
  world = torch.distributed.get_world_size()
  mesh = pmesh.make_mesh(spatial=world, device=CPU)
  model = ModeFusion(1000.0, (8, 16, 32, 64), device=CPU)
  depths = [torch.zeros((1, h, w, 1))] * 6
  views = [torch.zeros((1, h, w, 3))] * 4
  cases = {
      "fusion_h": lambda: model(depths, depths, views),
      "fusion_train": lambda: model.train()(depths, depths, views),
      "baseline": lambda: Baseline(1000.0, device=CPU)(depths),
  }
  out = {}
  with pmesh.activate(mesh):
    for label, fn in cases.items():
      try:
        fn()
      except (ValueError, NotImplementedError) as e:
        out[label] = f"{type(e).__name__}: {e}"
  data_mesh = pmesh.make_mesh(data=world, device=CPU)
  pipe = TwoStagePipeline(ModeDisparity(16, out_conf=True, device=CPU),
                          ModeFusion(1000.0, device=CPU), 16, device=CPU)
  frame = [torch.zeros((6, h, w, 3))] * 2 + [torch.zeros((4, h, w, 3))]
  with pmesh.activate(data_mesh):
    try:
      pipe(*frame)
    except ValueError as e:
      out["frame_data"] = f"{type(e).__name__}: {e}"
  return out
