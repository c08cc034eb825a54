"""The stage-1 -> stage-2 bridge over a dataset
(``mode_tpu/cli/save_output_disparity_stage.py``).

    python -m mode_tpu_torch.cli.save_output_disparity_stage \
        --datapath Deep360/ --outpath pred/ --checkpoint_disp disp.tar

Runs stage 1 (disparity and confidence) over every pair of the Deep360
tree, training, validation and testing, and writes for each pair its depth
in camera 1's frame (``disp_pred2depth/<frame>_<pair>_disp_pred2depth.npz``)
and its confidence carried there (``conf_map/<frame>_<pair>_conf_map.png``),
the tree that ``test_fusion`` reads. Stage 1 runs a batch at a time (6, a
frame's pairs, by default); the bridge runs image by image, as the JAX CLI
runs it, each image read back once. The flags are the JAX CLI's, plus
``--device`` (the CUDA card by default; ``cpu`` runs the kernels' plain
versions).
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from mode_tpu_torch.cli.common import count_params, load_model_checkpoint
from mode_tpu_torch.data.deep360 import Deep360DatasetDisparity
from mode_tpu_torch.data.file_lists import list_deep360_disparity_all
from mode_tpu_torch.data.loader import DataLoader
from mode_tpu_torch.device import resolve_device, upload
from mode_tpu_torch.geometry.reprojection import (DEEP360_BASELINES,
                                                  FISHEYE_BASELINES,
                                                  disp_to_depth_at_cam1)
from mode_tpu_torch.models.disparity import ModeDisparity
from mode_tpu_torch.utils.colormap import save_gray_png


def build_parser():
  p = argparse.ArgumentParser(
      description="MODE - save disparity and confidence outputs (CUDA)")
  p.add_argument("--max_disp", type=int, default=192)
  p.add_argument("--dbname", default="Deep360")
  p.add_argument("--datapath", default="../../datasets/Deep360/")
  p.add_argument("--soiled", action="store_true")
  p.add_argument("--outpath", default="./outputs/Deep360PredDepth/")
  p.add_argument("--batch_size", type=int, default=6)
  p.add_argument("--checkpoint_disp", default=None)
  p.add_argument("--width", default=512, type=int)
  p.add_argument("--height", default=1024, type=int)
  p.add_argument("--seed", type=int, default=1)
  p.add_argument("--max_batches", type=int, default=None)
  p.add_argument("--device", default=None,
                 help="torch device; the CUDA card by default, 'cpu' runs "
                      "the kernels' plain versions")
  return p


def baselines_for_dbname(dbname: str) -> dict:
  """The stereo baselines by dataset name (the reference's
  save_output_disparity_stage.py:108-113): 'Deep360' takes the simulated
  rig's 1 / 1 / sqrt 2, any other rig name the real fisheye rig's
  0.6 sqrt 2 / 1.2. '3D60' has no rig (the reference leaves it undefined):
  it raises."""
  if dbname == "Deep360":
    return DEEP360_BASELINES
  if dbname == "3D60":
    raise ValueError("3D60 has no camera rig: the bridge is Deep360/fisheye "
                     "only (3D60 fusion inputs come from the 3D60 loaders)")
  return FISHEYE_BASELINES


def output_paths(disp_name: str, datapath: str, outpath: str, outdir: str,
                 outdir_conf: str) -> tuple[str, str]:
  """A disparity file's (depth ``.npz``, conf ``.png``) output paths, by
  path components (the reference's ``.replace('disp', ...)`` breaks where
  'disp' is in the datapath or the episode's name)."""
  rel = os.path.relpath(disp_name, datapath)
  parts = rel.split(os.sep)
  # .../<ep>/<subset>/disp/<frame>_<pair>_disp.npz
  stem = parts[-1][:-len("disp.npz")]
  subdir = parts[:-2]
  depth_out = os.path.join(outpath, *subdir, outdir,
                           stem + "disp_pred2depth.npz")
  conf_out = os.path.join(outpath, *subdir, outdir_conf, stem + "conf_map.png")
  return depth_out, conf_out


def pad16(x: np.ndarray) -> tuple[np.ndarray, int, int]:
  """Pad H (at the top) and W (at the right) of an NHWC batch to multiples
  of 16 (save_output_disparity_stage.py:77-90); returns the padded batch
  and the two pads."""
  h, w = x.shape[1:3]
  top = (-h) % 16
  right = (-w) % 16
  if top or right:
    x = np.pad(x, ((0, 0), (top, 0), (0, right), (0, 0)))
  return x, top, right


def main(argv=None):
  args = build_parser().parse_args(argv)
  device = resolve_device(args.device)

  left, right, disp = list_deep360_disparity_all(args.datapath, args.soiled)
  ds = Deep360DatasetDisparity(left, right, disp,
                               shape=(args.height, args.width))
  loader = DataLoader(ds, batch_size=args.batch_size,
                      num_workers=args.batch_size)

  model = ModeDisparity(args.max_disp, "Sphere", "Cassini", out_conf=True,
                        device=device)
  if args.checkpoint_disp:
    print("Load pretrained model")
    load_model_checkpoint(args.checkpoint_disp, model)
  print(f"Number of model parameters: {count_params(model)}")

  outdir = "disp_pred2depth" if not args.soiled else "disp_pred2depth_soiled"
  outdir_conf = "conf_map" if not args.soiled else "conf_map_soiled"
  eps = sorted(d for d in os.listdir(args.datapath) if d.startswith("ep"))
  for ep in eps:
    for subset in ("training", "validation", "testing"):
      if not os.path.isdir(os.path.join(args.datapath, ep, subset)):
        continue
      os.makedirs(os.path.join(args.outpath, ep, subset, outdir),
                  exist_ok=True)
      os.makedirs(os.path.join(args.outpath, ep, subset, outdir_conf),
                  exist_ok=True)

  baselines = baselines_for_dbname(args.dbname)
  n = len(loader)
  for bi, batch in enumerate(loader):
    print(f"\rDisparity output progress: {100 * (bi + 1) / n:.2f}%", end="")
    if args.max_batches and bi >= args.max_batches:
      break
    imgl, top, rgt = pad16(batch["leftImg"])
    imgr, _, _ = pad16(batch["rightImg"])
    pred, conf = model(upload(imgl, device), upload(imgr, device))
    pred = pred[:, top:, :pred.shape[2] - rgt]
    conf = conf[:, top:, :conf.shape[2] - rgt]
    for i in range(pred.shape[0]):
      disp_name = batch["dispNames"][i]
      pair = disp_name[-11:-9]
      depth1, conf1 = disp_to_depth_at_cam1(pred[i], conf[i], pair,
                                            baselines)
      depth1, conf1 = torch.stack([depth1, conf1]).cpu().numpy()
      depth_out, conf_out = output_paths(disp_name, args.datapath,
                                         args.outpath, outdir, outdir_conf)
      np.savez(depth_out, depth1)
      save_gray_png(conf_out, conf1)
  print()


if __name__ == "__main__":
  main()
