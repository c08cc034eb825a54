"""Testing stage 1 (``mode_tpu/cli/test_disparity.py``).

    python -m mode_tpu_torch.cli.test_disparity --dataset_root Deep360/ \
        --checkpoint_disp disp.tar [--save_output_path out/ --save_ori]

Disparity metrics per batch (MAE, RMSE, Px1/3/5, D1 over the ground truth
in (0, max_disp]), averaged over the batches; optional ``_pred.npz`` and
colormapped ``_pred.png`` dumps; the table at the end. ``main`` returns the
averages by name. The flags are the JAX CLI's, plus ``--device`` (the CUDA
card by default; ``cpu`` runs the kernels' plain versions).

Each batch goes to the device in one copy per array; the metrics are
reduced there and read back as one vector, the prediction and the mask
only when they are dumped.
"""

from __future__ import annotations

import argparse
import os
import re

import numpy as np
import torch

from mode_tpu_torch.cli.common import (count_params, format_table,
                                       load_model_checkpoint)
from mode_tpu_torch.data.deep360 import Deep360DatasetDisparity
from mode_tpu_torch.data.file_lists import list_deep360_disparity_test
from mode_tpu_torch.data.loader import DataLoader
from mode_tpu_torch.device import resolve_device, upload
from mode_tpu_torch.models.disparity import ModeDisparity
from mode_tpu_torch.utils import metrics
from mode_tpu_torch.utils.colormap import save_colormapped

NAMES = ["MAE", "RMSE", "Px1 (%)", "Px3 (%)", "Px5 (%)", "D1 (%)"]


def build_parser():
  p = argparse.ArgumentParser(description="MODE Disparity testing (CUDA)")
  p.add_argument("--model_disp", default="ModeDisparity")
  p.add_argument("--dataset", default="Deep360",
                 choices=["Deep360", "3D60"])
  p.add_argument("--filenames_test", default=None,
                 help="3D60: filenames .txt for the test split")
  p.add_argument("--pair", default="lr", choices=["lr", "ud", "ur"])
  p.add_argument("--max_depth_3d60", type=float, default=20.0)
  p.add_argument("--dataset_root", default="../../datasets/Deep360/")
  p.add_argument("--width", default=512, type=int)
  p.add_argument("--height", default=1024, type=int)
  p.add_argument("--max_disp", type=int, default=192)
  p.add_argument("--max_depth", default=1000, type=float)
  p.add_argument("--batch_size", type=int, default=1)
  p.add_argument("--checkpoint_disp", default=None, required=True)
  p.add_argument("--soiled", action="store_true")
  p.add_argument("--save_output_path", type=str, default=None)
  p.add_argument("--save_ori", action="store_true")
  p.add_argument("--max_batches", type=int, default=None)
  p.add_argument("--device", default=None,
                 help="torch device; the CUDA card by default, 'cpu' runs "
                      "the kernels' plain versions")
  return p


def _out_name(ori_name: str, dataset: str) -> str:
  name = os.path.splitext(os.path.basename(ori_name))[0]
  if dataset == "Deep360":
    ep = re.findall(r"ep[0-9]_", ori_name)
    if ep:
      name = ep[0] + name
  return name


def main(argv=None):
  args = build_parser().parse_args(argv)
  device = resolve_device(args.device)
  save_out = args.save_output_path is not None
  if save_out:
    os.makedirs(args.save_output_path, exist_ok=True)

  model = ModeDisparity(args.max_disp, "Sphere", "Cassini", out_conf=False,
                        device=device)
  load_model_checkpoint(args.checkpoint_disp, model)
  print(f"Number of model parameters: {count_params(model)}")

  if args.dataset == "Deep360":
    tl, tr, td = list_deep360_disparity_test(args.dataset_root,
                                             soiled=args.soiled)
    ds = Deep360DatasetDisparity(tl, tr, td,
                                 shape=(args.height, args.width))
  else:
    from mode_tpu_torch.data.three_d60 import Dataset3D60Disparity
    ds = Dataset3D60Disparity(args.filenames_test, args.dataset_root,
                              "testing", shape=(args.height, args.width),
                              pair=args.pair,
                              max_depth=args.max_depth_3d60)
  loader = DataLoader(ds, batch_size=args.batch_size,
                      num_workers=args.batch_size)
  print(f"Testing of Disparity. Model: {args.checkpoint_disp}")
  print(f"num of test files: {len(ds)}")

  totals = np.zeros(len(NAMES))
  n_batches = 0
  for bi, batch in enumerate(loader):
    if args.max_batches and bi >= args.max_batches:
      break
    left = upload(batch["leftImg"], device)
    right = upload(batch["rightImg"], device)
    gt = upload(batch["dispMap"], device)
    mask = (gt > 0) & torch.isfinite(gt) & (gt <= args.max_disp)
    gt0 = torch.nan_to_num(gt)
    pred = model(left, right)
    m = metrics.disparity_metrics(pred, gt0, mask)
    totals += torch.stack([m[k] for k in NAMES]).cpu().numpy()
    n_batches += 1
    if save_out:
      pred, mask = pred.cpu().numpy(), mask.cpu().numpy()
      gt0 = np.nan_to_num(batch["dispMap"])
      name_key = "dispNames" if args.dataset == "Deep360" else "leftNames"
      for i in range(pred.shape[0]):
        name = _out_name(batch[name_key][i], args.dataset)
        if args.save_ori:
          np.savez(os.path.join(args.save_output_path, name + "_pred.npz"),
                   np.where(mask[i], pred[i], 0))
        side_by_side = np.concatenate([gt0[i], pred[i]], 1)
        save_colormapped(
            os.path.join(args.save_output_path, name + "_pred.png"),
            side_by_side, np.concatenate([mask[i], mask[i]], 1))
  mean = totals / max(n_batches, 1)
  print(f"\nTest Results on Disparity using model "
        f"{args.checkpoint_disp}:\n")
  print(format_table(NAMES, [list(mean)]))
  return dict(zip(NAMES, mean))


if __name__ == "__main__":
  main()
