"""Testing stage 2 in the ERP domain (``mode_tpu/cli/test_fusion.py``).

    python -m mode_tpu_torch.cli.test_fusion --datapath-input pred/ \
        --datapath-dataset Deep360/ --loadmodel fusion.tar

Fuses each test frame (``ModeFusion``, or the ``Baseline`` ablation),
optionally upsamples the prediction bicubically x2 (``--resize``, for a
half-resolution input), takes the prediction and the ground truth to the
ERP domain, computes the 8 depth metrics over ground truth <= maxdepth,
dumps ``_pred.npy`` and log-colormapped PNGs, and prints the table.
``main`` returns the averages by name. The flags are the JAX CLI's, plus
``--device`` (the CUDA card by default; ``cpu`` runs the kernels' plain
versions).

Each batch goes to the device in one copy per array; the metrics are
reduced there and read back as one vector, the ERP prediction and ground
truth once each for the dumps.
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
import re

import numpy as np
import torch
from PIL import Image

from mode_tpu_torch.cli.common import (METRIC_NAMES, count_params,
                                       format_table, load_model_checkpoint)
from mode_tpu_torch.data.deep360 import Deep360DatasetFusion
from mode_tpu_torch.data.file_lists import list_deep360_fusion_test
from mode_tpu_torch.data.loader import DataLoader
from mode_tpu_torch.device import resolve_device, upload
from mode_tpu_torch.geometry import cassini_to_erp
from mode_tpu_torch.models.fusion import Baseline, ModeFusion
from mode_tpu_torch.ops.resize import upsample_bicubic
from mode_tpu_torch.utils import metrics
from mode_tpu_torch.utils.colormap import jet_colormap


def build_parser():
  p = argparse.ArgumentParser(description="MODE Fusion testing (CUDA)")
  p.add_argument("--maxdepth", type=float, default=1000.0)
  p.add_argument("--model", default="ModeFusion",
                 choices=["ModeFusion", "Baseline"])
  p.add_argument("--dbname", default="Deep360")
  p.add_argument("--soiled", action="store_true")
  p.add_argument("--resize", action="store_true")
  p.add_argument("--datapath-input", default="./outputs/Deep360PredDepth/")
  p.add_argument("--datapath-dataset", default="./datasets/Deep360/")
  p.add_argument("--outpath", default="./MODE_Fusion_output/")
  p.add_argument("--batch-size", type=int, default=1)
  p.add_argument("--loadmodel", default=None, required=True)
  p.add_argument("--seed", type=int, default=1)
  p.add_argument("--max_batches", type=int, default=None)
  p.add_argument("--device", default=None,
                 help="torch device; the CUDA card by default, 'cpu' runs "
                      "the kernels' plain versions")
  return p


def _save_log_png(path, arr):
  v = np.log(arr - np.min(arr) + 1)
  v = np.clip(255 * v / max(np.max(v), 1e-9), 0, 255).astype(np.uint8)
  Image.fromarray(jet_colormap(v)).save(path)


def main(argv=None):
  args = build_parser().parse_args(argv)
  device = resolve_device(args.device)
  sd, sc, sr, sg = list_deep360_fusion_test(args.datapath_input,
                                            args.datapath_dataset,
                                            args.soiled)
  ds = Deep360DatasetFusion(sd, sc, sr, sg, resize=args.resize,
                            training=False)
  loader = DataLoader(ds, batch_size=args.batch_size,
                      num_workers=args.batch_size)

  if args.model == "ModeFusion":
    model = ModeFusion(args.maxdepth, device=device)
  else:
    model = Baseline(args.maxdepth, device=device)
  print("Load pretrained model")
  load_model_checkpoint(args.loadmodel, model)
  print(f"Number of model parameters: {count_params(model)}")

  snapshot = osp.splitext(osp.basename(args.loadmodel.rstrip("/")))[0]
  result_dir = osp.join(args.outpath, args.dbname, snapshot)
  depth_pred_path = osp.join(result_dir, "depth_pred")
  gt_png_path = osp.join(result_dir, "gt_png")
  os.makedirs(depth_pred_path, exist_ok=True)
  os.makedirs(gt_png_path, exist_ok=True)

  totals = np.zeros(len(METRIC_NAMES))
  nb = 0
  for bi, batch in enumerate(loader):
    if args.max_batches and bi >= args.max_batches:
      break
    print(f"\rStage2 Test: {100 * (bi + 1) / len(loader):.2f}%", end="")
    depths = upload(batch["depths"], device)
    if args.model == "ModeFusion":
      confs = upload(batch["confs"], device)
      rgbs = upload(batch["rgbs"], device)
      pred = model([depths[:, k] for k in range(6)],
                   [confs[:, k] for k in range(6)],
                   [rgbs[:, k] for k in range(4)])
    else:
      pred = model([depths[:, k] for k in range(6)])
    if args.resize:
      pred = upsample_bicubic(pred, pred.shape[1] * 2, pred.shape[2] * 2)
    gt = upload(batch["gt"], device)
    pred_erp = cassini_to_erp(pred)[..., 0]
    gt_erp = cassini_to_erp(gt[..., None])[..., 0]
    m = metrics.depth_metrics(pred_erp, gt_erp, gt_erp <= args.maxdepth)
    totals += torch.stack([m[k] for k in METRIC_NAMES]).cpu().numpy()
    nb += 1
    pred_erp = pred_erp.cpu().numpy()
    gt_erp = gt_erp.cpu().numpy()
    for i in range(pred_erp.shape[0]):
      name = osp.splitext(osp.basename(batch["gtNames"][i]))[0]
      ep = re.findall(r"ep[0-9]_", batch["gtNames"][i])
      if ep:
        name = ep[0] + name
      _save_log_png(osp.join(gt_png_path, name + "_gt.png"), gt_erp[i])
      np.save(osp.join(depth_pred_path, name + "_pred.npy"), pred_erp[i])
      _save_log_png(osp.join(depth_pred_path, name + "_pred.png"),
                    pred_erp[i])
  mean = totals / max(nb, 1)
  print("\nTest Results:\n")
  print(format_table(METRIC_NAMES, [list(mean)]))
  return dict(zip(METRIC_NAMES, mean))


if __name__ == "__main__":
  main()
