"""Prediction on one frame (``mode_tpu/cli/predict.py``).

    python -m mode_tpu_torch.cli.predict --stage disp --left_name L.png \
        --right_name R.png --checkpoint_disp disp.tar
    python -m mode_tpu_torch.cli.predict --stage all --data_root frame/ \
        --checkpoint_disp disp.tar --checkpoint_fusion fusion.tar

``--stage disp`` runs one stereo pair and writes ``output_disp.png`` (log
disparity, JET) and ``output_conf.png``; ``--stage all`` runs the whole
frame, the six pairs ``<prefix>_<pair>_<l|r><img_type>`` of ``--data_root``
through ``pipeline.TwoStagePipeline`` (f32, host-normalised inputs, as the
JAX CLI runs it), and writes ``output_depth.npz`` and ``output_depth.png``.
The flags are the JAX CLI's, plus ``--device`` (the CUDA card by default;
``cpu`` runs the kernels' plain versions).
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch
from PIL import Image

from mode_tpu_torch.cli.common import load_model_checkpoint
from mode_tpu_torch.data.preprocess import rgb_to_tensor
from mode_tpu_torch.device import resolve_device, upload
from mode_tpu_torch.models.disparity import ModeDisparity
from mode_tpu_torch.models.fusion import ModeFusion
from mode_tpu_torch.pipeline import CAM_PAIRS, TwoStagePipeline
from mode_tpu_torch.utils.colormap import (jet_colormap, normalize_to_u8,
                                           save_gray_png)


def build_parser():
  p = argparse.ArgumentParser(
      description="Multi View Omnidirectional Depth Estimation (CUDA)")
  p.add_argument("--stage", default="disp", choices=["disp", "all"])
  p.add_argument("--data_root", default="./",
                 help="directory holding the multi-view inputs")
  p.add_argument("--save_root", default="./")
  p.add_argument("--img_name_prefix", default="ca",
                 help="multi-view input prefix: <prefix>_<pair>_<l|r>.png")
  p.add_argument("--img_type", default=".png")
  p.add_argument("--left_name", default="")
  p.add_argument("--right_name", default="")
  p.add_argument("--widthC", default=512, type=int)
  p.add_argument("--heightC", default=1024, type=int)
  p.add_argument("--max_disp", type=int, default=192)
  p.add_argument("--max_depth", default=1000, type=float)
  p.add_argument("--checkpoint_disp", required=True)
  p.add_argument("--checkpoint_fusion", default=None)
  p.add_argument("--device", default=None,
                 help="torch device; the CUDA card by default, 'cpu' runs "
                      "the kernels' plain versions")
  return p


def _load(path, h, w) -> np.ndarray:
  """An image file as a normalised ``(h, w, 3)`` f32 array, resized by PIL
  (bicubic) where its size differs."""
  img = Image.open(path).convert("RGB")
  if img.size != (w, h):
    img = img.resize((w, h))
  return rgb_to_tensor(img)


def _save_log_jet(path: str, value: np.ndarray):
  Image.fromarray(jet_colormap(normalize_to_u8(np.log(value + 1.0)))).save(
      path)


def main(argv=None):
  args = build_parser().parse_args(argv)
  device = resolve_device(args.device)
  h, w = args.heightC, args.widthC

  disp_model = ModeDisparity(args.max_disp, out_conf=True, device=device)
  load_model_checkpoint(args.checkpoint_disp, disp_model)
  os.makedirs(args.save_root, exist_ok=True)

  if args.stage == "disp":
    left = upload(_load(args.left_name, h, w)[None], device)
    right = upload(_load(args.right_name, h, w)[None], device)
    pred, conf = disp_model(left, right)
    out = torch.stack([pred[0].clamp(min=0), conf[0]]).cpu().numpy()
    _save_log_jet(os.path.join(args.save_root, "output_disp.png"), out[0])
    save_gray_png(os.path.join(args.save_root, "output_conf.png"),
                  np.clip(out[1], 0, 1))
    print(f"wrote output_disp.png / output_conf.png to {args.save_root}")
    return

  if not args.checkpoint_fusion:
    raise ValueError("--stage all needs --checkpoint_fusion")
  fusion_model = ModeFusion(args.max_depth, device=device)
  load_model_checkpoint(args.checkpoint_fusion, fusion_model)

  lefts, rights = [], []
  for pair in CAM_PAIRS:
    base = os.path.join(args.data_root, f"{args.img_name_prefix}_{pair}")
    lefts.append(_load(base + "_l" + args.img_type, h, w))
    rights.append(_load(base + "_r" + args.img_type, h, w))
  lefts = np.stack(lefts)
  rights = np.stack(rights)
  # camera views 1, 2, 3, 4 = pair 12's left and right, pair 34's
  rgbs = np.stack([lefts[0], rights[0], lefts[5], rights[5]])

  pipe = TwoStagePipeline(disp_model, fusion_model, args.max_disp,
                          args.max_depth, device=device)
  depth = pipe(lefts, rights, rgbs)[0].cpu().numpy()
  np.savez(os.path.join(args.save_root, "output_depth.npz"), depth)
  _save_log_jet(os.path.join(args.save_root, "output_depth.png"), depth)
  print(f"wrote output_depth.npz / output_depth.png to {args.save_root}")


if __name__ == "__main__":
  main()
