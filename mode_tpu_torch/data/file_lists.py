"""Deep360 dataset file enumeration (``mode_tpu/data/file_lists.py``).

As the reference's ``dataloader/list_file.py``: walks the
``ep{1..6}_500frames/{training,validation,testing}`` tree, pairs the sorted
rgb files two per disparity map, and builds the fusion input lists (6
re-projected depth maps, 6 confidence maps and the RGB views of cameras
1, 2, 3, 4, which are the sorted rgb indices {0, 1, 10, 11} of the 12 per
frame).
"""

from __future__ import annotations

import os

EPISODES = sorted(f"ep{i}_500frames" for i in range(1, 7))
CAM_PAIRS = ("12", "13", "14", "23", "24", "34")


def _episodes(root: str) -> list[str]:
  """Use the canonical 6 episodes when present; fall back to whatever
  ep*_* dirs exist (lets tiny synthetic trees work)."""
  present = [e for e in EPISODES if os.path.isdir(os.path.join(root, e))]
  if present:
    return present
  return sorted(d for d in os.listdir(root)
                if d.startswith("ep") and
                os.path.isdir(os.path.join(root, d)))


def _pairs_for_subset(root, ep, subset, rgb_dir):
  rgb_path = os.path.join(root, ep, subset, rgb_dir)
  disp_path = os.path.join(root, ep, subset, "disp")
  rgbs = sorted(os.listdir(rgb_path))
  disps = sorted(os.listdir(disp_path))
  left = [os.path.join(rgb_path, rgbs[i * 2]) for i in range(len(disps))]
  right = [os.path.join(rgb_path, rgbs[i * 2 + 1]) for i in range(len(disps))]
  disp = [os.path.join(disp_path, d) for d in disps]
  return left, right, disp


def list_deep360_disparity_train(root: str, soiled: bool = False):
  """(list_file.py:30-65) → (train_l, train_r, train_disp, val_l, val_r,
  val_disp)."""
  rgb_dir = "rgb_soiled" if soiled else "rgb"
  out = {"training": ([], [], []), "validation": ([], [], [])}
  for ep in _episodes(root):
    for subset in ("training", "validation"):
      l, r, d = _pairs_for_subset(root, ep, subset, rgb_dir)
      out[subset][0].extend(l)
      out[subset][1].extend(r)
      out[subset][2].extend(d)
  return (*out["training"], *out["validation"])


def list_deep360_disparity_test(root: str, soiled: bool = False):
  """(list_file.py:68-94)."""
  rgb_dir = "rgb_soiled" if soiled else "rgb"
  left, right, disp = [], [], []
  for ep in _episodes(root):
    l, r, d = _pairs_for_subset(root, ep, "testing", rgb_dir)
    left.extend(l)
    right.extend(r)
    disp.extend(d)
  return left, right, disp


def list_deep360_disparity_all(root: str, soiled: bool = False):
  """Union train+val+test in that order — the save-stage CLI's input
  (save_output_disparity_stage.py:32-49)."""
  tl, tr, td, vl, vr, vd = list_deep360_disparity_train(root, soiled)
  sl, sr, sd = list_deep360_disparity_test(root, soiled)
  return tl + vl + sl, tr + vr + sr, td + vd + sd


def _fusion_for_subset(input_path, dataset_path, ep, subset, soiled):
  sfx = "_soiled" if soiled else ""
  pred_path = os.path.join(input_path, ep, subset, "disp_pred2depth" + sfx)
  conf_path = os.path.join(input_path, ep, subset, "conf_map" + sfx)
  rgb_path = os.path.join(dataset_path, ep, subset,
                          "rgb_soiled" if soiled else "rgb")
  depth_path = os.path.join(dataset_path, ep, subset, "depth")
  preds = sorted(os.listdir(pred_path))
  confs = sorted(os.listdir(conf_path))
  rgbs = sorted(os.listdir(rgb_path))
  depths = sorted(os.listdir(depth_path))
  n = len(depths)
  depth_lists = [[os.path.join(pred_path, preds[f * 6 + k])
                  for f in range(n)] for k in range(6)]
  conf_lists = [[os.path.join(conf_path, confs[f * 6 + k])
                 for f in range(n)] for k in range(6)]
  # cameras 1,2 are the sorted-rgb indices 0,1 (pair 12); cameras 3,4 are
  # indices 10,11 (pair 34) (list_file.py:170-173)
  rgb_lists = [[os.path.join(rgb_path, rgbs[f * 12 + i]) for f in range(n)]
               for i in (0, 1, 10, 11)]
  gt = [os.path.join(depth_path, d) for d in depths]
  return depth_lists, conf_lists, rgb_lists, gt


def _merge(a, b):
  return [x + y for x, y in zip(a, b)] if a else b


def list_deep360_fusion_train(input_path, dataset_path, soiled=False):
  """(list_file.py:97-201) → (train_depths, train_confs, train_rgbs,
  train_gt, val_depths, val_confs, val_rgbs, val_gt); the depth/conf/rgb
  entries are lists-of-lists [source][frame]."""
  train = ([], [], [], [])
  val = ([], [], [], [])
  for ep in _episodes(input_path):
    for subset, acc in (("training", train), ("validation", val)):
      d, c, r, g = _fusion_for_subset(input_path, dataset_path, ep, subset,
                                      soiled)
      acc[0][:] = _merge(acc[0], d)
      acc[1][:] = _merge(acc[1], c)
      acc[2][:] = _merge(acc[2], r)
      acc[3].extend(g)
  return (*train, *val)


def list_deep360_fusion_test(input_path, dataset_path, soiled=False):
  """(list_file.py:204-267)."""
  depths, confs, rgbs, gt = [], [], [], []
  for ep in _episodes(input_path):
    d, c, r, g = _fusion_for_subset(input_path, dataset_path, ep, "testing",
                                    soiled)
    depths = _merge(depths, d)
    confs = _merge(confs, c)
    rgbs = _merge(rgbs, r)
    gt.extend(g)
  return depths, confs, rgbs, gt
