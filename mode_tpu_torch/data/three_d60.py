"""The 3D60 datasets, Matterport3D, Stanford2D3D and SunCG ERP panoramas
(``mode_tpu/data/three_d60.py``).

As the reference's ``dataloader/dataset3D60Loader.py``: a trinocular rig
(Center_Left_Down / Right / Up) of ERP panoramas listed in a filenames
``.txt`` (6 space-separated paths a line: 3 colour, 3 depth). Items are
rectified on the fly into Cassini stereo pairs ('lr', 'ud', 'ur', or a
random one of them for 'all') with Rodrigues rotations 0 / -pi/2 / -pi/4
(``dataset3D60Loader.py:136-175``); the ground-truth disparity comes from
depth by the closed sine-law form with baseline 0.26 m (``:258-270``).

The rectification runs in numpy inside the loader's threads, from the pixel
maps of ``geometry/projection.py:_erp_to_rect_pix`` (cached per shape and
rotation) and a bilinear gather. ``cv2`` is imported only to read ``.exr``
depths and to resize a depth map.

The reference's ``Dataset3D60Fusion2View`` does not run (undefined
``self.inputDir`` / ``prefixPredDepth_r``, ``:323,369-371``); here it is the
two-view form of the working three-view loader.
"""

from __future__ import annotations

import os
import random

import numpy as np
from PIL import Image

from mode_tpu_torch.data.preprocess import depth_to_tensor, rgb_to_tensor
from mode_tpu_torch.geometry.projection import _erp_to_rect_pix, rodrigues

BASELINE_3D60 = 0.26
PAIR_ROTATIONS = {
    "lr": np.array([0.0, 0.0, 0.0]),
    "ud": np.array([0.0, 0.0, -np.pi / 2]),
    "ur": np.array([0.0, 0.0, -np.pi / 4]),
}
FUSION_IDS_3VIEW = ("lr_l", "lr_r", "ud_u", "ud_d", "ur_u", "ur_r")
FUSION_IDS_2VIEW = ("lr_l", "lr_r")


def load_depth_any(path: str) -> np.ndarray:
  """Depth map loader: EXR (reference's format, via cv2) / npz / npy."""
  if path.endswith(".npz"):
    return np.load(path)["arr_0"].astype(np.float32)
  if path.endswith(".npy"):
    return np.load(path).astype(np.float32)
  # OpenCV reads the flag at its first EXR decode
  os.environ.setdefault("OPENCV_IO_ENABLE_OPENEXR", "1")
  import cv2
  d = cv2.imread(path, cv2.IMREAD_ANYDEPTH)
  if d is None:
    raise IOError(f"could not read depth file {path}")
  return np.asarray(d, np.float32)


def _bilinear_np(img: np.ndarray, y: np.ndarray, x: np.ndarray) -> np.ndarray:
  """Border-clamped bilinear sampling, numpy (img HWC)."""
  h, w = img.shape[:2]
  y = np.clip(y, 0, h - 1)
  x = np.clip(x, 0, w - 1)
  y0 = np.floor(y).astype(np.int64)
  x0 = np.floor(x).astype(np.int64)
  y1 = np.minimum(y0 + 1, h - 1)
  x1 = np.minimum(x0 + 1, w - 1)
  wy = (y - y0)[..., None]
  wx = (x - x0)[..., None]
  top = img[y0, x0] * (1 - wx) + img[y0, x1] * wx
  bot = img[y1, x0] * (1 - wx) + img[y1, x1] * wx
  return top * (1 - wy) + bot * wy


def erp_to_rect_cassini_np(erp: np.ndarray, r: np.ndarray, ca_h: int,
                           ca_w: int) -> np.ndarray:
  """numpy twin of ``geometry.erp_to_rect_cassini`` (the same cached pixel
  maps)."""
  squeeze = erp.ndim == 2
  if squeeze:
    erp = erp[..., None]
  he, we = erp.shape[:2]
  r64 = np.ascontiguousarray(np.asarray(r, np.float64))
  y, x = _erp_to_rect_pix(he, we, ca_h, ca_w, r64.tobytes())
  out = _bilinear_np(erp.astype(np.float32), y, x)
  return out[..., 0] if squeeze else out


def depth_to_disp_np(depth: np.ndarray, baseline: float,
                     max_depth: float) -> np.ndarray:
  """(dataset3D60Loader.py:258-270): invalid depths → NaN, negatives → 0."""
  h, w = depth.shape
  k = np.arange(w, dtype=np.float64)
  phi_l = np.tile((0.5 * np.pi - (2 * k + 1) * 0.5 * np.pi / w)[None, :],
                  (h, 1)).astype(np.float32)
  invalid = (depth <= 0) | (depth > max_depth)
  d = np.where(invalid, 1.0, depth).astype(np.float64)
  denom = np.sqrt(d * d + baseline ** 2 -
                  2 * d * baseline * np.cos(phi_l + 0.5 * np.pi))
  disp = w * (np.arcsin(np.clip((d * np.sin(phi_l) + baseline) / denom,
                                -1, 1)) - phi_l) / np.pi
  disp = np.where(invalid, np.nan, disp).astype(np.float32)
  disp[disp < 0] = 0
  return disp


def read_filenames_file(path: str) -> list[list[str]]:
  with open(path) as f:
    return [line.strip().split(" ") for line in f if line.strip()]


def _resize_rgb(arr: np.ndarray, w: int, h: int) -> np.ndarray:
  return np.asarray(Image.fromarray(arr.astype(np.uint8)).resize((w, h)))


class Dataset3D60Disparity:
  """(dataset3D60Loader.py:56-270)."""

  def __init__(self, filenames_file: str, root_dir: str,
               cur_stage: str = "training", shape=(512, 256),
               crop: bool = False, pair: str = "lr", flip: bool = False,
               max_depth: float = 20.0):
    assert pair in ("lr", "ud", "ur", "all")
    self.root = root_dir
    self.height, self.width = shape
    self.crop = crop
    self.pair = pair
    self.flip = flip
    self.max_depth = max_depth
    self.prefix_l = os.path.join(root_dir, "Center_Left_Down/")
    self.prefix_r = os.path.join(root_dir, "Right/")
    self.prefix_u = os.path.join(root_dir, "Up/")
    self.names = read_filenames_file(filenames_file)

  def __len__(self):
    return len(self.names)

  def _select_pair(self, name):
    left_n = os.path.join(self.prefix_l, name[0][2:])
    left_d = os.path.join(self.prefix_l, name[3][2:])
    right_n = os.path.join(self.prefix_r, name[1][2:])
    right_d = os.path.join(self.prefix_r, name[4][2:])
    up_n = os.path.join(self.prefix_u, name[2][2:])
    up_d = os.path.join(self.prefix_u, name[5][2:])
    pair = self.pair
    if pair == "all":
      # the reference's random three-way split (dataset3D60Loader.py:152-175)
      ra = random.random()
      pair = "lr" if ra < 1 / 3 else ("ud" if ra < 2 / 3 else "ur")
    if pair == "lr":
      return left_n, right_n, left_d, right_d, PAIR_ROTATIONS["lr"]
    if pair == "ud":
      return up_n, left_n, up_d, left_d, PAIR_ROTATIONS["ud"]
    return up_n, right_n, up_d, right_d, PAIR_ROTATIONS["ur"]

  def __getitem__(self, index: int) -> dict:
    left, right, depth_n, depth_rn, rvec = self._select_pair(
        self.names[index])
    r = rodrigues(rvec)
    h, w = self.height, self.width

    left_rgb = np.asarray(Image.open(left).convert("RGB"))
    right_rgb = np.asarray(Image.open(right).convert("RGB"))
    left_rgb = erp_to_rect_cassini_np(left_rgb, r, h, w).astype(np.uint8)
    right_rgb = erp_to_rect_cassini_np(right_rgb, r, h, w).astype(np.uint8)
    left_depth = erp_to_rect_cassini_np(load_depth_any(depth_n), r, h, w)
    right_depth = erp_to_rect_cassini_np(load_depth_any(depth_rn), r, h, w)

    if left_rgb.shape[:2] != (h, w):
      import cv2
      left_rgb = _resize_rgb(left_rgb, w, h)
      right_rgb = _resize_rgb(right_rgb, w, h)
      left_depth = cv2.resize(left_depth, (w, h))
      right_depth = cv2.resize(right_depth, (w, h))

    depth = left_depth.copy()
    depth[depth > self.max_depth] = 0.0
    depth_flip = right_depth[:, ::-1].copy()
    depth_flip[depth_flip > self.max_depth] = 0.0

    disp = depth_to_disp_np(depth, BASELINE_3D60, self.max_depth)
    disp_flip = depth_to_disp_np(depth_flip, BASELINE_3D60, self.max_depth)

    if self.crop:
      th, tw = h // 2, w // 2
      x1 = random.randint(0, w - tw)
      y1 = random.randint(0, h - th)
      return {
          "leftImg": rgb_to_tensor(left_rgb[y1:y1 + th, x1:x1 + tw]),
          "rightImg": rgb_to_tensor(right_rgb[y1:y1 + th, x1:x1 + tw]),
          "dispMap": disp[y1:y1 + th, x1:x1 + tw],
          "leftNames": left,
      }
    return {
        "leftImg": rgb_to_tensor(left_rgb),
        "rightImg": rgb_to_tensor(right_rgb),
        "dispMap": disp,
        "leftImg_flip": rgb_to_tensor(right_rgb[:, ::-1]),
        "rightImg_flip": rgb_to_tensor(left_rgb[:, ::-1]),
        "dispMap_flip": disp_flip,
        "leftNames": left,
        "rightNames": right,
    }


class Dataset3D60Fusion:
  """3-view fusion loader (dataset3D60Loader.py:482-645) and its working
  2-view analog (the reference's 2-view class is bit-rotted)."""

  def __init__(self, filenames_file: str, root_dir: str, input_dir: str,
               cur_stage: str = "training", shape=(512, 256),
               max_depth: float = 20.0, view: str = "Center_Left_Down/",
               n_views: int = 3):
    assert view in ("Center_Left_Down/", "Right/", "Up/")
    assert n_views in (2, 3)
    self.root = root_dir
    self.input_dir = input_dir
    self.height, self.width = shape
    self.max_depth = max_depth
    self.view = view
    self.ids = FUSION_IDS_3VIEW if n_views == 3 else FUSION_IDS_2VIEW
    self.n_views = n_views
    self.prefix_l = os.path.join(root_dir, "Center_Left_Down/")
    self.prefix_r = os.path.join(root_dir, "Right/")
    self.prefix_u = os.path.join(root_dir, "Up/")
    self.pred_prefix = os.path.join(input_dir, view, "disp_pred2depth/")
    self.conf_prefix = os.path.join(input_dir, view, "conf_map/")
    self.names = read_filenames_file(filenames_file)

  def __len__(self):
    return len(self.names)

  def __getitem__(self, index: int) -> dict:
    name = self.names[index]
    left = os.path.join(self.prefix_l, name[0][2:])
    right = os.path.join(self.prefix_r, name[1][2:])
    up = os.path.join(self.prefix_u, name[2][2:])
    depth_name = os.path.join(self.prefix_l, name[3][2:])
    h, w = self.height, self.width
    r = rodrigues(PAIR_ROTATIONS["lr"])

    rgb_paths = [left, right] + ([up] if self.n_views == 3 else [])
    rgbs = []
    for p in rgb_paths:
      img = np.asarray(Image.open(p).convert("RGB"))
      rgbs.append(rgb_to_tensor(
          erp_to_rect_cassini_np(img, r, h, w).astype(np.uint8)))
    gt = erp_to_rect_cassini_np(load_depth_any(depth_name), r, h, w)

    base = left.split("color")[0]
    depths, confs = [], []
    for fid in self.ids:
      pred_name = (base.replace(self.prefix_l, self.pred_prefix) +
                   fid + "_disp_pred2depth.npz")
      conf_name = (base.replace(self.prefix_l, self.conf_prefix) +
                   fid + "_conf_map.png")
      depths.append(depth_to_tensor(
          np.load(pred_name)["arr_0"].astype(np.float32)))
      conf = np.asarray(Image.open(conf_name))
      if conf.ndim == 3:
        conf = conf[..., 0]
      confs.append((conf[..., None] / 255.0).astype(np.float32))

    return {
        "gtNames": depth_name,
        "depths": np.stack(depths),
        "confs": np.stack(confs),
        "rgbs": np.stack(rgbs),
        "gt": np.ascontiguousarray(gt, np.float32),
    }
