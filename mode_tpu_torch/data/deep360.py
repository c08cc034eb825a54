"""Deep360 datasets in numpy, channel-minor (``mode_tpu/data/deep360.py``).

As the reference's ``dataloader/deep360_loader.py``: a stage-1 item is the
normalised left and right RGB, the ground-truth disparity and its file name;
a stage-2 item is the ground truth's name, the 6 depth maps, the 6
confidence maps, the 4 RGB views and the ground-truth depth. The
reference's random-crop branch does not run (undefined names,
``deep360_loader.py:99-106``); here it crops 512-tall x 256-wide as it
evidently meant to. ``get_batch`` decodes a whole batch through the native
library (``native_io``) where it can.
"""

from __future__ import annotations

import os
import random
from typing import Sequence

import numpy as np
from PIL import Image

from mode_tpu_torch.data.preprocess import depth_to_tensor, rgb_to_tensor


def load_rgb(path: str) -> Image.Image:
  return Image.open(path).convert("RGB")


def load_npz(path: str) -> np.ndarray:
  return np.load(path)["arr_0"].astype(np.float32)


def load_conf(path: str) -> np.ndarray:
  """Confidence PNG: channel 0 / 255 (deep360_loader.py:27-29), HW1."""
  img = np.asarray(Image.open(path))
  if img.ndim == 3:
    img = img[..., 0]
  return (img[..., None] / 255.0).astype(np.float32)


def _nearest_resize(arr: np.ndarray, w: int, h: int) -> np.ndarray:
  """cv2.INTER_NEAREST-compatible resize of a 2-D array."""
  hs = (np.arange(h) * (arr.shape[0] / h)).astype(np.int64)
  ws = (np.arange(w) * (arr.shape[1] / w)).astype(np.int64)
  return arr[hs][:, ws]


class Deep360DatasetDisparity:
  """(deep360_loader.py:60-115)."""

  def __init__(self, left_imgs: Sequence[str], right_imgs: Sequence[str],
               disps: Sequence[str], shape=(1024, 512), crop: bool = False,
               device_normalize: bool = False):
    self.left_imgs = list(left_imgs)
    self.right_imgs = list(right_imgs)
    self.disps = list(disps)
    self.height, self.width = shape
    self.crop = crop
    # raw uint8 RGB (a quarter of the bytes to the device); the training
    # step ImageNet-normalises it there (training.normalize_rgb_on_device)
    self.device_normalize = device_normalize

  def __len__(self):
    return len(self.disps)

  def get_batch(self, indices, threads: int = 8):
    """Native fast path: batched fused decode+normalize (or the raw uint8
    decode, ``device_normalize``) through libmodeio (falls back to per-item
    Python when unavailable or when the items need resizing/cropping)."""
    from mode_tpu_torch.data import native_io
    if self.crop or not native_io.available():
      return None
    if not getattr(self, "_native_ok", None):
      with Image.open(self.left_imgs[indices[0]]) as probe:
        if probe.size != (self.width, self.height):
          return None
      self._native_ok = True
    decode = (native_io.decode_rgb_batch_u8 if self.device_normalize
              else native_io.decode_rgb_batch_normalized)
    try:
      lefts = decode([self.left_imgs[i] for i in indices], self.height,
                     self.width, threads)
      rights = decode([self.right_imgs[i] for i in indices], self.height,
                      self.width, threads)
      disps = native_io.read_npz_batch(
          [self.disps[i] for i in indices], (self.height, self.width),
          threads)
    except IOError:
      return None
    return {
        "leftImg": lefts,
        "rightImg": rights,
        "dispMap": disps,
        "dispNames": [self.disps[i] for i in indices],
    }

  def __getitem__(self, index: int) -> dict:
    left = load_rgb(self.left_imgs[index])
    right = load_rgb(self.right_imgs[index])
    disp = load_npz(self.disps[index])
    w, h = left.size
    if w != self.width:
      left = left.resize((self.width, self.height))
      right = right.resize((self.width, self.height))
      disp = _nearest_resize(disp, self.width, self.height) * (self.width / w)
    if self.device_normalize:
      left = np.asarray(left, np.uint8)
      right = np.asarray(right, np.uint8)
    else:
      left = rgb_to_tensor(left)
      right = rgb_to_tensor(right)
    if self.crop:
      th, tw = 512, 256
      hh, ww = disp.shape
      x1 = random.randint(0, ww - tw)
      y1 = random.randint(0, hh - th)
      left = left[y1:y1 + th, x1:x1 + tw]
      right = right[y1:y1 + th, x1:x1 + tw]
      disp = disp[y1:y1 + th, x1:x1 + tw]
    return {
        "leftImg": left,
        "rightImg": right,
        "dispMap": np.ascontiguousarray(disp, np.float32),
        "dispNames": self.disps[index],
    }


class Deep360DatasetFusion:
  """(deep360_loader.py:118-168)."""

  def __init__(self, depths, confs, rgbs, gt, resize: bool = False,
               training: bool = False):
    self.depths = depths      # [6][frame] paths
    self.confs = confs        # [6][frame]
    self.rgbs = rgbs          # [4][frame]
    self.gt = list(gt)
    self.resize = resize
    self.training = training

  def __len__(self):
    return len(self.depths[0])

  def get_batch(self, indices, threads: int = 8):
    """Native fast path: one frame is 12 PNGs + 7 NPZs — the worst ingest
    in the system per-item; batch all of them through libmodeio's thread
    pool. Falls back to the per-item Python path (return None) when the
    library is unavailable or ``resize`` is on."""
    from mode_tpu_torch.data import native_io
    if self.resize or not native_io.available():
      return None
    if getattr(self, "_native_shape", None) is None:
      self._native_shape = load_npz(self.depths[0][indices[0]]).shape
    h, w = self._native_shape
    b = len(indices)
    try:
      depths = native_io.read_npz_batch(
          [self.depths[k][i] for i in indices for k in range(6)], (h, w),
          threads).reshape(b, 6, h, w, 1)
      confs = native_io.decode_rgb_batch_u8(
          [self.confs[k][i] for i in indices for k in range(6)], h, w,
          threads)
      confs = (confs[..., :1].astype(np.float32) / 255.0).reshape(
          b, 6, h, w, 1)
      rgbs = native_io.decode_rgb_batch_normalized(
          [self.rgbs[k][i] for i in indices for k in range(4)], h, w,
          threads).reshape(b, 4, h, w, 3)
      gt = native_io.read_npz_batch([self.gt[i] for i in indices], (h, w),
                                    threads)
    except (IOError, ValueError):
      # ValueError: a frame whose shape disagrees with the cached first-item
      # shape (mixed-resolution dataset / wrong-size npz) fails at reshape —
      # fall back to the per-item Python path like any other decode failure.
      return None
    return {
        "gtNames": [self.gt[i] for i in indices],
        "depths": depths,
        "confs": confs,
        "rgbs": rgbs,
        "gt": gt,
    }

  def __getitem__(self, index: int) -> dict:
    depths = [depth_to_tensor(load_npz(d[index])) for d in self.depths]
    confs = [load_conf(c[index]) for c in self.confs]
    rgb_imgs = [load_rgb(r[index]) for r in self.rgbs]
    gt = load_npz(self.gt[index])

    if self.resize:
      depths = [d[::2, ::2] for d in depths]
      confs = [c[::2, ::2] for c in confs]
      w, h = rgb_imgs[0].size
      rgb_imgs = [r.resize((w // 2, h // 2)) for r in rgb_imgs]
      if self.training:
        gt = gt[::2, ::2]

    rgbs = [rgb_to_tensor(r) for r in rgb_imgs]
    return {
        "gtNames": self.gt[index],
        "depths": np.stack(depths),      # (6, H, W, 1)
        "confs": np.stack(confs),        # (6, H, W, 1)
        "rgbs": np.stack(rgbs),          # (4, H, W, 3)
        "gt": np.ascontiguousarray(gt, np.float32),
    }
