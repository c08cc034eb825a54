"""JET colormapping and the PNGs the CLIs write (``mode_tpu/utils/
colormap.py``), in numpy on the host: each map is read back from the card
once and written from there. The arithmetic is the JAX package's, uint8
truncation included, so the PNGs match it pixel for pixel."""

from __future__ import annotations

import numpy as np
from PIL import Image


def jet_colormap(gray: np.ndarray) -> np.ndarray:
  """uint8 ``(H, W)`` -> uint8 ``(H, W, 3)`` RGB, OpenCV's JET ramp."""
  x = gray.astype(np.float32) / 255.0

  def ramp(v):
    return np.clip(np.minimum(4 * v, -4 * v + 4.0), 0, 1)

  rgb = np.stack([ramp(x - 0.25), ramp(x), ramp(x + 0.25)], -1)
  return (rgb * 255).astype(np.uint8)


def normalize_to_u8(img: np.ndarray) -> np.ndarray:
  """Stretch ``img`` to [0, 255] and truncate to uint8 (a flat map -> 0)."""
  lo, hi = np.min(img), np.max(img)
  scale = (hi - lo) if hi > lo else 1.0
  return ((img - lo) / scale * 255).astype(np.uint8)


def save_colormapped(path: str, value: np.ndarray, mask=None,
                     log_scale: bool = True):
  """Log-normalise, JET-map, zero the masked-out pixels and write a PNG
  (the reference's test_disparity.py:82-117)."""
  v = value.astype(np.float32).copy()
  if log_scale:
    v = np.log10(np.maximum(v, 0) + 1.0)
  if mask is not None:
    v[~mask] = 0
  rgb = jet_colormap(normalize_to_u8(v))
  if mask is not None:
    rgb[~mask] = 0
  Image.fromarray(rgb).save(path)


def save_gray_png(path: str, value01: np.ndarray):
  """Write a [0, 1] map as an 8-bit gray PNG (the confidence maps,
  save_output_disparity_stage.py:199)."""
  Image.fromarray((np.clip(value01, 0, 1) * 255).astype(np.uint8)).save(path)
