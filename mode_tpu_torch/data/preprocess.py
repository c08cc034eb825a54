"""Image preprocessing in numpy, channel-minor HWC
(``mode_tpu/data/preprocess.py``).

Stage 1's transform is ToTensor (uint8 -> [0, 1]) and the ImageNet
normalisation (the reference's ``preprocess.py:8,49-54``); stage 2's depth
transform has identity statistics (``:27,57-62``). The reference's unused
colour-jitter and PCA-lighting pipeline is kept as two augmentations that
draw from a ``np.random.Generator``.
"""

from __future__ import annotations

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

# AlexNet's PCA lighting constants (preprocess.py:10-25)
PCA_EIGVAL = np.array([0.2175, 0.0188, 0.0045], np.float32)
PCA_EIGVEC = np.array([[-0.5675, 0.7192, 0.4009],
                       [-0.5808, -0.0045, -0.8140],
                       [-0.5836, -0.6948, 0.4203]], np.float32)


def rgb_to_tensor(img) -> np.ndarray:
  """uint8 HWC image (PIL or ndarray) -> float32 HWC, ImageNet-normalised."""
  arr = np.asarray(img, np.float32) / 255.0
  return (arr - IMAGENET_MEAN) / IMAGENET_STD


def depth_to_tensor(depth: np.ndarray) -> np.ndarray:
  """float depth map, HW or HWC -> float32 HWC, values unchanged."""
  d = np.asarray(depth, np.float32)
  if d.ndim == 2:
    d = d[..., None]
  return d


def lighting_augment(img_01: np.ndarray, rng: np.random.Generator,
                     alphastd: float = 0.1) -> np.ndarray:
  """PCA lighting noise (preprocess.py:78-95) on a [0, 1] HWC image."""
  if alphastd == 0:
    return img_01
  alpha = rng.normal(0, alphastd, size=(3,)).astype(np.float32)
  rgb = (PCA_EIGVEC * alpha[None, :] * PCA_EIGVAL[None, :]).sum(1)
  return img_01 + rgb[None, None, :]


def color_jitter(img_01: np.ndarray, rng: np.random.Generator,
                 brightness=0.4, contrast=0.4, saturation=0.4) -> np.ndarray:
  """Brightness, contrast and saturation jitter (preprocess.py:34-46)."""
  out = img_01 * (1.0 + rng.uniform(-brightness, brightness))
  c = 1.0 + rng.uniform(-contrast, contrast)
  mean = out.mean()
  out = (out - mean) * c + mean
  s = 1.0 + rng.uniform(-saturation, saturation)
  gray = out.mean(axis=-1, keepdims=True)
  out = (out - gray) * s + gray
  return np.clip(out, 0.0, 1.0)
