"""Inputs made from the seed on the device, then kept in pinned host memory,
as a loader hands them over.

Images are textured panoramas: noise at half resolution plus a coarse layer
at 1/8, upsampled bilinearly, put through the inverse of the ImageNet
normalisation and rounded to uint8. A stereo pair's right view is its left
view rolled along W by the pair's disparity, so stage 1 has a true match.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference.steps import IMAGENET_MEAN, IMAGENET_STD


def textures(gen: torch.Generator, n: int, h: int, w: int, device
             ) -> torch.Tensor:
  """``(n, h, w, 3)`` uint8 panoramas."""
  fine = torch.randn((n, 3, h // 2, w // 2), generator=gen, device=device)
  coarse = torch.randn((n, 3, max(h // 8, 1), max(w // 8, 1)), generator=gen,
                       device=device)
  up = lambda a: F.interpolate(a, size=(h, w), mode="bilinear",
                               align_corners=False)
  x = (up(fine) + 0.5 * up(coarse)).permute(0, 2, 3, 1)
  mean = torch.tensor(IMAGENET_MEAN, device=device)
  std = torch.tensor(IMAGENET_STD, device=device)
  return torch.round((x * std + mean) * 255).clamp(0, 255).to(torch.uint8)


def draw_ints(gen: torch.Generator, n: int, lo: int, hi: int, device
              ) -> list[int]:
  """``n`` integers in ``[lo, hi]``."""
  return torch.randint(lo, hi + 1, (n,), generator=gen,
                       device=device).tolist()


def shifted(left: torch.Tensor, disps: list[int]) -> torch.Tensor:
  """Each image of ``left`` ``(n, h, w, 3)`` rolled left along W by its
  disparity."""
  return torch.stack([torch.roll(x, -d, dims=1)
                      for x, d in zip(left, disps)])


def pinned(x: torch.Tensor) -> torch.Tensor:
  return x.cpu().pin_memory() if x.is_cuda else x.cpu()


def frame_pool(gen, size: int, h: int, w: int, disp_range, device
               ) -> list[dict]:
  """``size`` frames: six uint8 pairs ``(6, h, w, 3)`` with their
  disparities, and the four views (pair 12's two, pair 34's two)."""
  lefts = textures(gen, 6 * size, h, w, device)
  disps = draw_ints(gen, 6 * size, *disp_range, device)
  rights = shifted(lefts, disps)
  pool = []
  for f in range(size):
    lf, rf = lefts[6 * f:6 * f + 6], rights[6 * f:6 * f + 6]
    views = torch.stack([lf[0], rf[0], lf[5], rf[5]])
    pool.append({"lefts": pinned(lf), "rights": pinned(rf),
                 "views": pinned(views), "disps": disps[6 * f:6 * f + 6]})
  return pool


def stage1_batches(gen, count: int, batch: int, h: int, w: int, disp_range,
                   nan_patch, device) -> list[tuple]:
  """``count`` batches ``(left, right, gt)``: uint8 pairs ``(batch, h, w,
  3)`` and their disparity ``(batch, h, w)`` f32, NaN (no ground truth) on
  one ``nan_patch`` ``(rows, cols)`` rectangle per image at a drawn place."""
  left = textures(gen, count * batch, h, w, device)
  disps = draw_ints(gen, count * batch, *disp_range, device)
  right = shifted(left, disps)
  gt = torch.tensor(disps, dtype=torch.float32, device=device)[:, None, None]
  gt = gt.expand(count * batch, h, w).clone()
  ph, pw = nan_patch
  rows = draw_ints(gen, count * batch, 0, h - ph, device)
  cols = draw_ints(gen, count * batch, 0, w - pw, device)
  for k, (r, c) in enumerate(zip(rows, cols)):
    gt[k, r:r + ph, c:c + pw] = float("nan")
  return [tuple(pinned(t[b * batch:(b + 1) * batch])
                for t in (left, right, gt)) for b in range(count)]


def fusion_batches(gen, count: int, batch: int, h: int, w: int,
                   max_depth: float, device) -> list[tuple]:
  """``count`` packed fusion batches in the dataset's wire dtypes: six f16
  depths ``(batch, h, w, 1)``, six uint8 confidences, four uint8 views and
  the f32 ground truth ``(batch, h, w)``. The ground truth is a smooth
  log-depth field from 2 m to 1.1 ``max_depth`` (what lies past
  ``max_depth`` is masked out by the loss); each depth is it with 5% noise,
  clipped to (1, ``max_depth``)."""
  n = count * batch
  field = torch.randn((n, 1, max(h // 32, 1), max(w // 32, 1)),
                      generator=gen, device=device)
  field = F.interpolate(field, size=(h, w), mode="bicubic",
                        align_corners=False)[:, 0]
  lo, hi = torch.log(torch.tensor(2.0)), torch.log(
      torch.tensor(1.1 * max_depth))
  gt = torch.exp(lo + (hi - lo) * torch.sigmoid(1.5 * field))
  noise = torch.randn((6, n, h, w), generator=gen, device=device)
  depths = (gt[None] * (1 + 0.05 * noise)).clamp(1.0, max_depth).half()
  confs = torch.randint(128, 256, (6, n, h, w), generator=gen, device=device,
                        dtype=torch.uint8)
  views = textures(gen, 4 * n, h, w, device).view(4, n, h, w, 3)
  out = []
  for b in range(count):
    s = slice(b * batch, (b + 1) * batch)
    out.append(([pinned(d[s, ..., None]) for d in depths],
                [pinned(c[s, ..., None]) for c in confs],
                [pinned(v[s]) for v in views], pinned(gt[s])))
  return out


def to_device(tree, device):
  """Upload every tensor of a (nested) tuple or list, asynchronously from
  pinned memory."""
  if isinstance(tree, torch.Tensor):
    return tree.to(device, non_blocking=True)
  return type(tree)(to_device(t, device) for t in tree)


def rows(tree, index):
  """Every tensor of a (nested) tuple or list indexed along its batch
  rows."""
  if isinstance(tree, torch.Tensor):
    return tree[index]
  return type(tree)(rows(t, index) for t in tree)
