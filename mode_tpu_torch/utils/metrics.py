"""Evaluation metrics, disparity and depth (``mode_tpu/utils/metrics.py``).

Every metric takes ``(pred, gt, mask)`` tensors of one shape, ``mask``
boolean, and returns a 0-d f32 tensor on their device: the sums run where
the prediction lies, so a CLI reads back one small vector per batch, not the
maps. Each returns the scalar the reference (``utils/evaluation.py``)
computes on the masked flat tensors; an empty mask counts as one pixel.
"""

from __future__ import annotations

import torch


def _count(mask: torch.Tensor) -> torch.Tensor:
  return mask.sum().clamp(min=1)


def mae(pred, gt, mask):
  """evaluation.py:4"""
  return ((pred - gt).abs() * mask).sum() / _count(mask)


def max_ae(pred, gt, mask):
  """evaluation.py:8"""
  return ((pred - gt).abs() * mask).max()


def rmse(pred, gt, mask):
  """evaluation.py:12"""
  return torch.sqrt(((pred - gt).square() * mask).sum() / _count(mask))


def absrel(pred, gt, mask):
  """evaluation.py:16; the extra gt > 0 mask is composed in."""
  m = mask & (gt > 0)
  safe_gt = torch.where(m, gt, 1.0)
  return ((pred - gt).abs() / safe_gt * m).sum() / _count(m)


def sqrel(pred, gt, mask):
  """evaluation.py:21"""
  m = mask & (gt > 0)
  safe_gt = torch.where(m, gt, 1.0)
  return ((pred - gt).square() / safe_gt.square() * m).sum() / _count(m)


def silog(pred, gt, mask):
  """evaluation.py:26, the square root of SILog (KITTI's convention)."""
  m = mask & (gt > 0) & (pred > 0)
  d = torch.where(m, torch.log(torch.where(m, pred, 1.0))
                  - torch.log(torch.where(m, gt, 1.0)), 0.0)
  n = _count(m)
  mean_sq = d.square().sum() / n
  sq_mean = (d.sum() / n).square()
  return torch.sqrt((mean_sq - sq_mean).clamp(min=0.0))


def pixel_error_pct(th_pixel, pred, gt, mask):
  """evaluation.py:35: % of masked pixels with |err| >= th_pixel."""
  err = (pred - gt).abs()
  return 100.0 * ((err >= th_pixel) & mask).sum() / _count(mask)


def d1(th_pixel, th_pct, pred, gt, mask):
  """evaluation.py:40: % with err >= th_pixel and err >= th_pct * gt."""
  err = (pred - gt).abs()
  bad = (err >= th_pixel) & (err >= th_pct * gt) & mask
  return 100.0 * bad.sum() / _count(mask)


def _ratio(pred, gt, mask):
  safe_gt = torch.where(mask & (gt != 0), gt, 1.0)
  safe_pred = torch.where(mask & (pred != 0), pred, 1.0)
  return torch.maximum(pred / safe_gt, gt / safe_pred)


def delta_acc(exp, pred, gt, mask):
  """evaluation.py:45: % with max(pred/gt, gt/pred) < 1.25 ** exp."""
  ok = (_ratio(pred, gt, mask) < 1.25 ** exp) & mask
  return 100.0 * ok.sum() / _count(mask)


def threshold_acc(err_pct, pred, gt, mask):
  """evaluation.py:50"""
  ok = (_ratio(pred, gt, mask) < 1.0 + err_pct) & mask
  return 100.0 * ok.sum() / _count(mask)


def disparity_metrics(pred, gt, mask) -> dict[str, torch.Tensor]:
  """The stage-1 report row (test_disparity.py:137-143): MAE, RMSE, Px1,
  Px3, Px5, D1."""
  return {
      "MAE": mae(pred, gt, mask),
      "RMSE": rmse(pred, gt, mask),
      "Px1 (%)": pixel_error_pct(1, pred, gt, mask),
      "Px3 (%)": pixel_error_pct(3, pred, gt, mask),
      "Px5 (%)": pixel_error_pct(5, pred, gt, mask),
      "D1 (%)": d1(3, 0.05, pred, gt, mask),
  }


def depth_metrics(pred, gt, mask) -> dict[str, torch.Tensor]:
  """The stage-2 report row (test_fusion.py:92-100): MAE, RMSE, AbsRel,
  SqRel, SILog, δ1-3."""
  return {
      "MAE": mae(pred, gt, mask),
      "RMSE": rmse(pred, gt, mask),
      "AbsRel": absrel(pred, gt, mask),
      "SqRel": sqrel(pred, gt, mask),
      "SILog": silog(pred, gt, mask),
      "δ1 (%)": delta_acc(1, pred, gt, mask),
      "δ2 (%)": delta_acc(2, pred, gt, mask),
      "δ3 (%)": delta_acc(3, pred, gt, mask),
  }
