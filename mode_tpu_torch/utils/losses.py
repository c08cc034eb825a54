"""Training losses (``mode_tpu/utils/losses.py``): stage 1's deep-supervision
smooth-L1 and stage 2's scale-invariant log loss, with masks so every pixel
keeps its place in the batch."""

from __future__ import annotations

import torch


def smooth_l1(pred: torch.Tensor, target: torch.Tensor,
              mask: torch.Tensor) -> torch.Tensor:
  """Masked mean smooth-L1 (beta 1), torch ``F.smooth_l1_loss`` semantics:
  the sum over ``mask`` divided by ``max(sum(mask), 1)``."""
  d = torch.abs(pred - target)
  loss = torch.where(d < 1.0, 0.5 * d * d, d - 0.5)
  mask = mask.to(loss.dtype)
  return torch.sum(loss * mask) / torch.clamp(torch.sum(mask), min=1)


def disparity_deep_supervision(preds, disp_true: torch.Tensor,
                               mask: torch.Tensor) -> torch.Tensor:
  """``0.5 * L(pred1) + 0.7 * L(pred2) + 1.0 * L(pred3)``."""
  p1, p2, p3 = preds
  return (0.5 * smooth_l1(p1, disp_true, mask)
          + 0.7 * smooth_l1(p2, disp_true, mask)
          + smooth_l1(p3, disp_true, mask))


def silog_loss(lamda: float, pred: torch.Tensor, gt: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
  """Scale-invariant log loss ``mean(d^2) - lamda * mean(d)^2``, ``d = log
  pred - log gt``, over the pixels where ``mask & (gt > 0) & (pred > 0)``;
  the others enter as ``d = 0`` through ``log(1)``, so they give neither a
  NaN nor a gradient."""
  m = mask & (gt > 0) & (pred > 0)
  n = torch.clamp(torch.sum(m), min=1)
  d = torch.where(m, torch.log(torch.where(m, pred, 1.0))
                  - torch.log(torch.where(m, gt, 1.0)), 0.0)
  return torch.sum(d * d) / n - lamda * torch.square(torch.sum(d) / n)
