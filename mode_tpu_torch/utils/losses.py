"""Training losses (``mode_tpu/utils/losses.py``): stage 1's deep-supervision
smooth-L1 and stage 2's scale-invariant log loss, with masks so every pixel
keeps its place in the batch.

Each loss is a masked mean over the batch. With a ``mesh`` whose batch is
split over ranks (``parallel/mesh.py``), by data index and by rows of H, it
is the mean over the global batch, as the JAX package's loss over a
sharded batch is: the sums and the counts are all-reduced over the whole
mesh before the division, the sums differentiably, and every rank returns
the same value.
"""

from __future__ import annotations

import torch

from mode_tpu_torch.parallel.mesh import MESH, Mesh, all_count, all_sum, sharded


def _sums(mesh: Mesh | None, *sums: torch.Tensor) -> tuple:
  """``sums`` over the global batch (as they are without a split one)."""
  if not sharded(mesh, MESH):
    return sums
  return tuple(all_sum(torch.stack(sums), mesh, MESH).unbind())


def _count(mesh: Mesh | None, mask: torch.Tensor) -> torch.Tensor:
  n = torch.sum(mask)
  return all_count(n, mesh) if sharded(mesh, MESH) else n


def smooth_l1(pred: torch.Tensor, target: torch.Tensor,
              mask: torch.Tensor, mesh: Mesh | None = None) -> torch.Tensor:
  """Masked mean smooth-L1 (beta 1), torch ``F.smooth_l1_loss`` semantics:
  the sum over ``mask`` divided by ``max(sum(mask), 1)``."""
  d = torch.abs(pred - target)
  loss = torch.where(d < 1.0, 0.5 * d * d, d - 0.5)
  mask = mask.to(loss.dtype)
  (total,) = _sums(mesh, torch.sum(loss * mask))
  return total / torch.clamp(_count(mesh, mask), min=1)


def disparity_deep_supervision(preds, disp_true: torch.Tensor,
                               mask: torch.Tensor,
                               mesh: Mesh | None = None) -> torch.Tensor:
  """``0.5 * L(pred1) + 0.7 * L(pred2) + 1.0 * L(pred3)``."""
  p1, p2, p3 = preds
  return (0.5 * smooth_l1(p1, disp_true, mask, mesh)
          + 0.7 * smooth_l1(p2, disp_true, mask, mesh)
          + smooth_l1(p3, disp_true, mask, mesh))


def silog_loss(lamda: float, pred: torch.Tensor, gt: torch.Tensor,
               mask: torch.Tensor, mesh: Mesh | None = None) -> torch.Tensor:
  """Scale-invariant log loss ``mean(d^2) - lamda * mean(d)^2``, ``d = log
  pred - log gt``, over the pixels where ``mask & (gt > 0) & (pred > 0)``;
  the others enter as ``d = 0`` through ``log(1)``, so they give neither a
  NaN nor a gradient. Under a split batch ``n`` and both sums are the
  global batch's, and the mean of ``d`` is squared after the all-reduce."""
  m = mask & (gt > 0) & (pred > 0)
  n = torch.clamp(_count(mesh, m), min=1)
  d = torch.where(m, torch.log(torch.where(m, pred, 1.0))
                  - torch.log(torch.where(m, gt, 1.0)), 0.0)
  sq, s = _sums(mesh, torch.sum(d * d), torch.sum(d))
  return sq / n - lamda * torch.square(s / n)
