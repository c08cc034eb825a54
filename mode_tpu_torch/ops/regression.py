"""Stage-1 disparity regression: upsample, softmax, soft-argmin, confidence.

:func:`fused_disparity_regression` replaces
``mode_tpu/ops/pallas/regression_kernel.py:fused_disparity_regression``
(K2). On a CUDA tensor it launches the kernel of
``kernels/csrc/regression.cu`` (its source note says what bounds it and how
it is built), which never forms the full-resolution probability volume. On
a CPU tensor, or with ``plain=True``, it runs the plain PyTorch version: the
align_corners trilinear upsample of ``ops/resize.py``, a softmax in f32,
:func:`disparity_regression` and :func:`confidence_from_prob`, as
``mode_tpu/models/disparity.py:288-311`` does. With ``row0``/``h_out`` both
compute output rows ``[row0, row0 + h_out)`` of the full-``h`` result, as
the TPU kernel's row-window tables (``ys``/``mh_win``/``h_out``) do for a
rank of the ``spatial`` axis (``parallel/shard_ops.py``).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from mode_tpu_torch import kernels
from mode_tpu_torch.device import upload
from mode_tpu_torch.kernels import build
from mode_tpu_torch.ops.resize import interpolate, linear_taps

_NAME = "fused_disparity_regression"


@functools.cache
def _regression_lib():
  lib = build.load("regression")
  lib.fused_disparity_regression.argtypes = (
      [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9
      + [ctypes.c_void_p])
  lib.fused_disparity_regression.restype = ctypes.c_int
  return lib


def disparity_regression(prob: torch.Tensor, maxdisp: int) -> torch.Tensor:
  """Soft-argmin: ``sum_d d * p(d)``; ``prob`` is (B, D, H, W)."""
  disp = torch.arange(maxdisp, dtype=prob.dtype, device=prob.device)
  return torch.sum(prob * disp[None, :, None, None], dim=1)


def confidence_from_prob(prob: torch.Tensor, pred: torch.Tensor,
                         maxdisp: int) -> torch.Tensor:
  """Sum of ``prob`` at the disparity slices round(pred) - 1, round(pred)
  and round(pred) + 1, each clipped into range; a clipped border slice is
  counted twice, as the reference's border-padded ``grid_sample`` does.
  ``prob`` is (B, D, H, W), ``pred`` (B, H, W)."""
  d0 = torch.round(pred)
  total = torch.zeros_like(pred)
  for delta in (-1.0, 0.0, 1.0):
    idx = torch.clamp(d0 + delta, 0, maxdisp - 1).round().long()[:, None]
    total = total + torch.gather(prob, 1, idx)[:, 0]
  return total


@functools.lru_cache(maxsize=16)
def _tap_tables(d: int, hq: int, wq: int, maxdisp: int, h: int, w: int,
                device: torch.device):
  """The upsample's (index pair, weight pair) per disparity level, row and
  column, then each source level's first disparity level (the kernel walks
  the disparity levels by source interval), in the layout ``regression.cu``
  reads."""
  taps = [linear_taps(maxdisp, d), linear_taps(h, hq), linear_taps(w, wq)]
  lo, hi = taps[0][:2]
  # the walk's premise: the lower index never decreases, the upper one is
  # the next source level (the same one where d is 1)
  assert (np.diff(lo) >= 0).all() and (hi == np.minimum(lo + 1, d - 1)).all()
  starts = np.searchsorted(lo, np.arange(d + 1), side="left")
  idx = np.concatenate([np.stack([t[0], t[1]], axis=1).reshape(-1)
                        for t in taps] + [starts])
  wgt = np.concatenate([np.stack([t[2], t[3]], axis=1) for t in taps])
  return (upload(np.ascontiguousarray(idx, np.int32), device),
          upload(np.ascontiguousarray(wgt, np.float32), device))


def _upsample_rows(cost_q, maxdisp, h, w, row0, h_out):
  """Rows ``[row0, row0 + h_out)`` of the align_corners trilinear upsample
  of ``(N, D, Hq, Wq)`` to ``(N, maxdisp, h, w)``, in f32: the products of
  ``ops/resize.py:upsample_trilinear`` (D, then H, then W), H through the
  window's rows of its matrix."""
  return interpolate(cost_q.float(), {1: maxdisp, 2: h, 3: w},
                     windows={2: slice(row0, row0 + h_out)})


def _plain(cost_q, maxdisp, h, w, row0, h_out):
  up = _upsample_rows(cost_q, maxdisp, h, w, row0, h_out)
  prob = torch.softmax(up, dim=1)
  pred = disparity_regression(prob, maxdisp)
  return pred, confidence_from_prob(prob, pred, maxdisp)


def _launch(cost_q, maxdisp, h, w, row0=0, h_out=None):
  if (cost_q.dim() != 4 or cost_q.dtype not in (torch.float32, torch.bfloat16)
      or not cost_q.is_contiguous()):
    raise ValueError(f"{_NAME}: cost_q must be a contiguous f32 or bf16 "
                     f"(N, D, Hq, Wq) tensor, got {tuple(cost_q.shape)} "
                     f"{cost_q.dtype}")
  n, d, hq, wq = cost_q.shape
  h_out = h if h_out is None else h_out
  idx, wgt = _tap_tables(d, hq, wq, maxdisp, h, w, cost_q.device)
  pred = torch.empty((n, h_out, w), dtype=torch.float32,
                     device=cost_q.device)
  conf = torch.empty_like(pred)
  kernels.launch(
      _NAME, _regression_lib().fused_disparity_regression, cost_q.device,
      int(cost_q.dtype == torch.bfloat16), cost_q.data_ptr(), idx.data_ptr(),
      wgt.data_ptr(), pred.data_ptr(), conf.data_ptr(), n, d, hq, wq,
      maxdisp, h, w, row0, h_out, halo=h_out != h,
      shape=(n, d, hq, wq, maxdisp, h_out, w))
  return pred, conf


def fused_disparity_regression(cost_q: torch.Tensor, maxdisp: int, h: int,
                               w: int, *, row0: int = 0,
                               h_out: int | None = None, plain: bool = False
                               ) -> tuple[torch.Tensor, torch.Tensor]:
  """Upsample + softmax + soft-argmin + confidence.

  Args:
    cost_q: ``(N, D, Hq, Wq)`` quarter-resolution logits, f32 or bf16.
    maxdisp, h, w: the full-resolution sizes.
    row0, h_out: the output rows ``[row0, row0 + h_out)`` of the full-``h``
      result (``h_out`` None: to the last row).
    plain: run the plain PyTorch version even on a CUDA tensor.
  Returns:
    ``(pred, conf)``, each ``(N, h_out, w)`` f32.
  """
  h_out = h - row0 if h_out is None else h_out
  if row0 < 0 or h_out < 1 or row0 + h_out > h:
    raise ValueError(f"{_NAME}: rows [{row0}, {row0 + h_out}) are not rows "
                     f"of an output of {h}")
  if plain or cost_q.device.type == "cpu":
    return _plain(cost_q, maxdisp, h, w, row0, h_out)
  if cost_q.device.type != "cuda":
    raise ValueError(f"{_NAME}: unsupported device {cost_q.device}")
  return _launch(cost_q, maxdisp, h, w, row0, h_out)
