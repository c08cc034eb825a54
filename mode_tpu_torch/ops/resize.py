"""Separable linear and cubic interpolation with torch ``F.interpolate``
semantics (align_corners), as per-axis products with dense (out, in)
matrices.

Mirrors ``mode_tpu/ops/resize.py``: the matrices are built the same way in
float64 numpy and cast to float32, so the port and the JAX package contract
with bit-equal coefficients. ``linear_taps`` gives the same coefficients as
two (index, weight) pairs per output position, which is what the fused
regression kernel reads.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from mode_tpu_torch.device import upload


def _linear_src(n_out: int, n_in: int, align_corners: bool):
  """Left source index and float64 fraction per output position."""
  o = np.arange(n_out, dtype=np.float64)
  if align_corners:
    src = o * (n_in - 1) / max(n_out - 1, 1)
  else:
    src = np.clip((o + 0.5) * n_in / n_out - 0.5, 0, n_in - 1)
  i0 = np.clip(np.floor(src).astype(np.int64), 0, n_in - 2)
  return i0, src - i0


@functools.lru_cache(maxsize=128)
def linear_matrix(n_out: int, n_in: int,
                  align_corners: bool = True) -> np.ndarray:
  """(n_out, n_in) linear-interpolation matrix, float32."""
  m = np.zeros((n_out, n_in), np.float64)
  if n_in == 1:
    m[:, 0] = 1.0
    return m.astype(np.float32)
  i0, frac = _linear_src(n_out, n_in, align_corners)
  m[np.arange(n_out), i0] += 1.0 - frac
  m[np.arange(n_out), i0 + 1] += frac
  return m.astype(np.float32)


@functools.lru_cache(maxsize=64)
def linear_taps(n_out: int, n_in: int, align_corners: bool = True):
  """The two nonzero entries of each row of :func:`linear_matrix`.

  Returns ``(lo, hi, w_lo, w_hi)``: int32 source indices and their float32
  weights, equal to ``linear_matrix(n_out, n_in)[r, lo[r]]`` and
  ``[r, hi[r]]``. For ``n_in == 1`` both indices are 0 and ``w_hi`` is 0.
  """
  m = linear_matrix(n_out, n_in, align_corners)
  rows = np.arange(n_out)
  if n_in == 1:
    zero = np.zeros(n_out, np.int32)
    return zero, zero, m[:, 0].copy(), np.zeros(n_out, np.float32)
  lo = _linear_src(n_out, n_in, align_corners)[0]
  return (lo.astype(np.int32), (lo + 1).astype(np.int32), m[rows, lo],
          m[rows, lo + 1])


def _cubic_weight(t: np.ndarray, a: float = -0.75) -> np.ndarray:
  """The cubic convolution kernel (torch and OpenCV use a = -0.75)."""
  t = np.abs(t)
  return np.where(t <= 1, (a + 2) * t**3 - (a + 3) * t**2 + 1,
                  np.where(t < 2, a * t**3 - 5 * a * t**2 + 8 * a * t - 4 * a,
                           0.0))


@functools.lru_cache(maxsize=32)
def cubic_matrix(n_out: int, n_in: int,
                 align_corners: bool = True) -> np.ndarray:
  """(n_out, n_in) bicubic interpolation matrix, float32; the taps past an
  edge take the edge's value (torch's border replication)."""
  m = np.zeros((n_out, n_in), np.float64)
  if n_in == 1:
    m[:, 0] = 1.0
    return m.astype(np.float32)
  o = np.arange(n_out, dtype=np.float64)
  if align_corners:
    src = o * (n_in - 1) / max(n_out - 1, 1)
  else:
    src = (o + 0.5) * n_in / n_out - 0.5
  i0 = np.floor(src).astype(np.int64)
  frac = src - i0
  for k in range(-1, 3):
    np.add.at(m, (np.arange(n_out), np.clip(i0 + k, 0, n_in - 1)),
              _cubic_weight(k - frac))
  return m.astype(np.float32)


def _resize(x: torch.Tensor, sizes: dict[int, int], matrix,
            align_corners: bool, windows=None) -> torch.Tensor:
  """Resize the axes of ``x`` named in ``sizes`` (axis -> length) by the
  matrices ``matrix(n_out, n_in, align_corners)``: one product per axis,
  taken in float32 and cast back to ``x.dtype``, in the order of
  ``sizes``. The other axes are folded into the product's rows, so it is
  one GEMM: given the strided view, ``matmul`` may batch it as one
  matrix-vector product per row (the training heads' trailing axis of 1
  made it do so on the card). ``windows`` (axis -> slice) keeps only
  those output positions of an axis, through those rows of its matrix."""
  windows = windows or {}
  for axis, n_out in sizes.items():
    n_in = x.shape[axis]
    window = windows.get(axis)
    if n_in == n_out and window is None:
      continue
    mat = matrix(n_out, n_in, align_corners)
    if window is not None:
      mat = mat[window]
    mat = upload(np.ascontiguousarray(mat), x.device)
    xm = torch.movedim(x, axis, -1).float()
    y = (xm.reshape(-1, n_in) @ mat.T).reshape(*xm.shape[:-1], mat.shape[0])
    x = torch.movedim(y.to(x.dtype), -1, axis)
  return x


def interpolate(x: torch.Tensor, sizes: dict[int, int],
                align_corners: bool = True, windows=None) -> torch.Tensor:
  """Linearly resize the axes of ``x`` named in ``sizes`` (axis -> length);
  ``windows`` (axis -> slice) keeps those output positions only."""
  return _resize(x, sizes, linear_matrix, align_corners, windows)


def upsample_trilinear(x: torch.Tensor, d: int, h: int, w: int,
                       rows: slice | None = None) -> torch.Tensor:
  """NDHWC trilinear resize, align_corners=True; ``rows``: those output
  rows of H only."""
  return interpolate(x, {1: d, 2: h, 3: w},
                     windows=None if rows is None else {2: rows})


def upsample_bilinear(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
  """NHWC bilinear resize, align_corners=True."""
  return interpolate(x, {1: h, 2: w})


def upsample_bicubic(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
  """NHWC bicubic resize, align_corners=True (``F.interpolate(...,
  mode='bicubic', align_corners=True)``; ``test_fusion --resize``)."""
  return _resize(x, {1: h, 2: w}, cubic_matrix, True)
