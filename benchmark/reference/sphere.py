"""The sphere conv's sampling positions and bilinear gather tables, in numpy.

A frozen copy of the gnomonic construction of MODE's reference
(``models/basic/spherical_conv/sphere_conv.py:180-237`` of nju-ee/MODE-2022),
quirks included: the ``kerY`` divisor uses ``delta_lon``, the odd kernel's
centre rho is clamped to 1e-8, longitude wraps modulo the width and latitude
does not (no contribution past the poles). The reference's CUDA im2col reads
the four integer corners of each fractional position and adds nothing for a
corner outside the image; the tables below say which corners and with what
weight.
"""

from __future__ import annotations

import functools

import numpy as np


@functools.lru_cache(maxsize=64)
def sphere_positions(in_height: int, in_width: int, kh: int, kw: int,
                     sphere_type: str) -> np.ndarray:
  """``(kh*kw, H, W, 2)`` f32: the fractional (row, column) at which tap k
  samples for output pixel (i, j) of an ``(in_height, in_width)`` image."""
  height = min(in_height, in_width)
  width = max(in_height, in_width)
  if width != 2 * height:
    raise ValueError("the sphere conv takes a 2:1 panorama")
  delta_lat = np.pi / height
  delta_lon = 2 * np.pi / width
  range_x = np.arange(-(kw // 2), kw // 2 + 1)
  if not kw % 2:
    range_x = np.delete(range_x, kw // 2)
  range_y = np.arange(-(kh // 2), kh // 2 + 1)
  if not kh % 2:
    range_y = np.delete(range_y, kh // 2)
  ker_x = np.tan(range_x * delta_lon)
  ker_y = np.tan(range_y * delta_lat) / np.cos(range_y * delta_lon)
  ker_x, ker_y = np.meshgrid(ker_x, ker_y)
  rho = np.sqrt(ker_x**2 + ker_y**2)
  if kh % 2 and kw % 2:
    rho[kh // 2][kw // 2] = 1e-8
  nu = np.arctan(rho)
  cos_nu, sin_nu = np.cos(nu), np.sin(nu)
  lat_range = ((np.arange(0, height) / height) - 0.5) * np.pi
  lon_range = ((np.arange(0, width) / width) - 0.5) * (2 * np.pi)
  lat = np.arcsin(
      cos_nu[None] * np.sin(lat_range)[:, None, None]
      + ker_y[None] * sin_nu[None] * np.cos(lat_range)[:, None, None]
      / rho[None])
  lon = np.arctan2(
      ker_x[None] * sin_nu[None],
      rho[None] * np.cos(lat_range)[:, None, None] * cos_nu[None]
      - ker_y[None] * np.sin(lat_range)[:, None, None] * sin_nu[None])
  lat = np.broadcast_to(lat[:, None], (height, width, kh, kw))
  lon = lon[:, None] + lon_range[None, :, None, None]
  lat_pix = (lat / np.pi + 0.5) * height
  lon_pix = ((lon / (2 * np.pi) + 0.5) * width) % width
  if sphere_type == "ERP":
    rows, cols = lat_pix, lon_pix
  elif sphere_type == "Cassini":
    rows = lon_pix.transpose(1, 0, 2, 3)
    cols = lat_pix.transpose(1, 0, 2, 3)
  else:
    raise ValueError(f"unknown sphere_type {sphere_type!r}")
  pos = np.stack([rows, cols], axis=-1)
  pos = pos.transpose(2, 3, 0, 1, 4).reshape(kh * kw, *rows.shape[:2], 2)
  return np.ascontiguousarray(pos.astype(np.float32))


def conv_output_size(size: int, kernel: int, stride: int, pad: int,
                     dilation: int) -> int:
  return (size + 2 * pad - (dilation * (kernel - 1) + 1)) // stride + 1


@functools.lru_cache(maxsize=64)
def gather_tables(in_height: int, in_width: int, k: int, sphere_type: str,
                  stride: int, pad: int, dilation: int
                  ) -> tuple[np.ndarray, np.ndarray]:
  """``(idx, wgt)``, each ``(4, k*k, Ho, Wo)``: per bilinear corner the
  flattened input index (clamped into the image) and its weight (0 for a
  corner outside the image). The stride subsamples the dense position grid,
  as the reference's CUDA addressing does."""
  pos = sphere_positions(in_height, in_width, k, k, sphere_type)
  h_out = conv_output_size(in_height, k, stride, pad, dilation)
  w_out = conv_output_size(in_width, k, stride, pad, dilation)
  pos = pos[:, ::stride, ::stride][:, :h_out, :w_out]
  rows = pos[..., 0].astype(np.float64)
  cols = pos[..., 1].astype(np.float64)
  r0, c0 = np.floor(rows), np.floor(cols)
  wr = (rows - r0).astype(np.float32)
  wc = (cols - c0).astype(np.float32)
  idx, wgt = [], []
  for dr, dc, w in ((0, 0, (1 - wr) * (1 - wc)), (0, 1, (1 - wr) * wc),
                    (1, 0, wr * (1 - wc)), (1, 1, wr * wc)):
    rr, cc = r0 + dr, c0 + dc
    ok = (rr >= 0) & (rr < in_height) & (cc >= 0) & (cc < in_width)
    rr = np.clip(rr, 0, in_height - 1).astype(np.int64)
    cc = np.clip(cc, 0, in_width - 1).astype(np.int64)
    idx.append(rr * in_width + cc)
    wgt.append(np.where(ok, w, 0.0).astype(np.float32))
  return np.stack(idx), np.stack(wgt)
