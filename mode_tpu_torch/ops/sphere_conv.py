"""Spherical convolution on Cassini and ERP panoramas, with a fused epilogue.

The sampling grid is the reference's inverse-gnomonic construction
(``mode_tpu/ops/sphere_conv.py``), kept here as its own numpy copy and
cached per shape:

  * :func:`gen_sphere_positions` — the fractional (row, column) position at
    which each kernel tap samples for each output pixel;
  * :func:`build_gather_tables` — the 4 bilinear corners of every position,
    with zero weight outside the image: the plain version's tables;
  * :func:`build_shift_tables` and :func:`build_shift_tables_erp` — the
    compact tables of the grid's structure (``mode_tpu/ops/pallas/
    sphere_conv_kernel.py:59-104, 169-209``), which the CUDA kernels read.
    One image axis is the *band*: the taps sample within +-2 of the output
    pixel's band index, at two source band indices that depend on the band
    index and the tap only. The other is the circular *lane* axis: the tap's
    lane coordinate is ``(lane + Δ[band, k]) mod L``. So ``band x 9`` entries
    describe the whole grid. A Cassini map (H = 2W) has (band, lane) =
    (column, row); an ERP map (W = 2H) the transpose, (row, column).

:func:`sphere_conv_bn_act` computes ``act(sphere_conv(x, w) * scale + bias
(+ residual))`` on ``(N, H, W, Cin)`` maps, stride 1, dense output, for
``sphere_type="Cassini"`` (H = 2W) or ``"ERP"`` (W = 2H). It replaces
``mode_tpu/ops/pallas/sphere_conv_kernel.py:sphere_conv_cassini_pallas``
(K3) and ``sphere_conv_erp_pallas`` (K10); the BN, shortcut add and ReLU
that the JAX package applies after it in XLA (``SphereBasicBlock``) run in
its epilogue. On a CUDA tensor it launches the kernel of its layout from
``kernels/csrc/sphere_conv.cu``; on a CPU tensor, or with ``plain=True``, it
runs the plain version: the 4-corner gather and GEMM of :func:`sphere_conv`
(``sphere_conv_xla``) in f32 and the same epilogue.

The backward, :func:`sphere_conv_backward`, replaces
``sphere_conv_cassini_pallas_bwd`` (K3b) and ``sphere_conv_erp_pallas_bwd``
(K10b) with the two kernels of ``kernels/csrc/sphere_conv_bwd.cu``, each
built for both layouts: :func:`sphere_conv_bwd_input` (dx on the tensor
cores: each dx row gathers the output samples that read it, listed per
(band index, tap) by :func:`transpose_table`; no atomics) and
:func:`sphere_conv_bwd_weight` (dw on the tensor cores, K stages of 32
lanes, per-block f32 partial sums added in a fixed order). Their plain
versions are the explicit transpose of the gather version: ``g @ W^T``
scattered back through the 4 corners with ``index_add_``, and the gathered
samples contracted with ``g``. :func:`sphere_conv_train` is the bare conv as an
autograd ``Function`` (forward K3/K10, backward K3b/K10b), which the
training path of ``models/blocks.py`` runs where
:func:`train_kernel_eligible` says the JAX package runs Pallas.

Each layout's kernels have their own names, which are their C entry points
and their ``LAUNCHES`` keys (:data:`FORWARD`, :data:`BWD_INPUT`,
:data:`BWD_WEIGHT`), so a run shows the ERP kernels apart from the Cassini
ones.

The weight is torch's ``(Cout, Cin, 3, 3)``, or the ``(9, Cin, Cout)``
layout of ``ops/conv2d.py:pack_weight``, the taps row-major over (kh, kw)
as ``weight.reshape(kh * kw, cin, cout)`` orders them in the JAX package;
the forward kernel's own layout is the K-major
:class:`~mode_tpu_torch.ops.kmajor.TcWeight` of
``ops/conv2d.py:pack_weight_tc``, which a layer keeps between calls. The
grad-input kernel reads the ``(9, Cin, Cout)`` layout K-major over Cout,
packed on the device in each call by ``ops/kmajor.py:pack``.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from mode_tpu_torch import kernels, remat
from mode_tpu_torch.device import upload
from mode_tpu_torch.kernels import build
from mode_tpu_torch.ops import conv2d, kmajor
from mode_tpu_torch.ops.conv2d import pack_weight
from mode_tpu_torch.ops.epilogue import affine, epilogue
from mode_tpu_torch.ops.kmajor import TcWeight

_DTYPES = (torch.float32, torch.bfloat16)
_TAPS = 9
# the kernel of each pass, by layout: its C entry point and launch key
FORWARD = {"Cassini": "sphere_conv_bn_act", "ERP": "sphere_conv_erp_bn_act"}
BWD_INPUT = {"Cassini": "sphere_conv_bwd_input",
             "ERP": "sphere_conv_erp_bwd_input"}
BWD_WEIGHT = {"Cassini": "sphere_conv_bwd_weight",
              "ERP": "sphere_conv_erp_bwd_weight"}


@functools.lru_cache(maxsize=64)
def gen_sphere_positions(in_height: int, in_width: int, kh: int, kw: int,
                         sphere_type: str = "Cassini") -> np.ndarray:
  """Fractional sampling positions for every output pixel and kernel tap.

  Returns ``(kh*kw, H, W, 2)`` float32: ``[k, i, j, 0]`` is the row and
  ``[..., 1]`` the column in the input at which tap ``k`` (row-major over
  the kernel window) samples for output pixel ``(i, j)``. For Cassini,
  H = 2W; for ERP, W = 2H. The reference's quirks are kept: the ``kerY``
  divisor uses ``delta_lon``, the centre tap's rho is clamped to 1e-8,
  longitude wraps modulo the width and latitude does not (zero past the
  poles).
  """
  # the gnomonic grid lives on an ERP-shaped (h, w) = (min, max) canvas;
  # the Cassini image is its transpose
  height = min(in_height, in_width)
  width = max(in_height, in_width)
  if width != 2 * height:
    raise ValueError(f"spherical conv expects a 2:1 panorama, got "
                     f"{in_height}x{in_width}")

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
  ker_x, ker_y = np.meshgrid(ker_x, ker_y)  # (kh, kw)
  rho = np.sqrt(ker_x**2 + ker_y**2)
  if kh % 2 and kw % 2:
    rho[kh // 2][kw // 2] = 1e-8
  nu = np.arctan(rho)
  cos_nu, sin_nu = np.cos(nu), np.sin(nu)

  lat_range = ((np.arange(0, height) / height) - 0.5) * np.pi
  lon_range = ((np.arange(0, width) / width) - 0.5) * (2 * np.pi)

  # (h, kh, kw): the tap's latitude and longitude offset per output row
  lat = np.arcsin(
      cos_nu[None] * np.sin(lat_range)[:, None, None] +
      ker_y[None] * sin_nu[None] * np.cos(lat_range)[:, None, None] / rho[None])
  lon = np.arctan2(
      ker_x[None] * sin_nu[None],
      rho[None] * np.cos(lat_range)[:, None, None] * cos_nu[None] -
      ker_y[None] * np.sin(lat_range)[:, None, None] * sin_nu[None])

  # latitude does not depend on the column; longitude shifts with it
  lat = np.broadcast_to(lat[:, None], (height, width, kh, kw))
  lon = lon[:, None] + lon_range[None, :, None, None]

  lat_pix = (lat / np.pi + 0.5) * height
  lon_pix = ((lon / (2 * np.pi) + 0.5) * width) % width

  if sphere_type == "ERP":
    rows, cols = lat_pix, lon_pix            # image is (height, width)
  elif sphere_type == "Cassini":
    # image is (width, height): rows follow longitude, columns latitude
    rows = lon_pix.transpose(1, 0, 2, 3)
    cols = lat_pix.transpose(1, 0, 2, 3)
  else:
    raise ValueError(f"unknown sphere_type {sphere_type!r}")

  pos = np.stack([rows, cols], axis=-1)      # (H, W, kh, kw, 2)
  pos = pos.transpose(2, 3, 0, 1, 4).reshape(kh * kw, *rows.shape[:2], 2)
  return np.ascontiguousarray(pos.astype(np.float32))


def positions_reference_layout(pos: np.ndarray) -> np.ndarray:
  """``(K, H, W, 2)`` positions in the reference's CUDA buffer layout
  ``(1, 2*K, H, W)``."""
  k, h, w, _ = pos.shape
  return pos.transpose(0, 3, 1, 2).reshape(1, 2 * k, h, w)


def conv_output_size(size: int, kernel: int, stride: int, pad: int,
                     dilation: int) -> int:
  """Torch's conv output-size formula."""
  return (size + 2 * pad - (dilation * (kernel - 1) + 1)) // stride + 1


@functools.lru_cache(maxsize=64)
def build_gather_tables(in_height: int, in_width: int, kh: int, kw: int,
                        sphere_type: str, stride: int, pad: int,
                        dilation: int) -> tuple[np.ndarray, np.ndarray]:
  """The bilinear corners of every sampling position.

  Returns ``(idx, wgt)``, each ``(4, K, Ho, Wo)``: ``idx`` int32, the
  flattened ``row * W + col`` input index of each corner (clamped into
  range), and ``wgt`` float32, its bilinear weight, zero for a corner
  outside the image. The stride subsamples the dense position grid;
  padding and dilation only enter the output size, as in the reference.
  """
  pos = gen_sphere_positions(in_height, in_width, kh, kw, sphere_type)
  h_out = conv_output_size(in_height, kh, stride, pad, dilation)
  w_out = conv_output_size(in_width, kw, stride, pad, dilation)
  pos = pos[:, ::stride, ::stride][:, :h_out, :w_out]  # (K, Ho, Wo, 2)

  rows = pos[..., 0].astype(np.float64)
  cols = pos[..., 1].astype(np.float64)
  r0 = np.floor(rows)
  c0 = np.floor(cols)
  wr = (rows - r0).astype(np.float32)
  wc = (cols - c0).astype(np.float32)

  idx_list, wgt_list = [], []
  for dr, dc, wgt in ((0, 0, (1 - wr) * (1 - wc)), (0, 1, (1 - wr) * wc),
                      (1, 0, wr * (1 - wc)), (1, 1, wr * wc)):
    rr = r0 + dr
    cc = c0 + dc
    ok = (rr >= 0) & (rr < in_height) & (cc >= 0) & (cc < in_width)
    rr = np.clip(rr, 0, in_height - 1).astype(np.int64)
    cc = np.clip(cc, 0, in_width - 1).astype(np.int64)
    idx_list.append((rr * in_width + cc).astype(np.int32))
    wgt_list.append(np.where(ok, wgt, 0.0).astype(np.float32))
  return np.stack(idx_list), np.stack(wgt_list)


@functools.lru_cache(maxsize=32)
def build_shift_tables(h: int, w: int, k: int
                       ) -> tuple[np.ndarray, np.ndarray, np.ndarray,
                                  np.ndarray]:
  """The per-(output column, tap) tables of a ``k x k`` Cassini sphere conv.

  Returns ``(sigma, colint, quad, drop_row)``:
    * ``sigma`` int32 ``(W, K)``: the integer row shift ``floor(Δ) mod H``;
    * ``colint`` float32 ``(W, K, 2)``: the two source columns ``c0``,
      ``c0 + 1``, clamped into range;
    * ``quad`` float32 ``(W, K, 4)``: the bilinear weights of the corners
      (row s, c0), (row s+1, c0), (row s, c1), (row s+1, c1), with
      ``s = (i + sigma) mod H``; zero for a column outside the image;
    * ``drop_row`` int32 ``(W, K)``: the output row whose whole sample is
      dropped (its f32 position rounds to exactly H), or -1.
  The successor of source row H-1 is not wrapped: it contributes zero.
  """
  pos = gen_sphere_positions(h, w, k, k, "Cassini")   # (K, H, W, 2)
  delta = pos[:, 0, :, 0].astype(np.float64)          # Δ mod H at i = 0
  sigma = np.floor(delta).astype(np.int64) % h
  row_w = (delta - np.floor(delta)).astype(np.float32)

  at_h = pos[:, :, :, 0] >= h                         # (K, H, W)
  drop_row = np.where(at_h.any(axis=1), at_h.argmax(axis=1), -1)  # (K, W)

  cols = pos[:, 0, :, 1].astype(np.float64)           # (K, W)
  c0 = np.floor(cols)
  wc = (cols - c0).astype(np.float32)
  ok0 = (c0 >= 0) & (c0 < w)
  ok1 = (c0 + 1 >= 0) & (c0 + 1 < w)
  wc0 = np.where(ok0, 1.0 - wc, 0.0)
  wc1 = np.where(ok1, wc, 0.0)
  quad = np.stack([wc0 * (1.0 - row_w), wc0 * row_w,
                   wc1 * (1.0 - row_w), wc1 * row_w],
                  axis=-1).astype(np.float32)         # (K, W, 4)
  colint = np.stack([np.clip(c0, 0, w - 1), np.clip(c0 + 1, 0, w - 1)],
                    axis=-1).astype(np.float32)       # (K, W, 2)
  return (np.ascontiguousarray(sigma.T.astype(np.int32)),
          np.ascontiguousarray(colint.transpose(1, 0, 2)),
          np.ascontiguousarray(quad.transpose(1, 0, 2)),
          np.ascontiguousarray(drop_row.T.astype(np.int32)))


@functools.lru_cache(maxsize=32)
def build_shift_tables_erp(h: int, w: int, k: int
                           ) -> tuple[np.ndarray, np.ndarray, np.ndarray,
                                      np.ndarray]:
  """The per-(output row, tap) tables of a ``k x k`` ERP sphere conv, the
  transpose of :func:`build_shift_tables`: rows are the band (latitude,
  which does not wrap: a row outside the image has weight zero), columns
  the circular lane axis.

  Returns ``(sigma, rowint, quad, drop_col)``:
    * ``sigma`` int32 ``(H, K)``: the integer column shift
      ``floor(Δ) mod W``;
    * ``rowint`` float32 ``(H, K, 2)``: the two source rows ``r0``,
      ``r0 + 1``, clamped into range;
    * ``quad`` float32 ``(H, K, 4)``: the bilinear weights of the corners
      (r0, s), (r0, s+1), (r1, s), (r1, s+1), with ``s = (j + sigma) mod W``;
      zero for a row outside the image;
    * ``drop_col`` int32 ``(H, K)``: the output column whose whole sample is
      dropped (its f32 position rounds to exactly W), or -1.
  The successor of source column W-1 is not wrapped: it contributes zero.
  """
  pos = gen_sphere_positions(h, w, k, k, "ERP")       # (K, H, W, 2)
  delta = pos[:, :, 0, 1].astype(np.float64)          # Δ mod W at j = 0
  sigma = np.floor(delta).astype(np.int64) % w
  frac = (delta - np.floor(delta)).astype(np.float32)

  at_w = pos[:, :, :, 1] >= w                         # (K, H, W)
  drop_col = np.where(at_w.any(axis=2), at_w.argmax(axis=2), -1)  # (K, H)

  rows = pos[:, :, 0, 0].astype(np.float64)           # (K, H)
  r0 = np.floor(rows)
  wr = (rows - r0).astype(np.float32)
  ok0 = (r0 >= 0) & (r0 < h)
  ok1 = (r0 + 1 >= 0) & (r0 + 1 < h)
  wr0 = np.where(ok0, 1.0 - wr, 0.0)
  wr1 = np.where(ok1, wr, 0.0)
  quad = np.stack([wr0 * (1.0 - frac), wr0 * frac,
                   wr1 * (1.0 - frac), wr1 * frac],
                  axis=-1).astype(np.float32)         # (K, H, 4)
  rowint = np.stack([np.clip(r0, 0, h - 1), np.clip(r0 + 1, 0, h - 1)],
                    axis=-1).astype(np.float32)       # (K, H, 2)
  return (np.ascontiguousarray(sigma.T.astype(np.int32)),
          np.ascontiguousarray(rowint.transpose(1, 0, 2)),
          np.ascontiguousarray(quad.transpose(1, 0, 2)),
          np.ascontiguousarray(drop_col.T.astype(np.int32)))


def shift_tables(h: int, w: int, sphere_type: str):
  """The 3x3 shift tables of a map's layout, indexed by band:
  :func:`build_shift_tables` (Cassini) or :func:`build_shift_tables_erp`
  (ERP)."""
  if sphere_type == "ERP":
    return build_shift_tables_erp(h, w, 3)
  return build_shift_tables(h, w, 3)


def _check_layout(name: str, h: int, w: int, sphere_type: str) -> None:
  if sphere_type == "Cassini":
    ok, want = h == 2 * w, "a Cassini map (H = 2W)"
  elif sphere_type == "ERP":
    ok, want = w == 2 * h, "an ERP map (W = 2H)"
  else:
    raise ValueError(f"{name}: unknown sphere_type {sphere_type!r}")
  if not ok:
    raise ValueError(f"{name}: expected {want}, got {h}x{w}")


@functools.cache
def _sphere_lib():
  lib = build.load("sphere_conv")
  for name in FORWARD.values():
    fn = getattr(lib, name)
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 9
                   + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
  return lib


def _packed(weight) -> torch.Tensor:
  """The ``(9, Cin, Cout)`` layout of any weight this module takes."""
  if isinstance(weight, TcWeight):
    weight = weight.weight
  return weight if weight.dim() == 3 else pack_weight(weight)


@functools.lru_cache(maxsize=16)
def _device_tables(kind: str, h: int, w: int, sphere_type: str,
                   device: torch.device):
  """The tables of :func:`build_gather_tables` (``"gather"``),
  :func:`shift_tables` (``"shift"``, packed as ``sphere_conv.cu`` reads
  them) or :func:`transpose_table` (``"transpose"``) of a map's layout, as
  tensors on ``device``."""
  if kind == "gather":
    idx, wgt = build_gather_tables(h, w, 3, 3, sphere_type, 1, 1, 1)
    return upload(idx.astype(np.int64), device), upload(wgt, device)
  if kind == "transpose":
    return tuple(upload(t, device)
                 for t in transpose_table(h, w, sphere_type))
  sigma, pairint, quad, drop = shift_tables(h, w, sphere_type)
  # per (band index, tap): int4 (sigma, first, second source band index,
  # drop), float4 quad
  itab = np.stack([sigma, pairint[..., 0].astype(np.int32),
                   pairint[..., 1].astype(np.int32), drop], axis=-1)
  return (upload(np.ascontiguousarray(itab, np.int32), device),
          upload(quad, device))


def _im2col(x: torch.Tensor, sphere_type: str) -> torch.Tensor:
  """The 9 taps' samples ``(N, 9, H, W, Cin)`` in f32: the 4-corner
  bilinear gather of ``build_gather_tables``."""
  n, h, w, cin = x.shape
  idx, wgt = _device_tables("gather", h, w, sphere_type, x.device)
  xf = x.float().reshape(n, h * w, cin)
  col = None
  for corner in range(4):
    g = xf.index_select(1, idx[corner].reshape(-1)).reshape(
        n, _TAPS, h, w, cin)
    g = g * wgt[corner][None, ..., None]
    col = g if col is None else col + g
  return col


def _checked_packed(weight: torch.Tensor, cin: int, shape) -> torch.Tensor:
  wk = _packed(weight)
  if wk.shape[:2] != (_TAPS, cin):
    raise ValueError(f"weight {tuple(weight.shape)} does not match x "
                     f"{tuple(shape)}")
  return wk


def sphere_conv(x: torch.Tensor, weight: torch.Tensor,
                sphere_type: str = "Cassini") -> torch.Tensor:
  """The bare stride-1 3x3 sphere conv, plain PyTorch, in f32: the 4-corner
  bilinear gather of every tap (``build_gather_tables``), then one GEMM
  with the ``(9 * Cin, Cout)`` weight.

  ``x`` is ``(N, H, W, Cin)``, H = 2W for Cassini and W = 2H for ERP;
  ``weight`` torch or packed. Returns ``(N, H, W, Cout)`` f32.
  """
  _check_layout("sphere_conv", x.shape[1], x.shape[2], sphere_type)
  wk = _checked_packed(weight, x.shape[-1], x.shape).float()
  return torch.einsum("nkhwc,kco->nhwo", _im2col(x, sphere_type), wk)


def _check_map(name, t, what, sphere_type):
  if t.dim() != 4 or t.dtype not in _DTYPES or not t.is_contiguous():
    raise ValueError(f"{name}: {what} must be a contiguous f32 or bf16 NHWC "
                     f"map, got {tuple(t.shape)} {t.dtype}")
  _check_layout(name, t.shape[1], t.shape[2], sphere_type)


def _launch(x, weight, scale, bias, residual, relu, sphere_type):
  name = FORWARD[sphere_type]
  _check_map(name, x, "x", sphere_type)
  n, h, w, cin = x.shape
  tw = weight if isinstance(weight, TcWeight) else conv2d.pack_weight_tc(
      conv2d._torch_weight(weight))
  cout = tw.cout
  wbig, wsmall = kmajor.operands(name, x, tw, _TAPS,
                                 x.dtype == torch.float32)
  shape = (n, h, w, cout)
  if residual is not None and (tuple(residual.shape) != shape
                               or residual.dtype != x.dtype
                               or residual.device != x.device
                               or not residual.is_contiguous()):
    raise ValueError(f"{name}: residual must be a contiguous {x.dtype} "
                     f"tensor of shape {shape}")
  itab, ftab = _device_tables("shift", h, w, sphere_type, x.device)
  out = torch.empty(shape, dtype=x.dtype, device=x.device)
  kernels.launch(
      name, getattr(_sphere_lib(), name), x.device,
      int(x.dtype == torch.bfloat16), x.data_ptr(), wbig, wsmall,
      itab.data_ptr(), ftab.data_ptr(), scale.data_ptr(), bias.data_ptr(),
      None if residual is None else residual.data_ptr(), out.data_ptr(),
      n, h, w, cin, cout, int(relu), shape=(n, h, w, cin, cout))
  return out


def sphere_conv_bn_act(x: torch.Tensor, weight: torch.Tensor,
                       scale: torch.Tensor | None = None,
                       bias: torch.Tensor | None = None,
                       residual: torch.Tensor | None = None,
                       relu: bool = False, *, sphere_type: str = "Cassini",
                       plain: bool = False) -> torch.Tensor:
  """Stride-1 3x3 sphere conv + affine (+ residual) (+ ReLU).

  Args:
    x: ``(N, H, W, Cin)``, H = 2W for ``sphere_type="Cassini"`` and W = 2H
      for ``"ERP"``; f32 or bf16, contiguous.
    weight: torch ``(Cout, Cin, 3, 3)``, its ``conv2d.pack_weight_tc``
      layout (the kernel's) or its ``pack_weight`` layout ``(9, Cin,
      Cout)``; same dtype as ``x``.
    scale, bias: ``(Cout,)`` epilogue affine, kept in f32 (1 and 0 if None).
    residual: optional ``(N, H, W, Cout)`` added before the ReLU.
    sphere_type: the map's layout; the kernel is ``FORWARD[sphere_type]``.
    plain: run the plain PyTorch version even on a CUDA tensor.
  Returns:
    ``(N, H, W, Cout)`` in ``x.dtype``.
  """
  if isinstance(weight, TcWeight):
    cout = weight.cout
  else:
    cout = weight.shape[2] if weight.dim() == 3 else weight.shape[0]
  scale, bias = affine(scale, bias, cout, x.device)
  if plain or x.device.type == "cpu":
    return epilogue(sphere_conv(x, weight, sphere_type), scale, bias,
                    residual, relu, x.dtype)
  if x.device.type != "cuda":
    raise ValueError(f"{FORWARD[sphere_type]}: unsupported device "
                     f"{x.device}")
  return _launch(x, weight, scale, bias, residual, relu, sphere_type)


# --- backward (K3b, K10b) ---------------------------------------------------

# the most output band indices whose tap reads one input band index
# (sphere_conv_bwd.cu:MAXE)
_MAX_CONTRIB = 4


@functools.cache
def _bwd_lib():
  lib = build.load("sphere_conv_bwd")
  for name in BWD_INPUT.values():
    fn = getattr(lib, name)
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 6
                   + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
  for name in BWD_WEIGHT.values():
    fn = getattr(lib, name)
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 6
                   + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
  return lib


@functools.lru_cache(maxsize=32)
def transpose_bounds(h: int, w: int,
                     sphere_type: str = "Cassini") -> tuple[int, int]:
  """``(reach, most)`` of the shift tables' transpose: the largest
  distance between an input band index ``c`` and an output band index
  ``j`` whose tap reads it with a nonzero corner weight, and the most such
  output band indices for one (input band index, tap). The dx kernel's
  table (:func:`transpose_table`) holds ``most`` <= 4 of them (2 and 4 on
  the Cassini grids of 32x16 to 1024x512 and on the ERP grids of 16x32 to
  512x1024)."""
  _, pairint, quad, _ = shift_tables(h, w, sphere_type)
  band = pairint.shape[0]
  c = np.arange(band)[:, None, None]                   # input band index
  on0 = pairint[None, ..., 0] == c                     # (band_c, band_j, 9)
  on1 = pairint[None, ..., 1] == c
  hit = ((on0 & ((quad[None, ..., 0] != 0) | (quad[None, ..., 1] != 0)))
         | (on1 & ((quad[None, ..., 2] != 0) | (quad[None, ..., 3] != 0))))
  dist = np.abs(np.arange(band)[None, :, None] - c)
  reach = int(np.where(hit, dist, 0).max())
  return reach, int(hit.sum(axis=1).max())


@functools.lru_cache(maxsize=32)
def transpose_table(h: int, w: int, sphere_type: str = "Cassini"
                    ) -> tuple[np.ndarray, np.ndarray]:
  """The shift tables transposed, as the dx kernel reads them: for each
  input band index ``c`` and tap ``k``, the output band indices ``j``
  (ascending, at most 4) whose tap ``k`` reads ``c`` with a nonzero corner
  weight.

  Returns ``(entries, weights)``, ``(band, 9, 4, 4)`` int32 and
  ``(band, 9, 4, 2)`` float32: entry ``e`` of ``(c, k)`` is ``(j,
  sigma[j, k], drop[j, k], count)`` and ``(a_s, a_n)``, the summed weights
  of its corners at lane s (``quad`` 0 and 2 where ``c`` is ``b0`` and
  ``b1``) and at lane s + 1 (``quad`` 1 and 3); ``count`` is the number of
  such ``j`` in every entry of ``(c, k)``, and the slots past it hold ``j =
  c`` with zero weights. Output lane ``(l - sigma) mod L`` reads input
  pixel ``(c, l)`` through the lane-s corners and ``(l - 1 - sigma) mod
  L`` through the lane-s + 1 ones."""
  sigma, pairint, quad, drop = shift_tables(h, w, sphere_type)
  band = pairint.shape[0]
  c = np.arange(band)[:, None, None]                   # input band index
  on0 = pairint[None, ..., 0] == c                     # (band_c, band_j, 9)
  on1 = pairint[None, ..., 1] == c
  zero = np.float32(0)
  a_s = (np.where(on0, quad[None, ..., 0], zero)
         + np.where(on1, quad[None, ..., 2], zero))
  a_n = (np.where(on0, quad[None, ..., 1], zero)
         + np.where(on1, quad[None, ..., 3], zero))
  live = (a_s != 0) | (a_n != 0)
  count = live.sum(axis=1)                             # (band_c, 9)
  if count.max() > _MAX_CONTRIB:
    raise ValueError(f"a {h}x{w} {sphere_type} map reads one band index "
                     f"from {count.max()} others, more than "
                     f"{_MAX_CONTRIB}")
  entries = np.zeros((band, _TAPS, _MAX_CONTRIB, 4), np.int32)
  weights = np.zeros((band, _TAPS, _MAX_CONTRIB, 2), np.float32)
  entries[..., 0] = np.arange(band)[:, None, None]
  entries[..., 3] = count[..., None]
  for ci, j, k in zip(*np.nonzero(live)):              # j ascending per c
    e = int((live[ci, :j, k]).sum())
    entries[ci, k, e, :3] = (j, sigma[j, k], drop[j, k])
    weights[ci, k, e] = (a_s[ci, j, k], a_n[ci, j, k])
  return entries, weights


def _torch_layout(dw: torch.Tensor) -> torch.Tensor:
  """``(9, Cin, Cout)`` -> torch ``(Cout, Cin, 3, 3)``."""
  return dw.reshape(3, 3, *dw.shape[1:]).permute(3, 2, 0, 1).contiguous()


def _plain_bwd_input(g: torch.Tensor, weight: torch.Tensor,
                     sphere_type: str) -> torch.Tensor:
  """dx in f32: ``dcol = g @ W^T`` per tap, each of the gather's 4 corners
  scattered back with its weight (``index_add_``)."""
  n, h, w, _ = g.shape
  _check_layout(BWD_INPUT[sphere_type], h, w, sphere_type)
  wk = _packed(weight).float()
  idx, wgt = _device_tables("gather", h, w, sphere_type, g.device)
  dcol = torch.einsum("nhwo,kco->nkhwc", g.float(), wk)  # (N, 9, H, W, Cin)
  dx = torch.zeros((n, h * w, wk.shape[1]), device=g.device)
  for corner in range(4):
    src = (dcol * wgt[corner][None, ..., None]).reshape(n, -1, wk.shape[1])
    dx.index_add_(1, idx[corner].reshape(-1), src)
  return dx.reshape(n, h, w, -1)


def _plain_bwd_weight(x: torch.Tensor, g: torch.Tensor,
                      sphere_type: str) -> torch.Tensor:
  """dw ``(9, Cin, Cout)`` in f32: the gather's samples against g."""
  _check_layout(BWD_WEIGHT[sphere_type], x.shape[1], x.shape[2], sphere_type)
  return torch.einsum("nkhwc,nhwo->kco", _im2col(x, sphere_type), g.float())


def _launch_bwd_input(g, weight, sphere_type):
  name = BWD_INPUT[sphere_type]
  _check_map(name, g, "g", sphere_type)
  n, h, w, cout = g.shape
  wk = _packed(weight)
  if (wk.shape[0] != _TAPS or wk.shape[2] != cout or wk.dtype != g.dtype
      or wk.device != g.device):
    raise ValueError(f"{name}: weight {tuple(weight.shape)} {weight.dtype} "
                     f"does not match g {tuple(g.shape)} {g.dtype}")
  cin = wk.shape[1]
  _, most = transpose_bounds(h, w, sphere_type)
  if most > _MAX_CONTRIB or h * w * max(cin, cout) >= 2**31:
    raise ValueError(f"{name}: a {h}x{w} map with {cin}/{cout} channels "
                     "exceeds the kernel's table or offset bounds")
  if cout % 8 or g.data_ptr() % 16:
    raise ValueError(f"{name}: Cout must be a multiple of 8 and g 16-byte "
                     f"aligned, got Cout {cout}")
  # B: the (9, Cin, Cout) weight K-major over Cout, packed on the device
  split = g.dtype == torch.float32
  parts = kmajor.pack(wk, wk, split).parts
  wbig, wsmall = kmajor.pointers(name, g, parts, _TAPS, cin, split)
  entries, weights = _device_tables("transpose", h, w, sphere_type, g.device)
  dx = torch.empty((n, h, w, cin), dtype=g.dtype, device=g.device)
  kernels.launch(
      name, getattr(_bwd_lib(), name), g.device,
      int(g.dtype == torch.bfloat16), g.data_ptr(), wbig, wsmall,
      entries.data_ptr(), weights.data_ptr(), dx.data_ptr(), n, h, w, cin,
      cout, shape=(n, h, w, cin, cout))
  return dx


# the dw kernel's tile (sphere_conv_bwd.cu): output channels a block, and
# lanes a K stage
_DW_ROWS = 128
_DW_LANES = 32


def _weight_splits(n, h, w, cin, cout, sphere_type,
                   device) -> tuple[int, int]:
  """``(nsplit, chunk)``: the dw kernel's split of its K stages, one per
  run of 32 lanes of a band index of an image, into ``nsplit`` ranges of
  ``chunk`` stages. The grid of (tap x channel tile, output channel tile,
  split) blocks fills whole waves of the SMs of ``device``'s card, one
  block an SM: ``nsplit`` is the least count for which tiles x nsplit is a
  multiple of the SM count (44 at 9 tiles and 132 SMs), or the stage count
  if that is less."""
  sms = torch.cuda.get_device_properties(device).multi_processor_count
  band, lanes = (h, w) if sphere_type == "ERP" else (w, h)
  stages = n * band * -(-lanes // _DW_LANES)
  tiles = (_TAPS * -(-cin // (128 if cin > 64 else 64))
           * -(-cout // _DW_ROWS))
  nsplit = min(sms // math.gcd(tiles, sms), stages)
  chunk = -(-stages // nsplit)
  return -(-stages // chunk), chunk


def _launch_bwd_weight(x, g, sphere_type):
  name = BWD_WEIGHT[sphere_type]
  _check_map(name, x, "x", sphere_type)
  _check_map(name, g, "g", sphere_type)
  n, h, w, cin = x.shape
  cout = g.shape[3]
  if g.shape[:3] != x.shape[:3] or g.dtype != x.dtype or g.device != x.device:
    raise ValueError(f"{name}: g {tuple(g.shape)} {g.dtype} does not match "
                     f"x {tuple(x.shape)} {x.dtype}")
  if cin % 8 or cout % 8 or x.data_ptr() % 16 or g.data_ptr() % 16:
    raise ValueError(f"{name}: Cin and Cout must be multiples of 8 and x, g "
                     f"16-byte aligned, got Cin {cin}, Cout {cout}")
  nsplit, chunk = _weight_splits(n, h, w, cin, cout, sphere_type, x.device)
  itab, ftab = _device_tables("shift", h, w, sphere_type, x.device)
  part = torch.empty((nsplit, _TAPS * cin, cout), device=x.device)
  dw = torch.empty((_TAPS, cin, cout), device=x.device)
  kernels.launch(
      name, getattr(_bwd_lib(), name), x.device,
      int(x.dtype == torch.bfloat16), x.data_ptr(), g.data_ptr(),
      itab.data_ptr(), ftab.data_ptr(), part.data_ptr(), dw.data_ptr(),
      n, h, w, cin, cout, nsplit, chunk, shape=(n, h, w, cin, cout))
  return dw


def sphere_conv_bwd_input(g: torch.Tensor, weight: torch.Tensor, *,
                          sphere_type: str = "Cassini",
                          plain: bool = False) -> torch.Tensor:
  """The gradient of the bare sphere conv's input.

  Args:
    g: ``(N, H, W, Cout)`` cotangent of the conv's output in the layout of
      ``sphere_type`` (Cassini H = 2W, ERP W = 2H), f32 or bf16, contiguous.
    weight: torch ``(Cout, Cin, 3, 3)`` or packed ``(9, Cin, Cout)``, in
      ``g``'s dtype.
    plain: run the plain PyTorch version even on a CUDA tensor.
  Returns:
    dx ``(N, H, W, Cin)`` in ``g.dtype``.
  """
  if plain or g.device.type == "cpu":
    return _plain_bwd_input(g, weight, sphere_type).to(g.dtype)
  if g.device.type != "cuda":
    raise ValueError(f"{BWD_INPUT[sphere_type]}: unsupported device "
                     f"{g.device}")
  return _launch_bwd_input(g, weight, sphere_type)


def sphere_conv_bwd_weight(x: torch.Tensor, g: torch.Tensor, *,
                           sphere_type: str = "Cassini",
                           plain: bool = False) -> torch.Tensor:
  """The gradient of the bare sphere conv's weight, ``(9, Cin, Cout)`` f32,
  for the forward input ``x`` ``(N, H, W, Cin)`` and the cotangent ``g``
  ``(N, H, W, Cout)`` (same dtype, f32 or bf16, contiguous, in the layout
  of ``sphere_type``); summed in f32 over the pixels in a fixed order."""
  if plain or x.device.type == "cpu":
    return _plain_bwd_weight(x, g, sphere_type)
  if x.device.type != "cuda":
    raise ValueError(f"{BWD_WEIGHT[sphere_type]}: unsupported device "
                     f"{x.device}")
  return _launch_bwd_weight(x, g, sphere_type)


def sphere_conv_backward(x: torch.Tensor, weight: torch.Tensor,
                         g: torch.Tensor, *, sphere_type: str = "Cassini",
                         plain: bool = False
                         ) -> tuple[torch.Tensor, torch.Tensor]:
  """``(dx, dw)`` of the bare stride-1 3x3 sphere conv: replaces
  ``sphere_conv_kernel.py:sphere_conv_cassini_pallas_bwd`` (K3b) and
  ``sphere_conv_erp_pallas_bwd`` (K10b).

  ``x`` ``(N, H, W, Cin)`` and ``g`` ``(N, H, W, Cout)`` in one dtype and
  the layout of ``sphere_type``; ``weight`` torch or packed. Returns dx in
  ``x.dtype`` and dw in f32, in the layout of ``weight``. On a CUDA tensor
  the two kernels of ``kernels/csrc/sphere_conv_bwd.cu`` run; on a CPU
  tensor, or with ``plain=True``, their plain versions: the explicit
  transpose of the gather + GEMM of :func:`sphere_conv`.
  """
  _checked_packed(weight, x.shape[-1], x.shape)
  dx = sphere_conv_bwd_input(g, weight.to(g.dtype), sphere_type=sphere_type,
                             plain=plain)
  dw = sphere_conv_bwd_weight(x, g, sphere_type=sphere_type, plain=plain)
  return dx.to(x.dtype), (dw if weight.dim() == 3 else _torch_layout(dw))


def train_kernel_eligible(x_shape, sphere_type: str = "Cassini") -> bool:
  """Where the JAX package runs its Pallas sphere conv (K3/K3b, K10/K10b)
  in training, ``ops/sphere_conv.py:_pallas_eligible`` with its TPU memory
  budget left out: a map of the layout whose lane axis (Cassini H, ERP W)
  is a multiple of 128 and whose band axis (Cassini W, ERP H) a multiple
  of 8 up to 2048, Cin a multiple of 8."""
  _, h, w, cin = x_shape
  if sphere_type == "ERP":
    band, lanes, ok = h, w, w == 2 * h
  elif sphere_type == "Cassini":
    band, lanes, ok = w, h, h == 2 * w
  else:
    raise ValueError(f"unknown sphere_type {sphere_type!r}")
  return (ok and lanes % 128 == 0 and band % 8 == 0 and band <= 2048
          and cin % 8 == 0)


class _SphereConv(torch.autograd.Function):
  """The bare conv: forward K3/K10 (scale 1, bias 0, no residual, no ReLU),
  backward the two K3b/K10b kernels; their plain versions on the CPU or
  with ``plain``. The weight enters in torch layout, so its gradient
  reaches the ``Parameter``, and is packed in each call, on the device:
  K-major by the forward's wrapper, ``(9, Cin, Cout)`` here, saved for the
  backward."""

  @staticmethod
  def forward(ctx, x, weight, sphere_type, plain):
    x = x.contiguous()
    packed = _checked_packed(weight, x.shape[-1], x.shape).to(x.dtype)
    ctx.save_for_backward(x, packed)
    ctx.sphere_type, ctx.plain = sphere_type, plain
    return remat.conv_output(lambda: sphere_conv_bn_act(
        x, weight.to(x.dtype), sphere_type=sphere_type, plain=plain))

  @staticmethod
  def backward(ctx, g):
    x, packed = ctx.saved_tensors
    g = g.to(x.dtype).contiguous()
    kw = {"sphere_type": ctx.sphere_type, "plain": ctx.plain}
    dx = dw = None
    if ctx.needs_input_grad[0]:
      dx = sphere_conv_bwd_input(g, packed, **kw)
    if ctx.needs_input_grad[1]:
      dw = _torch_layout(sphere_conv_bwd_weight(x, g, **kw))
    return dx, dw, None, None


def sphere_conv_train(x: torch.Tensor, weight: torch.Tensor, *,
                      sphere_type: str = "Cassini",
                      plain: bool = False) -> torch.Tensor:
  """The bare sphere conv with its kernels' gradients: ``x`` ``(N, H, W,
  Cin)`` in the layout of ``sphere_type``, ``weight`` torch ``(Cout, Cin,
  3, 3)`` (a ``Parameter``); returns ``(N, H, W, Cout)`` in ``x.dtype``."""
  return _SphereConv.apply(x, weight, sphere_type, plain)
