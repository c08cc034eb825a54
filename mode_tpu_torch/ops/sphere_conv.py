"""Spherical convolution on Cassini panoramas, with a fused epilogue.

The sampling grid is the reference's inverse-gnomonic construction
(``mode_tpu/ops/sphere_conv.py``), kept here as its own numpy copy and
cached per shape:

  * :func:`gen_sphere_positions` — the fractional (row, column) position at
    which each kernel tap samples for each output pixel;
  * :func:`build_gather_tables` — the 4 bilinear corners of every position,
    with zero weight outside the image: the plain version's tables;
  * :func:`build_shift_tables` — the compact per-(output column, tap)
    tables of the Cassini structure (``mode_tpu/ops/pallas/
    sphere_conv_kernel.py:59-104``): the row coordinate of tap k at output
    pixel (i, j) is ``(i + Δ[j, k]) mod H`` and its column depends on j and
    k only, so W x 9 entries describe the whole grid. The CUDA kernel reads
    these.

:func:`sphere_conv_bn_act` computes ``act(sphere_conv(x, w) * scale + bias
(+ residual))`` on ``(N, H, W, Cin)`` Cassini maps (H = 2W), stride 1,
dense output. It replaces ``mode_tpu/ops/pallas/sphere_conv_kernel.py:
sphere_conv_cassini_pallas`` (K3); the BN, shortcut add and ReLU that the JAX
package applies after it in XLA (``SphereBasicBlock``) run in its epilogue.
On a CUDA tensor it launches the kernel of ``kernels/csrc/sphere_conv.cu``;
on a CPU tensor, or with ``plain=True``, it runs the plain version: the
4-corner gather and GEMM of :func:`sphere_conv` (``sphere_conv_xla``) in f32
and the same epilogue.

The backward, :func:`sphere_conv_backward`, replaces
``sphere_conv_cassini_pallas_bwd`` (K3b) with the two kernels of
``kernels/csrc/sphere_conv_bwd.cu``: :func:`sphere_conv_bwd_input` (dx, a
gather over the same shift tables, no atomics) and
:func:`sphere_conv_bwd_weight` (dw in f32, per-block partial sums added in a
fixed order). Their plain versions are the explicit transpose of the gather
version: ``g @ W^T`` scattered back through the 4 corners with
``index_add_``, and the gathered samples contracted with ``g``.
:func:`sphere_conv_train` is the bare conv as an autograd ``Function``
(forward K3, backward K3b), which the training path of ``models/blocks.py``
runs where :func:`train_kernel_eligible` says the JAX package runs Pallas.

The weight is torch's ``(Cout, Cin, 3, 3)``, or the ``(9, Cin, Cout)``
layout of ``ops/conv2d.py:pack_weight``, the taps row-major over (kh, kw)
as ``weight.reshape(kh * kw, cin, cout)`` orders them in the JAX package.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from mode_tpu_torch.kernels import LAUNCHES
from mode_tpu_torch.kernels import build
from mode_tpu_torch.ops.conv2d import pack_weight
from mode_tpu_torch.ops.epilogue import affine, epilogue

_NAME = "sphere_conv_bn_act"
_DTYPES = (torch.float32, torch.bfloat16)
_TAPS = 9


@functools.lru_cache(maxsize=64)
def gen_sphere_positions(in_height: int, in_width: int, kh: int, kw: int,
                         sphere_type: str = "Cassini") -> np.ndarray:
  """Fractional sampling positions for every output pixel and kernel tap.

  Returns ``(kh*kw, H, W, 2)`` float32: ``[k, i, j, 0]`` is the row and
  ``[..., 1]`` the column in the input at which tap ``k`` (row-major over
  the kernel window) samples for output pixel ``(i, j)``. For Cassini,
  H = 2W. The reference's quirks are kept: the ``kerY`` divisor uses
  ``delta_lon``, the centre tap's rho is clamped to 1e-8, longitude wraps
  modulo the width and latitude does not (zero past the poles).
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


@functools.cache
def _sphere_lib():
  lib = build.load("sphere_conv")
  lib.sphere_conv_bn_act.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 8
                                     + [ctypes.c_int] * 6 + [ctypes.c_void_p])
  lib.sphere_conv_bn_act.restype = ctypes.c_int
  return lib


def _packed(weight: torch.Tensor) -> torch.Tensor:
  return weight if weight.dim() == 3 else pack_weight(weight)


@functools.lru_cache(maxsize=16)
def _device_tables(kind: str, h: int, w: int, device: torch.device):
  """The tables of :func:`build_gather_tables` (``"gather"``) or
  :func:`build_shift_tables` (``"shift"``, packed as ``sphere_conv.cu``
  reads them) as tensors on ``device``."""
  if kind == "gather":
    idx, wgt = build_gather_tables(h, w, 3, 3, "Cassini", 1, 1, 1)
    return (torch.from_numpy(idx.astype(np.int64)).to(device),
            torch.from_numpy(wgt).to(device))
  sigma, colint, quad, drop = build_shift_tables(h, w, 3)
  # per (column, tap): int4 (sigma, c0, c1, drop_row), float4 quad
  itab = np.stack([sigma, colint[..., 0].astype(np.int32),
                   colint[..., 1].astype(np.int32), drop], axis=-1)
  return (torch.from_numpy(np.ascontiguousarray(itab, np.int32)).to(device),
          torch.from_numpy(quad).to(device))


def _im2col(x: torch.Tensor) -> torch.Tensor:
  """The 9 taps' samples ``(N, 9, H, W, Cin)`` in f32: the 4-corner
  bilinear gather of ``build_gather_tables``."""
  n, h, w, cin = x.shape
  idx, wgt = _device_tables("gather", h, w, x.device)
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


def sphere_conv(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
  """The bare stride-1 3x3 Cassini sphere conv, plain PyTorch, in f32: the
  4-corner bilinear gather of every tap (``build_gather_tables``), then
  one GEMM with the ``(9 * Cin, Cout)`` weight.

  ``x`` is ``(N, H, W, Cin)`` with H = 2W; ``weight`` torch or packed.
  Returns ``(N, H, W, Cout)`` f32.
  """
  wk = _checked_packed(weight, x.shape[-1], x.shape).float()
  return torch.einsum("nkhwc,kco->nhwo", _im2col(x), wk)


def _plain(x, weight, scale, bias, residual, relu):
  return epilogue(sphere_conv(x, weight), scale, bias, residual, relu,
                  x.dtype)


def _check_map(name, t, what):
  if t.dim() != 4 or t.dtype not in _DTYPES or not t.is_contiguous():
    raise ValueError(f"{name}: {what} must be a contiguous f32 or bf16 NHWC "
                     f"map, got {tuple(t.shape)} {t.dtype}")
  if t.shape[1] != 2 * t.shape[2]:
    raise ValueError(f"{name}: {what} must be a Cassini map (H = 2W), got "
                     f"{t.shape[1]}x{t.shape[2]}")


def _launch(x, weight, scale, bias, residual, relu):
  _check_map(_NAME, x, "x")
  n, h, w, cin = x.shape
  wk = _packed(weight)
  if (wk.shape[:2] != (_TAPS, cin) or wk.dtype != x.dtype
      or wk.device != x.device or not wk.is_contiguous()):
    raise ValueError(f"{_NAME}: weight {tuple(weight.shape)} {weight.dtype} "
                     f"does not match x {tuple(x.shape)} {x.dtype}")
  cout = wk.shape[2]
  shape = (n, h, w, cout)
  if residual is not None and (tuple(residual.shape) != shape
                               or residual.dtype != x.dtype
                               or residual.device != x.device
                               or not residual.is_contiguous()):
    raise ValueError(f"{_NAME}: residual must be a contiguous {x.dtype} "
                     f"tensor of shape {shape}")
  itab, ftab = _device_tables("shift", h, w, x.device)
  out = torch.empty(shape, dtype=x.dtype, device=x.device)
  err = _sphere_lib().sphere_conv_bn_act(
      int(x.dtype == torch.bfloat16), x.data_ptr(), wk.data_ptr(),
      itab.data_ptr(), ftab.data_ptr(), scale.data_ptr(), bias.data_ptr(),
      None if residual is None else residual.data_ptr(), out.data_ptr(),
      n, h, w, cin, cout, int(relu),
      torch.cuda.current_stream(x.device).cuda_stream)
  if err != 0:
    raise RuntimeError(f"{_NAME}: kernel launch failed with CUDA error {err}")
  LAUNCHES[_NAME] += 1
  return out


def sphere_conv_bn_act(x: torch.Tensor, weight: torch.Tensor,
                       scale: torch.Tensor | None = None,
                       bias: torch.Tensor | None = None,
                       residual: torch.Tensor | None = None,
                       relu: bool = False, *, plain: bool = False
                       ) -> torch.Tensor:
  """Stride-1 3x3 Cassini sphere conv + affine (+ residual) (+ ReLU).

  Args:
    x: ``(N, H, W, Cin)`` with H = 2W, f32 or bf16, contiguous.
    weight: torch ``(Cout, Cin, 3, 3)``, or its ``pack_weight`` layout
      ``(9, Cin, Cout)``; same dtype as ``x``.
    scale, bias: ``(Cout,)`` epilogue affine, kept in f32 (1 and 0 if None).
    residual: optional ``(N, H, W, Cout)`` added before the ReLU.
    plain: run the plain PyTorch version even on a CUDA tensor.
  Returns:
    ``(N, H, W, Cout)`` in ``x.dtype``.
  """
  cout = weight.shape[2] if weight.dim() == 3 else weight.shape[0]
  scale, bias = affine(scale, bias, cout, x.device)
  if plain or x.device.type == "cpu":
    return _plain(x, weight, scale, bias, residual, relu)
  if x.device.type != "cuda":
    raise ValueError(f"{_NAME}: unsupported device {x.device}")
  return _launch(x, weight, scale, bias, residual, relu)


# --- backward (K3b) ---------------------------------------------------------

_BWD_INPUT = "sphere_conv_bwd_input"
_BWD_WEIGHT = "sphere_conv_bwd_weight"
# the most samples of one tap that read one input column
# (sphere_conv_bwd.cu:MAXE)
_MAX_CONTRIB = 4


@functools.cache
def _bwd_lib():
  lib = build.load("sphere_conv_bwd")
  lib.sphere_conv_bwd_input.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 7
                                        + [ctypes.c_int] * 6
                                        + [ctypes.c_void_p])
  lib.sphere_conv_bwd_input.restype = ctypes.c_int
  lib.sphere_conv_bwd_weight.argtypes = ([ctypes.c_int]
                                         + [ctypes.c_void_p] * 6
                                         + [ctypes.c_int] * 7
                                         + [ctypes.c_void_p])
  lib.sphere_conv_bwd_weight.restype = ctypes.c_int
  return lib


@functools.lru_cache(maxsize=32)
def transpose_bounds(h: int, w: int) -> tuple[int, int]:
  """``(reach, most)`` of the shift tables' transpose: the largest
  ``|c - j|`` between an input column ``c`` and an output column ``j``
  whose tap reads it with a nonzero corner weight, and the most such output
  columns for one (input column, tap). The dx kernel scans ``reach``
  columns to each side and keeps ``most`` <= 4 samples (2 and 4 on the
  Cassini grids of 32x16 to 1024x512)."""
  _, colint, quad, _ = build_shift_tables(h, w, 3)
  c = np.arange(w)[:, None, None]                      # input column
  on0 = colint[None, ..., 0] == c                      # (W_c, W_j, 9)
  on1 = colint[None, ..., 1] == c
  hit = ((on0 & ((quad[None, ..., 0] != 0) | (quad[None, ..., 1] != 0)))
         | (on1 & ((quad[None, ..., 2] != 0) | (quad[None, ..., 3] != 0))))
  dist = np.abs(np.arange(w)[None, :, None] - c)
  reach = int(np.where(hit, dist, 0).max())
  return reach, int(hit.sum(axis=1).max())


def _torch_layout(dw: torch.Tensor) -> torch.Tensor:
  """``(9, Cin, Cout)`` -> torch ``(Cout, Cin, 3, 3)``."""
  return dw.reshape(3, 3, *dw.shape[1:]).permute(3, 2, 0, 1).contiguous()


def _plain_bwd_input(g: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
  """dx in f32: ``dcol = g @ W^T`` per tap, each of the gather's 4 corners
  scattered back with its weight (``index_add_``)."""
  n, h, w, _ = g.shape
  wk = _packed(weight).float()
  idx, wgt = _device_tables("gather", h, w, g.device)
  dcol = torch.einsum("nhwo,kco->nkhwc", g.float(), wk)  # (N, 9, H, W, Cin)
  dx = torch.zeros((n, h * w, wk.shape[1]), device=g.device)
  for corner in range(4):
    src = (dcol * wgt[corner][None, ..., None]).reshape(n, -1, wk.shape[1])
    dx.index_add_(1, idx[corner].reshape(-1), src)
  return dx.reshape(n, h, w, -1)


def _plain_bwd_weight(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
  """dw ``(9, Cin, Cout)`` in f32: the gather's samples against g."""
  return torch.einsum("nkhwc,nhwo->kco", _im2col(x), g.float())


def _launch_bwd_input(g, weight):
  _check_map(_BWD_INPUT, g, "g")
  n, h, w, cout = g.shape
  wk = _packed(weight)
  if (wk.shape[0] != _TAPS or wk.shape[2] != cout or wk.dtype != g.dtype
      or wk.device != g.device):
    raise ValueError(f"{_BWD_INPUT}: weight {tuple(weight.shape)} "
                     f"{weight.dtype} does not match g {tuple(g.shape)} "
                     f"{g.dtype}")
  cin = wk.shape[1]
  reach, most = transpose_bounds(h, w)
  if most > _MAX_CONTRIB or h * w * max(cin, cout) >= 2**31:
    raise ValueError(f"{_BWD_INPUT}: a {h}x{w} map with {cin}/{cout} "
                     "channels exceeds the kernel's table or offset bounds")
  wt = wk.transpose(1, 2).contiguous()                   # (9, Cout, Cin)
  itab, ftab = _device_tables("shift", h, w, g.device)
  scale, bias = affine(None, None, cin, g.device)
  dx = torch.empty((n, h, w, cin), dtype=g.dtype, device=g.device)
  err = _bwd_lib().sphere_conv_bwd_input(
      int(g.dtype == torch.bfloat16), g.data_ptr(), wt.data_ptr(),
      itab.data_ptr(), ftab.data_ptr(), scale.data_ptr(), bias.data_ptr(),
      dx.data_ptr(), n, h, w, cin, cout, reach,
      torch.cuda.current_stream(g.device).cuda_stream)
  if err != 0:
    raise RuntimeError(f"{_BWD_INPUT}: kernel launch failed with CUDA error "
                       f"{err}")
  LAUNCHES[_BWD_INPUT] += 1
  return dx


def _weight_splits(n, h, w, cin, cout, device) -> tuple[int, int]:
  """``(nsplit, chunk)``: the pixel ranges of the dw kernel, about two
  blocks for each SM of the card."""
  pixels = n * h * w
  tiles = -(-_TAPS * cin // 64) * -(-cout // (128 if cout > 64 else 64))
  sms = torch.cuda.get_device_properties(device).multi_processor_count
  nsplit = max(1, min(2 * sms // tiles, -(-pixels // 256)))
  chunk = -(-pixels // nsplit)
  return -(-pixels // chunk), chunk


def _launch_bwd_weight(x, g):
  _check_map(_BWD_WEIGHT, x, "x")
  _check_map(_BWD_WEIGHT, g, "g")
  n, h, w, cin = x.shape
  cout = g.shape[3]
  if g.shape[:3] != x.shape[:3] or g.dtype != x.dtype or g.device != x.device:
    raise ValueError(f"{_BWD_WEIGHT}: g {tuple(g.shape)} {g.dtype} does not "
                     f"match x {tuple(x.shape)} {x.dtype}")
  nsplit, chunk = _weight_splits(n, h, w, cin, cout, x.device)
  itab, ftab = _device_tables("shift", h, w, x.device)
  part = torch.empty((nsplit, _TAPS * cin, cout), device=x.device)
  dw = torch.empty((_TAPS, cin, cout), device=x.device)
  err = _bwd_lib().sphere_conv_bwd_weight(
      int(x.dtype == torch.bfloat16), x.data_ptr(), g.data_ptr(),
      itab.data_ptr(), ftab.data_ptr(), part.data_ptr(), dw.data_ptr(),
      n, h, w, cin, cout, nsplit, chunk,
      torch.cuda.current_stream(x.device).cuda_stream)
  if err != 0:
    raise RuntimeError(f"{_BWD_WEIGHT}: kernel launch failed with CUDA "
                       f"error {err}")
  LAUNCHES[_BWD_WEIGHT] += 1
  return dw


def sphere_conv_bwd_input(g: torch.Tensor, weight: torch.Tensor, *,
                          plain: bool = False) -> torch.Tensor:
  """The gradient of the bare sphere conv's input.

  Args:
    g: ``(N, H, W, Cout)`` cotangent of the conv's output, H = 2W, f32 or
      bf16, contiguous.
    weight: torch ``(Cout, Cin, 3, 3)`` or packed ``(9, Cin, Cout)``, in
      ``g``'s dtype.
    plain: run the plain PyTorch version even on a CUDA tensor.
  Returns:
    dx ``(N, H, W, Cin)`` in ``g.dtype``.
  """
  if plain or g.device.type == "cpu":
    return _plain_bwd_input(g, weight).to(g.dtype)
  if g.device.type != "cuda":
    raise ValueError(f"{_BWD_INPUT}: unsupported device {g.device}")
  return _launch_bwd_input(g, weight)


def sphere_conv_bwd_weight(x: torch.Tensor, g: torch.Tensor, *,
                           plain: bool = False) -> torch.Tensor:
  """The gradient of the bare sphere conv's weight, ``(9, Cin, Cout)`` f32,
  for the forward input ``x`` ``(N, H, W, Cin)`` and the cotangent ``g``
  ``(N, H, W, Cout)`` (same dtype, f32 or bf16, contiguous); summed in f32
  over the pixels in a fixed order."""
  if plain or x.device.type == "cpu":
    return _plain_bwd_weight(x, g)
  if x.device.type != "cuda":
    raise ValueError(f"{_BWD_WEIGHT}: unsupported device {x.device}")
  return _launch_bwd_weight(x, g)


def sphere_conv_backward(x: torch.Tensor, weight: torch.Tensor,
                         g: torch.Tensor, *, plain: bool = False
                         ) -> tuple[torch.Tensor, torch.Tensor]:
  """``(dx, dw)`` of the bare stride-1 3x3 Cassini sphere conv: replaces
  ``sphere_conv_kernel.py:sphere_conv_cassini_pallas_bwd`` (K3b).

  ``x`` ``(N, H, W, Cin)`` and ``g`` ``(N, H, W, Cout)`` in one dtype;
  ``weight`` torch or packed. Returns dx in ``x.dtype`` and dw in f32, in
  the layout of ``weight``. On a CUDA tensor the two kernels of
  ``kernels/csrc/sphere_conv_bwd.cu`` run; on a CPU tensor, or with
  ``plain=True``, their plain versions: the explicit transpose of the
  gather + GEMM of :func:`sphere_conv`.
  """
  _checked_packed(weight, x.shape[-1], x.shape)
  dx = sphere_conv_bwd_input(g, weight.to(g.dtype), plain=plain)
  dw = sphere_conv_bwd_weight(x, g, plain=plain)
  return dx.to(x.dtype), (dw if weight.dim() == 3 else _torch_layout(dw))


def train_kernel_eligible(x_shape) -> bool:
  """Where the JAX package runs its Pallas sphere conv (K3, K3b) in
  training, ``ops/sphere_conv.py:_pallas_eligible`` with its TPU memory
  budget left out: a Cassini map whose H (the TPU's lane axis) is a
  multiple of 128, W a multiple of 8 up to 2048, Cin a multiple of 8."""
  _, h, w, cin = x_shape
  return (h == 2 * w and h % 128 == 0 and w % 8 == 0 and w <= 2048
          and cin % 8 == 0)


class _SphereConv(torch.autograd.Function):
  """The bare conv: forward K3 (scale 1, bias 0, no residual, no ReLU),
  backward the two K3b kernels; their plain versions on the CPU or with
  ``plain``. The weight enters in torch layout and is packed here, so its
  gradient reaches the ``Parameter``."""

  @staticmethod
  def forward(ctx, x, weight, plain):
    x = x.contiguous()
    packed = _checked_packed(weight, x.shape[-1], x.shape).to(x.dtype)
    ctx.save_for_backward(x, packed)
    ctx.plain = plain
    return sphere_conv_bn_act(x, packed, plain=plain)

  @staticmethod
  def backward(ctx, g):
    x, packed = ctx.saved_tensors
    g = g.to(x.dtype).contiguous()
    dx = dw = None
    if ctx.needs_input_grad[0]:
      dx = sphere_conv_bwd_input(g, packed, plain=ctx.plain)
    if ctx.needs_input_grad[1]:
      dw = _torch_layout(sphere_conv_bwd_weight(x, g, plain=ctx.plain))
    return dx, dw, None


def sphere_conv_train(x: torch.Tensor, weight: torch.Tensor, *,
                      plain: bool = False) -> torch.Tensor:
  """The bare sphere conv with its kernels' gradients: ``x`` ``(N, H, W,
  Cin)``, ``weight`` torch ``(Cout, Cin, 3, 3)`` (a ``Parameter``);
  returns ``(N, H, W, Cout)`` in ``x.dtype``."""
  return _SphereConv.apply(x, weight, plain)
