"""The least time the chip could take for a stage of stage 1, from the
model's layers and shapes alone: for each layer ``max(operations / peak
operations, bytes / peak bandwidth)``, summed over the layers.

Operations are the useful MACs (2 operations each) of ``counts/flops.py``'s
combinatorics; a sphere conv counts all nine taps of its gathered GEMM (its
bilinear blend, on the FP32 pipes, is left out). Bytes are each input read
once, each output written once and each weight read once, in the cell's
activation dtype; a residual read, BN and ReLU are left out. Both are lower
bounds of the work, so a share of this least time stays under 100% while the
timed span covers the work. The layers are the program's names for them,
so a later change that renames, fuses or replaces a kernel leaves the work
where it is.

The peaks are NVIDIA's published dense rates for one H100 SXM at 700 W
(the data sheet): 989e12 bf16 tensor-core operations/s, 3.35e12 bytes/s of
HBM3.
"""

from __future__ import annotations

import math

from benchmark.counts.flops import _eff_taps, _eff_taps_deconv

PEAK_OPS_PER_S = {"bfloat16": 989e12, "float16": 989e12,
                  "float32": 495e12 / 3}
PEAK_BYTES_PER_S = 3.35e12
DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


class Layers:
  """Sums the least time of conv layers at one batch and dtype."""

  def __init__(self, batch: int, dtype: str):
    self.b = batch
    self.ops_s = PEAK_OPS_PER_S[dtype]
    self.nbytes = DTYPE_BYTES[dtype]
    self.seconds = 0.0
    self.ops = 0.0
    self.bytes = 0.0

  def add(self, macs: float, elems_in: float, elems_out: float,
          weights: float, elem_bytes: int | None = None) -> None:
    ops = 2.0 * macs
    nbytes = (elems_in + elems_out + weights) * (elem_bytes or self.nbytes)
    self.ops += ops
    self.bytes += nbytes
    self.seconds += max(ops / self.ops_s, nbytes / PEAK_BYTES_PER_S)

  def conv(self, dims, k, s, p, cin, cout, dil=1, dense=False):
    dims_out, taps = [], 1
    for n in dims:
      n_out = (n + 2 * p - dil * (k - 1) - 1) // s + 1
      dims_out.append(n_out)
      taps *= k * n_out if dense else _eff_taps(n, n_out, k, s, p, dil)
    self.add(self.b * taps * cin * cout, self.b * math.prod(dims) * cin,
             self.b * math.prod(dims_out) * cout, cin * cout * k ** len(dims))
    return dims_out

  def deconv(self, dims, k, s, p, op, cin, cout):
    dims_out, taps = [], 1
    for n in dims:
      n_out, t = _eff_taps_deconv(n, k, s, p, op)
      dims_out.append(n_out)
      taps *= t
    self.add(self.b * taps * cin * cout, self.b * math.prod(dims) * cin,
             self.b * math.prod(dims_out) * cout, cin * cout * k ** len(dims))
    return dims_out


def _block(c: Layers, dims, cin, cout, s=1, dil=1, sphere=False):
  pad = dil if dil > 1 else 1
  if sphere:
    out = c.conv(dims, 3, 1, 1, cin, cout, dense=True)
    c.conv(out, 3, 1, 1, cout, cout, dense=True)
  else:
    out = c.conv(dims, 3, s, pad, cin, cout, dil=dil)
    c.conv(out, 3, 1, pad, cout, cout, dil=dil)
  if s != 1 or cin != cout:
    c.conv(dims, 1, s, 0, cin, cout)
  return out


def feature_extraction(c: Layers, h: int, w: int) -> list:
  """The Sphere feature extractor on one batch of views ``(h, w)``."""
  d2 = c.conv([h, w], 7, 2, 3, 3, 32)
  c.conv(d2, 3, 1, 1, 32, 32)
  c.conv(d2, 3, 1, 1, 32, 32)
  _block(c, d2, 32, 64)
  for _ in range(2):
    _block(c, d2, 64, 64)
  d4 = _block(c, d2, 64, 64, s=2)
  for _ in range(7):
    _block(c, d4, 64, 64)
  for _ in range(4):
    _block(c, d4, 64, 64, dil=2)
  _block(c, d4, 64, 128, sphere=True)
  for _ in range(7):
    _block(c, d4, 128, 128, sphere=True)
  c.conv(d4, 1, 1, 0, 256, 128)
  c.conv(d4, 3, 1, 1, 128, 128)
  c.conv(d4, 1, 1, 0, 128, 32)
  return d4


def cost_volume_stack(c: Layers, h: int, w: int, maxdisp: int) -> None:
  """Stage 1 after the feature extractor: the concatenated volume, the 3-D
  stack and heads, and the regression (its logits read in f32, the
  disparity and confidence written in f32)."""
  h4, w4, d = h // 4, w // 4, maxdisp // 4
  vol = [d, h4, w4]
  c.add(0, 2 * c.b * 32 * h4 * w4, c.b * 64 * d * h4 * w4, 0)
  c.conv(vol, 3, 1, 1, 64, 32)
  for _ in range(3):
    c.conv(vol, 3, 1, 1, 32, 32)
  for _ in range(3):
    d8 = c.conv(vol, 3, 2, 1, 32, 64)
    c.conv(d8, 3, 1, 1, 64, 64)
    d16 = c.conv(d8, 3, 2, 1, 64, 64)
    c.conv(d16, 3, 1, 1, 64, 64)
    c.deconv(d16, 3, 2, 1, 1, 64, 64)
    c.deconv(d8, 3, 2, 1, 1, 64, 32)
  for _ in range(3):
    c.conv(vol, 3, 1, 1, 32, 32)
    c.conv(vol, 3, 1, 1, 32, 1)
  c.add(0, c.b * d * h4 * w4, 2 * c.b * h * w, 0, elem_bytes=4)


def stage1_least_s(batch: int, h: int, w: int, maxdisp: int,
                   dtype: str) -> dict:
  """``{"fe": s, "cv": s}``: the least time of one stage-1 call on ``batch``
  pairs, the feature extractor on both views and the rest."""
  fe = Layers(batch, dtype)
  for _ in range(2):
    feature_extraction(fe, h, w)
  cv = Layers(batch, dtype)
  cost_volume_stack(cv, h, w, maxdisp)
  return {"fe": fe.seconds, "cv": cv.seconds}
