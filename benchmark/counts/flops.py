"""Closed-form model-FLOP counts of the MODE networks: a frozen copy of the
program's ``utils/flops.py``, kept here so that the yardstick of every
``mfu`` metric cannot move with the program (``benchmark/tests`` holds the
copy equal to the program's counts).

The architectures are static, so the count is exact combinatorics over the
conv layers: *useful* MACs only (2 flops each): taps that fall on padding
are excluded, and so are the lhs-dilation zeros of transpose convs. BN,
activations, the regression volumes, the bridge, the loss and Adam are left
uncounted; they are sub-percent of the conv MACs.

Training: each conv counts forward + grad-input + grad-weight (3x the
forward MACs; 2x for convs whose input is the image). Recomputation is not
counted.
"""

from __future__ import annotations

import math


def _eff_taps(n_in: int, n_out: int, k: int, s: int, p: int,
              dil: int = 1) -> int:
  """Number of (output position, tap) pairs that read real input along one
  spatial dim — the per-dim factor of the useful-MAC product."""
  total = 0
  for i in range(n_out):
    base = i * s - p
    for j in range(k):
      if 0 <= base + j * dil < n_in:
        total += 1
  return total


def _eff_taps_deconv(n_in: int, k: int, s: int, p: int, op: int):
  """(n_out, useful tap pairs) for a torch-style ConvTranspose dim:
  lhs-dilated conv with pads (k-1-p, k-1-p+op); taps landing on dilation
  zeros or padding are excluded (XLA excludes both)."""
  pad_lo = k - 1 - p
  pad_hi = k - 1 - p + op
  dil_len = (n_in - 1) * s + 1
  n_out = dil_len + pad_lo + pad_hi - k + 1
  total = 0
  for o in range(n_out):
    base = o - pad_lo
    for j in range(k):
      idx = base + j
      if 0 <= idx < dil_len and idx % s == 0:
        total += 1
  return n_out, total


class _Counter:
  """Accumulates (flops_fwd, flops_train) over conv entries."""

  def __init__(self, batch: int):
    self.b = batch
    self.fwd = 0.0
    self.train = 0.0

  def conv(self, dims_in, k, s, p, cin, cout, dil=1, mult=3, dense=False):
    """N-D conv; dims_in spatial sizes. Returns dims_out. ``dense=True``
    counts every tap (the sphere conv's gather-GEMM is a dense matmul —
    out-of-range taps are zeros in the gathered operand, still MACs)."""
    dims = dims_in if isinstance(k, (list, tuple)) else dims_in
    ks = k if isinstance(k, (list, tuple)) else [k] * len(dims_in)
    taps = 1.0
    dims_out = []
    for n_in, kk in zip(dims_in, ks):
      n_out = (n_in + 2 * p - dil * (kk - 1) - 1) // s + 1
      dims_out.append(n_out)
      taps *= (kk * n_out if dense
               else _eff_taps(n_in, n_out, kk, s, p, dil))
    f = 2.0 * self.b * taps * cin * cout
    self.fwd += f
    self.train += mult * f
    return dims_out

  def deconv(self, dims_in, k, s, p, op, cin, cout, mult=3):
    taps = 1.0
    dims_out = []
    for n_in in dims_in:
      n_out, t = _eff_taps_deconv(n_in, k, s, p, op)
      dims_out.append(n_out)
      taps *= t
    f = 2.0 * self.b * taps * cin * cout
    self.fwd += f
    self.train += mult * f
    return dims_out

  def sphere(self, dims_in, cin, cout, mult=3):
    """SphereConv as gathered-im2col dense GEMM + bilinear tap mixing
    (4 corner reads -> 4 mul + 3 add per (position, tap, channel))."""
    self.conv(dims_in, 3, 1, 1, cin, cout, mult=mult, dense=True)
    n = self.b * math.prod(dims_in)
    f = 7.0 * n * 9 * cin
    self.fwd += f
    self.train += mult * f
    return list(dims_in)


def _basic_block(c, dims, cin, feats, s=1, dil=1, sphere=False, mult=3):
  """RegularBasicBlock / SphereBasicBlock / BasicBlockNoRelu conv MACs."""
  if sphere:
    # stride/dilation 1 everywhere layer4 is used (disparity.py:81)
    out = c.sphere(dims, cin, feats, mult=mult)
    c.sphere(out, feats, feats, mult=mult)
  else:
    out = c.conv(dims, 3, s, dil if dil > 1 else 1, cin, feats, dil=dil,
                 mult=mult)
    c.conv(out, 3, 1, dil if dil > 1 else 1, feats, feats, dil=dil,
           mult=mult)
  if s != 1 or cin != feats:
    c.conv(dims, 1, s, 0, cin, feats, mult=mult)   # downsample shortcut
  return out


def _feature_extraction(c, h, w, conv="Sphere"):
  """SphereFeatureExtraction (disparity.py:40-87), one view."""
  assert conv == "Sphere", "flop count implemented for the Sphere FE"
  dims = c.conv([h, w], 7, 2, 3, 3, 32, mult=2)   # image input: no dgrad
  c.conv(dims, 3, 1, 1, 32, 32)
  c.conv(dims, 3, 1, 1, 32, 32)
  # layer1: 3 blocks, 64, stride 1 (first has channel-change downsample)
  d1 = _basic_block(c, dims, 32, 64, s=1)
  for _ in range(2):
    _basic_block(c, d1, 64, 64)
  # layer2: 8 blocks, 64, stride 2
  d2 = _basic_block(c, d1, 64, 64, s=2)
  for _ in range(7):
    _basic_block(c, d2, 64, 64)
  # layer3: 4 blocks, 64, dilation 2
  for _ in range(4):
    _basic_block(c, d2, 64, 64, dil=2)
  # layer4: 8 sphere blocks, 128
  d4 = _basic_block(c, d2, 64, 128, sphere=True)
  for _ in range(7):
    _basic_block(c, d4, 128, 128, sphere=True)
  # lastconv on concat(64+64+128)
  c.conv(d2, 1, 1, 0, 256, 128)
  c.conv(d2, 3, 1, 1, 128, 128)
  c.conv(d2, 1, 1, 0, 128, 32)
  return d2


def _hourglass(c, dims4, inplanes=32):
  p2 = inplanes * 2
  d8 = c.conv(dims4, 3, 2, 1, inplanes, p2)        # conv1
  c.conv(d8, 3, 1, 1, p2, p2)                      # conv2
  d16 = c.conv(d8, 3, 2, 1, p2, p2)                # conv3
  c.conv(d16, 3, 1, 1, p2, p2)                     # conv4
  c.deconv(d16, 3, 2, 1, 1, p2, p2)                # conv5
  c.deconv(d8, 3, 2, 1, 1, p2, inplanes)           # conv6


def disparity_flops(b: int, h: int, w: int, maxdisp: int,
                    conv: str = "Sphere") -> dict:
  """{'fwd': eval-forward flops, 'train': train-step flops} for
  ModeDisparity at (b, h, w), maxdisp. Regression / confidence /
  BN / loss / Adam are uncounted (sub-percent of the conv MACs)."""
  c = _Counter(b)
  dims4 = _feature_extraction(c, h, w, conv)
  # second view shares params but re-runs every conv
  _feature_extraction(c, h, w, conv)
  d = maxdisp // 4
  vol = [d] + dims4
  c.conv(vol, 3, 1, 1, 64, 32)                     # dres0.0
  c.conv(vol, 3, 1, 1, 32, 32)                     # dres0.2
  c.conv(vol, 3, 1, 1, 32, 32)                     # dres1.0
  c.conv(vol, 3, 1, 1, 32, 32)                     # dres1.2
  for _ in range(3):
    _hourglass(c, vol, 32)
  for _ in range(3):                               # classif heads
    c.conv(vol, 3, 1, 1, 32, 32)
    c.conv(vol, 3, 1, 1, 32, 1)
  return {"fwd": c.fwd, "train": c.train}


def _fusion_block_pair(c, dims, cin, feats, blocks):
  for i in range(blocks):
    c.conv(dims, 3, 1, 1, cin if i == 0 else feats, feats)
    c.conv(dims, 3, 1, 1, feats, feats)


def fusion_flops(b: int, h: int, w: int,
                 channels=(32, 64, 128, 256)) -> dict:
  """{'fwd', 'train'} for ModeFusion (12ch depth+conf, 12ch rgb) at
  (b, h, w)."""
  c = _Counter(b)
  ch = channels
  s1 = [h, w]
  s2 = [h // 2, w // 2]
  s4 = [h // 4, w // 4]
  s8 = [h // 8, w // 8]
  # depth encoder (image-analog inputs still get full 3x mult: the fusion
  # inputs are stage-1 outputs inside the fused pipeline graph)
  _fusion_block_pair(c, s1, 12, ch[0], 2)
  _fusion_block_pair(c, s2, ch[0], ch[1], 1)
  _fusion_block_pair(c, s4, ch[1], ch[2], 1)
  _fusion_block_pair(c, s8, ch[2], ch[3], 1)
  c.deconv(s8, 2, 2, 0, 0, ch[3], ch[3] // 2)      # depth_layer4.2
  # rgb encoder
  _fusion_block_pair(c, s1, 12, ch[0], 2)
  _fusion_block_pair(c, s2, ch[0], ch[1], 1)
  _fusion_block_pair(c, s4, ch[1], ch[2], 1)
  # per-scale fusion
  _fusion_block_pair(c, s1, 2 * ch[0], ch[0], 2)
  _fusion_block_pair(c, s2, 2 * ch[1], ch[1], 2)
  _fusion_block_pair(c, s4, 2 * ch[2], ch[2], 2)
  # decoder
  _fusion_block_pair(c, s4, 2 * ch[2], ch[2], 1)
  c.deconv(s4, 2, 2, 0, 0, ch[2], ch[2] // 2)
  _fusion_block_pair(c, s2, ch[1] + ch[2] // 2, ch[1], 1)
  c.deconv(s2, 2, 2, 0, 0, ch[1], ch[1] // 2)
  _fusion_block_pair(c, s1, ch[0] + ch[1] // 2, ch[0], 2)
  c.conv(s1, 1, 1, 0, ch[0], 1)
  return {"fwd": c.fwd, "train": c.train}


def pipeline_flops(h: int = 1024, w: int = 512, maxdisp: int = 192) -> float:
  """Model FLOPs of one production frame: 6 stereo pairs through
  ModeDisparity + ModeFusion (the bridge's resampling/z-buffer work is
  gather/scatter, not MACs)."""
  return (6 * disparity_flops(1, h, w, maxdisp)["fwd"]
          + fusion_flops(1, h, w)["fwd"])
