"""MODE's two networks in plain PyTorch, NCHW, float32: the yardstick that
decides ``correct``.

The layers follow the reference implementation (nju-ee/MODE-2022,
``models/mode_disparity.py``, ``models/mode_fusion.py``,
``models/basic/spherical_conv/``) and carry its ``state_dict`` keys, so one
reference-layout state dict loads into these modules and into the program
under test alike. Departures from the reference, none of which changes what
is computed: the sphere conv is a bilinear gather of its four corners
(``reference/sphere.py``) and one matmul, not a CUDA im2col; tensors are
made on the input's device; the training forward may rematerialise blocks
(``checkpoint=True``) so that a batch of 16 fits on one card.

Every conv takes its input and weight through ``quant`` (identity, or the
8-bit float rounding of ``reference/precision.py`` that makes the control).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from benchmark.reference.sphere import gather_tables


def _identity(x):
  return x


class QConv2d(nn.Conv2d):
  quant = staticmethod(_identity)

  def forward(self, x):
    return self._conv_forward(self.quant(x), self.quant(self.weight),
                              self.bias)


class QConv3d(nn.Conv3d):
  quant = staticmethod(_identity)

  def forward(self, x):
    return self._conv_forward(self.quant(x), self.quant(self.weight),
                              self.bias)


class QConvTranspose3d(nn.ConvTranspose3d):
  quant = staticmethod(_identity)

  def forward(self, x):
    return F.conv_transpose3d(self.quant(x), self.quant(self.weight),
                              self.bias, self.stride, self.padding,
                              self.output_padding, self.groups,
                              self.dilation)


class QConvTranspose2d(nn.ConvTranspose2d):
  quant = staticmethod(_identity)

  def forward(self, x):
    return F.conv_transpose2d(self.quant(x), self.quant(self.weight),
                              self.bias, self.stride, self.padding,
                              self.output_padding, self.groups,
                              self.dilation)


class SphereConv(nn.Module):
  """The reference's sphere conv: each output pixel's 3x3 taps sampled
  bilinearly at gnomonic positions, then one product with the weight."""
  quant = staticmethod(_identity)

  def __init__(self, in_height, in_width, sphere_type, in_ch, out_ch,
               stride=1, pad=1, dilation=1):
    super().__init__()
    self.geometry = (in_height, in_width, sphere_type, stride, pad, dilation)
    self.weight = nn.Parameter(torch.empty(out_ch, in_ch, 3, 3))
    self._tables = {}

  def tables(self, device):
    if device not in self._tables:
      h, w, st, s, p, d = self.geometry
      idx, wgt = gather_tables(h, w, 3, st, s, p, d)
      self._tables[device] = (torch.from_numpy(idx).to(device),
                              torch.from_numpy(wgt).to(device))
    return self._tables[device]

  def forward(self, x):
    idx, wgt = self.tables(x.device)
    x = self.quant(x)
    n, c, h, w = x.shape
    k2, ho, wo = idx.shape[1:]
    xf = x.reshape(n, c, h * w)
    col = None
    for corner in range(4):
      g = xf[:, :, idx[corner].reshape(-1)].reshape(n, c, k2, ho, wo)
      g = g * wgt[corner]
      col = g if col is None else col + g
    wmat = self.quant(self.weight).reshape(self.weight.shape[0], c * k2)
    out = torch.matmul(wmat, col.reshape(n, c * k2, ho * wo))
    return out.reshape(n, -1, ho, wo)


def convbn(inp, out, k, stride, pad, dilation):
  return nn.Sequential(
      QConv2d(inp, out, kernel_size=k, stride=stride,
              padding=dilation if dilation > 1 else pad, dilation=dilation,
              bias=False),
      nn.BatchNorm2d(out))


def convbn_3d(inp, out, k, stride, pad):
  return nn.Sequential(
      QConv3d(inp, out, kernel_size=k, padding=pad, stride=stride,
              bias=False),
      nn.BatchNorm3d(out))


def _downsample(inplanes, planes, stride):
  return nn.Sequential(
      QConv2d(inplanes, planes, kernel_size=1, stride=stride, bias=False),
      nn.BatchNorm2d(planes))


class BasicBlock(nn.Module):
  """PSMNet's residual block, with 2-D or sphere convs."""

  def __init__(self, conv1, conv2, downsample):
    super().__init__()
    self.conv1 = nn.Sequential(conv1, nn.ReLU(inplace=True))
    self.conv2 = conv2
    self.downsample = downsample

  def forward(self, x):
    out = self.conv2(self.conv1(x))
    if self.downsample is not None:
      x = self.downsample(x)
    return F.relu(out + x)


def _layer(inplanes, planes, blocks, stride, pad, dilation, sphere=None):
  downsample = None
  if stride != 1 or inplanes != planes:
    downsample = _downsample(inplanes, planes, stride)
  layers = []
  for i in range(blocks):
    cin, s = (inplanes, stride) if i == 0 else (planes, 1)
    if sphere is None:
      c1 = convbn(cin, planes, 3, s, pad, dilation)
      c2 = convbn(planes, planes, 3, 1, pad, dilation)
    else:
      h, w, st = sphere
      c1 = nn.Sequential(SphereConv(h, w, st, cin, planes, s, pad, dilation),
                         nn.BatchNorm2d(planes))
      c2 = nn.Sequential(SphereConv(h // s, w // s, st, planes, planes, 1,
                                    pad, dilation), nn.BatchNorm2d(planes))
    layers.append(BasicBlock(c1, c2, downsample if i == 0 else None))
  return nn.Sequential(*layers)


class SphereFeatureExtraction(nn.Module):
  def __init__(self, in_height, in_width, sphere_type):
    super().__init__()
    self.firstconv = nn.Sequential(
        convbn(3, 32, 7, 2, 3, 1), nn.ReLU(inplace=True),
        convbn(32, 32, 3, 1, 1, 1), nn.ReLU(inplace=True),
        convbn(32, 32, 3, 1, 1, 1), nn.ReLU(inplace=True))
    self.layer1 = _layer(32, 64, 3, 1, 1, 1)
    self.layer2 = _layer(64, 64, 8, 2, 1, 1)
    self.layer3 = _layer(64, 64, 4, 1, 1, 2)
    self.layer4 = _layer(64, 128, 8, 1, 1, 1,
                         sphere=(in_height // 4, in_width // 4, sphere_type))
    self.lastconv = nn.Sequential(
        convbn(256, 128, 1, 1, 0, 1), nn.ReLU(inplace=True),
        convbn(128, 128, 3, 1, 1, 1), nn.ReLU(inplace=True),
        convbn(128, 32, 1, 1, 0, 1), nn.ReLU(inplace=True))

  def forward(self, x):
    out = self.layer1(self.firstconv(x))
    raw = self.layer2(out)
    reg = self.layer3(raw)
    sph = self.layer4(reg)
    return self.lastconv(torch.cat((raw, reg, sph), 1))


class Hourglass(nn.Module):
  def __init__(self, inplanes):
    super().__init__()
    p2 = inplanes * 2
    self.conv1 = nn.Sequential(convbn_3d(inplanes, p2, 3, 2, 1),
                               nn.ReLU(inplace=True))
    self.conv2 = convbn_3d(p2, p2, 3, 1, 1)
    self.conv3 = nn.Sequential(convbn_3d(p2, p2, 3, 2, 1),
                               nn.ReLU(inplace=True))
    self.conv4 = nn.Sequential(convbn_3d(p2, p2, 3, 1, 1),
                               nn.ReLU(inplace=True))
    self.conv5 = nn.Sequential(
        QConvTranspose3d(p2, p2, 3, padding=1, output_padding=1, stride=2,
                         bias=False), nn.BatchNorm3d(p2))
    self.conv6 = nn.Sequential(
        QConvTranspose3d(p2, inplanes, 3, padding=1, output_padding=1,
                         stride=2, bias=False), nn.BatchNorm3d(inplanes))

  def forward(self, x, presqu, postsqu):
    out = self.conv1(x)
    pre = self.conv2(out)
    pre = F.relu(pre + postsqu) if postsqu is not None else F.relu(pre)
    out = self.conv4(self.conv3(pre))
    skip = presqu if presqu is not None else pre
    post = F.relu(self.conv5(out) + skip)
    return self.conv6(post), pre, post


def _classif():
  return nn.Sequential(convbn_3d(32, 32, 3, 1, 1), nn.ReLU(inplace=True),
                       QConv3d(32, 1, 3, padding=1, stride=1, bias=False))


class ModeDisparity(nn.Module):
  """Stage 1: the Sphere feature extractor on both views, the concatenated
  cost volume at 1/4, three stacked hourglasses, three classifier heads and
  the soft-argmin over ``maxdisp`` levels; with ``out_conf`` the confidence
  of the reference's verbatim grid_sample formulation."""

  def __init__(self, maxdisp, in_height, in_width, sphere_type="Cassini",
               out_conf=False, checkpoint=False):
    super().__init__()
    self.maxdisp = maxdisp
    self.out_conf = out_conf
    self.checkpoint = checkpoint
    self.feature_extraction = SphereFeatureExtraction(in_height, in_width,
                                                      sphere_type)
    self.dres0 = nn.Sequential(convbn_3d(64, 32, 3, 1, 1),
                               nn.ReLU(inplace=True),
                               convbn_3d(32, 32, 3, 1, 1),
                               nn.ReLU(inplace=True))
    self.dres1 = nn.Sequential(convbn_3d(32, 32, 3, 1, 1),
                               nn.ReLU(inplace=True),
                               convbn_3d(32, 32, 3, 1, 1))
    self.dres2 = Hourglass(32)
    self.dres3 = Hourglass(32)
    self.dres4 = Hourglass(32)
    self.classif1 = _classif()
    self.classif2 = _classif()
    self.classif3 = _classif()

  def _run(self, fn, *args):
    if self.checkpoint and self.training:
      return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)

  def forward(self, left, right):
    ref = self._run(self.feature_extraction, left)
    tgt = self._run(self.feature_extraction, right)
    b, c, h, w = ref.shape
    levels = self.maxdisp // 4
    cost = ref.new_zeros(b, c * 2, levels, h, w)
    for i in range(levels):
      if i > 0:
        cost[:, :c, i, :, i:] = ref[:, :, :, i:]
        cost[:, c:, i, :, i:] = tgt[:, :, :, :-i]
      else:
        cost[:, :c, i] = ref
        cost[:, c:, i] = tgt
    cost0 = self._run(self.dres0, cost)
    cost0 = self._run(self.dres1, cost0) + cost0
    out1, pre1, post1 = self._run(self.dres2, cost0, None, None)
    out1 = out1 + cost0
    out2, pre2, post2 = self._run(self.dres3, out1, pre1, post1)
    out2 = out2 + cost0
    out3, _, _ = self._run(self.dres4, out2, pre1, post2)
    out3 = out3 + cost0
    cost1 = self._run(self.classif1, out1)
    cost2 = self._run(self.classif2, out2) + cost1
    cost3 = self._run(self.classif3, out3) + cost2
    full = (self.maxdisp, left.shape[2], left.shape[3])
    if self.training:
      return tuple(self._run(self._regress, cst, full)[1]
                   for cst in (cost1, cost2, cost3))
    prob3, pred3 = self._regress(cost3, full)
    if not self.out_conf:
      return pred3
    return pred3, self._confidence(prob3, pred3)

  def _regress(self, cost, full):
    up = F.interpolate(cost, full, mode="trilinear", align_corners=True)
    prob = F.softmax(up.squeeze(1), dim=1)
    disp = torch.arange(self.maxdisp, device=cost.device,
                        dtype=prob.dtype).reshape(1, -1, 1, 1)
    return prob, torch.sum(prob * disp, 1)

  def _confidence(self, prob, pred):
    """The probability mass at the rounded disparity and its two
    neighbours, as the reference samples it (``mode_disparity.py:157-183``:
    nearest ``grid_sample`` of the volume, border padding)."""
    b, h, w = pred.shape
    dev = pred.device
    r = torch.round(pred)[:, None, :, :, None]       # (B, 1, H, W, 1)
    gh, gw = torch.meshgrid(torch.arange(h, device=dev),
                            torch.arange(w, device=dev), indexing="ij")
    gh = (gh / (h - 1.0) * 2 - 1).float()[None, None, :, :, None]
    gw = (gw / (w - 1.0) * 2 - 1).float()[None, None, :, :, None]
    gh, gw = gh.expand(b, 1, h, w, 1), gw.expand(b, 1, h, w, 1)
    total = 0
    for off in (0.0, -1.0, 1.0):
      gd = (r + off) / (self.maxdisp - 1.0) * 2 - 1
      grid = torch.cat([gw, gh, gd], dim=-1)
      total = total + F.grid_sample(prob[:, None], grid, align_corners=True,
                                    padding_mode="border", mode="nearest")
    return total[:, 0, 0]


class FusionBlock(nn.Module):
  """The fusion net's BasicBlock: two conv-BN-ReLU, no residual; the
  ``downsample`` the reference builds is never run."""

  def __init__(self, inplanes, planes, downsample):
    super().__init__()
    self.conv1 = nn.Sequential(convbn(inplanes, planes, 3, 1, 1, 1),
                               nn.ReLU(inplace=True))
    self.conv2 = nn.Sequential(convbn(planes, planes, 3, 1, 1, 1),
                               nn.ReLU(inplace=True))
    self.downsample = downsample

  def forward(self, x):
    return self.conv2(self.conv1(x))


class FusionFeatures(nn.Module):
  """``feature_extraction_MODE_Fusion``: depth and RGB encoders, per-scale
  fusion, a decoder of k2 s2 transpose convs and a sigmoid x max_depth head.
  The 1x1 head stays f32 in every precision (``head_quant``)."""

  def __init__(self, maxdepth, channels, depth_in=12, rgb_in=12):
    super().__init__()
    ch = channels

    def run(inp, planes, blocks, pre=(), post=()):
      ds = _downsample(inp, planes, 1) if inp != planes else None
      layers = list(pre) + [FusionBlock(inp, planes, ds)]
      layers += [FusionBlock(planes, planes, None)
                 for _ in range(1, blocks)]
      return nn.Sequential(*layers, *post)

    def up(cin):
      return [QConvTranspose2d(cin, cin // 2, 2, 2), nn.BatchNorm2d(cin // 2),
              nn.ReLU(inplace=True)]

    pool = [nn.MaxPool2d(2, 2)]
    self.depth_layer1 = run(depth_in, ch[0], 2)
    self.depth_layer2 = run(ch[0], ch[1], 1, pre=pool)
    self.depth_layer3 = run(ch[1], ch[2], 1, pre=pool)
    self.rgb_layer1 = run(rgb_in, ch[0], 2)
    self.rgb_layer2 = run(ch[0], ch[1], 1, pre=pool)
    self.rgb_layer3 = run(ch[1], ch[2], 1, pre=pool)
    self.fusion_layer1 = run(2 * ch[0], ch[0], 2)
    self.fusion_layer2 = run(2 * ch[1], ch[1], 2)
    self.fusion_layer3 = run(2 * ch[2], ch[2], 2)
    self.depth_layer4 = run(ch[2], ch[3], 1, pre=pool, post=up(ch[3]))
    self.depth_layer5 = run(ch[3], ch[2], 1, post=up(ch[2]))
    self.depth_layer6 = run(ch[2], ch[1], 1, post=up(ch[1]))
    self.depth_layer7 = run(ch[1], ch[0], 2,
                            post=[nn.Conv2d(ch[0], 1, 1, bias=True),
                                  nn.Sigmoid()])
    self.maxdepth = float(maxdepth)

  def forward(self, depth_input, rgb_input):
    d1 = self.depth_layer1(depth_input)
    d2 = self.depth_layer2(d1)
    d3 = self.depth_layer3(d2)
    d4 = self.depth_layer4(d3)
    r1 = self.rgb_layer1(rgb_input)
    r2 = self.rgb_layer2(r1)
    r3 = self.rgb_layer3(r2)
    f1 = self.fusion_layer1(torch.cat((d1, r1), 1))
    f2 = self.fusion_layer2(torch.cat((d2, r2), 1))
    f3 = self.fusion_layer3(torch.cat((d3, r3), 1))
    d5 = self.depth_layer5(torch.cat((f3, d4), 1))
    d6 = self.depth_layer6(torch.cat((f2, d5), 1))
    d7 = self.depth_layer7(torch.cat((f1, d6), 1))
    return d7 * self.maxdepth


class ModeFusion(nn.Module):
  def __init__(self, maxdepth=1000.0, channels=(32, 64, 128, 256)):
    super().__init__()
    self.feature_extraction = FusionFeatures(maxdepth, channels)

  def forward(self, depths, confs, rgbs):
    """Six ``(B, 1, H, W)`` depths and confidences, four ``(B, 3, H, W)``
    normalised views; returns ``(B, 1, H, W)`` metres."""
    dc = [t for pair in zip(depths, confs) for t in pair]
    return self.feature_extraction(torch.cat(dc, 1), torch.cat(rgbs, 1))

  def head(self) -> nn.Conv2d:
    return self.feature_extraction.depth_layer7[-2]


def set_quant(model: nn.Module, quant) -> nn.Module:
  """Route every conv of ``model`` but the fusion net's f32 1x1 head through
  ``quant``."""
  kinds = (QConv2d, QConv3d, QConvTranspose2d, QConvTranspose3d, SphereConv)
  for m in model.modules():
    if isinstance(m, kinds):
      m.quant = quant
  return model

