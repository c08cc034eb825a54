"""MODE stage 1: omnidirectional stereo matching
(``mode_tpu/models/disparity.py``).

A shared feature extractor (the sphere one of ``conv="Sphere"``, the
default, or PSMNet's of ``conv="Regular"``), the concat-shift cost volume,
three stacked 3-D hourglasses with additive deep supervision, and the fused
regression head (trilinear upsample, softmax, soft-argmin, confidence).
Images are NHWC, cost volumes NDHWC, outputs ``(B, H, W)``, as in the JAX
package. The 3-D stack and the head run the CUDA kernels of
``ops/conv3d.py`` and ``ops/regression.py``, the sphere convs that of
``ops/sphere_conv.py``.

The feature extractors' 2-D convs run the fused kernel of ``ops/conv2d.py``
exactly where the JAX package runs its 2-D band kernels at the same batch:
at batch 1, the Sphere stem's ``firstconv.2`` and ``.4``
(``conv2d_band_pallas``); at batch >= 2, every stride-1 3x3 conv of either
feature extractor (``conv2d_band_bpack``). The others run ``F.conv2d``, as
the JAX package leaves them to XLA.

In training (``model.train()``) the forward returns the three deep-
supervision predictions. Each layer runs its training path
(``models/blocks.py``: batch-statistic BN, the kernels' autograd Functions
where the JAX package trains on Pallas). The three full-resolution heads
(trilinear upsample, f32 softmax, soft-argmin) run in plain PyTorch under
``torch.utils.checkpoint``, as the JAX package runs them in XLA under
``jax.checkpoint``: K2 has no backward, and each head's softmax volume
(maxdisp x H x W f32 per example) is recomputed in the backward rather than
kept. With ``remat`` (the default, as in the JAX package) the feature
extractor (each view's call) and the three hourglasses are rematerialised
too (``remat.py``): under ``remat_policy="save_convs"`` they keep only their
convs' outputs and rerun their BN, residual and ReLU tails in the backward,
under ``"full"`` they keep nothing and rerun their convs as well.

Under ``with activate(make_mesh(data=D, spatial=S)):`` (``parallel/``, one
process a card) each rank runs the feature extractor whole on its rows of
the batch (the sphere convs need whole maps), builds its rows of the cost
volume's H from its rows of the features (the volume shifts along W, so
slicing H first is exact), runs the 3-D stack on them
(``parallel/shard_ops.py``: a halo exchange per conv) and the regression
head on its output rows, and returns its ``(B / D, H / S, W)`` rows:
``mesh.gather_rows`` (then ``global_batch_from_local``) makes the frame.
In training the three heads do the same: the quarter-resolution logits
gathered over the spatial group (one all-gather, whose backward sums the
gradient over the group), then only this rank's output rows expanded,
through those rows of the H resize matrix.

The forward opens the tracer's spans (``utils/profiling.py``)
``stage1.features`` (each feature extractor call), ``stage1.cost_volume``,
``stage1.aggregation`` (``dres0`` to ``classif3``) and
``stage1.regression`` (the heads).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mode_tpu_torch import remat as rematerialisation
from mode_tpu_torch.device import ieee_f32_convs, resolve_device
from mode_tpu_torch.models.blocks import (BasicBlockNoRelu, Classif,
                                          ConvBn3d, DeconvBn3d,
                                          RegularBasicBlock, SphereBasicBlock,
                                          convbn, init_weights)
from mode_tpu_torch.ops.cost_volume import build_cost_volume
from mode_tpu_torch.ops.regression import (disparity_regression,
                                           fused_disparity_regression)
from mode_tpu_torch.ops.resize import interpolate, upsample_trilinear
from mode_tpu_torch.parallel.mesh import (constrain_spatial, gather_rows,
                                          row_sharding, spatial_mesh)
from mode_tpu_torch.parallel.shard_ops import regression_sharded
from mode_tpu_torch.utils.profiling import span


def _stage(block, cin: int, cout: int, blocks: int, stride: int,
           dilation: int) -> nn.Sequential:
  layers = [block(cin, cout, stride, 1, dilation,
                  has_downsample=(stride != 1 or cin != cout))]
  layers += [block(cout, cout, 1, 1, dilation) for _ in range(1, blocks)]
  return nn.Sequential(*layers)


def _run(stage: nn.Sequential, x: torch.Tensor, **kw) -> torch.Tensor:
  for block in stage:
    x = block(x, **kw)
  return x


def _stem(firstconv: nn.Sequential, x: torch.Tensor, fused: bool,
          plain: bool) -> torch.Tensor:
  """``firstconv``: a strided conv, then two stride-1 3x3 convs, each with
  BN and ReLU; ``fused`` runs the latter two through the 2-D kernel."""
  x = firstconv[0](x, relu=True)
  x = firstconv[2](x, relu=True, fused=fused, plain=plain)
  return firstconv[4](x, relu=True, fused=fused, plain=plain)


class SphereFeatureExtraction(nn.Module):
  """The ``conv="Sphere"`` feature extractor: a 7x7 stride-2 stem, three
  regular residual stages (dilation 2 in the third), a stage of 8 sphere
  residual blocks, and ``concat(64 + 64 + 128)`` through ``lastconv`` (1x1,
  3x3, 1x1, each with BN and ReLU): ``(B, H, W, 3)`` -> ``(B, H/4, W/4,
  32)``. ``sphere_type`` is the panoramas' layout, ``"Cassini"`` (H = 2W)
  or ``"ERP"`` (W = 2H); only the sphere convs of layer 4 depend on it, and
  the parameters are the same for both."""

  def __init__(self, sphere_type: str = "Cassini"):
    super().__init__()
    self.firstconv = nn.Sequential(
        convbn(3, 32, 7, 2, 3, 1), nn.ReLU(),
        convbn(32, 32, 3, 1, 1, 1), nn.ReLU(),
        convbn(32, 32, 3, 1, 1, 1), nn.ReLU())
    self.layer1 = _stage(RegularBasicBlock, 32, 64, 3, 1, 1)
    self.layer2 = _stage(RegularBasicBlock, 64, 64, 8, 2, 1)
    self.layer3 = _stage(RegularBasicBlock, 64, 64, 4, 1, 2)
    self.layer4 = nn.Sequential(
        SphereBasicBlock(64, 128, has_downsample=True,
                         sphere_type=sphere_type),
        *[SphereBasicBlock(128, 128, sphere_type=sphere_type)
          for _ in range(7)])
    self.lastconv = nn.Sequential(
        convbn(256, 128, 1, 1, 0, 1), nn.ReLU(),
        convbn(128, 128, 3, 1, 1, 1), nn.ReLU(),
        convbn(128, 32, 1, 1, 0, 1), nn.ReLU())

  def forward(self, x: torch.Tensor, *, plain: bool = False) -> torch.Tensor:
    fused = x.shape[0] > 1
    # the stem's 3x3 convs take the 2-D kernel at every batch (K8 at 1)
    x = _stem(self.firstconv, x.permute(0, 3, 1, 2), True, plain)
    x = _run(self.layer1, x, fused=fused, plain=plain)
    out_raw = _run(self.layer2, x, fused=fused, plain=plain)
    out_reg = _run(self.layer3, out_raw, fused=fused, plain=plain)
    out_sph = _run(self.layer4, out_reg, plain=plain)
    feat = torch.cat([out_raw, out_reg, out_sph], dim=1)
    feat = self.lastconv[0](feat, relu=True)
    feat = self.lastconv[2](feat, relu=True, fused=fused, plain=plain)
    return self.lastconv[4](feat, relu=True).permute(0, 2, 3, 1)


class PSMNetFeatureExtraction(nn.Module):
  """The ``conv="Regular"`` feature extractor: PSMNet's residual stages and
  spatial-pyramid pooling, ``(B, H, W, 3)`` -> ``(B, H/4, W/4, 32)``."""

  def __init__(self):
    super().__init__()
    self.firstconv = nn.Sequential(
        convbn(3, 32, 3, 2, 1, 1), nn.ReLU(),
        convbn(32, 32, 3, 1, 1, 1), nn.ReLU(),
        convbn(32, 32, 3, 1, 1, 1), nn.ReLU())
    self.layer1 = _stage(BasicBlockNoRelu, 32, 32, 3, 1, 1)
    self.layer2 = _stage(BasicBlockNoRelu, 32, 64, 16, 2, 1)
    self.layer3 = _stage(BasicBlockNoRelu, 64, 128, 3, 1, 1)
    self.layer4 = _stage(BasicBlockNoRelu, 128, 128, 3, 1, 2)
    for i, pool in enumerate((64, 32, 16, 8)):
      self.add_module(f"branch{i + 1}", nn.Sequential(
          nn.AvgPool2d(pool, pool), convbn(128, 32, 1, 1, 0, 1), nn.ReLU()))
    self.lastconv = nn.Sequential(convbn(320, 128, 3, 1, 1, 1), nn.ReLU(),
                                  nn.Conv2d(128, 32, 1, bias=False))

  def forward(self, x: torch.Tensor, *, plain: bool = False) -> torch.Tensor:
    fused = x.shape[0] > 1
    x = _stem(self.firstconv, x.permute(0, 3, 1, 2), fused, plain)
    x = _run(self.layer1, x, fused=fused, plain=plain)
    out_raw = _run(self.layer2, x, fused=fused, plain=plain)
    out_skip = _run(self.layer3, out_raw, fused=fused, plain=plain)
    out_skip = _run(self.layer4, out_skip, fused=fused, plain=plain)
    h, w = out_skip.shape[2:]
    branches = [interpolate(branch(out_skip), {2: h, 3: w})
                for branch in (self.branch4, self.branch3, self.branch2,
                               self.branch1)]
    feat = torch.cat([out_raw, out_skip, *branches], dim=1)
    feat = self.lastconv[0](feat, relu=True, fused=fused, plain=plain)
    last = self.lastconv[2]               # a bare 1x1 conv, in feat's dtype
    return rematerialisation.library_conv(
        F.conv2d, feat, last.weight.to(feat.dtype)).permute(0, 2, 3, 1)


class Hourglass(nn.Module):
  """3-D hourglass, eval, on NDHWC volumes: returns ``(out, pre, post)``."""

  def __init__(self, inplanes: int):
    super().__init__()
    p2 = inplanes * 2
    self.conv1 = nn.Sequential(ConvBn3d(inplanes, p2, 2), nn.ReLU())
    self.conv2 = ConvBn3d(p2, p2)
    self.conv3 = nn.Sequential(ConvBn3d(p2, p2, 2), nn.ReLU())
    self.conv4 = nn.Sequential(ConvBn3d(p2, p2), nn.ReLU())
    self.conv5 = DeconvBn3d(p2, p2)
    self.conv6 = DeconvBn3d(p2, inplanes)

  def forward(self, x, presqu, postsqu, *, plain: bool = False):
    out = self.conv1[0](x, relu=True, plain=plain)                 # 1/8
    pre = self.conv2(out, postsqu, relu=True, plain=plain)         # 1/8
    out = self.conv3[0](pre, relu=True, plain=plain)               # 1/16
    out = self.conv4[0](out, relu=True, plain=plain)               # 1/16
    post = self.conv5(out, pre if presqu is None else presqu, relu=True,
                      plain=plain)                                 # 1/8
    return self.conv6(post, plain=plain), pre, post                # 1/4


def _regress(cost: torch.Tensor, maxdisp: int, h: int, w: int,
             rows: slice | None = None) -> torch.Tensor:
  """A training head: ``(B, D, Hq, Wq)`` logits -> ``(B, h, w)`` f32
  prediction (trilinear upsample, f32 softmax, soft-argmin); ``rows``:
  those rows of the prediction only."""
  up = upsample_trilinear(cost[..., None], maxdisp, h, w, rows)[..., 0]
  up = up.to(torch.promote_types(up.dtype, torch.float32))
  return disparity_regression(torch.softmax(up, dim=1), maxdisp)


class ModeDisparity(nn.Module):
  """Stage-1 network. In eval mode (the default) ``forward(left, right)``
  with NHWC images returns ``pred``, or ``(pred, conf)`` when ``out_conf``,
  each ``(B, H, W)`` f32, at any batch; after ``train()`` it returns the
  three deep-supervision predictions ``(pred1, pred2, pred3)``.

  ``conv="Sphere"`` (the default) builds the sphere feature extractor on
  Cassini panoramas (H = 2W), or with ``sphere_type="ERP"`` on
  equirectangular ones (W = 2H); the two have the same parameters.
  ``conv="Regular"`` builds PSMNet's. ``remat`` and ``remat_policy``
  (``"save_convs"`` or ``"full"``) are the JAX model's fields of the same
  names: how the training forward rematerialises the feature extractor
  and the hourglasses (module docstring). The weights are drawn
  from ``generator`` (seed 0 if None) as the reference initialises them;
  load trained ones with ``load_state_dict`` (reference torch keys, see
  ``utils/convert.py``). ``device`` defaults to the CUDA card and raises
  without one; pass ``"cpu"`` to run the plain PyTorch path on the CPU.
  """

  def __init__(self, maxdisp: int = 192, conv: str = "Sphere",
               sphere_type: str = "Cassini", out_conf: bool = False, *,
               remat: bool = True, remat_policy: str = "save_convs",
               device: str | torch.device | None = None,
               generator: torch.Generator | None = None):
    super().__init__()
    if remat_policy not in rematerialisation.POLICIES:
      raise ValueError(f"remat_policy must be one of "
                       f"{rematerialisation.POLICIES}, got {remat_policy!r}")
    self.remat = remat
    self.remat_policy = remat_policy
    if conv == "Sphere":
      fe = SphereFeatureExtraction(sphere_type)
    elif conv == "Regular":
      fe = PSMNetFeatureExtraction()
    else:
      raise NotImplementedError("Convolution Type must be Regular or Sphere!")
    self.maxdisp = maxdisp
    self.out_conf = out_conf
    self.feature_extraction = fe
    self.dres0 = nn.Sequential(ConvBn3d(64, 32), nn.ReLU(),
                               ConvBn3d(32, 32), nn.ReLU())
    self.dres1 = nn.Sequential(ConvBn3d(32, 32), nn.ReLU(),
                               ConvBn3d(32, 32))
    self.dres2 = Hourglass(32)
    self.dres3 = Hourglass(32)
    self.dres4 = Hourglass(32)
    self.classif1 = Classif(32)
    self.classif2 = Classif(32)
    self.classif3 = Classif(32)
    if generator is None:
      generator = torch.Generator().manual_seed(0)
    init_weights(self, generator)
    self.device = resolve_device(device)
    self.to(self.device)
    self.eval()

  def forward(self, left: torch.Tensor, right: torch.Tensor, *,
              plain: bool = False):
    """``left``/``right``: ``(B, H, W, 3)`` on the model's device.
    ``plain=True`` runs the kernels' plain PyTorch versions instead (a
    reference for the kernels on the card). The library convs run in IEEE
    f32 (``device.ieee_f32_convs``), whatever cuDNN's TF32 flag says. Under
    a spatial mesh the outputs are this rank's rows (module docstring)."""
    if left.device != self.device or right.device != self.device:
      raise ValueError(f"inputs on {left.device}/{right.device}, model on "
                       f"{self.device}")
    h, w = left.shape[1:3]
    with ieee_f32_convs():
      if self.training:
        costs = self._costs(left, right, plain)
        with span("stage1.regression"):
          mesh, rows = spatial_mesh(), None
          if mesh is not None:      # every rank's logits, this rank's rows
            costs = gather_rows(torch.stack(costs), 3, mesh).unbind()
            rows = row_sharding(mesh, h)
          return tuple(rematerialisation.checkpoint(
              _regress, cost, self.maxdisp, h, w, rows) for cost in costs)
      with torch.no_grad():
        cost3 = self._costs(left, right, plain)[2]
        with span("stage1.regression"):
          mesh = spatial_mesh()
          if mesh is not None:
            pred, conf = regression_sharded(cost3, self.maxdisp, h, w,
                                            mesh=mesh, plain=plain)
          else:
            pred, conf = fused_disparity_regression(cost3, self.maxdisp, h,
                                                    w, plain=plain)
    return (pred, conf) if self.out_conf else pred

  def _remat(self, block, *args, **kwargs):
    """``block(*args, **kwargs)``, rematerialised in training when
    ``remat`` says so."""
    if self.training and self.remat:
      return rematerialisation.rematerialise(block, self.remat_policy, *args,
                                             **kwargs)
    return block(*args, **kwargs)

  def _costs(self, left, right, plain):
    """The three classifiers' summed logits ``(B, D, Hq, Wq)``."""
    fe = self.feature_extraction
    feats = []
    for x in (left, right):
      with span("stage1.features"):
        feats.append(self._remat(fe, x, plain=plain))
    with span("stage1.cost_volume"):
      # this rank's rows of H under a spatial mesh (the whole maps otherwise)
      cost = build_cost_volume(*(constrain_spatial(f, 1) for f in feats),
                               self.maxdisp // 4)
    with span("stage1.aggregation", time_launches=True):
      return self._aggregate(cost, plain)

  def _aggregate(self, cost, plain):
    """``dres0`` to ``classif3`` on the cost volume."""
    cost0 = self.dres0[0](cost, relu=True, plain=plain)
    cost0 = self.dres0[2](cost0, relu=True, plain=plain)
    d1 = self.dres1[0](cost0, relu=True, plain=plain)
    cost0 = self.dres1[2](d1, cost0, plain=plain)

    out1, pre1, post1 = self._remat(self.dres2, cost0, None, None,
                                    plain=plain)
    out1 = out1 + cost0
    out2, _, post2 = self._remat(self.dres3, out1, pre1, post1, plain=plain)
    out2 = out2 + cost0
    out3, _, _ = self._remat(self.dres4, out2, pre1, post2, plain=plain)
    out3 = out3 + cost0

    cost1 = self.classif1(out1, plain=plain)
    cost2 = self.classif2(out2, plain=plain) + cost1
    cost3 = self.classif3(out3, plain=plain) + cost2
    return cost1, cost2, cost3
