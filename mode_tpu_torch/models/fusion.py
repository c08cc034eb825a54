"""MODE stage 2: multi-view depth fusion (``mode_tpu/models/fusion.py``).

``ModeFusion`` is a two-branch UNet: a depth branch over the six
interleaved (depth, confidence) maps and an RGB branch over the four views,
per-scale fusion layers, a decoder of k2 s2 transpose convs, and a sigmoid x
max_depth head in f32. ``Baseline`` is the ablation: a stack of fusion
blocks over the depths alone.

Modules carry the reference's ``state_dict`` keys (``nn.Sequential`` indices
included, with parameter-free placeholders where the reference has its pools,
ReLUs and sigmoid). The fusion ``BasicBlock`` has no residual, and the
``downsample`` branches the reference builds and never runs are not built.

The forward runs NHWC from input to output (``models/blocks.py``). In eval
its stride-1 3x3 convs run the fused 2-D kernel of ``ops/conv2d.py`` exactly
where the JAX package runs them on its 2-D band kernels
(:func:`kernel_route`); the others run ``F.conv2d`` in IEEE f32
(``device.ieee_f32_convs``), as the JAX package leaves them to XLA. In
training (``module.train()``) every layer takes the batch's BN statistics,
and the stride-1 3x3 convs run the kernel's autograd Function (forward and
grad-input) where the JAX package's batch-packed training gate takes them;
the JAX package never trains on its lane-major path, so neither does the
port.

Under ``with activate(make_mesh(data=D, spatial=S)):`` (``parallel/``, one
process a card, eval only) ``ModeFusion`` takes this rank's rows of the
batch (B / D) of whole maps, cuts its rows of H at entry and returns its
``(B / D, H / S, W, 1)`` rows: each 3x3 conv runs on its rows after a
one-row halo exchange (``parallel/shard_ops.py``), on the 2-D kernel's halo
form where the JAX package runs ``conv2d_band_sharded`` (the lane-major
forward's ``kernel_route``; W is never split, so the routes are the
unsharded ones) and as ``F.conv2d`` on the haloed rows elsewhere; the
pools, the transpose convs, the concatenations and the 1x1 head are
row-local. H must be a multiple of 8 S, so that every rank holds an even
count of rows before each of the three pools; the JAX package lets GSPMD
partition other shapes, the port raises. ``Baseline``, which the JAX
package runs NHWC and leaves to GSPMD under a mesh, raises under a spatial
mesh.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Sequence

import torch
from torch import nn

from mode_tpu_torch.device import ieee_f32_convs, resolve_device
from mode_tpu_torch.models.blocks import (ConvHead2d, FusionBasicBlock,
                                          TorchBatchNorm, init_weights,
                                          max_pool2, no_spatial_training,
                                          up_bn_relu)
from mode_tpu_torch.ops import conv2d as conv2d_ops
from mode_tpu_torch.parallel.mesh import constrain_spatial, spatial_mesh

Route = Callable[[tuple, int], bool]


def lane_eligible(shape) -> bool:
  """Whether the JAX package runs the fusion net's eval forward lane-major
  on its per-image 2-D band kernel (``models/fusion.py:_lane_eligible``):
  an NHWC input whose W is a multiple of 128 and H of 8. Its TPU policy
  (platform, mesh) is left out, as the port's other gates leave out the
  TPU's memory budgets."""
  _, h, w, _ = shape
  return w % 128 == 0 and h % 8 == 0


def kernel_route(lane: bool) -> Route:
  """``route(x_shape, cout)``: whether a stride-1 3x3 fusion conv on an NHWC
  input of ``x_shape`` runs the 2-D kernel. On the lane-major forward
  (``lane``), where the JAX package's ``Conv2dLane`` takes
  ``conv2d_band_pallas`` (``lane_conv2d_ok``'s shape conditions: the map's
  W a multiple of 128 and Cout of 8; Cin is padded to 8); otherwise where
  its ``Conv2dFast3x3`` takes the batch-packed kernel
  (``train_bpack2d_g``: ``conv2d.train_kernel_eligible``)."""
  if lane:
    return lambda x_shape, cout: x_shape[2] % 128 == 0 and cout % 8 == 0
  return conv2d_ops.train_kernel_eligible


def _library_only(x_shape, cout) -> bool:
  """The route of the NHWC forward under a spatial mesh: every conv a
  library call, as the JAX package's batch-packed kernel takes no mesh."""
  return False


def _spatial_rows(mesh, depth_in: torch.Tensor, rgb_in: torch.Tensor):
  """This rank's rows of both NHWC inputs; H must be a multiple of 8 S."""
  h = depth_in.shape[1]
  if h % (8 * mesh.spatial):
    raise ValueError(
        f"the fusion net under a spatial mesh needs H % (8 x spatial) == 0, "
        f"an even count of rows a rank before each of its three pools: H "
        f"{h} over {mesh.spatial} ranks")
  return constrain_spatial(depth_in, 1), constrain_spatial(rgb_in, 1)


def _blocks(stage: nn.Sequential, x: torch.Tensor, route: Route,
            plain: bool) -> torch.Tensor:
  """Run the :class:`FusionBasicBlock` s of ``stage`` in order."""
  for block in stage:
    if isinstance(block, FusionBasicBlock):
      x = block(x, route=route, plain=plain)
  return x


def _block_stage(cin: int, cout: int, blocks: int, pre=(), post=()
                 ) -> nn.Sequential:
  layers = list(pre) + [FusionBasicBlock(cin, cout)]
  layers += [FusionBasicBlock(cout, cout) for _ in range(1, blocks)]
  return nn.Sequential(*layers, *post)


def _up(cin: int) -> list[nn.Module]:
  """A decoder step's k2 s2 transpose conv (with bias), BN and ReLU."""
  return [nn.ConvTranspose2d(cin, cin // 2, 2, 2), TorchBatchNorm(cin // 2),
          nn.ReLU()]


class FeatureExtractionFusion(nn.Module):
  """The reference's ``feature_extraction_MODE_Fusion``: ``forward(
  depth_in, rgb_in)`` on NHWC maps, ``(B, H, W, depth_channels)`` and
  ``(B, H, W, rgb_channels)``, returns the fused depth ``(B, H, W, 1)`` in
  f32. ``channels`` (32, 64, 128, 256) for Deep360; each must double the
  one before, as the reference's decoder assumes."""

  def __init__(self, max_depth: float,
               channels: Sequence[int] = (32, 64, 128, 256),
               depth_channels: int = 12, rgb_channels: int = 12):
    super().__init__()
    c = tuple(channels)
    self.max_depth = max_depth
    pool = lambda: [nn.MaxPool2d(2, 2)]
    self.depth_layer1 = _block_stage(depth_channels, c[0], 2)
    self.depth_layer2 = _block_stage(c[0], c[1], 1, pre=pool())
    self.depth_layer3 = _block_stage(c[1], c[2], 1, pre=pool())
    self.rgb_layer1 = _block_stage(rgb_channels, c[0], 2)
    self.rgb_layer2 = _block_stage(c[0], c[1], 1, pre=pool())
    self.rgb_layer3 = _block_stage(c[1], c[2], 1, pre=pool())
    self.fusion_layer1 = _block_stage(2 * c[0], c[0], 2)
    self.fusion_layer2 = _block_stage(2 * c[1], c[1], 2)
    self.fusion_layer3 = _block_stage(2 * c[2], c[2], 2)
    self.depth_layer4 = _block_stage(c[2], c[3], 1, pre=pool(),
                                     post=_up(c[3]))
    self.depth_layer5 = _block_stage(c[3], c[2], 1, post=_up(c[2]))
    self.depth_layer6 = _block_stage(c[2], c[1], 1, post=_up(c[1]))
    self.depth_layer7 = _block_stage(c[1], c[0], 2,
                                     post=[ConvHead2d(c[0]), nn.Sigmoid()])

  def forward(self, depth_in: torch.Tensor, rgb_in: torch.Tensor, *,
              plain: bool = False) -> torch.Tensor:
    lane = not self.training and lane_eligible(depth_in.shape)
    route = kernel_route(lane)
    mesh = spatial_mesh()
    if mesh is not None:       # this rank's rows (ModeFusion: eval only)
      depth_in, rgb_in = _spatial_rows(mesh, depth_in, rgb_in)
      if not lane:
        route = _library_only

    def run(stage, x):
      return _blocks(stage, x, route, plain)

    def up(stage, x):       # a stage's block(s), then its decoder step
      n = len(stage)
      return up_bn_relu(stage[n - 3], stage[n - 2], run(stage, x))

    d1 = run(self.depth_layer1, depth_in)
    d2 = run(self.depth_layer2, max_pool2(d1))
    d3 = run(self.depth_layer3, max_pool2(d2))
    d4 = up(self.depth_layer4, max_pool2(d3))
    r1 = run(self.rgb_layer1, rgb_in)
    r2 = run(self.rgb_layer2, max_pool2(r1))
    r3 = run(self.rgb_layer3, max_pool2(r2))
    f1 = run(self.fusion_layer1, torch.cat([d1, r1], -1))
    f2 = run(self.fusion_layer2, torch.cat([d2, r2], -1))
    f3 = run(self.fusion_layer3, torch.cat([d3, r3], -1))
    d5 = up(self.depth_layer5, torch.cat([f3, d4], -1))
    d6 = up(self.depth_layer6, torch.cat([f2, d5], -1))
    d7 = run(self.depth_layer7, torch.cat([f1, d6], -1))
    # sigmoid x max_depth in f32: a bf16 depth at 1000 m steps by ~4 m
    return torch.sigmoid(self.depth_layer7[2](d7)) * self.max_depth


def _grad_mode(model: nn.Module):
  """The eval forward runs without autograd; the training forward as the
  caller's grad mode says."""
  return contextlib.nullcontext() if model.training else torch.no_grad()


def _place(model: nn.Module, device, generator) -> torch.device:
  """Initialise ``model``'s weights from ``generator`` (seed 0 if None),
  move it to ``device`` (the CUDA card by default) and set eval mode."""
  if generator is None:
    generator = torch.Generator().manual_seed(0)
  init_weights(model, generator)
  device = resolve_device(device)
  model.to(device)
  model.eval()
  return device


class ModeFusion(nn.Module):
  """Stage 2. ``forward(depths, confs, rgbs)``: lists of NHWC maps, six
  ``(B, H, W, 1)`` depths, six ``(B, H, W, 1)`` confidences and four
  ``(B, H, W, 3)`` views, on the model's device; depth and confidence are
  interleaved channel-wise, as the reference concatenates them. Returns the
  fused depth ``(B, H, W, 1)`` in f32: in eval without autograd, after
  ``train()`` differentiable, its BN layers on the batch's statistics.

  The weights are drawn from ``generator`` (seed 0 if None) as the
  reference initialises them; load trained ones with ``load_state_dict``
  or ``utils/convert.py:load_reference_state_dict``. ``device`` defaults
  to the CUDA card and raises without one; pass ``"cpu"`` to run the plain
  PyTorch path on the CPU. Under a spatial mesh (eval) the output is this
  rank's rows (module docstring)."""

  def __init__(self, max_depth: float = 1000.0,
               channels: Sequence[int] = (32, 64, 128, 256), *,
               device: str | torch.device | None = None,
               generator: torch.Generator | None = None):
    super().__init__()
    self.max_depth = max_depth
    self.feature_extraction = FeatureExtractionFusion(max_depth, channels)
    self.device = _place(self, device, generator)

  def forward(self, depths, confs, rgbs, *, plain: bool = False
              ) -> torch.Tensor:
    """``plain=True`` runs the kernels' plain PyTorch versions instead."""
    interleaved = []
    for d, c in zip(depths, confs):
      interleaved.extend([d, c])
    depth_in = torch.cat(interleaved, -1)
    rgb_in = torch.cat(list(rgbs), -1)
    if depth_in.device != self.device or rgb_in.device != self.device:
      raise ValueError(f"inputs on {depth_in.device}/{rgb_in.device}, model "
                       f"on {self.device}")
    if self.training:
      no_spatial_training()
    with _grad_mode(self), ieee_f32_convs():
      return self.feature_extraction(depth_in, rgb_in, plain=plain)


class BaselineFeatures(nn.Module):
  """The ablation's conv stack: seven stages of fusion blocks at full
  resolution, widths 32 (2 blocks), 64, 128, 256, 128, 64, 32 (2 blocks),
  then the 1x1 head."""

  def __init__(self, in_channels: int):
    super().__init__()
    widths = [(32, 2), (64, 1), (128, 1), (256, 1), (128, 1), (64, 1)]
    cin = in_channels
    for i, (cout, blocks) in enumerate(widths, start=1):
      self.add_module(f"layer{i}", _block_stage(cin, cout, blocks))
      cin = cout
    self.layer7 = _block_stage(cin, 32, 2, post=[ConvHead2d(32),
                                                 nn.Sigmoid()])

  def forward(self, x: torch.Tensor, *, plain: bool = False) -> torch.Tensor:
    """Logits ``(B, H, W, 1)`` in f32 of an NHWC input."""
    route = kernel_route(False)
    for i in range(1, 8):
      x = _blocks(getattr(self, f"layer{i}"), x, route, plain)
    return self.layer7[2](x)


class Baseline(nn.Module):
  """The ablation fusion net: ``forward(depths)``, a list of ``(B, H, W,
  1)`` depth maps, returns ``(B, H, W, 1)`` f32 depths. The JAX package
  runs it NHWC, so its convs take the batch-packed kernel's gate only, and
  under a mesh leaves it to GSPMD; the port refuses it under a spatial
  mesh. ``device`` and ``generator`` as for :class:`ModeFusion`."""

  def __init__(self, max_depth: float = 1000.0, in_channels: int = 6, *,
               device: str | torch.device | None = None,
               generator: torch.Generator | None = None):
    super().__init__()
    self.max_depth = max_depth
    self.feature_extraction = BaselineFeatures(in_channels)
    self.device = _place(self, device, generator)

  def forward(self, depths, *, plain: bool = False) -> torch.Tensor:
    if spatial_mesh() is not None:
      raise NotImplementedError(
          "Baseline under a spatial mesh is not ported: the JAX package runs "
          "it NHWC and leaves its sharding to GSPMD; serve ModeFusion, or "
          "run Baseline without the spatial axis")
    x = torch.cat(list(depths), -1)
    if x.device != self.device:
      raise ValueError(f"inputs on {x.device}, model on {self.device}")
    with _grad_mode(self), ieee_f32_convs():
      logits = self.feature_extraction(x, plain=plain)
    return torch.sigmoid(logits) * self.max_depth
