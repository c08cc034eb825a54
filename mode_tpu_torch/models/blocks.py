"""Building blocks of the stage-1 and fusion networks
(``mode_tpu/models/blocks.py``).

Every module is named with the reference's torch ``state_dict`` path
segments (``nn.Sequential`` indices included, with ``nn.ReLU`` placeholders
where the reference has them), so the port's ``state_dict`` keys are the
reference's keys and the JAX package's Flax paths joined with dots.

The 2-D blocks take NCHW tensors, as the reference's torch modules do; the
feature extractors hand them channels-last memory, so the NHWC images and
features at their boundary are views, not copies. A 2-D conv + BN runs
``F.conv2d`` and the BN, as the JAX package leaves its convs to XLA, or, where
the caller asks for it (``fused=True``: the convs that reach the JAX
package's 2-D band kernels), the fused kernel of ``ops/conv2d.py``. The
sphere convs run the fused kernel of ``ops/sphere_conv.py`` and the 3-D
blocks, on NDHWC volumes, those of ``ops/conv3d.py``, each with the BatchNorm
folded into the epilogue. A fused layer keeps its weight in the kernel's
layout (every conv but the deconv: the K-major, in f32 split, layout of
the tensor-core kernels) and its folded BN between calls, and remakes them
only after one of its parameters or buffers changes.

The fusion net's blocks (:class:`FusionBasicBlock`, :func:`up_bn_relu`,
:class:`ConvHead2d`) take NHWC maps and keep them NHWC: the library convs
and pools see channels-last NCHW views, so no block copies between the
layouts.

In training (``module.train()``) each conv + BN layer runs in the JAX
package's order: the bare conv, BN with batch statistics, the residual, the
ReLU. The bare conv is the autograd Function of its op module (forward and
grad-input on the port's kernels) exactly where the JAX package takes its
Pallas training path at the same shape and batch (the ``train_*eligible``
gates of ``ops/``); elsewhere it is ``F.conv2d``/``F.conv3d``/
``F.conv_transpose3d`` or the plain sphere conv under autograd, as the JAX
package leaves those convs to XLA. The Functions take the torch-layout
``Parameter`` and pack it in each call, so its gradient reaches it.

A training conv computes in its input's dtype: it casts its weight at use
(``w.to(x.dtype)``), so with bf16 activations the f32 master weights get
f32 gradients through the cast, as the JAX package's mixed-precision step
casts its conv kernels inside the differentiated function. Biases and BN
parameters and statistics stay f32.

Under a mesh with a ``spatial`` axis (``parallel/mesh.py``) the 3-D layers
and the fusion net's 3x3 convs hold their rank's rows of the volume's or
the map's H and run through ``parallel/shard_ops.py`` (a one-plane halo
exchange with the neighbouring ranks, then the kernel's halo form, or the
library conv on the haloed rows): a shape whose rows the sharded kernel
cannot take raises, and nothing runs the layer unsharded in its place. The
3-D layers train so too (the kernels' Functions on the rows, where the
gates take the whole volume's shape, else the library conv on the haloed
rows), their BN over the whole mesh; the fusion net does not train under
the axis (:func:`no_spatial_training`).

The training convs' library calls go through ``remat.library_conv``: the
call itself, except inside a block that ``ModeDisparity`` rematerialises
with the ``"save_convs"`` policy, which keeps the conv's output for the
backward instead of running the conv again (the kernels' Functions keep
theirs the same way).
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch import nn

from mode_tpu_torch import remat
from mode_tpu_torch.ops import conv2d as conv2d_ops
from mode_tpu_torch.ops import conv3d as conv3d_ops
from mode_tpu_torch.ops import sphere_conv as sphere_ops
from mode_tpu_torch.ops.conv3d import (conv3d_s1_bn_act, conv3d_s2_bn_act,
                                       deconv3d_bn_act, pack_weight_tc)
from mode_tpu_torch.ops.epilogue import epilogue
from mode_tpu_torch.ops.sphere_conv import sphere_conv_bn_act
from mode_tpu_torch.parallel import shard_ops
from mode_tpu_torch.parallel.mesh import (DATA, FUSION_SPATIAL_TRAINING_ITEM,
                                          MESH, active_mesh, all_sum,
                                          sharded, spatial_mesh)


class _Operands:
  """The kernel operands a 3-D layer derives from its tensors, made again
  only when one of those tensors has changed: in place (its version
  counter moves; ``load_state_dict`` copies in place) or replaced (``.to()``
  gives it new storage). Holding the old tensors keeps their storage
  alive, so a new one cannot take the same address."""

  def __init__(self):
    self._key, self._held, self._value = None, (), None

  def get(self, tensors, make):
    key = tuple((t.device, t.data_ptr(), t._version) for t in tensors)
    if key != self._key:
      with torch.no_grad():
        self._value = make()
      self._key, self._held = key, tuple(t.detach() for t in tensors)
    return self._value


class TorchBatchNorm(nn.Module):
  """BatchNorm with torch's parameters and buffers (``weight``, ``bias``,
  ``running_mean``, ``running_var``, ``num_batches_tracked``), over channel
  axis 1. In training it normalises with the batch's f32 statistics over
  every other axis (biased variance) and updates the running ones with
  momentum 0.1 and the unbiased variance ``var * n / (n - 1)``, as
  ``mode_tpu/models/blocks.py:TorchBatchNorm`` does.

  Under a mesh whose batch is split over ranks (``parallel/mesh.py``) the
  statistics are the global batch's, in the JAX package's two passes: the
  mean from the all-reduced sum, then the variance from the all-reduced sum
  of ``(x - mean)^2``, both f32 and differentiable. ``over`` is the group
  whose ranks hold parts of the layer's batch: ``mesh.DATA`` where every
  spatial rank holds its data index's whole maps (the 2-D layers),
  ``mesh.MESH`` where a spatial rank holds its rows of H (the 3-D stack).
  Where a rematerialised block runs again for its backward
  (``remat.replaying``) the running statistics are not updated a second
  time."""

  momentum = 0.1

  def __init__(self, num_features: int, eps: float = 1e-5, *,
               over: str = DATA):
    super().__init__()
    self.eps = eps
    self.over = over
    self.weight = nn.Parameter(torch.ones(num_features))
    self.bias = nn.Parameter(torch.zeros(num_features))
    self.register_buffer("running_mean", torch.zeros(num_features))
    self.register_buffer("running_var", torch.ones(num_features))
    self.register_buffer("num_batches_tracked",
                         torch.tensor(0, dtype=torch.long))

  def _global_batch(self, xf: torch.Tensor, mesh) -> torch.Tensor:
    """Normalise with the statistics of the batch of every rank of the
    group ``over`` (the ranks' parts are the same size, so ``n`` is this
    rank's times the group's ranks)."""
    dims = [0, *range(2, xf.dim())]
    shape = (1, -1) + (1,) * (xf.dim() - 2)
    n = xf.numel() // xf.shape[1] * mesh.ranks(self.over)
    mean = all_sum(xf.sum(dims), mesh, self.over) / n
    d = xf - mean.view(shape)
    var = all_sum((d * d).sum(dims), mesh, self.over) / n
    if not remat.replaying():
      with torch.no_grad():
        m = self.momentum
        self.running_mean.mul_(1 - m).add_(m * mean)
        self.running_var.mul_(1 - m).add_(m * var * (n / max(n - 1, 1)))
        self.num_batches_tracked += 1
    inv = torch.rsqrt(var + self.eps) * self.weight
    return d * inv.view(shape) + self.bias.view(shape)

  def folded(self) -> tuple[torch.Tensor, torch.Tensor]:
    """``(scale, bias)`` in f32 with ``BN(x) == x * scale + bias``."""
    inv = torch.rsqrt(self.running_var + self.eps) * self.weight
    return inv, self.bias - self.running_mean * inv

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    if self.training:
      xf = x.to(torch.promote_types(x.dtype, torch.float32))
      mesh = active_mesh()
      if sharded(mesh, self.over):
        return self._global_batch(xf, mesh).to(x.dtype)
      # the rerun's momentum 0 leaves the running statistics as they are
      replaying = remat.replaying()
      y = F.batch_norm(xf, self.running_mean, self.running_var, self.weight,
                       self.bias, training=True,
                       momentum=0.0 if replaying else self.momentum,
                       eps=self.eps)
      if not replaying:
        with torch.no_grad():
          self.num_batches_tracked += 1
      return y.to(x.dtype)
    shape = (-1,) + (1,) * (x.dim() - 2)
    inv = torch.rsqrt(self.running_var + self.eps) * self.weight
    y = ((x.float() - self.running_mean.view(shape)) * inv.view(shape)
         + self.bias.view(shape))
    return y.to(x.dtype)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
  """The contiguous NHWC tensor of an NCHW one (a view of channels-last
  memory, copied only if the memory is not)."""
  return x.permute(0, 2, 3, 1).contiguous()


def _bn_act(bn: TorchBatchNorm, y: torch.Tensor,
            residual: torch.Tensor | None, relu: bool,
            channels_last: bool = False) -> torch.Tensor:
  """``act(BN(y) (+ residual))``, the training tail of a conv + BN layer;
  ``channels_last``: the channels are ``y``'s last axis (NDHWC)."""
  if channels_last:
    n = y.dim()
    y = bn(y.permute(0, n - 1, *range(1, n - 1))).permute(
        0, *range(2, n), 1)
  else:
    y = bn(y)
  if residual is not None:
    y = y + residual
  return torch.relu(y) if relu else y


def no_spatial_training() -> None:
  """Refuse the fusion net's training forward under a mesh that splits H
  (the JAX package trains it only with ``spatial=1``,
  ``mode_tpu/cli/train_fusion.py:102``)."""
  if spatial_mesh() is not None:
    raise NotImplementedError(
        "training under a spatial mesh is not ported for the fusion net "
        f"({FUSION_SPATIAL_TRAINING_ITEM}); it serves over the spatial axis "
        "in eval")


def _whole_shape(shape, mesh) -> tuple[int, ...]:
  """The whole volume's NDHWC shape of a rank's rows under ``mesh`` (the
  rows' own without one): the training gates read it, so that a rank's
  rows take the kernels that one process's whole volume takes."""
  if mesh is None:
    return tuple(shape)
  return (*shape[:2], shape[2] * mesh.spatial, *shape[3:])


def _conv3d_train(x: torch.Tensor, weight: torch.Tensor, stride: int,
                  plain: bool) -> torch.Tensor:
  """The bare pad-1 3x3x3 conv of a training step, NDHWC: the kernels'
  Function where the JAX package trains on Pallas, else ``F.conv3d``;
  under a spatial mesh on this rank's rows (``F.conv3d`` on the haloed
  rows)."""
  gate = (conv3d_ops.train_s1_eligible if stride == 1
          else conv3d_ops.train_s2_eligible)
  weight = weight.to(x.dtype)
  mesh = spatial_mesh()
  if gate(_whole_shape(x.shape, mesh), weight.shape[0]):
    return conv3d_ops.conv3d_train(x, weight, stride, plain=plain, mesh=mesh)
  if mesh is not None:
    return shard_ops.conv3d_library_sharded(x, weight, stride, mesh=mesh)
  return remat.library_conv(F.conv3d, x.permute(0, 4, 1, 2, 3), weight,
                            stride=stride, padding=1).permute(0, 2, 3, 4, 1)


def _conv3d_eval(x, weight, stride, scale=None, bias=None, residual=None,
                 relu=False, *, plain):
  """The eval 3-D conv of stride 1 or 2 with its epilogue: the kernel on
  the whole volume, or on this rank's rows under a spatial mesh."""
  if stride == 2 and residual is not None:
    raise ValueError("the stride-2 conv takes no residual")
  mesh = spatial_mesh()
  if mesh is not None:
    if stride == 1:
      return shard_ops.conv3d_s1_sharded(x, weight, scale, bias, residual,
                                         relu, mesh=mesh, plain=plain)
    return shard_ops.conv3d_s2_sharded(x, weight, scale, bias, relu,
                                       mesh=mesh, plain=plain)
  if stride == 1:
    return conv3d_s1_bn_act(x, weight, scale, bias, residual, relu,
                            plain=plain)
  return conv3d_s2_bn_act(x, weight, scale, bias, relu, plain=plain)


class ConvBn2d(nn.Sequential):
  """``convbn``: conv (no bias) + BN, with the reference's padding quirk
  ``padding = dilation if dilation > 1 else pad``; NCHW in and out.

  ``forward(x, residual, relu)`` computes ``act(BN(conv(x)) (+ residual))``.
  By default the conv is ``F.conv2d``. With ``fused=True`` the layer, which
  must then be a 3x3 stride-1 conv, runs as one call of
  ``ops/conv2d.py:conv2d_s1_bn_act`` with the BN, residual and ReLU in its
  epilogue (``plain`` asks for that op's plain version).
  """

  def __init__(self, cin: int, cout: int, kernel: int, stride: int,
               pad: int, dilation: int):
    super().__init__(
        nn.Conv2d(cin, cout, kernel, stride,
                  padding=dilation if dilation > 1 else pad,
                  dilation=dilation, bias=False),
        TorchBatchNorm(cout))
    self._operands = _Operands()

  def forward(self, x: torch.Tensor, residual: torch.Tensor | None = None,
              relu: bool = False, *, fused: bool = False,
              plain: bool = False) -> torch.Tensor:
    conv = self[0]
    if self.training:
      weight = conv.weight.to(x.dtype)
      if self._kernel_in_training(x):
        y = conv2d_ops.conv2d_train(_nhwc(x), weight, conv.dilation[0],
                                    plain=plain).permute(0, 3, 1, 2)
      else:
        y = remat.library_conv(F.conv2d, x, weight, stride=conv.stride,
                               padding=conv.padding, dilation=conv.dilation)
      return _bn_act(self[1], y, residual, relu)
    if not fused:
      y = self[1](conv(x))
      if residual is not None:
        y = y + residual
      return torch.relu(y) if relu else y
    if (conv.kernel_size != (3, 3) or conv.stride != (1, 1)
        or conv.padding != conv.dilation):
      raise ValueError("the fused 2-D conv is 3x3, stride 1, padding = "
                       f"dilation; this layer is {conv}")
    weight, scale, bias = _fused_operands(self, conv2d_ops.pack_weight_tc)
    y = conv2d_ops.conv2d_s1_bn_act(
        _nhwc(x), weight, scale, bias,
        None if residual is None else _nhwc(residual), relu,
        conv.dilation[0], plain=plain)
    return y.permute(0, 3, 1, 2)

  def _kernel_in_training(self, x: torch.Tensor) -> bool:
    """Whether the JAX package trains this conv on its 2-D kernel (K9):
    a stride-1 3x3 conv with padding = dilation, at a shape and batch
    ``conv2d_ops.train_kernel_eligible`` takes."""
    conv = self[0]
    return (conv.kernel_size == (3, 3) and conv.stride == (1, 1)
            and conv.padding == conv.dilation and conv.dilation[0] in (1, 2)
            and conv2d_ops.train_kernel_eligible(
                (x.shape[0], x.shape[2], x.shape[3], x.shape[1]),
                conv.out_channels))


def convbn(cin: int, cout: int, kernel: int, stride: int, pad: int,
           dilation: int) -> ConvBn2d:
  """``convbn`` (``mode_tpu/models/blocks.py``)."""
  return ConvBn2d(cin, cout, kernel, stride, pad, dilation)


class Shortcut(nn.Sequential):
  """The residual blocks' ``downsample``: a 1x1 conv (no bias) + BN, the
  conv in its input's dtype; NCHW."""

  def __init__(self, cin: int, cout: int, stride: int):
    super().__init__(nn.Conv2d(cin, cout, 1, stride, bias=False),
                     TorchBatchNorm(cout))

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    conv = self[0]
    return self[1](remat.library_conv(F.conv2d, x, conv.weight.to(x.dtype),
                                      stride=conv.stride))


def downsample_shortcut(cin: int, cout: int, stride: int) -> Shortcut:
  """1x1 conv + BN shortcut of the residual blocks."""
  return Shortcut(cin, cout, stride)


class BasicBlockNoRelu(nn.Module):
  """PSMNet ``BasicBlock``: no ReLU after the residual add. NCHW.

  ``fused=True`` runs its stride-1 3x3 convs through the fused 2-D kernel,
  the shortcut add in conv2's epilogue.
  """
  relu_after_add = False

  def __init__(self, cin: int, cout: int, stride: int = 1, pad: int = 1,
               dilation: int = 1, has_downsample: bool = False):
    super().__init__()
    self.conv1 = nn.Sequential(convbn(cin, cout, 3, stride, pad, dilation),
                               nn.ReLU())
    self.conv2 = convbn(cout, cout, 3, 1, pad, dilation)
    self.downsample = (downsample_shortcut(cin, cout, stride)
                       if has_downsample else None)

  def forward(self, x: torch.Tensor, *, fused: bool = False,
              plain: bool = False) -> torch.Tensor:
    conv1 = self.conv1[0]
    out = conv1(x, relu=True, fused=fused and conv1[0].stride == (1, 1),
                plain=plain)
    shortcut = x if self.downsample is None else self.downsample(x)
    return self.conv2(out, shortcut, self.relu_after_add, fused=fused,
                      plain=plain)


class RegularBasicBlock(BasicBlockNoRelu):
  """``RegularBasicBlock``: the same block with a ReLU after the add."""
  relu_after_add = True


class SphereConv(nn.Module):
  """The reference ``SphereConv`` (3x3, stride 1, no bias): holds the
  weight, torch layout ``(Cout, Cin, 3, 3)``. The sampling tables are
  functions of the input's shape (``ops/sphere_conv.py``)."""

  def __init__(self, cin: int, cout: int):
    super().__init__()
    self.weight = nn.Parameter(torch.empty(cout, cin, 3, 3))


class SphereConvBn(nn.Sequential):
  """``sphere_convbn``: sphere conv + BN, run as one call of
  ``ops/sphere_conv.py:sphere_conv_bn_act`` with the BN, an optional
  residual and ReLU in its epilogue; NCHW in and out. ``sphere_type`` is
  the maps' layout, ``"Cassini"`` (H = 2W) or ``"ERP"`` (W = 2H); it
  chooses the sampling tables and the kernel, not the parameters."""

  def __init__(self, cin: int, cout: int, sphere_type: str = "Cassini"):
    super().__init__(SphereConv(cin, cout), TorchBatchNorm(cout))
    if sphere_type not in sphere_ops.FORWARD:
      raise ValueError(f"unknown sphere_type {sphere_type!r}")
    self.sphere_type = sphere_type
    self._operands = _Operands()

  def forward(self, x: torch.Tensor, residual: torch.Tensor | None = None,
              relu: bool = False, *, plain: bool = False) -> torch.Tensor:
    kind = self.sphere_type
    if self.training:
      xn = _nhwc(x)
      weight = self[0].weight.to(x.dtype)
      if sphere_ops.train_kernel_eligible(xn.shape, kind):
        y = sphere_ops.sphere_conv_train(xn, weight, sphere_type=kind,
                                         plain=plain)
      else:
        y = sphere_ops.sphere_conv(xn, weight, kind)
      return _bn_act(self[1], y.permute(0, 3, 1, 2), residual, relu)
    weight, scale, bias = _fused_operands(self, conv2d_ops.pack_weight_tc)
    y = sphere_conv_bn_act(_nhwc(x), weight, scale, bias,
                           None if residual is None else _nhwc(residual),
                           relu, sphere_type=kind, plain=plain)
    return y.permute(0, 3, 1, 2)


class SphereBasicBlock(nn.Module):
  """``SphereBasicBlock``: two sphere conv + BN stages, the shortcut (a 1x1
  conv + BN where the width changes) added and a ReLU after, the add and
  the ReLU in conv2's epilogue. NCHW, in the layout ``sphere_type``."""

  def __init__(self, cin: int, cout: int, has_downsample: bool = False,
               sphere_type: str = "Cassini"):
    super().__init__()
    self.conv1 = nn.Sequential(SphereConvBn(cin, cout, sphere_type),
                               nn.ReLU())
    self.conv2 = SphereConvBn(cout, cout, sphere_type)
    self.downsample = (downsample_shortcut(cin, cout, 1)
                       if has_downsample else None)

  def forward(self, x: torch.Tensor, *, plain: bool = False) -> torch.Tensor:
    out = self.conv1[0](x, relu=True, plain=plain)
    shortcut = x if self.downsample is None else self.downsample(x)
    return self.conv2(out, shortcut, relu=True, plain=plain)


class Conv3dWeight(nn.Module):
  """Holds a 3x3x3 ``nn.Conv3d`` weight, torch layout ``(O, I, 3, 3, 3)``,
  and the conv's stride (1 or 2, padding 1, no bias)."""

  def __init__(self, cin: int, cout: int, stride: int = 1):
    super().__init__()
    self.stride = stride
    self.weight = nn.Parameter(torch.empty(cout, cin, 3, 3, 3))
    self._operands = _Operands()

  def forward(self, x: torch.Tensor, *, plain: bool = False) -> torch.Tensor:
    """The bare conv (no affine, no ReLU), NDHWC."""
    if self.training:
      return _conv3d_train(x, self.weight, self.stride, plain)
    packed = self._operands.get(
        (self.weight,), lambda: pack_weight_tc(self.weight, self.stride))
    return _conv3d_eval(x, packed, self.stride, plain=plain)


class ConvTranspose3dWeight(nn.Module):
  """Holds an ``nn.ConvTranspose3d(k3, s2, p1, output_padding 1)`` weight,
  torch layout ``(I, O, 3, 3, 3)``."""

  def __init__(self, cin: int, cout: int):
    super().__init__()
    self.weight = nn.Parameter(torch.empty(cin, cout, 3, 3, 3))


class ConvBn3d(nn.Sequential):
  """``convbn_3d``: 3x3x3 conv (stride 1 or 2, pad 1) + BN, run as one fused
  kernel with the BN folded into the epilogue, on NDHWC volumes."""

  def __init__(self, cin: int, cout: int, stride: int = 1):
    super().__init__(Conv3dWeight(cin, cout, stride),
                     TorchBatchNorm(cout, over=MESH))
    self._operands = _Operands()

  def forward(self, x: torch.Tensor, residual: torch.Tensor | None = None,
              relu: bool = False, *, plain: bool = False) -> torch.Tensor:
    if self.training:
      y = _conv3d_train(x, self[0].weight, self[0].stride, plain)
      return _bn_act(self[1], y, residual, relu, channels_last=True)
    weight, scale, bias = _fused_operands(
        self, functools.partial(pack_weight_tc, stride=self[0].stride))
    return _conv3d_eval(x, weight, self[0].stride, scale, bias, residual,
                        relu, plain=plain)


class DeconvBn3d(nn.Sequential):
  """ConvTranspose3d(k3, s2, p1, output_padding 1) + BN, one fused kernel,
  on NDHWC volumes."""

  def __init__(self, cin: int, cout: int):
    super().__init__(ConvTranspose3dWeight(cin, cout),
                     TorchBatchNorm(cout, over=MESH))
    self._operands = _Operands()

  def forward(self, x: torch.Tensor, residual: torch.Tensor | None = None,
              relu: bool = False, *, plain: bool = False) -> torch.Tensor:
    if self.training:
      weight = self[0].weight.to(x.dtype)
      mesh = spatial_mesh()
      if conv3d_ops.train_deconv_eligible(_whole_shape(x.shape, mesh),
                                          weight.shape[1]):
        y = conv3d_ops.deconv3d_train(x, weight, plain=plain, mesh=mesh)
      elif mesh is not None:
        y = shard_ops.deconv3d_library_sharded(x, weight, mesh=mesh)
      else:
        y = remat.library_conv(F.conv_transpose3d, x.permute(0, 4, 1, 2, 3),
                               weight, stride=2, padding=1,
                               output_padding=1).permute(0, 2, 3, 4, 1)
      return _bn_act(self[1], y, residual, relu, channels_last=True)
    weight, scale, bias = _fused_operands(
        self, functools.partial(pack_weight_tc, transpose=True))
    mesh = spatial_mesh()
    if mesh is not None:
      return shard_ops.deconv3d_sharded(x, weight, scale, bias, residual,
                                        relu, mesh=mesh, plain=plain)
    return deconv3d_bn_act(x, weight, scale, bias, residual, relu,
                           plain=plain)


def _fused_operands(layer: nn.Sequential, pack):
  """``(pack(weight), scale, bias)`` of a conv + BN layer."""
  bn = layer[1]
  return layer._operands.get(
      (layer[0].weight, bn.weight, bn.bias, bn.running_mean, bn.running_var),
      lambda: (pack(layer[0].weight), *bn.folded()))


class Classif(nn.Sequential):
  """Classifier head: ``convbn_3d`` + ReLU, then a 3x3x3 conv to one
  channel. NDHWC volume in, ``(B, D, H, W)`` logits out."""

  def __init__(self, cin: int):
    super().__init__(ConvBn3d(cin, cin), nn.ReLU(), Conv3dWeight(cin, 1))

  def forward(self, x: torch.Tensor, *, plain: bool = False) -> torch.Tensor:
    y = self[0](x, relu=True, plain=plain)
    return self[2](y, plain=plain)[..., 0]


def _channels_last(x: torch.Tensor) -> torch.Tensor:
  """The NCHW view of an NHWC tensor (channels-last memory, no copy)."""
  return x.permute(0, 3, 1, 2)


def max_pool2(x: torch.Tensor) -> torch.Tensor:
  """The fusion net's 2x2/2 max-pool on an NHWC map (the pool keeps
  channels-last memory, so the result is a view)."""
  return F.max_pool2d(_channels_last(x), 2, 2).permute(0, 2, 3,
                                                       1).contiguous()


class FusionConvBn(nn.Sequential):
  """The fusion net's ``convbn`` (3x3, stride 1, padding 1, no bias) + BN,
  with a ReLU after, on NHWC maps: ``forward(x, kernel)``.

  In eval, ``kernel=True`` runs it as one call of
  ``ops/conv2d.py:conv2d_s1_bn_act``, the BN and ReLU in the epilogue, where
  the JAX package runs the conv on its 2-D band kernel; a Cin off a
  multiple of 8 (the fusion net's 12-channel inputs) is padded with zero
  channels, input and weight, as the JAX package pads them. Otherwise
  ``F.conv2d`` in the map's dtype, then the folded BN and the ReLU in f32.

  Under a spatial mesh (eval) ``x`` is this rank's rows of the map and the
  conv runs on them after a one-row halo exchange: the kernel's halo form
  (``shard_ops.conv2d_s1_sharded``) where ``kernel`` says so, else
  ``F.conv2d`` on the haloed rows (``shard_ops.conv2d_library_sharded``).

  In training the bare conv runs ``conv2d_ops.conv2d_train`` (forward and
  grad-input on the kernel) where ``kernel`` says so, else ``F.conv2d``;
  then BN with batch statistics and the ReLU. Nothing is padded (the JAX
  training gate takes no Cin off a multiple of 8, so the router never asks
  for the kernel there) and nothing is cached: the weight is cast to the
  map's dtype at use."""

  def __init__(self, cin: int, cout: int):
    super().__init__(nn.Conv2d(cin, cout, 3, 1, padding=1, bias=False),
                     TorchBatchNorm(cout))
    self._operands = _Operands()
    self._packed = _Operands()

  def forward(self, x: torch.Tensor, *, kernel: bool,
              plain: bool = False) -> torch.Tensor:
    conv, bn = self[0], self[1]
    if self.training:
      no_spatial_training()
      weight = conv.weight.to(x.dtype)
      if kernel:
        y = conv2d_ops.conv2d_train(x, weight, plain=plain)
      else:
        y = F.conv2d(_channels_last(x), weight, padding=1).permute(0, 2, 3, 1)
      return _bn_act(bn, y, None, True, channels_last=True)
    scale, bias = self._operands.get(
        (bn.weight, bn.bias, bn.running_mean, bn.running_var), bn.folded)
    mesh = spatial_mesh()
    if kernel:
      pad = -conv.in_channels % 8
      weight = self._packed.get((conv.weight,), lambda: (
          conv2d_ops.pack_weight_tc(F.pad(conv.weight,
                                          (0, 0, 0, 0, 0, pad)))))
      if pad:
        x = F.pad(x, (0, pad))
      if mesh is not None:
        return shard_ops.conv2d_s1_sharded(x, weight, scale, bias, None, True,
                                           mesh=mesh, plain=plain)
      return conv2d_ops.conv2d_s1_bn_act(x, weight, scale, bias, None, True,
                                         1, plain=plain)
    if mesh is not None:
      y = shard_ops.conv2d_library_sharded(x, conv.weight, mesh=mesh)
    else:
      y = F.conv2d(_channels_last(x), conv.weight,
                   padding=1).permute(0, 2, 3, 1)
    return epilogue(y, scale, bias, None, True, x.dtype)


class FusionBasicBlock(nn.Module):
  """The fusion net's ``BasicBlock``: two convbn + ReLU stages and no
  residual. The reference builds a ``downsample`` branch that its forward
  never runs; the port does not build it (``utils/convert.py`` drops its
  keys). ``forward(x, route)`` on NHWC maps: each conv runs the 2-D kernel
  where ``route(x_shape, cout)`` says so (``models/fusion.py``)."""

  def __init__(self, cin: int, cout: int):
    super().__init__()
    self.conv1 = nn.Sequential(FusionConvBn(cin, cout), nn.ReLU())
    self.conv2 = nn.Sequential(FusionConvBn(cout, cout), nn.ReLU())

  def forward(self, x: torch.Tensor, *, route, plain: bool = False
              ) -> torch.Tensor:
    for stage in (self.conv1, self.conv2):
      layer = stage[0]
      x = layer(x, kernel=route(tuple(x.shape), layer[0].out_channels),
                plain=plain)
    return x


def up_bn_relu(deconv: nn.ConvTranspose2d, bn: TorchBatchNorm,
               x: torch.Tensor) -> torch.Tensor:
  """``relu(BN(deconv(x)))`` on an NHWC map, the fusion decoder's k2 s2
  transpose conv (with its bias) + BN + ReLU: ``F.conv_transpose2d`` in the
  map's dtype on a channels-last view, then, in eval, the bias folded into
  the BN's affine and the ReLU, in f32. In training the bias is added by
  the transpose conv, so it keeps its own gradient, and the BN takes the
  batch's statistics."""
  if bn.training:
    y = F.conv_transpose2d(_channels_last(x), deconv.weight.to(x.dtype),
                           deconv.bias.to(x.dtype), stride=deconv.stride)
    return _bn_act(bn, y.permute(0, 2, 3, 1), None, True, channels_last=True)
  y = F.conv_transpose2d(_channels_last(x), deconv.weight,
                         stride=deconv.stride)
  scale, shift = bn.folded()
  shift = shift + deconv.bias.float() * scale
  return epilogue(y.permute(0, 2, 3, 1), scale, shift, None, True, x.dtype)


class ConvHead2d(nn.Conv2d):
  """The fusion nets' 1x1 head with a bias, ``nn.Conv2d(cin, 1, 1)``:
  ``forward(x)`` on an NHWC map returns the f32 logits ``(B, H, W, 1)``.
  The conv runs in f32 whatever the map's and the weight's dtype, as the
  JAX package's head does (its flax conv promotes the map and the kernel
  to the type of its f32 bias)."""

  def __init__(self, cin: int):
    super().__init__(cin, 1, 1, bias=True)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    y = F.conv2d(_channels_last(x).float(), self.weight.float())
    return y.permute(0, 2, 3, 1) + self.bias.float()


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator) -> None:
  """The reference's initialisation, drawn from ``generator`` in module
  order: conv weights ~ N(0, sqrt(2 / (prod(k) * C_out))), BN weight 1 and
  bias 0, transpose-conv weights ~ U(+-1 / sqrt(C_out * prod(k))) (torch's
  default for them), sphere-conv weights ~ U(+-1 / sqrt(C_in * prod(k)))
  (the reference ``SphereConv``'s own); a conv's or transpose conv's bias
  ~ U(+-1 / sqrt(fan_in)), torch's default, which the reference keeps."""
  for m in module.modules():
    if isinstance(m, (nn.Conv2d, Conv3dWeight)):
      w = m.weight
      n = math.prod(w.shape[2:]) * w.shape[0]
      w.copy_(torch.empty(w.shape).normal_(0, math.sqrt(2.0 / n),
                                           generator=generator))
    elif isinstance(m, (nn.ConvTranspose2d, ConvTranspose3dWeight,
                        SphereConv)):
      # fan: C_out * prod(k) for the transpose conv's (I, O, *k) layout,
      # C_in * prod(k) for the sphere conv's (O, I, *k)
      w = m.weight
      bound = 1.0 / math.sqrt(w.shape[1] * math.prod(w.shape[2:]))
      w.copy_(torch.empty(w.shape).uniform_(-bound, bound,
                                            generator=generator))
    elif isinstance(m, TorchBatchNorm):
      m.weight.fill_(1.0)
      m.bias.zero_()
    if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)) and m.bias is not None:
      w = m.weight          # fan_in: axis 1 times the taps, as torch's
      bound = 1.0 / math.sqrt(w.shape[1] * math.prod(w.shape[2:]))
      m.bias.copy_(torch.empty(m.bias.shape).uniform_(-bound, bound,
                                                      generator=generator))
