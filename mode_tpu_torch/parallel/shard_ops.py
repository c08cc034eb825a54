"""The kernels over the ``spatial`` axis
(``mode_tpu/parallel/shard_ops.py``).

Each rank holds its rows of the volume's or the map's H
(``mesh.row_sharding``). A 3x3x3 conv of stride 1 or 2 reads one row
beyond each end of its rows, and the k3 s2 p1 op1 transpose conv one row
beyond the last: :func:`halo_concat` (``parallel/mesh.py``) brings those
planes from the neighbours (zeros at the mesh's edges, the convs' zero
padding), and the kernel runs on the haloed rows with ``h_halo=True``
(``ops/conv3d.py``).
The fusion net's stride-1 3x3 2-D convs do the same on NHWC rows: on the
2-D kernel's halo form (:func:`conv2d_s1_sharded`, ``ops/conv2d.py``) where
the JAX package runs ``conv2d_band_sharded``, and as ``F.conv2d`` on the
haloed rows (:func:`conv2d_library_sharded`) where it leaves the conv to
XLA. The regression head (:func:`regression_sharded`) gathers the
quarter-resolution logits, which are small, and expands only this rank's
output rows.

In training the 3-D convs that the kernels train on run their autograd
Functions on the rows (``ops/conv3d.py:conv3d_train(..., mesh=)``); the
others, the 1/16 level and the Cout-1 heads, run the library conv on the
haloed rows (:func:`conv3d_library_sharded`,
:func:`deconv3d_library_sharded`), whose gradient reaches the neighbours'
rows through ``halo_concat``'s backward.

Every function here takes its arguments as the op it wraps takes them and
counts its collectives on ``mesh.collectives``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from mode_tpu_torch import remat
from mode_tpu_torch.ops import conv2d, conv3d, regression
from mode_tpu_torch.parallel.mesh import (Mesh, gather_rows, halo_concat,
                                          row_sharding)

H_AXIS = 2          # the H axis of an NDHWC volume
H_AXIS_2D = 1       # the H axis of an NHWC map


def conv3d_s1_sharded(x, weight, scale=None, bias=None, residual=None,
                      relu=False, *, mesh: Mesh, plain: bool = False):
  """``conv3d.conv3d_s1_bn_act`` on this rank's rows (the Cout-1 head
  included)."""
  return conv3d.conv3d_s1_bn_act(halo_concat(x, H_AXIS, mesh), weight, scale,
                                 bias, residual, relu, h_halo=True,
                                 plain=plain)


def check_even_rows(x: torch.Tensor, mesh: Mesh) -> None:
  """A stride-2 conv's rows must start on an even global row: an even
  count of them on every rank, i.e. the whole H a multiple of 2 *
  spatial."""
  if x.shape[H_AXIS] % 2:
    raise ValueError(
        f"the stride-2 conv under a spatial mesh needs H % (2 x spatial) "
        f"== 0: H {x.shape[H_AXIS] * mesh.spatial} over {mesh.spatial} "
        "ranks")


def conv3d_s2_sharded(x, weight, scale=None, bias=None, relu=False, *,
                      mesh: Mesh, plain: bool = False):
  """``conv3d.conv3d_s2_bn_act`` on this rank's rows, which must start on
  an even global row (:func:`check_even_rows`)."""
  check_even_rows(x, mesh)
  return conv3d.conv3d_s2_bn_act(halo_concat(x, H_AXIS, mesh), weight, scale,
                                 bias, relu, h_halo=True, plain=plain)


def deconv3d_sharded(x, weight, scale=None, bias=None, residual=None,
                     relu=False, *, mesh: Mesh, plain: bool = False):
  """``conv3d.deconv3d_bn_act`` on this rank's rows: twice as many output
  rows, the upper halo plane unread."""
  return conv3d.deconv3d_bn_act(halo_concat(x, H_AXIS, mesh), weight, scale,
                                bias, residual, relu, h_halo=True,
                                plain=plain)


def conv3d_library_sharded(x: torch.Tensor, weight: torch.Tensor,
                           stride: int, *, mesh: Mesh) -> torch.Tensor:
  """The bare pad-1 3x3x3 conv ``F.conv3d(x, weight, stride=stride,
  padding=1)`` of training on this rank's rows of an NDHWC volume, NDHWC
  out: ``F.conv3d`` on the haloed rows, H unpadded, through
  ``remat.library_conv``; the gradient of the halo planes goes back to the
  neighbours."""
  if stride == 2:
    check_even_rows(x, mesh)
  xh = halo_concat(x, H_AXIS, mesh)
  return remat.library_conv(F.conv3d, xh.permute(0, 4, 1, 2, 3), weight,
                            stride=stride, padding=(1, 0, 1)).permute(
                                0, 2, 3, 4, 1)


def deconv3d_library_sharded(x: torch.Tensor, weight: torch.Tensor, *,
                             mesh: Mesh) -> torch.Tensor:
  """The bare ``F.conv_transpose3d(x, weight, stride=2, padding=1,
  output_padding=1)`` of training on this rank's rows, NDHWC in and out:
  twice its rows. The transpose conv reads its own rows and the next
  rank's first: it runs on those, and the two output rows of that plane
  are dropped."""
  xh = halo_concat(x, H_AXIS, mesh)
  y = remat.library_conv(F.conv_transpose3d,
                         xh[:, :, 1:].permute(0, 4, 1, 2, 3), weight,
                         stride=2, padding=1, output_padding=1)
  return y[:, :, :, :-2].permute(0, 2, 3, 4, 1)


def conv2d_s1_sharded(x, weight, scale=None, bias=None, residual=None,
                      relu=False, *, mesh: Mesh, plain: bool = False):
  """``conv2d.conv2d_s1_bn_act`` (dilation 1) on this rank's rows of an
  NHWC map; ``residual`` is this rank's rows of the output."""
  return conv2d.conv2d_s1_bn_act(halo_concat(x, H_AXIS_2D, mesh), weight,
                                 scale, bias, residual, relu, h_halo=True,
                                 plain=plain)


def conv2d_library_sharded(x: torch.Tensor, weight: torch.Tensor, *,
                           mesh: Mesh) -> torch.Tensor:
  """The bare 3x3 pad-1 conv ``F.conv2d(x, weight, padding=1)`` on this
  rank's rows of an NHWC map, NHWC out: ``F.conv2d`` on the haloed rows,
  W alone padded, in the caller's precision (the models run it under
  ``device.ieee_f32_convs``)."""
  xh = halo_concat(x, H_AXIS_2D, mesh)
  return F.conv2d(xh.permute(0, 3, 1, 2), weight,
                  padding=(0, 1)).permute(0, 2, 3, 1)


def regression_sharded(cost_q: torch.Tensor, maxdisp: int, h: int, w: int, *,
                       mesh: Mesh, plain: bool = False):
  """``regression.fused_disparity_regression`` for this rank's output rows
  of the full ``h``: the spatial group's rows of the quarter-resolution
  ``cost_q`` (N, D, Hq / S, Wq) gathered, then the row window."""
  rows = row_sharding(mesh, h)
  return regression.fused_disparity_regression(
      gather_rows(cost_q, 2, mesh), maxdisp, h, w, row0=rows.start,
      h_out=rows.stop - rows.start, plain=plain)
