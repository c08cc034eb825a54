"""Cost-volume 3-D convolutions with a fused epilogue, on NDHWC volumes.

Each function computes ``act(conv(x, w) * scale + bias (+ residual))``, where
``scale``/``bias`` are the folded eval-BatchNorm affine (f32) and ``act`` is
an optional ReLU, and returns ``x.dtype``:

  * :func:`conv3d_s1_bn_act` — stride-1 pad-1 3x3x3 conv, any Cout. Replaces
    ``mode_tpu/ops/pallas/conv3d_kernel.py:conv3d_band_pallas`` (K1) and
    ``conv3d_fold_pallas`` (K6).
  * :func:`conv3d_s2_bn_act` — stride-2 pad-1 3x3x3 conv. Replaces
    ``conv3d_band_s2_pallas`` (K4).
  * :func:`deconv3d_bn_act` — ConvTranspose3d(k3, s2, p1, output_padding 1)
    with the torch ``(I, O, 3, 3, 3)`` weight. Replaces
    ``conv3d_band_deconv_pallas`` (K5) and ``conv3d_fold_deconv_pallas``
    (K7).

On a CUDA tensor each function launches its kernel, all three on the
tensor-core machinery of ``kernels/csrc/igemm_tc.cuh`` (the stride-1 conv:
``conv3d_s1.cu``, with a kernel of its own for Cout 1 and, for the bf16
calls :func:`box_eligible` admits, the box-tiled kernel of
``conv3d_box.cuh``; the stride-2 conv:
``conv3d_s2.cu``; the deconv: ``conv3d.cu``, its eight output parity
phases walked one after another; each source's note says what bounds it
and how it is built), or raises on an input the kernel does not take. On a
CPU tensor, or when the caller passes ``plain=True``, it runs the plain
PyTorch version below: ``F.conv3d``/``F.conv_transpose3d`` in f32 and the
same epilogue.

The weight is the torch layout, or the kernel's own layout, which saves the
per-call repack where a layer keeps it (``models/blocks.py`` does): the
K-major :class:`~mode_tpu_torch.ops.kmajor.TcWeight` of
:func:`pack_weight_tc` (the deconv's with ``transpose=True``). Each also
takes the ``(27, Cin, Cout)`` layout of :func:`pack_weight`, repacked per
call.

Under a spatial mesh (``parallel/shard_ops.py``) each call takes
``h_halo=True``: ``x`` then holds this rank's rows of H with one halo plane
above and below (its neighbours' rows, or zeros at the mesh's edges), H is
not padded, and the output is this rank's rows of the unsharded call:
``H - 2`` of them at stride 1, ``(H - 2) // 2`` at stride 2 (the rows
starting on an even global row), ``2 (H - 2)`` for the deconv, which does
not read the upper halo plane. The kernels take the halo as an H origin of
one row; the plain versions pad D and W only.

For training, :func:`conv3d_train` and :func:`deconv3d_train` are the bare
convs as autograd Functions whose forward and grad-input run these kernels
(the JAX package's custom VJPs), and ``train_*_eligible`` are the JAX
package's gates for them. Given a ``mesh`` with a spatial axis, they run
on this rank's rows: the forward exchanges ``x``'s halo planes and runs
the halo form, the backward exchanges the cotangent's and runs the
grad-input's halo form on it (the JAX package trains under a mesh through
XLA's partitioner instead, its training kernels gated off).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from mode_tpu_torch import kernels, remat
from mode_tpu_torch.kernels import build
from mode_tpu_torch.ops import kmajor
from mode_tpu_torch.ops.epilogue import affine, epilogue
from mode_tpu_torch.ops.kmajor import TcWeight
from mode_tpu_torch.parallel.mesh import Mesh, halo_planes
from mode_tpu_torch.utils import profiling

_S1, _S2, _DECONV = 0, 1, 2
_NAMES = {_S1: "conv3d_s1_bn_act", _S2: "conv3d_s2_bn_act",
          _DECONV: "deconv3d_bn_act"}
_DTYPES = (torch.float32, torch.bfloat16)
_H = 2              # the H axis of an NDHWC volume


@functools.cache
def _deconv3d_lib():
  lib = build.load("conv3d")
  lib.deconv3d_bn_act.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 7
                                  + [ctypes.c_int] * 8 + [ctypes.c_void_p])
  lib.deconv3d_bn_act.restype = ctypes.c_int
  return lib


@functools.cache
def _conv3d_s1_lib():
  lib = build.load("conv3d_s1")
  lib.conv3d_s1_bn_act.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 7
                                   + [ctypes.c_int] * 9 + [ctypes.c_void_p])
  lib.conv3d_s1_bn_act.restype = ctypes.c_int
  return lib


@functools.cache
def _conv3d_s2_lib():
  lib = build.load("conv3d_s2")
  lib.conv3d_s2_bn_act.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 6
                                   + [ctypes.c_int] * 8 + [ctypes.c_void_p])
  lib.conv3d_s2_bn_act.restype = ctypes.c_int
  return lib


# The most shared memory a block can take on the card (227 KB), and what
# the Cout-1 head kernel needs for Cin channels of `itemsize` bytes
# (conv3d_s1.cu:head_smem): two halo planes of 34 x 10 voxels, each padded
# by 16 bytes, and the f32 weights.
SMEM_MAX = 232448


def head_smem(cin: int, itemsize: int) -> int:
  return 2 * 340 * (cin * itemsize + 16) + 27 * cin * 4


# The channel counts the box kernel takes: its weight slice (27 x Cin x 32
# bf16, 110 KB at Cin 64) stays in shared memory beside two input boxes.
BOX_CHANNELS = (32, 64)


def box_eligible(dtype: torch.dtype, cin: int, cout: int,
                 h_halo: bool = False) -> bool:
  """Whether a stride-1 call runs on the box kernel
  (``conv3d_s1.cu``'s ``box`` flag): bf16, unhaloed, Cin and Cout 32 or
  64. Everything else (f32, the halo forms, the Cout-1 head, other
  widths) stays on the tile kernel of ``igemm_tc.cuh`` or the head
  kernel."""
  return (dtype == torch.bfloat16 and not h_halo and cin in BOX_CHANNELS
          and cout in BOX_CHANNELS)


def pack_weight(weight: torch.Tensor, transpose: bool = False
                ) -> torch.Tensor:
  """The kernel's weight layout ``(27, Cin, Cout)``, taps in (kd, kh, kw)
  order, from a torch conv weight ``(Cout, Cin, 3, 3, 3)`` or, with
  ``transpose``, a transpose-conv weight ``(Cin, Cout, 3, 3, 3)``."""
  if weight.dim() != 5 or weight.shape[2:] != (3, 3, 3):
    raise ValueError(f"expected a 3x3x3 torch weight, got "
                     f"{tuple(weight.shape)}")
  wk = weight.permute(2, 3, 4, 0, 1) if transpose else weight.permute(
      2, 3, 4, 1, 0)
  return wk.reshape(27, *wk.shape[3:]).contiguous()


def pack_weight_tc(weight: torch.Tensor, stride: int = 1,
                   transpose: bool = False) -> TcWeight:
  """The tensor-core kernels' K-major weight ``(P, 27, Cout, Cin)``, taps
  in (kd, kh, kw) order, from a torch conv weight ``(Cout, Cin, 3, 3, 3)``
  or, with ``transpose``, the deconv's transpose-conv weight ``(Cin, Cout,
  3, 3, 3)``; in f32 split into ``big`` and ``small`` for 3xTF32, except
  for the stride-1 conv's Cout 1 (the head kernel, f32 FMAs)."""
  if weight.dim() != 5 or weight.shape[2:] != (3, 3, 3):
    raise ValueError(f"expected a 3x3x3 torch weight, got "
                     f"{tuple(weight.shape)}")
  if transpose:
    cin, cout = weight.shape[:2]
    wk = weight.permute(2, 3, 4, 1, 0)
  else:
    cout, cin = weight.shape[:2]
    wk = weight.permute(2, 3, 4, 0, 1)
  return kmajor.pack(wk.reshape(27, cout, cin), weight,
                     split=cout > 1 or stride == 2 or transpose,
                     transposed=transpose)


def _torch_weight(mode, weight):
  """``weight`` in torch layout, unpacking a ``pack_weight`` or
  ``pack_weight_tc`` result."""
  if isinstance(weight, TcWeight):
    return weight.weight
  if weight.dim() == 5:
    return weight
  wk = weight.reshape(3, 3, 3, *weight.shape[1:])
  return wk.permute(3, 4, 0, 1, 2) if mode == _DECONV else wk.permute(
      4, 3, 0, 1, 2)


def _out_shape(mode: int, x_shape, cout: int,
               h_halo: bool = False) -> tuple[int, ...]:
  b, d, h, w, _ = x_shape
  if h_halo:
    h -= 2
    if h < 1 or (mode == _S2 and h % 2):
      own = ("an even count of rows" if mode == _S2
             else "at least one row")
      raise ValueError(f"{_NAMES[mode]}: a haloed x holds two halo planes "
                       f"and {own} of its own, got H {h + 2}")
  if mode == _S1:
    return (b, d, h, w, cout)
  if mode == _S2:   # (a haloed H is even: (H - 1) // 2 + 1 = H / 2)
    return (b, (d - 1) // 2 + 1, (h - 1) // 2 + 1, (w - 1) // 2 + 1, cout)
  return (b, 2 * d, 2 * h, 2 * w, cout)


def _plain(mode, x, weight, scale, bias, residual, relu, h_halo=False):
  """The same function in plain PyTorch, in f32, cast to ``x.dtype``; with
  ``h_halo`` H padded by the halo planes instead of zeros."""
  xc = x.float().permute(0, 4, 1, 2, 3)
  weight = _torch_weight(mode, weight)
  if mode == _DECONV:
    # the transposed conv reads its own rows and the one below: drop the
    # upper halo plane, and the two output rows of the lower one
    src = xc[:, :, :, 1:] if h_halo else xc
    y = F.conv_transpose3d(src, weight.float(), stride=2, padding=1,
                           output_padding=1)
    if h_halo:
      y = y[:, :, :, :-2]
  elif h_halo:
    y = F.conv3d(F.pad(xc, (1, 1, 0, 0, 1, 1)), weight.float(),
                 stride=1 if mode == _S1 else 2)
  else:
    y = F.conv3d(xc, weight.float(), stride=1 if mode == _S1 else 2,
                 padding=1)
  return epilogue(y.permute(0, 2, 3, 4, 1), scale, bias, residual, relu,
                  x.dtype)


def _check_residual(name, x, residual, shape):
  if residual is not None and (tuple(residual.shape) != shape
                               or residual.dtype != x.dtype
                               or residual.device != x.device
                               or not residual.is_contiguous()):
    raise ValueError(f"{name}: residual must be a contiguous {x.dtype} "
                     f"tensor of shape {shape}")


def _launch(mode, x, weight, scale, bias, residual, relu, h_halo=False):
  """The stride-1 conv on ``conv3d_s1.cu`` (the box kernel where
  :func:`box_eligible`, else the tensor-core kernel, or the head kernel for
  Cout 1), the stride-2 conv on ``conv3d_s2.cu``, the deconv on
  ``conv3d.cu``; each C entry takes x's extents and the halo flag, the
  stride-1 conv's the box flag too."""
  name = _NAMES[mode]
  if x.dim() != 5 or x.dtype not in _DTYPES or not x.is_contiguous():
    raise ValueError(f"{name}: x must be a contiguous f32 or bf16 NDHWC "
                     f"volume, got {tuple(x.shape)} {x.dtype}")
  cin = x.shape[-1]
  deconv = mode == _DECONV
  tw = weight if isinstance(weight, TcWeight) else pack_weight_tc(
      _torch_weight(mode, weight), 1 if mode == _S1 else 2, deconv)
  cout = tw.cout
  head = mode == _S1 and cout == 1
  wbig, wsmall = kmajor.operands(name, x, tw, 27,
                                 x.dtype == torch.float32 and not head,
                                 deconv)
  if head and head_smem(cin, x.element_size()) > SMEM_MAX:
    raise ValueError(f"{name}: the Cout-1 head kernel takes Cin up to "
                     f"{72 if x.dtype == torch.float32 else 144} "
                     f"in {x.dtype}, got Cin {cin}")
  shape = _out_shape(mode, x.shape, cout, h_halo)
  _check_residual(name, x, residual, shape)
  out = torch.empty(shape, dtype=x.dtype, device=x.device)
  flag = int(x.dtype == torch.bfloat16)
  ptrs = (x.data_ptr(), wbig, wsmall, scale.data_ptr(), bias.data_ptr())
  extents = (*x.shape[:4], cin, cout, int(relu), int(h_halo))
  if mode == _S2:
    kernels.launch(name, _conv3d_s2_lib().conv3d_s2_bn_act, x.device, flag,
                   *ptrs, out.data_ptr(), *extents, halo=h_halo,
                   shape=extents[:6])
  elif deconv:
    kernels.launch(name, _deconv3d_lib().deconv3d_bn_act, x.device, flag,
                   *ptrs, None if residual is None else residual.data_ptr(),
                   out.data_ptr(), *extents, halo=h_halo, shape=extents[:6])
  else:
    box = box_eligible(x.dtype, cin, cout, h_halo)
    kernels.launch(name, _conv3d_s1_lib().conv3d_s1_bn_act, x.device, flag,
                   *ptrs, None if residual is None else residual.data_ptr(),
                   out.data_ptr(), *extents, int(box), halo=h_halo, box=box,
                   shape=extents[:6])
    if box:
      profiling.count("conv3d_s1.box")
  return out


def _run(mode, x, weight, scale, bias, residual, relu, plain, h_halo=False):
  cout = _torch_weight(mode, weight).shape[1 if mode == _DECONV else 0]
  scale, bias = affine(scale, bias, cout, x.device)
  if plain or x.device.type == "cpu":
    _out_shape(mode, x.shape, cout, h_halo)      # the same refusals
    return _plain(mode, x, weight, scale, bias, residual, relu, h_halo)
  if x.device.type != "cuda":
    raise ValueError(f"{_NAMES[mode]}: unsupported device {x.device}")
  return _launch(mode, x, weight, scale, bias, residual, relu, h_halo)


def conv3d_s1_bn_act(x: torch.Tensor, weight: torch.Tensor,
                     scale: torch.Tensor | None = None,
                     bias: torch.Tensor | None = None,
                     residual: torch.Tensor | None = None,
                     relu: bool = False, *, h_halo: bool = False,
                     plain: bool = False) -> torch.Tensor:
  """Stride-1 SAME 3x3x3 conv + affine (+ residual) (+ ReLU).

  Args:
    x: ``(B, D, H, W, Cin)`` f32 or bf16, contiguous; on the card Cin a
      multiple of 8.
    weight: torch ``(Cout, Cin, 3, 3, 3)``, its :func:`pack_weight_tc`
      layout (the kernel's) or its :func:`pack_weight` layout ``(27, Cin,
      Cout)``; same dtype as ``x``.
    scale, bias: ``(Cout,)`` epilogue affine, kept in f32 (1 and 0 if None).
    residual: optional ``(B, D, H, W, Cout)`` added before the ReLU.
    h_halo: ``x`` carries a halo plane above and below its rows (module
      docstring); the output and the residual then have ``H - 2`` rows.
    plain: run the plain PyTorch version even on a CUDA tensor.
  Returns:
    ``(B, D, H, W, Cout)`` in ``x.dtype``.
  """
  return _run(_S1, x, weight, scale, bias, residual, relu, plain, h_halo)


def conv3d_s2_bn_act(x: torch.Tensor, weight: torch.Tensor,
                     scale: torch.Tensor | None = None,
                     bias: torch.Tensor | None = None,
                     relu: bool = False, *, h_halo: bool = False,
                     plain: bool = False) -> torch.Tensor:
  """Stride-2 pad-1 3x3x3 conv + affine (+ ReLU): ``(B, D, H, W, Cin)`` ->
  ``(B, ceil(D/2), ceil(H/2), ceil(W/2), Cout)``, with ``h_halo`` ``(H -
  2) / 2`` rows (``H - 2`` even); arguments as for
  :func:`conv3d_s1_bn_act` (the kernel's layout:
  ``pack_weight_tc(weight, stride=2)``)."""
  return _run(_S2, x, weight, scale, bias, None, relu, plain, h_halo)


def deconv3d_bn_act(x: torch.Tensor, weight: torch.Tensor,
                    scale: torch.Tensor | None = None,
                    bias: torch.Tensor | None = None,
                    residual: torch.Tensor | None = None,
                    relu: bool = False, *, h_halo: bool = False,
                    plain: bool = False) -> torch.Tensor:
  """ConvTranspose3d(k3, s2, p1, output_padding 1) + affine (+ residual)
  (+ ReLU): ``(B, D, H, W, Cin)`` -> ``(B, 2D, 2H, 2W, Cout)``, with
  ``h_halo`` ``2 (H - 2)`` rows.

  ``weight`` is the torch transpose-conv layout ``(Cin, Cout, 3, 3, 3)``,
  its ``pack_weight_tc(weight, transpose=True)`` layout (the kernel's) or
  its ``pack_weight(weight, transpose=True)`` layout; on the card Cin a
  multiple of 8. The other arguments are as for :func:`conv3d_s1_bn_act`.
  """
  return _run(_DECONV, x, weight, scale, bias, residual, relu, plain,
              h_halo)


# --- training ---------------------------------------------------------------
# The JAX package's custom VJPs around its 3-D kernels
# (conv3d_kernel.py:1317-1343, 1526-1580) as autograd Functions: the forward
# and the grad-input run the port's kernels, the grad-weight stays a library
# call (cuDNN on the card), as the JAX package leaves it to XLA.


def _lane_axis(shape) -> bool:
  """Whether an NDHWC volume has a spatial axis the TPU kernels put on the
  lanes (``conv3d_kernel.py:lane_axis_for``): W or H a multiple of 128."""
  return shape[3] % 128 == 0 or shape[2] % 128 == 0


def _deconv_routable(shape, cout: int) -> bool:
  """``conv3d_kernel.py:_deconv_route`` is not None: a band deconv on a lane
  axis, or the folded one over H*W (a multiple of 128)."""
  return (shape[4] % 8 == 0 and cout % 8 == 0
          and (_lane_axis(shape) or (shape[2] * shape[3]) % 128 == 0))


def _s2_routable(shape, cout: int) -> bool:
  """``conv3d_kernel.py:_s2_route`` is not None."""
  b, d, h, w, c = shape
  return (_lane_axis(shape) and c % 8 == 0 and cout % 8 == 0
          and d % 2 == 0 and h % 2 == 0 and w % 2 == 0)


# The TPU kernels' training gates with their memory budgets left out (a TPU
# limit). The stride-1 conv needs batch >= 2 (conv3d_kernel.py:1230).
TRAIN_MIN_BATCH = 2


def train_s1_eligible(x_shape, cout: int) -> bool:
  """``conv3d_kernel.py:train_conv3d_eligible``: batch >= 2, a lane axis,
  Cin and Cout multiples of 8. The Cout-1 classifier heads and the 1/16
  level (no lane axis) stay off the kernel."""
  return (x_shape[0] >= TRAIN_MIN_BATCH and _lane_axis(x_shape)
          and x_shape[4] % 8 == 0 and cout % 8 == 0)


def train_s2_eligible(x_shape, cout: int) -> bool:
  """``conv3d_kernel.py:train_s2_eligible``: the stride-2 conv and its
  grad-input deconv (at the half-resolution cotangent) both route."""
  b, d, h, w, c = x_shape
  return (_s2_routable(x_shape, cout)
          and _deconv_routable((b, d // 2, h // 2, w // 2, cout), c))


def train_deconv_eligible(x_shape, cout: int) -> bool:
  """``conv3d_kernel.py:train_deconv_eligible``: the deconv and its
  grad-input stride-2 conv (at the double-resolution cotangent) both
  route."""
  b, d, h, w, c = x_shape
  return (_deconv_routable(x_shape, cout)
          and _s2_routable((b, 2 * d, 2 * h, 2 * w, cout), c))


def _grad_weight(mode, x, weight, g, h_halo=False):
  """The weight's gradient, one library call on channels-last views; with
  ``h_halo`` the input of the conv's adjoint (``x``, or the deconv's
  ``g``) holds its halo rows and H is not padded."""
  xc, gc = x.permute(0, 4, 1, 2, 3), g.permute(0, 4, 1, 2, 3)
  pad = (1, 0, 1) if h_halo else 1
  if mode == _DECONV:
    # the deconv is the adjoint of the stride-2 conv with the same tensor:
    # <g, deconv(x, w)> = <conv_s2(g, w), x>
    return torch.nn.grad.conv3d_weight(gc, weight.shape, xc, stride=2,
                                       padding=pad)
  return torch.nn.grad.conv3d_weight(xc, weight.shape, gc,
                                     stride=1 if mode == _S1 else 2,
                                     padding=pad)


def _grad_input(mode, g, weight, plain, h_halo=False):
  """The input's gradient on the kernels: the stride-1 conv with the
  flipped, io-swapped weight, the deconv for the stride-2 conv and the
  stride-2 conv for the deconv (see :class:`_Conv3d`)."""
  if mode == _S1:
    wt = weight.flip((2, 3, 4)).transpose(0, 1)
    return _run(_S1, g, wt, None, None, None, False, plain, h_halo)
  return _run(_DECONV if mode == _S2 else _S2, g, weight, None, None, None,
              False, plain, h_halo)


class _Conv3d(torch.autograd.Function):
  """A bare 3-D conv (no affine, no residual, no ReLU) whose forward and
  grad-input run the port's kernels (their plain versions on the CPU or
  with ``plain``):
    * stride 1: grad-input is the stride-1 conv with the spatially flipped,
      io-swapped weight;
    * stride 2: grad-input is the deconv kernel with the same tensor, the
      conv's ``(Cout, Cin, k)`` read as the transpose conv's ``(I, O, k)``;
    * deconv: grad-input is the stride-2 kernel with the same tensor.
  The weight is the torch-layout ``Parameter``, packed in each call."""

  @staticmethod
  def forward(ctx, x, weight, mode, plain):
    x = x.contiguous()
    ctx.save_for_backward(x, weight)
    ctx.mode, ctx.plain = mode, plain
    return remat.conv_output(
        lambda: _run(mode, x, weight, None, None, None, False, plain))

  @staticmethod
  def backward(ctx, g):
    x, weight = ctx.saved_tensors
    mode, plain = ctx.mode, ctx.plain
    g = g.contiguous()
    dx = dw = None
    if ctx.needs_input_grad[0]:
      dx = _grad_input(mode, g, weight, plain)
    if ctx.needs_input_grad[1]:
      dw = _grad_weight(mode, x, weight, g)
    return dx, dw, None, None


class _Conv3dRows(torch.autograd.Function):
  """:class:`_Conv3d` on this rank's rows of H under a spatial mesh. The
  forward brings ``x``'s halo planes from the neighbours
  (``mesh.halo_planes``) and runs the kernel's halo form; the backward
  brings the cotangent's and runs the grad-input's halo form on them:
    * stride 1: ``dx`` of a row reads ``g`` a row either side;
    * stride 2: the deconv's halo form reads ``g``'s rows and the next
      rank's first;
    * deconv: the stride-2 halo form reads the double-resolution ``g``'s
      rows, which start on an even row, and the previous rank's last.
  The weight's gradient is this rank's share (the library call on the
  haloed input, H unpadded); the gradient average over the mesh sums the
  shares. Each run exchanges its halo planes, a rematerialised block's
  rerun too, so every rank issues the same collectives."""

  @staticmethod
  def forward(ctx, x, weight, mode, plain, mesh):
    x = x.contiguous()
    above, below = halo_planes(x, _H, mesh)
    ctx.save_for_backward(x, above, below, weight)
    ctx.mode, ctx.plain, ctx.mesh = mode, plain, mesh
    return remat.conv_output(lambda: _run(
        mode, torch.cat([above, x, below], _H), weight, None, None, None,
        False, plain, True))

  @staticmethod
  def backward(ctx, g):
    x, above, below, weight = ctx.saved_tensors
    mode, plain = ctx.mode, ctx.plain
    g = g.contiguous()
    g_above, g_below = halo_planes(g, _H, ctx.mesh)
    gh = torch.cat([g_above, g, g_below], _H)
    dx = dw = None
    if ctx.needs_input_grad[0]:
      dx = _grad_input(mode, gh, weight, plain, True)
    if ctx.needs_input_grad[1]:
      if mode == _DECONV:
        dw = _grad_weight(mode, x, weight, gh, True)
      else:
        dw = _grad_weight(mode, torch.cat([above, x, below], _H), weight, g,
                          True)
    return dx, dw, None, None, None


def _sharded(mesh: Mesh | None) -> bool:
  return mesh is not None and mesh.spatial > 1


def conv3d_train(x: torch.Tensor, weight: torch.Tensor, stride: int = 1, *,
                 plain: bool = False, mesh: Mesh | None = None
                 ) -> torch.Tensor:
  """The bare stride-1 or stride-2 pad-1 3x3x3 conv with the kernels'
  gradients; ``x`` NDHWC, ``weight`` torch ``(Cout, Cin, 3, 3, 3)``. With
  a ``mesh`` whose spatial axis is above 1, ``x`` is this rank's rows of H
  and so is the output (module docstring); at stride 2 the rows must start
  on an even global row."""
  rows = _sharded(mesh)
  if stride == 2 and any(n % 2 for n in x.shape[1:4]):
    raise ValueError(
        "the stride-2 conv trains on even extents only, its grad-input "
        "deconv doubles them" + (
            f"; under a spatial mesh the whole H must be a multiple of 2 x "
            f"spatial (H {x.shape[_H] * mesh.spatial} over {mesh.spatial} "
            "ranks)" if rows else ""))
  mode = _S1 if stride == 1 else _S2
  if rows:
    return _Conv3dRows.apply(x, weight, mode, plain, mesh)
  return _Conv3d.apply(x, weight, mode, plain)


def deconv3d_train(x: torch.Tensor, weight: torch.Tensor, *,
                   plain: bool = False, mesh: Mesh | None = None
                   ) -> torch.Tensor:
  """The bare ConvTranspose3d(k3, s2, p1, output_padding 1) with the
  kernels' gradients; ``weight`` torch ``(Cin, Cout, 3, 3, 3)``; ``mesh``
  as for :func:`conv3d_train` (twice this rank's rows out)."""
  if _sharded(mesh):
    return _Conv3dRows.apply(x, weight, _DECONV, plain, mesh)
  return _Conv3d.apply(x, weight, _DECONV, plain)
