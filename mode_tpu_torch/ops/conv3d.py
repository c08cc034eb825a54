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

On a CUDA tensor each function launches its kernel (the stride-1 conv:
``kernels/csrc/conv3d_s1.cu``, on the tensor cores, with a kernel of its own
for Cout 1; the others: ``kernels/csrc/conv3d.cu``; each source's note
says what bounds it and how it is built), or raises on an input the kernel
does not take. On a CPU tensor, or when the caller passes ``plain=True``, it
runs the plain PyTorch version below: ``F.conv3d``/``F.conv_transpose3d`` in
f32 and the same epilogue.

The weight is the torch layout, or the kernel's own layout, which saves the
per-call repack where a layer keeps it (``models/blocks.py`` does): for the
stride-1 conv the K-major :class:`~mode_tpu_torch.ops.kmajor.TcWeight` of
:func:`pack_weight_tc`, for the others ``(27, Cin, Cout)`` from
:func:`pack_weight`.

For training, :func:`conv3d_train` and :func:`deconv3d_train` are the bare
convs as autograd Functions whose forward and grad-input run these kernels
(the JAX package's custom VJPs), and ``train_*_eligible`` are the JAX
package's gates for them.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from mode_tpu_torch.kernels import LAUNCHES
from mode_tpu_torch.kernels import build
from mode_tpu_torch.ops import kmajor
from mode_tpu_torch.ops.epilogue import affine, epilogue
from mode_tpu_torch.ops.kmajor import TcWeight

_S1, _S2, _DECONV = 0, 1, 2
_NAMES = {_S1: "conv3d_s1_bn_act", _S2: "conv3d_s2_bn_act",
          _DECONV: "deconv3d_bn_act"}
_DTYPES = (torch.float32, torch.bfloat16)


@functools.cache
def _conv3d_lib():
  lib = build.load("conv3d")
  lib.conv3d_bn_act.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 6
                                + [ctypes.c_int] * 10 + [ctypes.c_void_p])
  lib.conv3d_bn_act.restype = ctypes.c_int
  return lib


@functools.cache
def _conv3d_s1_lib():
  lib = build.load("conv3d_s1")
  lib.conv3d_s1_bn_act.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 7
                                   + [ctypes.c_int] * 7 + [ctypes.c_void_p])
  lib.conv3d_s1_bn_act.restype = ctypes.c_int
  return lib


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


def pack_weight_tc(weight: torch.Tensor) -> TcWeight:
  """The stride-1 kernel's K-major weight ``(P, 27, Cout, Cin)``, taps in
  (kd, kh, kw) order, from a torch conv weight ``(Cout, Cin, 3, 3, 3)``; in
  f32 split into ``big`` and ``small`` for 3xTF32, except for Cout 1 (the
  head kernel, f32 FMAs)."""
  if weight.dim() != 5 or weight.shape[2:] != (3, 3, 3):
    raise ValueError(f"expected a 3x3x3 torch weight, got "
                     f"{tuple(weight.shape)}")
  cout, cin = weight.shape[:2]
  wk = weight.permute(2, 3, 4, 0, 1).reshape(27, cout, cin)
  return kmajor.pack(wk, weight, split=cout > 1)


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


def _out_shape(mode: int, x_shape, cout: int) -> tuple[int, ...]:
  b, d, h, w, _ = x_shape
  if mode == _S1:
    return (b, d, h, w, cout)
  if mode == _S2:
    return (b, (d - 1) // 2 + 1, (h - 1) // 2 + 1, (w - 1) // 2 + 1, cout)
  return (b, 2 * d, 2 * h, 2 * w, cout)


def _plain(mode, x, weight, scale, bias, residual, relu):
  """The same function in plain PyTorch, in f32, cast to ``x.dtype``."""
  xc = x.float().permute(0, 4, 1, 2, 3)
  weight = _torch_weight(mode, weight)
  if mode == _DECONV:
    y = F.conv_transpose3d(xc, weight.float(), stride=2, padding=1,
                           output_padding=1)
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


def _launch_s1(x, weight, scale, bias, residual, relu):
  """The stride-1 conv on ``conv3d_s1.cu``: the tensor-core kernel, or the
  head kernel for Cout 1."""
  name = _NAMES[_S1]
  cin = x.shape[-1]
  if cin % 8 or x.data_ptr() % 16:
    raise ValueError(f"{name}: Cin must be a multiple of 8 and x 16-byte "
                     f"aligned, got Cin {cin}")
  tw = weight if isinstance(weight, TcWeight) else pack_weight_tc(
      _torch_weight(_S1, weight))
  parts, cout = tw.parts, tw.cout
  split = x.dtype == torch.float32 and cout > 1
  wcin = -(-cin // kmajor.STAGE_CHANNELS) * kmajor.STAGE_CHANNELS
  nparts = 2 if split else 1
  if (parts.shape != (nparts, 27, cout, wcin if split else cin)
      or tw.weight.shape[1] != cin or parts.dtype != x.dtype
      or parts.device != x.device or not parts.is_contiguous()):
    raise ValueError(f"{name}: weight {tuple(parts.shape)} {parts.dtype} "
                     f"does not match x {tuple(x.shape)} {x.dtype}")
  shape = (*x.shape[:4], cout)
  _check_residual(name, x, residual, shape)
  out = torch.empty(shape, dtype=x.dtype, device=x.device)
  err = _conv3d_s1_lib().conv3d_s1_bn_act(
      int(x.dtype == torch.bfloat16), x.data_ptr(), parts[0].data_ptr(),
      parts[1].data_ptr() if nparts == 2 else None, scale.data_ptr(),
      bias.data_ptr(), None if residual is None else residual.data_ptr(),
      out.data_ptr(), *x.shape[:4], cin, cout, int(relu),
      torch.cuda.current_stream(x.device).cuda_stream)
  if err != 0:
    raise RuntimeError(f"{name}: kernel launch failed with CUDA error {err}")
  LAUNCHES[name] += 1
  return out


def _launch(mode, x, weight, scale, bias, residual, relu):
  cin = x.shape[-1]
  if x.dim() != 5 or x.dtype not in _DTYPES or not x.is_contiguous():
    raise ValueError(f"{_NAMES[mode]}: x must be a contiguous f32 or bf16 "
                     f"NDHWC volume, got {tuple(x.shape)} {x.dtype}")
  if mode == _S1:
    return _launch_s1(x, weight, scale, bias, residual, relu)
  wk = (weight if weight.dim() == 3
        else pack_weight(weight, transpose=mode == _DECONV))
  if (wk.shape[:2] != (27, cin) or wk.dtype != x.dtype
      or wk.device != x.device or not wk.is_contiguous()):
    raise ValueError(f"{_NAMES[mode]}: weight {tuple(weight.shape)} "
                     f"{weight.dtype} does not match x {tuple(x.shape)} "
                     f"{x.dtype}")
  cout = wk.shape[2]
  shape = _out_shape(mode, x.shape, cout)
  _check_residual(_NAMES[mode], x, residual, shape)
  out = torch.empty(shape, dtype=x.dtype, device=x.device)
  err = _conv3d_lib().conv3d_bn_act(
      mode, int(x.dtype == torch.bfloat16), x.data_ptr(), wk.data_ptr(),
      scale.data_ptr(), bias.data_ptr(),
      None if residual is None else residual.data_ptr(), out.data_ptr(),
      *x.shape[:4], cin, *shape[1:4], cout, int(relu),
      torch.cuda.current_stream(x.device).cuda_stream)
  if err != 0:
    raise RuntimeError(f"{_NAMES[mode]}: kernel launch failed with CUDA "
                       f"error {err}")
  LAUNCHES[_NAMES[mode]] += 1
  return out


def _run(mode, x, weight, scale, bias, residual, relu, plain):
  cout = _torch_weight(mode, weight).shape[1 if mode == _DECONV else 0]
  scale, bias = affine(scale, bias, cout, x.device)
  if plain or x.device.type == "cpu":
    return _plain(mode, x, weight, scale, bias, residual, relu)
  if x.device.type != "cuda":
    raise ValueError(f"{_NAMES[mode]}: unsupported device {x.device}")
  return _launch(mode, x, weight, scale, bias, residual, relu)


def conv3d_s1_bn_act(x: torch.Tensor, weight: torch.Tensor,
                     scale: torch.Tensor | None = None,
                     bias: torch.Tensor | None = None,
                     residual: torch.Tensor | None = None,
                     relu: bool = False, *, plain: bool = False
                     ) -> torch.Tensor:
  """Stride-1 SAME 3x3x3 conv + affine (+ residual) (+ ReLU).

  Args:
    x: ``(B, D, H, W, Cin)`` f32 or bf16, contiguous; on the card Cin a
      multiple of 8.
    weight: torch ``(Cout, Cin, 3, 3, 3)``, its :func:`pack_weight_tc`
      layout (the kernel's) or its :func:`pack_weight` layout ``(27, Cin,
      Cout)``; same dtype as ``x``.
    scale, bias: ``(Cout,)`` epilogue affine, kept in f32 (1 and 0 if None).
    residual: optional ``(B, D, H, W, Cout)`` added before the ReLU.
    plain: run the plain PyTorch version even on a CUDA tensor.
  Returns:
    ``(B, D, H, W, Cout)`` in ``x.dtype``.
  """
  return _run(_S1, x, weight, scale, bias, residual, relu, plain)


def conv3d_s2_bn_act(x: torch.Tensor, weight: torch.Tensor,
                     scale: torch.Tensor | None = None,
                     bias: torch.Tensor | None = None,
                     relu: bool = False, *, plain: bool = False
                     ) -> torch.Tensor:
  """Stride-2 pad-1 3x3x3 conv + affine (+ ReLU): ``(B, D, H, W, Cin)`` ->
  ``(B, ceil(D/2), ceil(H/2), ceil(W/2), Cout)``; arguments as for
  :func:`conv3d_s1_bn_act`."""
  return _run(_S2, x, weight, scale, bias, None, relu, plain)


def deconv3d_bn_act(x: torch.Tensor, weight: torch.Tensor,
                    scale: torch.Tensor | None = None,
                    bias: torch.Tensor | None = None,
                    residual: torch.Tensor | None = None,
                    relu: bool = False, *, plain: bool = False
                    ) -> torch.Tensor:
  """ConvTranspose3d(k3, s2, p1, output_padding 1) + affine (+ residual)
  (+ ReLU): ``(B, D, H, W, Cin)`` -> ``(B, 2D, 2H, 2W, Cout)``.

  ``weight`` is the torch transpose-conv layout ``(Cin, Cout, 3, 3, 3)``,
  or its ``pack_weight(weight, transpose=True)`` layout; the other arguments are as for :func:`conv3d_s1_bn_act`.
  """
  return _run(_DECONV, x, weight, scale, bias, residual, relu, plain)


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


def _grad_weight(mode, x, weight, g):
  """The weight's gradient, one library call on channels-last views."""
  xc, gc = x.permute(0, 4, 1, 2, 3), g.permute(0, 4, 1, 2, 3)
  if mode == _DECONV:
    # the deconv is the adjoint of the stride-2 conv with the same tensor:
    # <g, deconv(x, w)> = <conv_s2(g, w), x>
    return torch.nn.grad.conv3d_weight(gc, weight.shape, xc, stride=2,
                                       padding=1)
  return torch.nn.grad.conv3d_weight(xc, weight.shape, gc,
                                     stride=1 if mode == _S1 else 2,
                                     padding=1)


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
    return _run(mode, x, weight, None, None, None, False, plain)

  @staticmethod
  def backward(ctx, g):
    x, weight = ctx.saved_tensors
    mode, plain = ctx.mode, ctx.plain
    g = g.contiguous()
    dx = dw = None
    if ctx.needs_input_grad[0]:
      if mode == _S1:
        wt = weight.flip((2, 3, 4)).transpose(0, 1)
        dx = _run(_S1, g, wt, None, None, None, False, plain)
      else:
        dx = _run(_DECONV if mode == _S2 else _S2, g, weight, None, None,
                  None, False, plain)
    if ctx.needs_input_grad[1]:
      dw = _grad_weight(mode, x, weight, g)
    return dx, dw, None, None


def conv3d_train(x: torch.Tensor, weight: torch.Tensor, stride: int = 1, *,
                 plain: bool = False) -> torch.Tensor:
  """The bare stride-1 or stride-2 pad-1 3x3x3 conv with the kernels'
  gradients; ``x`` NDHWC, ``weight`` torch ``(Cout, Cin, 3, 3, 3)``."""
  if stride == 2 and any(n % 2 for n in x.shape[1:4]):
    raise ValueError("the stride-2 conv trains on even extents only, its "
                     "grad-input deconv doubles them")
  return _Conv3d.apply(x, weight, _S1 if stride == 1 else _S2, plain)


def deconv3d_train(x: torch.Tensor, weight: torch.Tensor, *,
                   plain: bool = False) -> torch.Tensor:
  """The bare ConvTranspose3d(k3, s2, p1, output_padding 1) with the
  kernels' gradients; ``weight`` torch ``(Cin, Cout, 3, 3, 3)``."""
  return _Conv3d.apply(x, weight, _DECONV, plain)
