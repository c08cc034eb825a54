"""Stride-1 3x3 2-D convolution with a fused epilogue, on NHWC maps.

:func:`conv2d_s1_bn_act` computes ``act(conv2d(x, w) * scale + bias (+
residual))`` with padding = dilation (1 or 2), where ``scale``/``bias`` are
the folded eval-BatchNorm affine (f32) and ``act`` an optional ReLU, and
returns ``x.dtype``. It replaces ``mode_tpu/ops/pallas/conv2d_kernel.py:
conv2d_band_pallas`` (K8) and ``conv2d_band_bpack`` (K9): on the card the
batch is part of the GEMM's M, so one kernel takes both.

On a CUDA tensor it launches the tensor-core kernel of
``kernels/csrc/conv2d.cu`` (its source note says what bounds it and how it
is built), or raises on an input the kernel does not take. On a CPU tensor,
or when the caller passes ``plain=True``, it runs the plain PyTorch version:
``F.conv2d`` in f32 and the same epilogue.

Under a spatial mesh (``parallel/shard_ops.py``) a call takes
``h_halo=True``: ``x`` then holds this rank's rows of H with one halo row
above and below (its neighbours' rows, or zeros at the mesh's edges), H is
not padded, and the output is this rank's ``H - 2`` rows of the unsharded
call, as ``conv2d_band_pallas(..., m_halo=True)`` computes them. The kernel
takes the halo as an H origin of one row; the plain version pads W only.
Dilation 2 takes no halo (the JAX package shards only the dilation-1
per-image convs, ``mode_tpu/models/blocks.py:350``).

The weight is torch's ``(Cout, Cin, 3, 3)``, or the kernel's K-major
:class:`~mode_tpu_torch.ops.kmajor.TcWeight` from :func:`pack_weight_tc`,
which saves the per-call repack where a layer keeps it (``models/blocks.py``
does; so does the sphere conv's, ``ops/sphere_conv.py``).
:func:`pack_weight`'s ``(9, Cin, Cout)`` layout, that of the sphere conv's
backward, is taken too.

For training, :func:`conv2d_train` is the bare conv as an autograd Function
whose forward and grad-input run the kernel, as ``conv2d_3x3_fast_train``
runs K9 in the JAX package, where :func:`train_kernel_eligible` says so.
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

_NAME = "conv2d_s1_bn_act"
_DTYPES = (torch.float32, torch.bfloat16)


@functools.cache
def _conv2d_lib():
  lib = build.load("conv2d")
  lib.conv2d_s1_bn_act.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 7
                                   + [ctypes.c_int] * 8 + [ctypes.c_void_p])
  lib.conv2d_s1_bn_act.restype = ctypes.c_int
  return lib


def pack_weight(weight: torch.Tensor) -> torch.Tensor:
  """``(9, Cin, Cout)``, taps row-major over (kh, kw), from a torch
  ``(Cout, Cin, 3, 3)`` weight."""
  if weight.dim() != 4 or weight.shape[2:] != (3, 3):
    raise ValueError(f"expected a 3x3 torch weight, got "
                     f"{tuple(weight.shape)}")
  return weight.permute(2, 3, 1, 0).reshape(9, weight.shape[1],
                                            weight.shape[0]).contiguous()


def pack_weight_tc(weight: torch.Tensor) -> TcWeight:
  """The kernel's K-major weight ``(P, 9, Cout, Cin)``, taps row-major over
  (kh, kw), from a torch ``(Cout, Cin, 3, 3)`` weight; in f32 split into
  ``big`` and ``small`` for 3xTF32."""
  if weight.dim() != 4 or weight.shape[2:] != (3, 3):
    raise ValueError(f"expected a 3x3 torch weight, got "
                     f"{tuple(weight.shape)}")
  cout, cin = weight.shape[:2]
  wk = weight.permute(2, 3, 0, 1).reshape(9, cout, cin)
  return kmajor.pack(wk, weight, split=True)


def _torch_weight(weight):
  """``weight`` in torch layout, unpacking a packed one."""
  if isinstance(weight, TcWeight):
    return weight.weight
  if weight.dim() == 3:            # (9, Cin, Cout) -> (Cout, Cin, 3, 3)
    return weight.reshape(3, 3, *weight.shape[1:]).permute(3, 2, 0, 1)
  return weight


def _plain(x, weight, scale, bias, residual, relu, dilation, h_halo=False):
  """The same function in plain PyTorch, in f32, cast to ``x.dtype``; with
  ``h_halo`` H padded by the halo rows instead of zeros."""
  weight = _torch_weight(weight)
  y = F.conv2d(x.float().permute(0, 3, 1, 2), weight.float(),
               padding=(0, 1) if h_halo else dilation, dilation=dilation)
  return epilogue(y.permute(0, 2, 3, 1), scale, bias, residual, relu,
                  x.dtype)


def _out_shape(x_shape, cout: int, dilation: int,
               h_halo: bool) -> tuple[int, ...]:
  n, h, w, _ = x_shape
  if h_halo:
    if dilation != 1:
      raise ValueError(f"{_NAME}: a haloed x takes dilation 1, got "
                       f"{dilation}")
    if h < 3:
      raise ValueError(f"{_NAME}: a haloed x holds two halo rows and at "
                       f"least one row of its own, got H {h}")
    h -= 2
  return (n, h, w, cout)


def _launch(x, weight, scale, bias, residual, relu, dilation, h_halo=False):
  """The tensor-core kernel of ``conv2d.cu``; its C entry takes x's
  extents and the halo flag."""
  if x.dim() != 4 or x.dtype not in _DTYPES or not x.is_contiguous():
    raise ValueError(f"{_NAME}: x must be a contiguous f32 or bf16 NHWC "
                     f"map, got {tuple(x.shape)} {x.dtype}")
  n, h, w, cin = x.shape
  tw = weight if isinstance(weight, TcWeight) else pack_weight_tc(
      _torch_weight(weight))
  cout = tw.cout
  wbig, wsmall = kmajor.operands(_NAME, x, tw, 9, x.dtype == torch.float32)
  shape = _out_shape(x.shape, cout, dilation, h_halo)
  if residual is not None and (tuple(residual.shape) != shape
                               or residual.dtype != x.dtype
                               or residual.device != x.device
                               or not residual.is_contiguous()):
    raise ValueError(f"{_NAME}: residual must be a contiguous {x.dtype} "
                     f"tensor of shape {shape}")
  out = torch.empty(shape, dtype=x.dtype, device=x.device)
  kernels.launch(
      _NAME, _conv2d_lib().conv2d_s1_bn_act, x.device,
      int(x.dtype == torch.bfloat16), x.data_ptr(), wbig, wsmall,
      scale.data_ptr(), bias.data_ptr(),
      None if residual is None else residual.data_ptr(), out.data_ptr(),
      n, h, w, cin, cout, dilation, int(relu), int(h_halo), halo=h_halo,
      shape=(n, h, w, cin, cout))
  return out


def conv2d_s1_bn_act(x: torch.Tensor, weight: torch.Tensor,
                     scale: torch.Tensor | None = None,
                     bias: torch.Tensor | None = None,
                     residual: torch.Tensor | None = None,
                     relu: bool = False, dilation: int = 1, *,
                     h_halo: bool = False,
                     plain: bool = False) -> torch.Tensor:
  """Stride-1 3x3 conv, padding = dilation, + affine (+ residual) (+ ReLU).

  Args:
    x: ``(N, H, W, Cin)`` f32 or bf16, contiguous; on the card Cin a
      multiple of 8.
    weight: torch ``(Cout, Cin, 3, 3)``, its :func:`pack_weight_tc` layout
      or its :func:`pack_weight` layout ``(9, Cin, Cout)``; same dtype as
      ``x``.
    scale, bias: ``(Cout,)`` epilogue affine, kept in f32 (1 and 0 if None).
    residual: optional ``(N, H, W, Cout)`` added before the ReLU.
    dilation: 1 or 2; the padding equals it, so the map keeps its size.
    h_halo: ``x``'s first and last rows are halo rows (module docstring);
      dilation 1 only.
    plain: run the plain PyTorch version even on a CUDA tensor.
  Returns:
    ``(N, H, W, Cout)`` in ``x.dtype``, ``H - 2`` rows with ``h_halo``.
  """
  if dilation not in (1, 2):
    raise ValueError(f"{_NAME}: dilation must be 1 or 2, got {dilation}")
  scale, bias = affine(scale, bias, _torch_weight(weight).shape[0],
                       x.device)
  if plain or x.device.type == "cpu":
    _out_shape(x.shape, scale.shape[0], dilation, h_halo)  # the same refusals
    return _plain(x, weight, scale, bias, residual, relu, dilation, h_halo)
  if x.device.type != "cuda":
    raise ValueError(f"{_NAME}: unsupported device {x.device}")
  return _launch(x, weight, scale, bias, residual, relu, dilation, h_halo)


# --- training ---------------------------------------------------------------


def train_kernel_eligible(x_shape, cout: int) -> bool:
  """Where the JAX package trains a stride-1 3x3 conv on its batch-packed
  kernel (``conv2d_kernel.py:train_bpack2d_g``), with its memory budget
  left out: batch >= 2 with a pack factor (2, 3 or 6 divides it), Cin and
  Cout multiples of 8, and W or H (NHWC) a multiple of 128."""
  b, h, w, cin = x_shape
  return (b >= 2 and (b % 2 == 0 or b % 3 == 0) and cin % 8 == 0
          and cout % 8 == 0 and (w % 128 == 0 or h % 128 == 0))


class _Conv2d(torch.autograd.Function):
  """The bare stride-1 3x3 conv (padding = dilation) whose forward and
  grad-input run the kernel (its plain version on the CPU or with
  ``plain``), the grad-input with the spatially flipped, io-swapped weight
  at the same dilation (``conv2d_kernel.py:522-555``); the grad-weight is a
  library call. The weight is the torch-layout ``Parameter``."""

  @staticmethod
  def forward(ctx, x, weight, dilation, plain):
    x = x.contiguous()
    ctx.save_for_backward(x, weight)
    ctx.dilation, ctx.plain = dilation, plain
    return remat.conv_output(lambda: conv2d_s1_bn_act(
        x, weight, dilation=dilation, plain=plain))

  @staticmethod
  def backward(ctx, g):
    x, weight = ctx.saved_tensors
    dil = ctx.dilation
    g = g.contiguous()
    dx = dw = None
    if ctx.needs_input_grad[0]:
      dx = conv2d_s1_bn_act(g, weight.flip((2, 3)).transpose(0, 1),
                            dilation=dil, plain=ctx.plain)
    if ctx.needs_input_grad[1]:
      dw = torch.nn.grad.conv2d_weight(
          x.permute(0, 3, 1, 2), weight.shape, g.permute(0, 3, 1, 2),
          padding=dil, dilation=dil)
    return dx, dw, None, None


def conv2d_train(x: torch.Tensor, weight: torch.Tensor, dilation: int = 1, *,
                 plain: bool = False) -> torch.Tensor:
  """The bare stride-1 3x3 conv with the kernel's gradients; ``x`` NHWC,
  ``weight`` torch ``(Cout, Cin, 3, 3)``."""
  if dilation not in (1, 2):
    raise ValueError(f"{_NAME}: dilation must be 1 or 2, got {dilation}")
  return _Conv2d.apply(x, weight, dilation, plain)
