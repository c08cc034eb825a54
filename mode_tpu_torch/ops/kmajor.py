"""The K-major weight of the port's tensor-core convolutions.

The 3-D and 2-D conv kernels and the sphere conv's forward
(``kernels/csrc/igemm_tc.cuh`` and the sources on it) take their weight as
``(taps, Cout, Cin)``: ``wgmma`` reads B K-major, and with ``.tf32`` it
takes no transposed operand. In f32 the kernels run 3xTF32, so the weight
comes in two parts, made on the weight's device: ``big = tf32_round(w)``
and ``small = tf32_round(w - big)``, with Cin padded to whole K stages of
32 channels and each stage's channels permuted (see :func:`pack`). A layer
keeps the :class:`TcWeight` between calls as it kept the ``pack_weight``
layout; a training Function packs in each call. The sphere conv's
grad-input packs the forward's ``(9, Cin, Cout)`` weight the same way, as
``(taps, rows, K)`` with rows Cin and K Cout, and checks it with
:func:`pointers`; the transposed 3-D conv packs its ``(I, O, k)`` weight as
``(taps, O, I)`` and marks it ``transposed``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class TcWeight(NamedTuple):
  """A conv weight packed for the tensor-core kernels.

  ``parts``: ``(P, taps, Cout, Cin')`` in the conv's dtype, taps in the
  kernel's order; P = 2 (``big``, ``small``) where the kernel runs f32 on
  the tensor cores, Cin' = Cin padded to whole stages and the channels
  permuted as :func:`pack` says; else P = 1, the weight whole, Cin' = Cin.
  ``weight``: the torch-layout weight it was made from, which the plain
  versions take. ``transposed``: ``weight`` is a transpose conv's ``(I, O,
  k)``, its Cin on axis 0 (a conv's ``(O, I, k)`` has it on axis 1)."""
  parts: torch.Tensor
  weight: torch.Tensor
  transposed: bool = False

  @property
  def cout(self) -> int:
    return self.parts.shape[2]


def tf32_round(t: torch.Tensor) -> torch.Tensor:
  """``t`` (f32) rounded to TF32's 10 mantissa bits, to nearest with ties
  away from zero: ``cvt.rna.tf32.f32``, the low 13 bits cleared."""
  if t.dtype != torch.float32:
    raise ValueError(f"tf32_round takes f32, got {t.dtype}")
  mag = t.abs().contiguous().view(torch.int32)
  rounded = ((mag + 0x1000) & -0x2000).view(torch.float32)
  return rounded.copysign(t)


STAGE_CHANNELS = 32  # input channels per K stage of the kernels


def pack(wk: torch.Tensor, weight: torch.Tensor, split: bool,
         transposed: bool = False) -> TcWeight:
  """A :class:`TcWeight` from ``wk`` ``(taps, Cout, Cin)`` and the torch
  ``weight`` it was taken from (a transpose conv's where ``transposed``):
  where ``split`` and ``wk`` is f32, padded, permuted and split into
  ``big`` and ``small``; else whole.

  The f32 permutation: within each stage, K position ``p = q + 4 j`` holds
  channel ``8 q + j`` (q < 4, j < 8). The kernel's m64k8 tf32 A fragment
  takes K positions ``q + 4 j`` of a stage in thread ``q`` of each quad,
  so it reads channels ``8 q .. 8 q + 7``: two 16-byte loads a row instead
  of eight 4-byte ones. It is a transpose of each stage's channels viewed
  as (q, j), so it needs no index tensor on the device."""
  wk = wk.contiguous()
  if split and wk.dtype == torch.float32:
    taps, cout, cin = wk.shape
    stages = -(-cin // STAGE_CHANNELS)
    wk = torch.nn.functional.pad(wk, (0, stages * STAGE_CHANNELS - cin))
    wk = wk.view(taps, cout, stages, 4, 8).transpose(3, 4).reshape(
        taps, cout, stages * STAGE_CHANNELS)
    big = tf32_round(wk)
    parts = torch.stack((big, tf32_round(wk - big)))
  else:
    parts = wk[None]
  return TcWeight(parts.contiguous(), weight.detach(), transposed)


def operands(name: str, x: torch.Tensor, tw: TcWeight, taps: int,
             split: bool, transposed: bool = False
             ) -> tuple[int, int | None]:
  """The ``(big, small)`` data pointers of ``tw`` for a tensor-core
  kernel's launch on ``x`` (``small`` None unless ``split``), after the
  checks the kernels need: ``x``'s Cin a multiple of 8 and ``x`` 16-byte
  aligned (whole 16-byte copies), and ``tw`` the layout :func:`pack` makes
  for ``taps`` taps, ``x``'s Cin, dtype and device, from a transpose
  conv's weight exactly where ``transposed``. Raises ``ValueError`` naming
  kernel ``name`` otherwise."""
  cin = x.shape[-1]
  if cin % 8 or x.data_ptr() % 16:
    raise ValueError(f"{name}: Cin must be a multiple of 8 and x 16-byte "
                     f"aligned, got Cin {cin}")
  if (tw.transposed != transposed
      or tw.weight.shape[0 if transposed else 1] != cin):
    raise ValueError(f"{name}: weight {tuple(tw.weight.shape)} does not "
                     f"match the input {tuple(x.shape)} {x.dtype}")
  return pointers(name, x, tw.parts, taps, tw.cout, split)


def pointers(name: str, x: torch.Tensor, parts: torch.Tensor, taps: int,
             rows: int, split: bool) -> tuple[int, int | None]:
  """The ``(big, small)`` data pointers of ``parts`` (``small`` None unless
  ``split``) after checking that they are the layout :func:`pack` makes for
  ``taps`` taps of ``rows`` B rows whose K channels are ``x``'s last axis,
  in ``x``'s dtype and on its device. Raises ``ValueError`` naming kernel
  ``name`` otherwise."""
  k = x.shape[-1]
  wk = -(-k // STAGE_CHANNELS) * STAGE_CHANNELS if split else k
  if (parts.shape != (2 if split else 1, taps, rows, wk)
      or parts.dtype != x.dtype or parts.device != x.device
      or not parts.is_contiguous()):
    raise ValueError(f"{name}: weight {tuple(parts.shape)} {parts.dtype} "
                     f"does not match the input {tuple(x.shape)} {x.dtype}")
  return parts[0].data_ptr(), parts[1].data_ptr() if split else None
