"""The epilogue the port's conv kernels share, ``act(y * scale + bias (+
residual))``, as their plain versions compute it."""

from __future__ import annotations

import torch


def affine(scale: torch.Tensor | None, bias: torch.Tensor | None, cout: int,
           device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
  """``(scale, bias)`` as contiguous f32 ``(cout,)`` tensors on ``device``;
  1 and 0 where None."""
  scale = (torch.ones(cout, device=device) if scale is None
           else scale.to(device=device, dtype=torch.float32))
  bias = (torch.zeros(cout, device=device) if bias is None
          else bias.to(device=device, dtype=torch.float32))
  if scale.shape != (cout,) or bias.shape != (cout,):
    raise ValueError(f"scale and bias must be ({cout},), got "
                     f"{tuple(scale.shape)} and {tuple(bias.shape)}")
  return scale.contiguous(), bias.contiguous()


def epilogue(y: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
             residual: torch.Tensor | None, relu: bool,
             dtype: torch.dtype) -> torch.Tensor:
  """``act(y * scale + bias (+ residual))`` in f32 over the last (channel)
  axis of ``y``, cast to ``dtype``, contiguous."""
  y = y * scale + bias
  if residual is not None:
    y = y + residual.float()
  if relu:
    y = torch.relu(y)
  return y.to(dtype).contiguous()
