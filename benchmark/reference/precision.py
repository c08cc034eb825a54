"""The control's precision: 8-bit floats (e4m3) with one scale per tensor.

bf16 is the precision the configurations state for activations and conv
weights; the nearest below it is fp8. :func:`fp8` rounds a tensor as an fp8
GEMM's operand is rounded: scaled so its largest magnitude is e4m3's largest
finite value (448), cast, and scaled back. The backward passes through
unchanged (a straight-through estimator), so a training control keeps f32
gradients of its fp8 forward.
"""

from __future__ import annotations

import torch

E4M3_MAX = 448.0


def fp8(x: torch.Tensor) -> torch.Tensor:
  xd = x.detach()
  scale = E4M3_MAX / xd.abs().amax().float().clamp(min=1e-30)
  q = (xd.float() * scale).to(torch.float8_e4m3fn).float().div(scale)
  return x + (q.to(x.dtype) - xd)


PRECISIONS = {"float32": None, "fp8": fp8}
