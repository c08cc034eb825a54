"""Seeded weights in the reference's ``state_dict`` layout, made on the
device in two large random calls.

Conv weights are normal with the reference's scale ``sqrt(2 / (k... C_out))``
(``models/mode_disparity.py``'s init, applied here to transpose convs too);
BN layers get random affines and running statistics, so an eval-mode BN is
not the identity; biases are small. One state dict loads into the
program's model and into the reference's alike.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def seeded_state(template: dict, gen: torch.Generator, device) -> dict:
  """A state dict with ``template``'s keys, shapes and dtypes, its values
  drawn from ``gen`` on ``device``."""
  floats = {k: v for k, v in template.items() if v.is_floating_point()}
  total = sum(v.numel() for v in floats.values())
  normal = torch.randn(total, generator=gen, device=device)
  uniform = torch.rand(total, generator=gen, device=device)
  out, at = {}, 0
  for key, ref in template.items():
    if not ref.is_floating_point():
      out[key] = torch.zeros_like(ref, device=device)
      continue
    n = ref.numel()
    z, u = normal[at:at + n].view(ref.shape), uniform[at:at + n].view(
        ref.shape)
    at += n
    leaf = key.rsplit(".", 1)[-1]
    if ref.dim() >= 3:
      value = z * math.sqrt(2.0 / (np.prod(ref.shape[2:]) * ref.shape[0]))
    elif leaf in ("running_var",) or (leaf == "weight" and ref.dim() == 1):
      value = u * 0.4 + 0.8
    else:                      # BN bias and running mean, conv biases
      value = z * 0.05
    out[key] = value.to(ref.dtype).contiguous()
  return out
