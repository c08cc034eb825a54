"""The weight re-initialisation menu (``mode_tpu/models/initialize.py``,
the reference's ``models/initModel.py:9-32``): ``train_disparity
--init_type``.

It touches the tensors the JAX package's menu touches: every conv-like
weight of more than two dimensions (2-D, 3-D, transpose and sphere convs and
the 1x1 heads) is drawn anew, every BatchNorm weight becomes 1 and every
bias, a conv's or a BatchNorm's, 0. The fans are torch's own (and the JAX
package's): ``fan_in = I * prod(K)`` and ``fan_out = O * prod(K)`` of a
``(O, I, *K)`` weight, a transpose conv's ``(I, O, *K)`` read the same way
(its ``fan_in`` is ``O * prod(K)``); the kaiming gain is the leaky ReLU's,
``sqrt(2 / (1 + 0.01^2))``. The draws come from a CPU generator, one
tensor after another in ``named_parameters`` order, so they do not depend
on the model's device; they are not the JAX package's draws.
"""

from __future__ import annotations

import torch
from torch import nn

from mode_tpu_torch.models.blocks import TorchBatchNorm

INIT_TYPES = ("default", "kaiming_normal", "xavier_normal",
              "kaiming_uniform", "xavier_uniform", "normal")
# the JAX package's leaky-ReLU slope
_SLOPE = 0.01


def _draw(shape, init_type: str, generator: torch.Generator) -> torch.Tensor:
  w = torch.empty(shape)
  if init_type == "kaiming_normal":
    nn.init.kaiming_normal_(w, a=_SLOPE, generator=generator)
  elif init_type == "kaiming_uniform":
    nn.init.kaiming_uniform_(w, a=_SLOPE, generator=generator)
  elif init_type == "xavier_normal":
    nn.init.xavier_normal_(w, generator=generator)
  elif init_type == "xavier_uniform":
    nn.init.xavier_uniform_(w, generator=generator)
  elif init_type == "normal":
    nn.init.normal_(w, 0.0, 1.0, generator=generator)
  else:
    raise ValueError(f"unknown init type {init_type!r}")
  return w


@torch.no_grad()
def init_model_params(model: nn.Module, init_type: str | None,
                      generator: torch.Generator) -> nn.Module:
  """Re-initialise ``model`` in place by ``init_type`` (one of
  ``INIT_TYPES``, or None) from the CPU ``generator``; returns it.
  ``default`` and None leave the weights the model was built with, as the
  reference does (``train_disparity.py:273-274``)."""
  if init_type in (None, "default"):
    return model
  if init_type not in INIT_TYPES:
    raise ValueError(f"unknown init type {init_type!r}")
  for m in model.modules():
    for leaf, p in m.named_parameters(recurse=False):
      if leaf == "bias":
        p.zero_()
      elif isinstance(m, TorchBatchNorm):
        p.fill_(1.0)
      elif leaf == "weight" and p.ndim > 2:
        p.copy_(_draw(p.shape, init_type, generator))
  return model

