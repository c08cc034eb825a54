"""The stage-1 training step (``mode_tpu/training.py``).

One step is forward, deep-supervision loss, backward and Adam, and it
updates the BN running statistics. The model's layers run their training
paths (``models/blocks.py``), so the convs the JAX package trains on Pallas
run the port's kernels forward and backward. The optimizer is
``torch.optim.Adam`` with the reference's settings, and the learning-rate
rule is the CLI's (``mode_tpu/cli/train_disparity.py``).
"""

from __future__ import annotations

import functools
from typing import Callable, Iterable

import torch
from torch import nn

from mode_tpu_torch.device import ieee_f32_convs
from mode_tpu_torch.models.blocks import (Conv3dWeight,
                                          ConvTranspose3dWeight, SphereConv)
from mode_tpu_torch.utils.losses import disparity_deep_supervision

# ImageNet statistics (the JAX package's data/preprocess.py)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
BASE_LR = 1e-3
START_DECAY = 45


@functools.lru_cache(maxsize=8)
def imagenet_stats(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
  """The ImageNet mean and std, f32 ``(3,)``, uploaded once per device: a
  call that uploads them waits on the device (an upload from pageable
  memory synchronises)."""
  return (torch.tensor(IMAGENET_MEAN, device=device),
          torch.tensor(IMAGENET_STD, device=device))


def normalize_rgb_on_device(x: torch.Tensor,
                            dtype: torch.dtype | None = None
                            ) -> torch.Tensor:
  """ImageNet-normalise a uint8 RGB batch ``(..., 3)`` where it lies; a
  float batch passes through. ``dtype`` casts the result."""
  if x.dtype == torch.uint8:
    mean, std = imagenet_stats(x.device)
    x = (x.float() / 255.0 - mean) / std
  return x.to(dtype) if dtype is not None else x


_CONV_WEIGHTS = (nn.Conv2d, nn.ConvTranspose2d, Conv3dWeight,
                 ConvTranspose3dWeight, SphereConv)


def cast_conv_params(module: nn.Module, dtype: torch.dtype) -> nn.Module:
  """Cast ``module``'s conv weights to ``dtype`` in place: every 2-D and 3-D
  conv's and transpose conv's, the sphere convs' and the 1x1 heads';
  biases and BN parameters stay f32 (the JAX package's
  ``cast_conv_params``, which casts its ``kernel`` and ``kernel_t``
  leaves). Each cast weight is a new ``Parameter``, so the layers remake
  their kernel-layout weights on their next call. Returns ``module``."""
  for m in module.modules():
    if isinstance(m, _CONV_WEIGHTS) and m.weight.dtype != dtype:
      m.weight = nn.Parameter(m.weight.detach().to(dtype),
                              requires_grad=m.weight.requires_grad)
  return module


def make_optimizer(params: Iterable[torch.nn.Parameter]
                   ) -> torch.optim.Optimizer:
  """Adam, lr 1e-3, betas (0.9, 0.999), eps 1e-8 (torch's defaults, which
  the reference trains with)."""
  return torch.optim.Adam(params, lr=BASE_LR, betas=(0.9, 0.999), eps=1e-8)


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
  for group in optimizer.param_groups:
    group["lr"] = lr


def learning_rate(epoch: int, base_lr: float = BASE_LR,
                  start_decay: int = START_DECAY) -> float:
  """The stage-1 schedule: ``base_lr``, times 0.1 after epoch
  ``start_decay``."""
  return base_lr * (0.1 if epoch > start_decay else 1.0)


def make_disparity_train_step(model: torch.nn.Module,
                              optimizer: torch.optim.Optimizer, *,
                              plain: bool = False
                              ) -> Callable[..., torch.Tensor]:
  """``step(left, right, disp_gt) -> loss``: one stage-1 update.

  ``left``/``right`` are ``(B, H, W, 3)`` uint8 or normalised float images
  and ``disp_gt`` ``(B, H, W)`` with NaN where there is no ground truth, all
  on the model's device. The loss is the deep-supervision smooth-L1 over
  ``~isnan(disp_gt)``. After the step each parameter's ``.grad`` holds this
  step's gradient. ``plain=True`` runs the kernels' plain versions (a
  reference for the kernels on the card). The forward and the backward run
  their library convs in IEEE f32 (``device.ieee_f32_convs``).
  """

  def step(left: torch.Tensor, right: torch.Tensor,
           disp_gt: torch.Tensor) -> torch.Tensor:
    mask = ~torch.isnan(disp_gt)
    gt = torch.where(mask, disp_gt, torch.zeros_like(disp_gt))
    model.train()
    optimizer.zero_grad(set_to_none=True)
    with ieee_f32_convs():
      preds = model(normalize_rgb_on_device(left),
                    normalize_rgb_on_device(right), plain=plain)
      loss = disparity_deep_supervision(preds, gt, mask)
      loss.backward()
    optimizer.step()
    return loss.detach()

  return step
