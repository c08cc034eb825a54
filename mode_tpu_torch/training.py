"""The stage-1 training step (``mode_tpu/training.py``).

One step is forward, deep-supervision loss, backward and Adam, and it
updates the BN running statistics. The model's layers run their training
paths (``models/blocks.py``), so the convs the JAX package trains on Pallas
run the port's kernels forward and backward. The optimizer is
``torch.optim.Adam`` with the reference's settings, and the learning-rate
rule is the CLI's (``mode_tpu/cli/train_disparity.py``).
"""

from __future__ import annotations

from typing import Callable, Iterable

import torch

from mode_tpu_torch.device import ieee_f32_convs
from mode_tpu_torch.utils.losses import disparity_deep_supervision

# ImageNet statistics (the JAX package's data/preprocess.py)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
BASE_LR = 1e-3
START_DECAY = 45


def normalize_rgb_on_device(x: torch.Tensor,
                            dtype: torch.dtype | None = None
                            ) -> torch.Tensor:
  """ImageNet-normalise a uint8 RGB batch ``(..., 3)`` where it lies; a
  float batch passes through. ``dtype`` casts the result."""
  if x.dtype == torch.uint8:
    mean = torch.tensor(IMAGENET_MEAN, device=x.device)
    std = torch.tensor(IMAGENET_STD, device=x.device)
    x = (x.float() / 255.0 - mean) / std
  return x.to(dtype) if dtype is not None else x


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
