"""The training steps of both stages (``mode_tpu/training.py``).

One step is forward, loss, backward and Adam, and it updates the BN running
statistics: stage 1's deep-supervision smooth-L1
(:func:`make_disparity_train_step`) and stage 2's scale-invariant log loss
(:func:`make_fusion_train_step`). The models' layers run their training
paths (``models/blocks.py``), so the convs the JAX package trains on Pallas
run the port's kernels forward and backward. The optimizer is
``torch.optim.Adam`` with the reference's settings, and the learning-rate
rules are the CLIs' (``mode_tpu/cli/train_disparity.py``,
``train_fusion.py``).

``compute_dtype=torch.bfloat16`` is the JAX package's mixed precision: bf16
activations and conv weights (each layer casts its f32 weight at use, so
the gradients reach the f32 masters through the cast), f32 BN statistics,
softmax, sigmoid head and loss; the parameters and Adam's state stay f32.

``mesh=`` (``parallel/mesh.py``, one process per card) trains on the
global batch split over the ranks, as the JAX steps' ``mesh`` does: each
data index takes its own rows of the batch, and under a ``spatial`` axis
each of its spatial ranks its rows of the cost volume's H and of the
ground truth (stage 1 only; the fusion net does not train under the axis).
The BN layers and the loss reduce over every rank's part, and after the
backward one all-reduce over the whole mesh averages the f32 gradients, so
every rank takes the same Adam step. Building the step broadcasts rank 0's
parameters and buffers once. Each rank's convs take the kernels as the
single-card step takes them at the per-rank batch and the whole volume's
shape.

A step opens the tracer's spans (``utils/profiling.py``) ``step``, and
inside it ``step.inputs`` (the mask, the inputs' normalisation or unpacking,
``zero_grad``), ``step.forward``, ``step.loss``, ``step.backward``,
``step.allreduce`` (under a mesh) and ``step.optimizer``.
"""

from __future__ import annotations

import copy
import functools
from typing import Callable, Iterable, Sequence

import torch
from torch import nn

from mode_tpu_torch.device import ieee_f32_convs, upload
from mode_tpu_torch.models.blocks import (Conv3dWeight,
                                          ConvTranspose3dWeight, SphereConv)
from mode_tpu_torch.parallel.mesh import (Mesh, activate,
                                          allreduce_gradients,
                                          broadcast_state, constrain_spatial)
from mode_tpu_torch.utils.losses import disparity_deep_supervision, silog_loss
from mode_tpu_torch.utils.profiling import span

# ImageNet statistics (the JAX package's data/preprocess.py)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
BASE_LR = 1e-3
START_DECAY = 45
# stage 2's constant learning rate (the CLI's ``--lr``) and silog's lambda
FUSION_LR = 1e-4
SILOG_LAMBDA = 0.5


@functools.lru_cache(maxsize=None)
def inv255(dtype: torch.dtype = torch.float32) -> float:
  """1/255 rounded to ``dtype``, as the JAX package's compiled steps hold
  the constant."""
  return float(torch.tensor(1.0 / 255.0, dtype=dtype))


@functools.lru_cache(maxsize=8)
def imagenet_stats(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
  """The ImageNet mean (its f32 values held in f64) and the f32 reciprocal
  of the std, each ``(3,)``, uploaded once per device: a call that uploads
  them waits on the device (an upload from pageable memory synchronises)."""
  mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32).double()
  inv_std = torch.tensor(IMAGENET_STD, dtype=torch.float32).reciprocal()
  return upload(mean, device), upload(inv_std, device)


def normalize_rgb_on_device(x: torch.Tensor,
                            dtype: torch.dtype | None = None
                            ) -> torch.Tensor:
  """ImageNet-normalise a uint8 RGB batch ``(..., 3)`` where it lies; a
  float batch passes through. ``dtype`` casts the result.

  The arithmetic is the JAX package's compiled step's, bit for bit: XLA
  turns ``(x / 255 - mean) / std`` into one fused multiply-add ``x *
  f32(1/255) - mean``, rounded once, times ``f32(1/std)``. The product of
  a byte and an f32 is exact in f64, so the f64 subtraction rounded to f32
  gives the fused result (checked over all 256 values of each channel)."""
  if x.dtype == torch.uint8:
    mean, inv_std = imagenet_stats(x.device)
    x = (x.double() * inv255() - mean).float() * inv_std
  return x.to(dtype) if dtype is not None else x


_CONV_WEIGHTS = (nn.Conv2d, nn.ConvTranspose2d, Conv3dWeight,
                 ConvTranspose3dWeight, SphereConv)


def cast_conv_params(module: nn.Module, dtype: torch.dtype) -> nn.Module:
  """A copy of ``module`` with its conv weights cast to ``dtype``: every 2-D
  and 3-D conv's and transpose conv's, the sphere convs' and the 1x1
  heads'; biases and BN parameters stay f32 (the JAX package's
  ``cast_conv_params``, which returns a new tree with its ``kernel`` and
  ``kernel_t`` leaves cast). ``module`` itself is left as it is."""
  module = copy.deepcopy(module)
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


def replicate(model: torch.nn.Module, mesh: Mesh | None) -> None:
  """Give every rank of ``mesh`` rank 0's parameters and buffers (nothing
  without a process group)."""
  if mesh is not None and torch.distributed.is_initialized():
    broadcast_state(model, mesh)


def sync_gradients(model: torch.nn.Module, mesh: Mesh | None) -> None:
  """Average the gradients over the ranks of ``mesh`` (nothing without a
  process group)."""
  if mesh is not None and torch.distributed.is_initialized():
    with span("step.allreduce"):
      allreduce_gradients(model.parameters(), mesh)


def make_disparity_train_step(model: torch.nn.Module,
                              optimizer: torch.optim.Optimizer, *,
                              compute_dtype: torch.dtype | None = None,
                              plain: bool = False, mesh: Mesh | None = None
                              ) -> Callable[..., torch.Tensor]:
  """``step(left, right, disp_gt) -> loss``: one stage-1 update.

  ``left``/``right`` are ``(B, H, W, 3)`` uint8 or normalised float images
  and ``disp_gt`` ``(B, H, W)`` with NaN where there is no ground truth, all
  on the model's device. The loss is the deep-supervision smooth-L1 over
  ``~isnan(disp_gt)``. After the step each parameter's ``.grad`` holds this
  step's gradient. ``compute_dtype`` (``torch.bfloat16``) casts the
  normalised images and so the activations and conv weights; the three
  heads' softmax and soft-argmin and the loss stay f32. ``plain=True`` runs
  the kernels' plain versions (a reference for the kernels on the card).
  The forward and the backward run their library convs in IEEE f32
  (``device.ieee_f32_convs``). With ``mesh`` the arguments are this rank's
  data index's rows of the global batch (``parallel.mesh.shard_batch``),
  whole images: under a spatial axis the step takes this rank's rows of
  ``disp_gt`` itself (``mesh.row_sharding``). The loss is the global
  batch's, the same on every rank (module docstring).
  """
  replicate(model, mesh)

  def step(left: torch.Tensor, right: torch.Tensor,
           disp_gt: torch.Tensor) -> torch.Tensor:
    with span("step"):
      with span("step.inputs"):
        mask = ~torch.isnan(disp_gt)
        gt = torch.where(mask, disp_gt, torch.zeros_like(disp_gt))
        left = normalize_rgb_on_device(left, compute_dtype)
        right = normalize_rgb_on_device(right, compute_dtype)
        model.train()
        optimizer.zero_grad(set_to_none=True)
      with ieee_f32_convs(), activate(mesh):
        with span("step.forward"):
          preds = model(left, right, plain=plain)
        with span("step.loss"):
          # this rank's rows under a spatial mesh, as the predictions are
          gt, mask = (constrain_spatial(t, 1) for t in (gt, mask))
          loss = disparity_deep_supervision(preds, gt, mask, mesh)
        with span("step.backward"):
          loss.backward()
      sync_gradients(model, mesh)
      with span("step.optimizer"):
        optimizer.step()
      return loss.detach()

  return step


def unpack_fusion_inputs(depths: Sequence[torch.Tensor],
                         confs: Sequence[torch.Tensor],
                         rgbs: Sequence[torch.Tensor],
                         dtype: torch.dtype = torch.float32):
  """The packed fusion frame's wire dtypes (``mode_tpu/data/
  fusion_pack.py``: f16 depths, uint8 confidences, uint8 views) unpacked
  where they lie, in ``dtype``: depths cast, confidences times 1/255
  rounded to ``dtype`` (as the JAX step rounds its constant), the views
  ImageNet-normalised. Returns three lists."""
  return ([d.to(dtype) for d in depths],
          [c.to(dtype) * inv255(dtype) for c in confs],
          [normalize_rgb_on_device(r, dtype) for r in rgbs])


def make_fusion_train_step(model: torch.nn.Module,
                           optimizer: torch.optim.Optimizer,
                           max_depth: float, *,
                           compute_dtype: torch.dtype | None = None,
                           raw_inputs: bool = False, plain: bool = False,
                           mesh: Mesh | None = None
                           ) -> Callable[..., torch.Tensor]:
  """``step(depths, confs, rgbs, gt) -> loss``: one stage-2 update of a
  ``ModeFusion``.

  ``depths``/``confs`` are six ``(B, H, W, 1)`` maps each and ``rgbs`` four
  ``(B, H, W, 3)`` views, ``gt`` ``(B, H, W)`` f32, all on the model's
  device. The loss is ``silog_loss(0.5, ...)`` over ``gt <= max_depth``.
  ``raw_inputs``: the inputs come in the packed dataset's wire dtypes and
  are unpacked on the device (:func:`unpack_fusion_inputs`) in
  ``compute_dtype``, which then runs the net's activations and conv weights
  (``torch.bfloat16``); its BN statistics, sigmoid head and loss stay f32,
  and so do the parameters and Adam's state. Float inputs are taken in
  their own dtype, as the JAX step takes them: each conv casts its weight
  to its input's dtype, so f32 inputs train in f32. Use
  :func:`make_optimizer` with :func:`set_learning_rate` at
  ``FUSION_LR``, the CLI's constant rate. ``plain=True`` runs the
  kernels' plain versions. After the step each parameter's ``.grad``
  holds this step's gradient. ``mesh`` as in
  :func:`make_disparity_train_step`.
  """
  dtype = compute_dtype or torch.float32
  replicate(model, mesh)

  def step(depths, confs, rgbs, gt: torch.Tensor) -> torch.Tensor:
    with span("step"):
      with span("step.inputs"):
        mask = gt <= max_depth
        if raw_inputs:
          depths, confs, rgbs = unpack_fusion_inputs(depths, confs, rgbs,
                                                     dtype)
        model.train()
        optimizer.zero_grad(set_to_none=True)
      with ieee_f32_convs(), activate(mesh):
        with span("step.forward"):
          out = model(depths, confs, rgbs, plain=plain)
        with span("step.loss"):
          loss = silog_loss(SILOG_LAMBDA, out[..., 0], gt, mask, mesh)
        with span("step.backward"):
          loss.backward()
      sync_gradients(model, mesh)
      with span("step.optimizer"):
        optimizer.step()
      return loss.detach()

  return step
