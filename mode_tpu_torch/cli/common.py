"""What the CLIs share (``mode_tpu/cli/common.py``): seeding, the metric
table, parameter counts, loading a checkpoint into a model, the trainers'
mesh (one process per card under ``torchrun``) with what only rank 0 does,
and the trainers' batches on the device."""

from __future__ import annotations

import itertools
import os
import random

import numpy as np
import torch
from torch import nn

from mode_tpu_torch.parallel.mesh import (Mesh, initialize_distributed,
                                          make_mesh)
from mode_tpu_torch.utils.checkpoint import load_torch_checkpoint
from mode_tpu_torch.utils.convert import (load_reference_state_dict,
                                          load_stack_hourglass_only)
from mode_tpu_torch.utils.profiling import span

# converts a JAX (orbax) checkpoint directory into a reference .tar
CONVERTER = "scripts/jax_checkpoint_to_torch.py"


def seed_everything(seed: int):
  random.seed(seed)
  np.random.seed(seed)
  torch.manual_seed(seed)


# the fusion CLIs' validation metrics, in the order of their table
METRIC_NAMES = ["MAE", "RMSE", "AbsRel", "SqRel", "SILog", "δ1 (%)",
                "δ2 (%)", "δ3 (%)"]


def format_table(headers: list[str], rows: list[list]) -> str:
  """A PrettyTable-style report (the reference's test_disparity.py:150-154)
  without the dependency."""
  cells = [[f"{v:^.4f}" if isinstance(v, (float, np.floating)) else str(v)
            for v in row] for row in rows]
  widths = [max(len(h), *(len(r[i]) for r in cells)) if cells else len(h)
            for i, h in enumerate(headers)]
  sep = "+" + "+".join("-" * (w + 2) for w in widths) + "+"

  def fmt(row):
    return "| " + " | ".join(v.center(w) for v, w in zip(row, widths)) + " |"

  return "\n".join([sep, fmt(headers), sep, *(fmt(r) for r in cells), sep])


def training_mesh(dp: int | None, sp: int, device: str | None) -> Mesh:
  """The trainers' mesh, as the JAX CLIs' ``make_mesh(data=--dp,
  spatial=--sp)``: join ``torchrun``'s process group if there is one
  (``parallel/mesh.py``), then ``--sp`` must divide the world size and
  ``--dp`` None means the world size over ``--sp``; any other value times
  ``--sp`` must equal it (``mesh.make_mesh``'s refusals). Without
  ``torchrun`` the world is this one process, on ``device``."""
  initialize_distributed(device)
  return make_mesh(data=dp, spatial=sp, device=device)


class NullWriter:
  """The event writer of a rank that writes none (every rank but 0)."""

  def add_scalar(self, *args, **kwargs):
    pass

  def close(self):
    pass


def rank_zero(mesh: Mesh):
  """``print`` on rank 0 of the mesh, a no-op on the others."""
  return print if mesh.global_rank == 0 else (lambda *a, **k: None)


def barrier() -> None:
  """Wait for every rank (nothing without a process group)."""
  if torch.distributed.is_initialized():
    torch.distributed.barrier()


def count_params(model: nn.Module) -> int:
  return sum(p.numel() for p in model.parameters())


def load_model_checkpoint(path: str, model: nn.Module,
                          shg_only: bool = False) -> int:
  """Load a reference-layout torch ``.tar`` (a bare ``state_dict``, or the
  training wrapper ``{'epoch', 'state_dict', ...}``) into ``model`` in place
  (``utils/convert.py:load_reference_state_dict``); returns its epoch (0 if
  it has none). ``shg_only`` loads all but the feature extractor, which
  keeps its weights (``--loadSHGonly``,
  ``utils/convert.py:load_stack_hourglass_only``). A directory is a JAX
  (orbax) checkpoint, which this package cannot read: convert it first."""
  if os.path.isdir(path):
    raise ValueError(
        f"{path} is a directory, a JAX (orbax) checkpoint; convert it to a "
        f"torch .tar with {CONVERTER} where JAX is installed")
  obj = load_torch_checkpoint(path)
  if shg_only:
    load_stack_hourglass_only(model, obj)
  else:
    load_reference_state_dict(model, obj)
  return int(obj.get("epoch", 0))


def device_batches(loader, to_device, limit: int | None = None):
  """``to_device(batch)`` for each batch of ``loader``, the first ``limit``
  (all if None), each fetch and upload in a ``loader.wait`` span
  (``utils/profiling.py``): the time the step waits for its data."""
  batches = iter(loader)
  for i in itertools.count():
    with span("loader.wait"):
      batch = next(batches, None)
      if batch is None or (limit and i >= limit):
        return
      out = to_device(batch)
    yield out
