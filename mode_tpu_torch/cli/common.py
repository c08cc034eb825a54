"""What the CLIs share (``mode_tpu/cli/common.py``): seeding, the metric
table, parameter counts and loading a checkpoint into a model."""

from __future__ import annotations

import os
import random

import numpy as np
import torch
from torch import nn

from mode_tpu_torch.utils.checkpoint import load_torch_checkpoint
from mode_tpu_torch.utils.convert import load_reference_state_dict

# converts a JAX (orbax) checkpoint directory into a reference .tar
CONVERTER = "scripts/jax_checkpoint_to_torch.py"


def seed_everything(seed: int):
  random.seed(seed)
  np.random.seed(seed)
  torch.manual_seed(seed)


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


def count_params(model: nn.Module) -> int:
  return sum(p.numel() for p in model.parameters())


def load_model_checkpoint(path: str, model: nn.Module) -> int:
  """Load a reference-layout torch ``.tar`` (a bare ``state_dict``, or the
  training wrapper ``{'epoch', 'state_dict', ...}``) into ``model`` in place
  (``utils/convert.py:load_reference_state_dict``); returns its epoch (0 if
  it has none). A directory is a JAX (orbax) checkpoint, which this package
  cannot read: convert it first."""
  if os.path.isdir(path):
    raise ValueError(
        f"{path} is a directory, a JAX (orbax) checkpoint; convert it to a "
        f"torch .tar with {CONVERTER} where JAX is installed")
  obj = load_torch_checkpoint(path)
  load_reference_state_dict(model, obj)
  return int(obj.get("epoch", 0))
