"""Reading checkpoints (``mode_tpu/utils/checkpoint.py``): the reference's
torch ``.tar`` files, ``{'epoch', 'state_dict', 'train_loss'}``. Saving
comes with the training CLIs."""

from __future__ import annotations

import os
from typing import Any, Optional

import torch


def load_torch_checkpoint(path: str) -> Any:
  """Load a torch ``.tar`` / ``.pth`` checkpoint onto the CPU.

  Only tensors, numbers, strings and containers of them are unpickled
  (``weights_only=True``): the reference's training wrapper and a bare
  ``state_dict`` load; a pickle of anything else raises
  ``pickle.UnpicklingError``."""
  return torch.load(path, map_location="cpu", weights_only=True)


def latest_epoch_dir(root: str, prefix: str) -> Optional[str]:
  """The ``<prefix><epoch>`` entry of ``root`` with the largest epoch, or
  None."""
  if not os.path.isdir(root):
    return None
  best, best_ep = None, -1
  for name in os.listdir(root):
    if name.startswith(prefix):
      try:
        ep = int(name[len(prefix):])
      except ValueError:
        continue
      if ep > best_ep:
        best, best_ep = os.path.join(root, name), ep
  return best
