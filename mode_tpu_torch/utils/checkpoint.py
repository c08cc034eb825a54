"""Checkpoints (``mode_tpu/utils/checkpoint.py``): the reference's torch
``.tar`` files, ``{'epoch', 'state_dict', 'train_loss'}``, read and written.

The trainers write one per epoch, as the reference's do
(``train_disparity.py:91-94``, ``train_fusion.py:178-179``): the model's
``state_dict`` in the reference's keys, which the serving CLIs load. Like
the JAX package's trainers, they save no optimiser state, so a resumed run
starts Adam from zero."""

from __future__ import annotations

import os
from typing import Any, Mapping, Optional

import torch


def save_checkpoint(path: str, payload: Mapping[str, Any]) -> None:
  """Write ``payload`` (``{'epoch', 'state_dict', ...}``) to ``path`` as a
  torch ``.tar``, every tensor of its ``state_dict`` detached and on the
  CPU, so the file loads with ``weights_only=True`` anywhere. The file is
  written beside ``path`` and then renamed over it: a reader never sees a
  partial file."""
  payload = dict(payload)
  if "state_dict" in payload:
    payload["state_dict"] = {k: v.detach().cpu()
                             for k, v in payload["state_dict"].items()}
  tmp = f"{path}.tmp"
  torch.save(payload, tmp)
  os.replace(tmp, path)


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
