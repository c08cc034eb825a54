"""The port's hand-written CUDA kernels (``csrc/``), their build
(``build.py``), their launch (:func:`launch`) and their launch counts.

Each wrapper in ``mode_tpu_torch.ops`` launches its kernel through
:func:`launch`, which adds one to ``LAUNCHES[<kernel>]``, and nowhere else,
so a run can show that a path went through the kernels and not through
their plain versions. A launch on a spatial shard's haloed rows
(``parallel/shard_ops.py``) also adds one to ``HALO_LAUNCHES[<kernel>]``.
"""

from __future__ import annotations

import collections

import torch

LAUNCHES: collections.Counter = collections.Counter()
HALO_LAUNCHES: collections.Counter = collections.Counter()


def launch(name: str, fn, device: torch.device, *args,
           halo: bool = False) -> None:
  """Call the C entry ``fn(*args, stream)`` of kernel ``name`` with
  ``device`` as the current CUDA device and its current stream (the CUDA
  runtime launches on the current device, whatever the pointers), raise if
  the launch failed, else count it (``halo``: also as a haloed call)."""
  with torch.cuda.device(device):
    err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
  if err != 0:
    raise RuntimeError(f"{name}: kernel launch failed with CUDA error {err}")
  LAUNCHES[name] += 1
  if halo:
    HALO_LAUNCHES[name] += 1


def reset_launches() -> None:
  """Set every kernel's launch counts to 0."""
  LAUNCHES.clear()
  HALO_LAUNCHES.clear()
