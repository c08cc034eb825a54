"""The port's hand-written CUDA kernels (``csrc/``), their build
(``build.py``), their launch (:func:`launch`) and their launch counts.

Each wrapper in ``mode_tpu_torch.ops`` launches its kernel through
:func:`launch`, which adds one to ``LAUNCHES[<kernel>]``, and nowhere else,
so a run can show that a path went through the kernels and not through
their plain versions. A launch on a spatial shard's haloed rows
(``parallel/shard_ops.py``) also adds one to ``HALO_LAUNCHES[<kernel>]``,
and one on the stride-1 conv's box kernel (``csrc/conv3d_box.cuh``) to
``BOX_LAUNCHES[<kernel>]``.
While the tracer is on (``utils/profiling.py``) a launch is also recorded
with its kernel's extents (``shape``) and the innermost open span, and
inside a span that times its launches with a CUDA event pair around it.
"""

from __future__ import annotations

import collections

import torch

from mode_tpu_torch.utils import profiling

LAUNCHES: collections.Counter = collections.Counter()
HALO_LAUNCHES: collections.Counter = collections.Counter()
BOX_LAUNCHES: collections.Counter = collections.Counter()


def launch(name: str, fn, device: torch.device, *args,
           halo: bool = False, box: bool = False, shape: tuple = ()) -> None:
  """Call the C entry ``fn(*args, stream)`` of kernel ``name`` with
  ``device`` as the current CUDA device and its current stream (the CUDA
  runtime launches on the current device, whatever the pointers), raise if
  the launch failed, else count it (``halo``: also as a haloed call;
  ``box``: also as a call of the box kernel) and, while the tracer is on,
  record it with ``shape``, the extents the wrapper passes its kernel."""
  with torch.cuda.device(device):
    stream = torch.cuda.current_stream(device)
    rec = profiling.launch_begin(name, shape, stream) if profiling.on() else 0
    err = fn(*args, stream.cuda_stream)
    if rec and err == 0:
      profiling.launch_end(rec, stream)
  if err != 0:
    raise RuntimeError(f"{name}: kernel launch failed with CUDA error {err}")
  LAUNCHES[name] += 1
  if halo:
    HALO_LAUNCHES[name] += 1
  if box:
    BOX_LAUNCHES[name] += 1


def reset_launches() -> None:
  """Set every kernel's launch counts to 0."""
  LAUNCHES.clear()
  HALO_LAUNCHES.clear()
  BOX_LAUNCHES.clear()
