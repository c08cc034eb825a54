"""Where the port runs: CUDA by default, the CPU only when asked for; the
precision of the library convs it runs; and its copies of host arrays to
the device."""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from mode_tpu_torch.utils import profiling


def resolve_device(device: str | torch.device | None = None) -> torch.device:
  """The device an entry point runs on.

  ``None`` means the current CUDA card. Without a card that raises: the
  port does not fall back to the CPU on its own. Pass ``"cpu"`` to run the
  plain PyTorch versions of the kernels on the CPU (the tests do).
  """
  if device is None:
    if not torch.cuda.is_available():
      raise RuntimeError(
          "no CUDA device is available; pass device='cpu' to run the plain "
          "PyTorch path on the CPU")
    return torch.device("cuda", torch.cuda.current_device())
  device = torch.device(device)
  if device.type == "cuda" and not torch.cuda.is_available():
    raise RuntimeError(f"{device} was asked for but no CUDA device is "
                       "available")
  if device.type not in ("cuda", "cpu"):
    raise ValueError(f"unsupported device {device}; use 'cuda' or 'cpu'")
  if device.type == "cuda" and device.index is None:
    device = torch.device("cuda", torch.cuda.current_device())
  return device


@contextlib.contextmanager
def ieee_f32_convs():
  """Run cuDNN's f32 convolutions in IEEE f32 while the block runs.

  PyTorch's default lets cuDNN run an f32 convolution as one TF32 pass
  (``torch.backends.cudnn.allow_tf32``), about three decimal digits. The
  JAX package runs f32 at ``Precision.HIGHEST`` and the port's own kernels
  at f32 level (3xTF32), so the port's eval forward and training step run
  their library convs (the ones the kernels do not take, and every
  grad-weight) under this. The flag is set and restored by itself, not
  through ``torch.backends.cudnn.flags()``, whose other arguments would
  reset cuDNN's other flags (it defaults to ``enabled=False``). The flag
  is process-wide, so it also holds in autograd's backward threads while
  the block runs.
  """
  before = torch.backends.cudnn.allow_tf32
  torch.backends.cudnn.allow_tf32 = False
  try:
    yield
  finally:
    torch.backends.cudnn.allow_tf32 = before


def upload(array: np.ndarray | torch.Tensor,
           device: str | torch.device) -> torch.Tensor:
  """A host array (numpy, or a CPU tensor) as a tensor on ``device``: the
  one way the program copies host arrays to the device. While the tracer
  is on (``utils/profiling.py``) each call counts one ``uploads`` and its
  ``upload_bytes`` in the innermost open span (on a CPU device too, where
  nothing is copied). From pageable memory the copy waits for the
  device."""
  t = torch.from_numpy(array) if isinstance(array, np.ndarray) else array
  if profiling.on():
    profiling.count("uploads")
    profiling.count("upload_bytes", t.numel() * t.element_size())
  return t.to(device)
