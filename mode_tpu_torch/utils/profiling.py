"""Tracing and step timing (``mode_tpu/utils/profiling.py``).

The reference has no profiler, only wall-clock prints (its
``train_disparity.py:234``). :func:`trace` records a ``torch.profiler``
trace of a block, the host's operations and, on a card, its kernels, and
writes it as a Chrome trace (open it in Perfetto or ``chrome://tracing``);
:func:`annotate` names a region in it; :class:`StepTimer` keeps a rolling
wall-clock time of the training steps that can go to the trainers'
TensorBoard files.
"""

from __future__ import annotations

import contextlib
import os
import socket
import time
from typing import Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function


@contextlib.contextmanager
def trace(log_dir: Optional[str], device: str | torch.device = "cpu"):
  """Record the block into ``log_dir/trace.<host>.<pid>.json`` (nothing
  when ``log_dir`` is None or empty). The host's operations always; the
  CUDA kernels and copies too when ``device`` is a CUDA device. Yields the
  profiler, or None."""
  if not log_dir:
    yield None
    return
  activities = [ProfilerActivity.CPU]
  if torch.device(device).type == "cuda":
    activities.append(ProfilerActivity.CUDA)
  os.makedirs(log_dir, exist_ok=True)
  with profile(activities=activities) as prof:
    yield prof
  prof.export_chrome_trace(os.path.join(
      log_dir, f"trace.{socket.gethostname()}.{os.getpid()}.json"))


def annotate(name: str):
  """A named region that shows in :func:`trace`'s traces."""
  return record_function(name)


class StepTimer:
  """Rolling wall-clock timing of train steps, TensorBoard-loggable."""

  def __init__(self, writer=None, tag: str = "step_time_ms",
               window: int = 50):
    self.writer = writer
    self.tag = tag
    self.window = window
    self._times: list[float] = []
    self._t0: Optional[float] = None

  def start(self):
    self._t0 = time.time()

  def stop(self, step: int):
    if self._t0 is None:
      return
    dt = (time.time() - self._t0) * 1e3
    self._times.append(dt)
    if len(self._times) > self.window:
      self._times.pop(0)
    if self.writer is not None:
      self.writer.add_scalar(self.tag, dt, step)
    self._t0 = None

  @property
  def mean_ms(self) -> float:
    return sum(self._times) / max(len(self._times), 1)
