"""What every driver shares. A driver is one kind of traffic: the file
``benchmark/drivers/<kind>.py`` that a traffic mix names under ``"driver"``
(``harness/spec.py:driver_class``), whose ``Driver`` class builds the
program under test and its inputs from the seed (``setup``), runs one
request or step of the timed path (``call``), and, once the window has
closed, gives what the program produced (``program_outputs``) and what the
plain reference computes from the same inputs (``reference_outputs``) for
``harness/compare.py`` to judge.

A driver owns its loop (``window``: one client in a closed loop unless it
says otherwise) and the cards it runs on (``check_chips``: one, unless it
brings its own launcher of ranks), so a new kind of traffic is a new file.
"""

from __future__ import annotations

import contextlib
import gc
import time
from pathlib import Path

import numpy as np
import torch

from benchmark.harness.window import closed_loop

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
ROOT = Path(__file__).resolve().parents[2]


class Unrunnable(RuntimeError):
  """The cell asks for what its driver cannot run (say, more cards)."""


def cuda_sync(device) -> None:
  if torch.device(device).type == "cuda":
    torch.cuda.synchronize(device)


def sampled(seed: int, n: int, k: int) -> list[int]:
  """``k`` distinct indices of ``range(n)`` drawn from the seed."""
  rng = np.random.default_rng(seed)
  return sorted(int(i) for i in rng.choice(n, size=min(k, n), replace=False))


def load_npz(path: str, device) -> dict:
  """A reference-layout state dict kept in the repository (``path`` from
  the checkout's root), f16 arrays widened to f32, on ``device``."""
  with np.load(ROOT / path) as z:
    return {k: torch.from_numpy(z[k].astype(np.float32)
                                if z[k].dtype == np.float16 else z[k]
                                ).to(device) for k in z.files}


class Driver:
  """Shared plumbing: the seed's generator, the device, the spans, the
  set-up's marks and the reference's seconds inside the set-up."""

  examples_per_call = 1
  program_state: tuple = ()

  def __init__(self, config: dict, traffic: dict, seed: int, device):
    self.config, self.traffic, self.seed = config, traffic, seed
    self.device = torch.device(device)
    self.gen = torch.Generator(device=self.device).manual_seed(seed)
    self.dtype = DTYPES[config["dtype"]]
    self.spans: dict[str, list] = {}
    self.marks: list = []
    self.reference_s = 0.0

  @classmethod
  def check_chips(cls, chips: int) -> None:
    """Raise ``Unrunnable`` unless this driver runs on ``chips`` cards."""
    if chips != 1:
      raise Unrunnable(f"the driver {cls.__module__} runs one card in one "
                       f"process; the cell asks for {chips}")

  def window(self, call, seconds: float, first: int) -> dict:
    """The measured window (``harness/window.py``'s keys)."""
    return closed_loop(call, seconds, first)

  def mark(self, label: str) -> None:
    """Note the host clock at the end of a part of the set-up."""
    cuda_sync(self.device)
    self.marks.append((label, time.perf_counter()))

  @contextlib.contextmanager
  def reference_time(self):
    """The seconds of this block (device work included) are the
    reference's inside the set-up: ``setup_s`` leaves them out."""
    cuda_sync(self.device)
    t = time.perf_counter()
    try:
      yield
    finally:
      cuda_sync(self.device)
      self.reference_s += time.perf_counter() - t

  def warm_calls(self) -> int:
    """Calls the set-up has made (the window's first call follows)."""
    return self.traffic["warmup_calls"]

  def trace_hooks(self) -> list:
    """Handles of hooks that record spans in a traced window."""
    return []

  def traced_call(self, i: int) -> None:
    self.call(i)

  def span_seconds(self) -> dict:
    """Each span's durations (s), read from its CUDA events after a
    synchronise."""
    cuda_sync(self.device)
    return {name: [a.elapsed_time(b) * 1e-3 for a, b in pairs]
            for name, pairs in self.spans.items()}

  def event(self):
    e = torch.cuda.Event(enable_timing=True)
    e.record()
    return e

  def release(self) -> None:
    """Free the program's state before the reference runs."""
    for name in self.program_state:
      setattr(self, name, None)
    gc.collect()
    if self.device.type == "cuda":
      torch.cuda.empty_cache()


HEAD = "feature_extraction.depth_layer7.2"   # the fusion net's 1x1 head


def scale_head(state: dict, net, run, device) -> None:
  """Scale and shift the seeded fusion net's 1x1 head in ``state`` so that
  its logits have mean 0 and std 1 in ``run(net)``, with the reference's
  f32 net: the seeded net's raw logits spread over hundreds, where the
  sigmoid is flat."""
  net.load_state_dict(state)
  net.to(device)
  logits = []
  net.head().register_forward_hook(lambda m, a, out: logits.append(out))
  with torch.no_grad(), ieee_f32():
    run(net)
  mean, std = float(logits[0].mean()), float(logits[0].std())
  state[f"{HEAD}.weight"] = state[f"{HEAD}.weight"] / std
  state[f"{HEAD}.bias"] = (state[f"{HEAD}.bias"] - mean) / std


class ieee_f32:
  """f32 matmuls and convs without TF32 while the reference runs."""

  def __enter__(self):
    self.saved = (torch.backends.cuda.matmul.allow_tf32,
                  torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

  def __exit__(self, *exc):
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = self.saved
