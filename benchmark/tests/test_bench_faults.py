"""The check fails what it must: the control (the reference in fp8 in the
program's place) and each fault a cell can have, planted under a run that
skips the look for a card, at the tiny size on the CPU.

Faults (one chip, so no exchange between chips to leave out): a training
step that leaves its state unchanged; half of the batch left out, the
mean taken over the rest; an answer altered where it is produced (a
frame's fused depth, a step's loss).
"""

import functools

import pytest
import torch

from benchmark.calibrate import control_numbers
from benchmark.harness.compare import judge
import tiny


@pytest.mark.parametrize("kind", tiny.KINDS)
def test_control_fails(kind):
  numbers = control_numbers(tiny.spec(kind), 2**31 + 7, "cpu")
  assert not judge(numbers, tiny.TINY["limits"][kind])["correct"], numbers


def _broken_pipeline(monkeypatch, fault):
  from mode_tpu_torch import pipeline
  call, stage1 = pipeline.TwoStagePipeline.__call__, \
      pipeline.TwoStagePipeline.stage1
  if fault == "answer":
    def broken(self, *a, **k):
      fused, disp, conf = call(self, *a, **k)
      return fused * 1.01, disp, conf
    monkeypatch.setattr(pipeline.TwoStagePipeline, "__call__", broken)
  else:
    def half(self, lefts, rights, **k):
      disp, conf = stage1(self, lefts[:3], rights[:3], **k)
      return torch.cat([disp, disp]), torch.cat([conf, conf])
    monkeypatch.setattr(pipeline.TwoStagePipeline, "stage1", half)


def _broken_step(monkeypatch, kind, fault):
  from mode_tpu_torch import training
  name = {"train_disparity": "make_disparity_train_step",
          "train_fusion": "make_fusion_train_step"}[kind]
  make = getattr(training, name)

  @functools.wraps(make)
  def broken_make(model, optimizer, *a, **k):
    step = make(model, optimizer, *a, **k)

    def broken(*batch):
      if fault == "unchanged":
        saved = [p.detach().clone() for p in model.parameters()]
        loss = step(*batch)
        with torch.no_grad():
          for p, s in zip(model.parameters(), saved):
            p.copy_(s)
        return loss
      if fault == "half":
        n = batch[-1].shape[0] // 2
        cut = [x[:n] if torch.is_tensor(x) else [t[:n] for t in x]
               for x in batch]
        return step(*cut)
      return step(*batch) * 1.01
    return broken

  monkeypatch.setattr(training, name, broken_make)


CASES = [("frame", "answer"), ("frame", "half")] + [
    (k, f) for k in ("train_disparity", "train_fusion")
    for f in ("unchanged", "half", "answer")]


@pytest.mark.parametrize("kind, fault", CASES)
def test_fault_makes_the_run_incorrect(monkeypatch, kind, fault):
  if kind == "frame":
    _broken_pipeline(monkeypatch, fault)
  else:
    _broken_step(monkeypatch, kind, fault)
  result, diag = tiny.run(kind)
  assert not result["correct"], diag
  assert result["failed"] >= 1
