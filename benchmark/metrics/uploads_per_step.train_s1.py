"""The host arrays the stage-1 training step copies to the device per step
(``mode_tpu_torch/device.py:upload``): the program's ``uploads`` counter
inside its ``step`` span, summed over the profiled stretch after the
window and divided by its steps. An upload from pageable memory waits for
the device."""

from benchmark.harness.program_spans import counter_per_call


def read(run):
  return counter_per_call(run, "uploads", "step")
