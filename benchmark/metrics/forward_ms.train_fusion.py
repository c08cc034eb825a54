"""The device time (ms) of the fusion training step's forward per step: the
program's ``step.forward`` span (a CUDA event pair on the device's timeline,
the device's waits inside the span included), summed over the profiled stretch
after the window and divided by its steps."""

from benchmark.harness.program_spans import device_ms_per_call

SPAN, OUTER = "step.forward", "step"


def read(run):
  return device_ms_per_call(run, SPAN, OUTER)
