"""The device time (ms) of remat's reruns in the stage-1 training step's
backward (the feature extractor's two calls, the three hourglasses and the
three heads, summed) per step: the program's ``remat.rerun`` span (a CUDA
event pair on the device's timeline, the device's waits inside the span
included), summed over the profiled stretch after the window and divided by
its steps."""

from benchmark.harness.program_spans import device_ms_per_call

SPAN, OUTER = "remat.rerun", "step"


def read(run):
  return device_ms_per_call(run, SPAN, OUTER)
