"""The device time (ms) of the frame's 3-D stack (``dres0`` to ``classif3`` of
``models/disparity.py``) per frame: the program's ``stage1.aggregation`` span
(a CUDA event pair on the device's timeline, the device's waits inside the
span included), summed over the profiled stretch after the window and divided
by its frames."""

from benchmark.harness.program_spans import device_ms_per_call

SPAN, OUTER = "stage1.aggregation", "frame"


def read(run):
  return device_ms_per_call(run, SPAN, OUTER)
