"""The share (%) of the frame's 3-D stack (``dres0`` to ``classif3``) that
its kernels take on the device: the device time of the kernel launches
inside the program's ``stage1.aggregation`` span (a CUDA event pair around
each launch) over that span's device time, over the profiled stretch after
the window. The rest is the glue between the kernels (residual adds,
casts) and the device's waits."""

from benchmark.harness.program_spans import spans

SPAN = "stage1.aggregation"


def read(run):
  s = spans(run, "frame")
  agg = s.get(SPAN) if s else None
  if not agg or not agg["device_ms"] or agg["launch_ms"] is None:
    return None
  return 100.0 * agg["launch_ms"] / agg["device_ms"]
