"""Seconds from the start of the process to the first timed call: imports,
CUDA's start, loading (or building) the kernels, weights, inputs and the
warm-up calls."""


def read(run):
  return run["setup_s"]
