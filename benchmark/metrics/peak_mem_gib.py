"""The card's peak of allocated memory over the window (GiB): the CUDA
caching allocator's ``max_memory_allocated``, reset as the window opens."""


def read(run):
  return run["peak_bytes"] / 2**30
