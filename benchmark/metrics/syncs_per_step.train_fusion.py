"""The host's waits for the device per training step, from the profiler's
record of the CUDA runtime over a stretch of whole steps:
``cudaStreamSynchronize``, ``cudaDeviceSynchronize``,
``cudaEventSynchronize`` and synchronous ``cudaMemcpy`` calls. The
benchmark's own read-back of each step's loss is one of them."""


def read(run):
  p = run["profile"]
  if not p or not p["calls"]:
    return None
  return p["syncs"] / p["calls"]
