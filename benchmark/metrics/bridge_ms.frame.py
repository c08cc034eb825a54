"""The mean device time (ms) of the frame's bridge over every frame of a traced
window: CUDA events the benchmark records around its call of the stage."""


def read(run):
  spans = run["spans"].get("bridge")
  return 1e3 * sum(spans) / len(spans) if spans else None
