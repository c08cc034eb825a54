"""The 95th percentile of every frame's latency in the window (ms), from the
start of its upload to its fused depth in host memory, on the host clock."""

from benchmark.harness.window import percentile


def read(run):
  return percentile(run["window"]["latencies"], 95) * 1e3
