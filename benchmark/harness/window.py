"""The measured window: one client in a closed loop.

Each call ends with its result on the host (a fused depth map, a step's
loss), so a call's time on the host clock covers all of its device work.
The window runs calls until ``seconds`` have passed and ends when the call
running at that moment ends: a rate counts every call over the whole
window, and the tail is the tail of every call.
"""

from __future__ import annotations

import statistics
import time


def closed_loop(call, seconds: float, first: int = 0) -> dict:
  """Run ``call(i)`` for ``i = first, first + 1, ...`` for ``seconds``.
  Returns the calls' latencies (s), their count and the window (s)."""
  latencies = []
  i = first
  t0 = time.perf_counter()
  while True:
    ts = time.perf_counter()
    call(i)
    te = time.perf_counter()
    latencies.append(te - ts)
    i += 1
    if te - t0 >= seconds:
      return {"latencies": latencies, "calls": len(latencies),
              "window_s": te - t0}


def percentile(values, q: int) -> float:
  """The ``q``-th percentile, interpolated between order statistics."""
  if len(values) < 2:
    return float(values[0])
  return statistics.quantiles(values, n=100, method="inclusive")[q - 1]
