"""The device's idle share (%) over a profiled stretch of whole calls after
the window: 1 less the union of its kernel, copy and set intervals over the
stretch (``harness/profile.py``)."""


def read(run):
  p = run["profile"]
  if not p or not p["window_s"]:
    return None
  return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
