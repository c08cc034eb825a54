"""Frames completed per second: every frame of the window over the whole
window, on the host clock (each frame ends with its fused depth on the
host)."""


def read(run):
  return run["window"]["calls"] / run["window"]["window_s"]
