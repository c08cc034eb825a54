"""The whole frame's share of the card's peak (%): the frozen model FLOPs of
a frame (``counts/flops.py:pipeline_flops``, useful conv MACs) times the
frames of the window, over the window's seconds times the peak of the
configuration's dtype."""

from benchmark.counts.flops import pipeline_flops
from benchmark.counts.roofline import PEAK_OPS_PER_S


def read(run):
  cfg, w = run["config"], run["window"]
  flops = pipeline_flops(cfg["height"], cfg["width"], cfg["maxdisp"])
  return 100.0 * flops * w["calls"] / (
      w["window_s"] * PEAK_OPS_PER_S[cfg["dtype"]] * run["chips"])
