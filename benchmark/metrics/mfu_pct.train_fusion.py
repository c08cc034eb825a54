"""The whole fusion training step's share of the card's peak (%): the
frozen model FLOPs of a step (``counts/flops.py:fusion_flops``'s "train":
forward, grad-input and grad-weight) times the steps of the window, over
the window's seconds times the peak of the configuration's dtype and the
cards."""

from benchmark.counts.flops import fusion_flops
from benchmark.counts.roofline import PEAK_OPS_PER_S


def read(run):
  cfg, tr, w = run["config"], run["traffic"], run["window"]
  flops = fusion_flops(tr["batch"], cfg["height"], cfg["width"],
                       tuple(cfg["fusion_channels"]))["train"]
  return 100.0 * flops * w["calls"] / (
      w["window_s"] * PEAK_OPS_PER_S[cfg["dtype"]] * run["chips"])
