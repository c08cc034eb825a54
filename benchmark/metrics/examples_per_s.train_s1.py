"""Stage-1 training examples (stereo pairs with their ground truth) per
second: every step of the window times its batch, over the whole window,
on the host clock (each step ends with its loss on the host)."""


def read(run):
  w = run["window"]
  return w["calls"] * run["examples_per_call"] / w["window_s"]
