"""Stage 1 after its feature extractor (the cost volume, the 3-D stack, the
heads and the regression) against its roofline (%): the least time of that
work at the cell's shapes (``counts/roofline.py``) over stage 1's device
time less the feature extractor's, per frame."""

from benchmark.counts.roofline import stage1_least_s


def read(run):
  fe = run["spans"].get("feature_extraction")
  stage1 = run["spans"].get("stage1")
  if not fe or not stage1:
    return None
  cfg, chunk = run["config"], run["traffic"]["stage1_chunk"]
  least = stage1_least_s(chunk, cfg["height"], cfg["width"], cfg["maxdisp"],
                         cfg["dtype"])["cv"] * (6 // chunk)
  rest = (sum(stage1) - sum(fe)) / len(stage1)
  return 100.0 * least / rest
