"""Stage 1's feature extractor against its roofline (%): the least time of
its conv work on both views at the cell's shapes (``counts/roofline.py``)
over its device time, from CUDA events in hooks around each of its calls,
per frame."""

from benchmark.counts.roofline import stage1_least_s


def read(run):
  fe = run["spans"].get("feature_extraction")
  frames = len(run["spans"].get("stage1", []))
  if not fe or not frames:
    return None
  cfg, chunk = run["config"], run["traffic"]["stage1_chunk"]
  least = stage1_least_s(chunk, cfg["height"], cfg["width"], cfg["maxdisp"],
                         cfg["dtype"])["fe"] * (6 // chunk)
  return 100.0 * least / (sum(fe) / frames)
