#!/usr/bin/env python3
"""Profile the host work of the port's dataset CLIs on one CUDA card.

    python3 cli_profile.py [--top N]

Builds the port's kernels and writes ``chip_smoke.py``'s ``cli`` tree and
weights (1024x512, maxdisp 192; the fusion net seeded and its head
calibrated on the frame, as the ``frame`` phase does), then runs
``test_disparity`` at batch 1 with its dumps, ``save_output_disparity_stage``
at batch 6 and ``test_fusion`` once each under ``cProfile``. For each it
prints the wall seconds, the host ms per call of the PNG and array writers,
the bridge, the model calls and the device read-backs (where the host waits
for the card), and the N functions with the most self time. The last line
is a JSON summary.
"""

from __future__ import annotations

import argparse
import cProfile
import json
import pstats
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

import chip_smoke

LABELS = ("test_disparity_b1", "save_output_disparity_stage", "test_fusion")
# (a part of the file's path, a part of the function's name) -> the name
# printed
WATCHED = {
    ("utils/colormap.py", "save_colormapped"): "save_colormapped",
    ("utils/colormap.py", "save_gray_png"): "save_gray_png",
    ("cli/test_fusion.py", "_save_log_png"): "_save_log_png",
    ("PIL/Image.py", "save"): "PIL Image.save",
    ("npyio", "savez"): "np.savez",
    ("npyio", "save"): "np.save",
    ("geometry/reprojection.py", "disp_to_depth_at_cam1"): "bridge",
    ("torch/nn/modules/module.py", "_call_impl"): "module calls",
    ("~", "method 'cpu' of"): "Tensor.cpu",
}


def _watched(stats: pstats.Stats) -> dict:
  """Calls and cumulative host ms of each watched function."""
  out = {}
  for (path, _, func), (_, calls, _, cum, _) in stats.stats.items():
    for (where, name), label in WATCHED.items():
      if where in path and (func == name if where != "~" else name in func):
        row = out.setdefault(label, {"calls": 0, "ms": 0.0})
        row["calls"] += calls
        row["ms"] += cum * 1e3
  for row in out.values():
    row["ms_per_call"] = row["ms"] / max(row["calls"], 1)
  return out


def _top_self(stats: pstats.Stats, n: int) -> list:
  rows = sorted(stats.stats.items(), key=lambda kv: -kv[1][2])[:n]
  return [{"function": f"{Path(path).name}:{line} {func}", "calls": calls,
           "self_ms": tt * 1e3}
          for (path, line, func), (_, calls, tt, _, _) in rows]


def main() -> int:
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument("--top", type=int, default=8)
  args = parser.parse_args()
  if not torch.cuda.is_available():
    print("cli_profile: no CUDA device is available", file=sys.stderr)
    return 1
  from mode_tpu_torch.kernels import build
  from mode_tpu_torch.pipeline import TwoStagePipeline
  card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                         "--format=csv,noheader"], capture_output=True,
                        text=True, timeout=60, check=True).stdout.strip()
  print(card, flush=True)
  build.build()
  disp, fusion = chip_smoke._frame_models()
  pipe = TwoStagePipeline(disp, fusion, chip_smoke.MAXDISP,
                          chip_smoke.MAX_DEPTH, stage1_chunk=6,
                          uint8_inputs=True, device=chip_smoke.DEVICE)
  chip_smoke._calibrate_head(pipe, chip_smoke._frame_inputs())
  fusion_state = {k: v.detach().cpu()
                  for k, v in pipe.fusion.state_dict().items()}
  del disp, fusion, pipe
  torch.cuda.empty_cache()
  summary = {"card": card}
  with tempfile.TemporaryDirectory() as tmp:
    *_, runs = chip_smoke._cli_setup(Path(tmp), fusion_state)
    for label in LABELS:
      run, argv = runs[label]
      prof = cProfile.Profile()
      torch.cuda.synchronize()
      t0 = time.perf_counter()
      prof.enable()
      run(argv)
      torch.cuda.synchronize()
      prof.disable()
      wall = time.perf_counter() - t0
      stats = pstats.Stats(prof)
      summary[label] = {"wall_s": wall, "watched": _watched(stats),
                        "top_self": _top_self(stats, args.top)}
      print(f"\ncli_profile {label}: {wall:.2f} s wall under cProfile "
            f"({card})", flush=True)
      for name, row in summary[label]["watched"].items():
        print(f"  {name}: {row['calls']} calls, {row['ms']:.2f} ms, "
              f"{row['ms_per_call']:.2f} ms a call", flush=True)
      for row in summary[label]["top_self"]:
        print(f"  self {row['self_ms']:.2f} ms in {row['calls']} calls: "
              f"{row['function']}", flush=True)
  print(json.dumps(summary), flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
