#!/usr/bin/env python3
"""Read where the bf16 training step's gradient bars must lie, on one CUDA
card.

    python3 step_bar_study.py [--seeds N]

Builds the port's kernels, then runs ``chip_smoke.py``'s
``train_anchor_bf16`` check N times (default 4): the trained
mid-resolution weights' mixed-precision step through the kernels against
the same step through the plain versions, at 1024x512, batch 2, each time
on other anchor pairs and with other jitter draws (``seed_shift`` 0 to
N-1; 0 is the pair ``chip_smoke.py`` runs). For each it prints what the
kernel step needs of the per-leaf and the global relative bars (the least
bars it passes, over the leaves ``STEP_BARS`` holds) and what an f32 step,
read against the same plain bf16 step, needs: a bar set between the
largest of the first and the smallest of the second passes the kernel step
and fails a step that runs no bf16. The last line is a JSON summary.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch

import chip_smoke


def main() -> int:
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument("--seeds", type=int, default=4)
  args = parser.parse_args()
  if not torch.cuda.is_available():
    print("step_bar_study: no CUDA device is available", file=sys.stderr)
    return 1
  from mode_tpu_torch.kernels import build
  card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                         "--format=csv,noheader"], capture_output=True,
                        text=True, timeout=60, check=True).stdout.strip()
  print(card, flush=True)
  build.build()
  runs = []
  for shift in range(args.seeds):
    check = chip_smoke._train_anchor(torch.bfloat16, seed_shift=shift)
    runs.append({"seed_shift": shift, "held": check["held_leaves"],
                 "leaves": check["leaves"], "loss_rel": check["loss_rel"],
                 "kernel_leaf_needs": check["leaf_needs"],
                 "kernel_global_needs": check["global_needs"],
                 "kernel_worst_leaf": check["worst_leaf"]["leaf"],
                 "f32_leaf_needs": check["f32_step"]["leaf_needs"],
                 "f32_global_needs": check["f32_step"]["global_needs"],
                 "f32_loss_rel": check["f32_step"]["loss_rel"]})
    print(json.dumps(runs[-1]), flush=True)
    torch.cuda.empty_cache()
  summary = {"card": card, "seeds": args.seeds,
             "bars": {k: v for k, v in
                      chip_smoke.STEP_BARS[torch.bfloat16].items()}}
  for key in ("leaf_needs", "global_needs"):
    summary[f"kernel_{key}_max"] = max(r[f"kernel_{key}"] for r in runs)
    summary[f"f32_{key}_min"] = min(r[f"f32_{key}"] for r in runs)
  summary["loss_rel_max"] = max(r["loss_rel"] for r in runs)
  summary["f32_loss_rel_min"] = min(r["f32_loss_rel"] for r in runs)
  print(json.dumps(summary), flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
