#!/usr/bin/env python3
"""What the rematerialisation of the stage-1 training step costs and saves
on one card.

    python3 scripts/remat_cost.py [--turns 6] [--out FILE]

Builds the port's kernels, then at ``chip_smoke.py``'s ``train_b2`` shape
(Sphere Cassini 1024x512, maxdisp 192, batch 2, seeded weights) takes the
step with ``remat=False``, ``remat_policy="save_convs"`` and ``"full"``,
each from an identical copy on the same batch, in f32 and in bf16:

- ``--turns`` steps of each after a first one, the policies in turns,
  each timed to a CUDA synchronisation, with its peak memory above what was
  allocated before it;
- one step of each under ``torch.profiler`` (``chip_smoke._profile``): its
  device time by kind of kernel, its host time and its kernel launches.

Then one f32 step at batch 4 (the trainers' default) and at batch 8 under
each policy: its time and peak memory, or that the card ran out of memory.
Prints the card's name and power limit first and a JSON summary as the last
line (also written to ``--out``).
"""

from __future__ import annotations

import argparse
import copy
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402

POLICIES = cs.REMAT_POLICIES
BIG_BATCHES = (4, 8)


def _model(remat: bool, policy: str):
  from mode_tpu_torch.models.disparity import ModeDisparity
  return ModeDisparity(cs.MAXDISP, "Sphere", "Cassini", device=cs.DEVICE,
                       generator=torch.Generator().manual_seed(0),
                       remat=remat, remat_policy=policy)


def _timed(step, batch) -> tuple[float, float]:
  """One step: its ms and its peak GiB above what was allocated before."""
  torch.cuda.synchronize()
  held = torch.cuda.memory_allocated()
  torch.cuda.reset_peak_memory_stats()
  t = time.perf_counter()
  step(*batch)
  torch.cuda.synchronize()
  ms = (time.perf_counter() - t) * 1e3
  return ms, (torch.cuda.max_memory_allocated() - held) / 2**30


def _in_turns(dtype, batch, turns: int) -> dict:
  from mode_tpu_torch import training
  cdt = None if dtype == torch.float32 else dtype
  init = _model(False, "save_convs")
  steps = {}
  for label, (remat, policy) in POLICIES.items():
    model = copy.deepcopy(init)
    model.remat, model.remat_policy = remat, policy
    steps[label] = training.make_disparity_train_step(
        model, training.make_optimizer(model.parameters()),
        compute_dtype=cdt)
    steps[label](*batch)                            # the first step
  out = {label: {"step_ms": [], "step_peak_gib": []} for label in steps}
  for _ in range(turns):
    for label, step in steps.items():
      ms, peak = _timed(step, batch)
      out[label]["step_ms"].append(ms)
      out[label]["step_peak_gib"].append(peak)
  for label, step in steps.items():
    rec = out[label]
    rec["median_ms"] = statistics.median(rec["step_ms"])
    rec["profile"] = cs._profile(step, batch)
    prof = rec["profile"]
    print(f"{cs._dtype_name(dtype)} {label}: ms/step "
          + ", ".join(f"{t:.2f}" for t in rec["step_ms"])
          + f" (median {rec['median_ms']:.2f}); peak "
          f"{max(rec['step_peak_gib']):.2f} GiB above the model; profiled "
          f"step host {prof['host_ms']:.2f} ms, device "
          f"{prof['device_ms']:.2f} ms, "
          f"{prof['runtime_calls']['launch_kernel']} kernel launches; "
          "device ms by kind " + json.dumps(
              {k: round(v, 2) for k, v in prof["by_kind_ms"].items()}),
          flush=True)
  off = out["remat_off"]["median_ms"]
  for label in ("save_convs", "full"):
    out[label]["over_remat_off"] = out[label]["median_ms"] / off - 1
  return out


def _big(batch_size: int) -> dict:
  """One f32 step at ``batch_size`` under each policy."""
  from mode_tpu_torch import training
  gen = torch.Generator(device=cs.DEVICE).manual_seed(3)
  batch = cs._train_batch(gen, batch_size, *cs.GEOMETRY["Cassini"])
  out = {}
  for label in ("save_convs", "full", "remat_off"):
    model = _model(*POLICIES[label])
    step = training.make_disparity_train_step(
        model, training.make_optimizer(model.parameters()))
    try:
      ms, peak = _timed(step, batch)
      out[label] = {"first_step_ms": ms, "step_peak_gib": peak}
    except torch.OutOfMemoryError as e:
      out[label] = {"out_of_memory": str(e).splitlines()[0]}
    del model, step
    torch.cuda.empty_cache()
    print(f"f32 batch {batch_size} {label}: {json.dumps(out[label])}",
          flush=True)
  return out


def main() -> int:
  ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
  ap.add_argument("--turns", type=int, default=6)
  ap.add_argument("--out", default="")
  args = ap.parse_args()
  if not torch.cuda.is_available():
    print("remat_cost: no CUDA device is available", file=sys.stderr)
    return 1
  from mode_tpu_torch.kernels import build
  card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                         "--format=csv,noheader"], capture_output=True,
                        text=True, check=True).stdout.strip().splitlines()[0]
  print(card, flush=True)
  build.build()
  gen = torch.Generator(device=cs.DEVICE).manual_seed(0)
  batch = cs._train_batch(gen, 2, *cs.GEOMETRY["Cassini"])
  out = {"card": card, "torch": torch.__version__, "turns": args.turns,
         "batch_2": {cs._dtype_name(dt): _in_turns(dt, batch, args.turns)
                     for dt in (torch.float32, torch.bfloat16)}}
  for n in BIG_BATCHES:
    out[f"f32_batch_{n}"] = _big(n)
  line = json.dumps(out)
  if args.out:
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(line + "\n")
  print(line, flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
