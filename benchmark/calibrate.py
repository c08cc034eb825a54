"""The readings that the limits of ``benchmark/workloads/<cell>.json`` are set
from, in one process on the card:

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 \\
        --control-seeds 4,5,6 --seconds 3

For each of ``--seeds`` a run of the cell (set-up, a short window at the
cell's load, the check): every number the check computes, the lower
readings. For each of ``--control-seeds`` the control: the plain reference
computed in fp8 (``reference/precision.py``) put in the program's place and
compared with the f32 reference on the same inputs, the upper readings.
Each reading is one JSON line on standard output. The benchmark's own runs
never run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _ints(text: str) -> list[int]:
  return [int(s) for s in text.split(",") if s]


def control_numbers(spec: dict, seed: int, device,
                    variants=("fp8",)) -> dict:
  """The control against the f32 reference on the seed's inputs, as the
  cell's driver makes it (its ``control``): "fp8", the reference in fp8;
  for a training cell also "reversed" (the f32 reference on each batch's
  rows reversed: f32 rounding alone) and "half" (the f32 reference on half
  of each batch: a fault). Returns the numbers of the first variant, or
  ``{variant: numbers}`` for several."""
  from benchmark.harness import spec as specs
  kind = specs.driver_class(spec["traffic"]["driver"])
  driver = kind(spec["config"], spec["traffic"], seed, device)
  driver.setup()
  driver.program_outputs()      # picks the frames a frame cell checks
  driver.release()
  out = {}
  for variant in variants:
    numbers = driver.numbers(*driver.control(variant))
    out[variant] = {k: v for k, v in numbers.items()
                    if not k.startswith("_")}
    out[variant]["leaves"] = numbers.get("_leaves")
  return out[variants[0]] if len(variants) == 1 else out


def main() -> None:
  parser = argparse.ArgumentParser()
  parser.add_argument("--workload", required=True)
  parser.add_argument("--seeds", type=_ints, default=[])
  parser.add_argument("--control-seeds", type=_ints, default=[])
  parser.add_argument("--seconds", type=float, default=3.0)
  parser.add_argument("--variants", default="fp8",
                      help="comma-separated: fp8, and for training cells "
                      "reversed and half")
  args = parser.parse_args()
  sys.path.insert(0, str(ROOT))
  from benchmark.harness import spec as specs
  from benchmark.harness.runner import run_cell
  spec = specs.cell_spec(args.workload)
  for seed in args.seeds:
    t = time.perf_counter()
    result, diag = run_cell(spec, seed, args.seconds, False, "cuda:0", t)
    print(json.dumps({"workload": args.workload, "seed": seed,
                      "side": "program", "correct": result["correct"],
                      "numbers": diag["numbers"],
                      "leaves": diag.get("_leaves"),
                      "metrics": result["metrics"],
                      "seconds": time.perf_counter() - t}), flush=True)
  for seed in args.control_seeds:
    t = time.perf_counter()
    variants = tuple(args.variants.split(","))
    numbers = control_numbers(spec, seed, "cuda:0", variants)
    if len(variants) == 1:
      numbers = {variants[0]: numbers}
    for variant, got in numbers.items():
      print(json.dumps({"workload": args.workload, "seed": seed,
                        "side": variant, "numbers": got,
                        "seconds": time.perf_counter() - t}), flush=True)


if __name__ == "__main__":
  main()
