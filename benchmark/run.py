"""Run one cell of the benchmark of ``mode_tpu_torch`` on the card(s) of this
machine and print its result as the last line of standard output.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Run it from the root of a checkout. The cell, its configuration, its traffic
and its metrics are found by name from ``BENCHMARK.json``
(``harness/spec.py``). With ``--trace 0`` the result carries the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics, the device's
busy time and a breakdown. The numbers compared with the reference, each
beside its limit, are the last lines of standard error and the last key of
the result. Without as many CUDA cards as the cell asks for, with a
driver (``benchmark/drivers/``) that cannot run that many, or without the
program beside the benchmark, it exits with an error and prints no result.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# JAX and the JAX package must not run here; compared by top-level name
# (the port's name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "mode_tpu")


def _fail(msg: str, code: int) -> None:
  print(f"benchmark: {msg}", file=sys.stderr, flush=True)
  sys.exit(code)


def _forbidden_modules() -> list:
  return sorted({name.split(".")[0] for name in sys.modules}
                & set(FORBIDDEN))


def main(argv=None) -> None:
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument("--workload", required=True)
  parser.add_argument("--seed", type=int, required=True)
  parser.add_argument("--seconds", type=float, required=True)
  parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
  args = parser.parse_args(argv)

  sys.path.insert(0, str(ROOT))
  # every cache a library may keep stays inside the checkout, at a fixed path
  for var, sub in (("TRITON_CACHE_DIR", "triton"),
                   ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
    os.environ.setdefault(var, str(ROOT / "benchmark" / ".cache" / sub))
  if importlib.util.find_spec("mode_tpu_torch") is None:
    _fail("the program under test (mode_tpu_torch) is not beside the "
          "benchmark", 2)

  import torch
  from benchmark.harness import spec as specs
  from benchmark.harness.driver import Unrunnable
  from benchmark.harness.runner import run_cell

  spec = specs.cell_spec(args.workload)
  chips = spec["cell"]["chips"]
  if not torch.cuda.is_available():
    _fail("no CUDA device", 2)
  if torch.cuda.device_count() < chips:
    _fail(f"the cell asks for {chips} cards, {torch.cuda.device_count()} "
          "found", 2)
  try:
    result, diagnostics = run_cell(spec, args.seed, args.seconds,
                                   bool(args.trace), "cuda:0", STARTED)
  except Unrunnable as e:
    _fail(str(e), 2)
  found = _forbidden_modules()
  if found:
    _fail(f"modules of JAX or the JAX package were loaded: {found}", 3)
  print(f"diagnostics: {json.dumps(diagnostics)}", file=sys.stderr)
  for name, c in result["checks"].items():
    print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
          file=sys.stderr)
  sys.stderr.flush()
  print(json.dumps(result), flush=True)


if __name__ == "__main__":
  main()
