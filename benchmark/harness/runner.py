"""One run of one cell: set-up, the measured window, with ``trace`` a
profiled stretch after it, then the correctness check, and the result.

The result has the keys the benchmark's contract names, in this order:
``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``trace`` also ``breakdown``, and last ``checks``: each number compared,
beside its limit.
"""

from __future__ import annotations

import time

import torch

from benchmark.harness import spec as specs
from benchmark.harness.compare import judge
from benchmark.harness.profile import profile_calls


def run_cell(spec: dict, seed: int, seconds: float, trace: bool, device,
             started: float, root=specs.ROOT) -> tuple[dict, dict]:
  """Run the cell ``spec`` (``harness/spec.py:cell_spec``) on ``device``;
  ``started`` is the process's start on ``time.perf_counter``'s clock.
  Returns the result and diagnostics (the worst leaves, the profile's
  counts) for standard error. The cell's driver is found by the name its
  traffic gives (``harness/spec.py:driver_class``); it raises
  ``harness.driver.Unrunnable`` where it cannot run the cell's cards."""
  cuda = torch.device(device).type == "cuda"
  traffic = spec["traffic"]
  kind = specs.driver_class(traffic["driver"], root)
  kind.check_chips(spec["cell"]["chips"])
  driver = kind(spec["config"], traffic, seed, device)
  driver.setup()
  if cuda:
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
  # the reference's seconds inside the set-up (a head's calibration) are
  # the benchmark's, not the program's
  setup_s = time.perf_counter() - started - driver.reference_s
  hooks = driver.trace_hooks() if trace else []
  call = driver.traced_call if trace else driver.call
  window = driver.window(call, seconds, first=driver.warm_calls())
  for h in hooks:
    h.remove()
  peak = torch.cuda.max_memory_allocated() if cuda else 0
  spans = driver.span_seconds() if trace else {}
  profile = None
  if trace:
    after = driver.warm_calls() + window["calls"]
    profile = profile_calls(driver.call,
                            range(after, after + traffic["profiled_calls"]))
  produced = driver.program_outputs()
  driver.release()
  t_check = time.perf_counter()
  numbers = driver.numbers(produced,
                           driver.reference_outputs(judged=produced))
  check_s = time.perf_counter() - t_check
  verdict = judge(numbers, spec["checks"]["limits"])
  record = {"window": window, "spans": spans, "profile": profile,
            "setup_s": setup_s, "peak_bytes": peak, "config": spec["config"],
            "traffic": traffic, "chips": spec["cell"]["chips"],
            "examples_per_call": driver.examples_per_call}
  wanted = spec["per_layer"] if trace else spec["end_to_end"]
  metrics = {}
  for m in wanted:
    value = specs.metric_reader(m["name"], root)(record)
    if value is not None:
      metrics[m["name"]] = {"value": value, "unit": m["unit"]}
  dev = {"platform": "gpu" if cuda else "cpu",
         "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
         "count": spec["cell"]["chips"], "memory_peak_bytes": peak}
  result = {"correct": verdict["correct"], "attempted": window["calls"],
            "failed": 0 if verdict["correct"] else 1, "metrics": metrics,
            "device": dev}
  if profile is not None:
    dev["busy_s"] = profile["busy_s"]
    dev["window_s"] = profile["window_s"]
    result["breakdown"] = {"device_ops": profile["device_ops"],
                           "idle_gaps": profile["idle_gaps"]}
  result["checks"] = verdict["checks"]
  diagnostics = {"numbers": {k: v for k, v in numbers.items()
                             if not k.startswith("_")},
                 **{k: v for k, v in numbers.items() if k.startswith("_")}}
  diagnostics["window_s"] = window["window_s"]
  lat = sorted(window["latencies"])
  diagnostics["call_ms"] = {"min": lat[0] * 1e3,
                            "median": lat[len(lat) // 2] * 1e3,
                            "max": lat[-1] * 1e3}
  diagnostics["check_s"] = check_s
  diagnostics["reference_s_in_setup"] = driver.reference_s
  last, diagnostics["setup_parts_s"] = started, {}
  for label, t in driver.marks:
    diagnostics["setup_parts_s"][label] = t - last
    last = t
  if profile is not None:
    diagnostics["profiled_calls"] = profile["calls"]
    diagnostics["syncs"] = profile["syncs"]
  return result, diagnostics
