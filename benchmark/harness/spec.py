"""Everything a run needs, found by name from ``BENCHMARK.json``.

A cell (``workloads`` entry) names its configuration and its traffic mix.
The configuration is the file its ``configs`` entry gives; the mix is
``benchmark/traffic/<traffic>.json``, data read by the driver it names,
``benchmark/drivers/<driver>.py``; the cell's own file,
``benchmark/workloads/<cell>.json``, holds the limits of its correctness
check; each per-layer metric is read by ``benchmark/metrics/<metric>.py``.
Adding a cell, a configuration, a mix, a driver or a metric adds files and
entries and edits none.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def load_json(path: Path) -> dict:
  with open(path) as f:
    return json.load(f)


def cell_spec(name: str, root: Path = ROOT) -> dict:
  """The cell ``name`` with its configuration, traffic, checks and the
  metrics it reports: ``{"cell", "config", "traffic", "checks",
  "end_to_end", "per_layer"}``."""
  bench = load_json(root / "BENCHMARK.json")
  cells = {w["name"]: w for w in bench["workloads"]}
  if name not in cells:
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                   f"known: {sorted(cells)}")
  cell = cells[name]
  configs = {c["name"]: c for c in bench["configs"]}
  bench_dir = root / BENCH_DIR.name

  def reported(metric):
    return name in metric.get("workloads", [name])

  return {"cell": cell, "run_seconds": bench["run_seconds"],
          "config": load_json(root / configs[cell["config"]]["file"]),
          "traffic": load_json(bench_dir / "traffic" / f"{cell['traffic']}.json"),
          "checks": load_json(bench_dir / "workloads" / f"{name}.json"),
          "end_to_end": [m for m in bench["end_to_end"] if reported(m)],
          "per_layer": [m for m in bench["per_layer"] if reported(m)]}


def _module(kind: str, name: str, root: Path):
  """``benchmark/<kind>/<name>.py`` of the checkout at ``root``, loaded by
  its path."""
  path = root / BENCH_DIR.name / kind / f"{name}.py"
  if not path.is_file():
    raise KeyError(f"no {path.relative_to(root)}")
  spec = importlib.util.spec_from_file_location(
      f"benchmark_{kind}_{name.replace('.', '_')}", path)
  module = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(module)
  return module


def metric_reader(name: str, root: Path = ROOT):
  """The ``read(run)`` function of ``benchmark/metrics/<name>.py``."""
  return _module("metrics", name, root).read


def driver_class(name: str, root: Path = ROOT):
  """The ``Driver`` class of ``benchmark/drivers/<name>.py`` (a subclass of
  ``harness/driver.py:Driver``)."""
  return _module("drivers", name, root).Driver
