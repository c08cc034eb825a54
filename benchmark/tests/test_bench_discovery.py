"""A configuration, a traffic mix, a driver of a new kind, a cell and a
per-layer metric added as files and entries, with no edit to any code, are
found by name and run."""

import json
import shutil
import time
from pathlib import Path

import pytest

from benchmark.harness import spec as specs
from benchmark.harness.driver import Unrunnable
from benchmark.harness.runner import run_cell
import tiny

ROOT = Path(__file__).resolve().parents[2]

# a driver of a kind the harness has not seen: its own loop (open, at a
# fixed period) and its own cards (it would launch its ranks itself)
OPEN_LOOP_DRIVER = '''
import time

import torch

from benchmark.harness import driver as base


class Driver(base.Driver):
  program_state = ("kept",)

  @classmethod
  def check_chips(cls, chips):
    if chips not in (1, 4):
      raise base.Unrunnable(f"{chips} cards")

  def window(self, call, seconds, first):
    period, lat, i = self.traffic["period_s"], [], first
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
      due = t0 + (i - first) * period
      time.sleep(max(0.0, due - time.perf_counter()))
      call(i)
      lat.append(time.perf_counter() - due)
      i += 1
    return {"latencies": lat, "calls": len(lat),
            "window_s": time.perf_counter() - t0}

  def setup(self):
    self.x = torch.randn(self.traffic["size"], generator=self.gen,
                         device=self.device)
    self.kept = {}

  def call(self, i):
    self.kept[i] = float(self.x.sum()) * i

  def program_outputs(self):
    return dict(self.kept)

  def reference_outputs(self, judged=None):
    total = float(self.x.double().sum())
    return {i: total * i for i in judged}

  @staticmethod
  def numbers(prog, ref):
    return {"sum_gap": max(abs(prog[i] - r) / max(abs(r), 1e-30)
                           for i, r in ref.items())}
'''


def _copy(tmp_path):
  shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                  ignore=shutil.ignore_patterns("__pycache__", ".cache"))
  return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_new_cell_found_by_name(tmp_path):
  bench = _copy(tmp_path)
  b = tmp_path / "benchmark"
  config = tiny.spec("frame")["config"]
  (b / "configs" / "tiny_rig.json").write_text(json.dumps(
      {**config, "reduced": ["height", "width", "maxdisp"]}))
  traffic = dict(tiny.TINY["traffic"]["frame"])
  (b / "traffic" / "tiny_stream.json").write_text(json.dumps(traffic))
  (b / "workloads" / "tiny_cell.json").write_text(json.dumps(
      {"limits": tiny.TINY["limits"]["frame"]}))
  (b / "metrics" / "frames_seen.py").write_text(
      "def read(run):\n  return float(run['window']['calls'])\n")
  bench["configs"].append({"name": "tiny_rig", "source": "a test",
                           "file": "benchmark/configs/tiny_rig.json",
                           "reduced": ["height", "width", "maxdisp"],
                           "why": "a test"})
  bench["workloads"].append({"name": "tiny_cell", "config": "tiny_rig",
                             "traffic": "tiny_stream", "chips": 1,
                             "why": "a test"})
  for m in bench["end_to_end"]:
    if m["name"] in ("frames_per_s", "setup_s") and "workloads" in m:
      m["workloads"].append("tiny_cell")
  bench["per_layer"].append({"name": "frames_seen", "unit": "count",
                             "better": "higher", "source": "host_clock",
                             "layer": "a test", "moves": "frames_per_s",
                             "workloads": ["tiny_cell"]})
  (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
  spec = specs.cell_spec("tiny_cell", root=tmp_path)
  assert [m["name"] for m in spec["end_to_end"]] == ["frames_per_s",
                                                     "setup_s"]
  assert [m["name"] for m in spec["per_layer"]] == ["frames_seen"]
  assert specs.metric_reader("frames_seen", tmp_path)(
      {"window": {"calls": 3}}) == 3.0
  result, _ = run_cell(spec, 2**33 + 1, 0.3, False, "cpu",
                       time.perf_counter(), root=tmp_path)
  assert result["correct"]
  assert set(result["metrics"]) == {"frames_per_s", "setup_s"}


@pytest.mark.parametrize("chips", [1, 4])
def test_new_driver_kind_found_by_name(tmp_path, chips):
  bench = _copy(tmp_path)
  b = tmp_path / "benchmark"
  (b / "drivers" / "sum_stream.py").write_text(OPEN_LOOP_DRIVER)
  (b / "configs" / "sums.json").write_text(json.dumps({"dtype": "float32"}))
  (b / "traffic" / "sums_open.json").write_text(json.dumps(
      {"driver": "sum_stream", "size": 1000, "period_s": 0.01,
       "warmup_calls": 0, "profiled_calls": 2}))
  (b / "workloads" / "sums_cell.json").write_text(json.dumps(
      {"limits": {"sum_gap": 1e-5}}))
  (b / "metrics" / "sums_per_s.py").write_text(
      "def read(run):\n  w = run['window']\n"
      "  return w['calls'] / w['window_s']\n")
  bench["configs"].append({"name": "sums", "source": "a test",
                           "file": "benchmark/configs/sums.json",
                           "reduced": [], "why": "a test"})
  bench["workloads"].append({"name": "sums_cell", "config": "sums",
                             "traffic": "sums_open", "chips": chips,
                             "why": "a test"})
  bench["end_to_end"].append({"name": "sums_per_s", "unit": "1/s",
                              "better": "higher", "bound": 0.05,
                              "source": "host_clock",
                              "workloads": ["sums_cell"]})
  (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
  spec = specs.cell_spec("sums_cell", root=tmp_path)
  result, _ = run_cell(spec, 2**33 + 3, 0.2, False, "cpu",
                       time.perf_counter(), root=tmp_path)
  assert result["correct"] and result["checks"]["sum_gap"]["value"] < 1e-5
  assert set(result["metrics"]) == {"sums_per_s", "setup_s"}
  # open loop at 100 a second: the rate is the arrivals', not the calls'
  assert 50 < result["metrics"]["sums_per_s"]["value"] <= 110


def test_a_one_card_driver_refuses_four_cards():
  spec = specs.cell_spec("frame_deep360_bf16")
  spec["cell"] = dict(spec["cell"], chips=4)
  with pytest.raises(Unrunnable):
    run_cell(spec, 1, 0.1, False, "cpu", time.perf_counter())
