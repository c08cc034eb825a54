"""The result line: the contract's keys in order, ``checks`` last, and a
run's metrics named as its cell's."""

import json
import subprocess
import sys
from pathlib import Path

import tiny

ROOT = Path(__file__).resolve().parents[2]


def test_last_line_has_exactly_the_contract_keys():
  result, _ = tiny.run("frame")
  assert list(result) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
  assert set(result["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
  assert set(result["metrics"]) == {"setup_s", "frames_per_s"}
  for m in result["metrics"].values():
    assert set(m) == {"value", "unit"} and m["value"] > 0
  for c in result["checks"].values():
    assert set(c) == {"value", "limit"}
  json.dumps(result)


def test_without_a_card_the_entry_exits_with_no_result(tmp_path):
  proc = subprocess.run(
      [sys.executable, "benchmark/run.py", "--workload", "frame_deep360_bf16",
       "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
      cwd=ROOT, capture_output=True, text=True, timeout=300,
      env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": "",
           "HOME": str(tmp_path), "TMPDIR": str(tmp_path)})
  assert proc.returncode != 0
  assert proc.stdout.strip() == ""
  assert "no CUDA device" in proc.stderr


def test_without_the_program_the_entry_exits_with_no_result(tmp_path):
  import shutil
  shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
  shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                  ignore=shutil.ignore_patterns("__pycache__", ".cache"))
  proc = subprocess.run(
      [sys.executable, "benchmark/run.py", "--workload", "frame_deep360_bf16",
       "--seed", "1", "--seconds", "1", "--trace", "0"],
      cwd=tmp_path, capture_output=True, text=True, timeout=300,
      env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path),
           "TMPDIR": str(tmp_path)})
  assert proc.returncode != 0 and proc.stdout.strip() == ""
