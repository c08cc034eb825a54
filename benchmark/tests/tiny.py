"""Tiny cells of each kind of traffic for the CPU tests
(``tests/data/tiny.json``), run through the harness without its look for a
card."""

from __future__ import annotations

import json
import time
from pathlib import Path

from benchmark.harness.runner import run_cell

ROOT = Path(__file__).resolve().parents[2]
TINY = json.loads((Path(__file__).parent / "data" / "tiny.json").read_text())
KINDS = tuple(TINY["configs"])
RATES = {"frame": "frames_per_s", "train_disparity": "examples_per_s.train_s1",
         "train_fusion": "examples_per_s.train_fusion"}


def spec(kind: str) -> dict:
  config = dict(TINY["configs"][kind])
  if kind == "frame":
    rig = json.loads((ROOT / "benchmark/configs/mode_deep360.json")
                     .read_text())["rig"]
    config["rig"] = rig
  return {"cell": {"name": f"tiny_{kind}", "chips": 1}, "config": config,
          "traffic": TINY["traffic"][kind],
          "checks": {"limits": TINY["limits"][kind]},
          "end_to_end": [{"name": "setup_s", "unit": "s"},
                         {"name": RATES[kind], "unit": "1/s"}],
          "per_layer": []}


def run(kind: str, seed: int = 2**31 + 17, seconds: float = 0.5):
  return run_cell(spec(kind), seed, seconds, False, "cpu",
                  time.perf_counter())
