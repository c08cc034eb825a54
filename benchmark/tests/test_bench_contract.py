"""``BENCHMARK.json`` against the benchmark's contract: names, units, keys,
and that every cell resolves to its files."""

import json
import re
from pathlib import Path

import pytest

from benchmark.harness import spec as specs
from benchmark.harness.driver import Driver

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {"config": {"name", "source", "file", "reduced", "why"},
        "workload": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}


def test_top_level_keys_and_command():
  assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
  assert 1 <= len(BENCH["command"]) <= 32
  assert all(TEXT.match(w) for w in BENCH["command"])
  assert 1 <= len(BENCH["paths"]) <= 16
  for p in BENCH["paths"]:
    assert PATH.match(p) and not p.startswith("/") and ".." not in p
  for word in BENCH["command"][1:]:
    assert not word.startswith("/") and ".." not in word
    if "/" in word:
      assert any(word.startswith(p + "/") for p in BENCH["paths"])
  assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_names_units_and_entry_keys():
  names = {}
  for group, kind in (("configs", "config"), ("workloads", "workload"),
                      ("end_to_end", "end_to_end"),
                      ("per_layer", "per_layer")):
    for entry in BENCH[group]:
      extra = {"workloads"} if kind in ("end_to_end", "per_layer") else set()
      assert KEYS[kind] <= set(entry) <= KEYS[kind] | extra, entry
      assert NAME.match(entry["name"]), entry["name"]
      names.setdefault(kind if kind == "config" or kind == "workload"
                       else "metric", set())
      bucket = names[kind if kind in ("config", "workload") else "metric"]
      assert entry["name"] not in bucket
      bucket.add(entry["name"])
      if "unit" in entry:
        assert UNIT.match(entry["unit"]), entry["unit"]
        assert entry["better"] in ("lower", "higher")
      for key in ("why", "layer", "source"):
        if key in entry:
          assert TEXT.match(entry[key]), entry[key]
  for c in BENCH["configs"]:
    assert len(c["reduced"]) <= 16
    assert all(NAME.match(k) for k in c["reduced"])
  for w in BENCH["workloads"]:
    assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    assert w["chips"] in (1, 4)


def test_metrics_follow_the_rules():
  e2e = {m["name"]: m for m in BENCH["end_to_end"]}
  assert e2e["setup_s"]["bound"] <= 0.25
  for m in e2e.values():
    assert m["source"] in ("host_clock", "device_trace")
    assert 0.01 <= m["bound"] <= 0.25
  for m in BENCH["per_layer"]:
    assert m["source"] in ("device_trace", "program_span",
                           "program_counter", "host_clock")
    assert m["moves"] in e2e
    if m["name"].endswith("_roofline") or "roofline" in m["name"]:
      assert m["unit"] == "%"
  cells = {w["name"] for w in BENCH["workloads"]}
  for w in cells:
    got = [m for m in BENCH["end_to_end"] if w in m.get("workloads", [w])]
    assert "setup_s" in {m["name"] for m in got} and len(got) >= 2
    layer = [m for m in BENCH["per_layer"] if w in m.get("workloads", [w])]
    assert layer
    for m in layer:
      assert w in e2e[m["moves"]].get("workloads", [w])
  four = sum(w["chips"] == 4 for w in BENCH["workloads"])
  assert four <= max(1, len(cells) // 4)


def test_run_seconds_fit_the_check_with_24_cells():
  rs = BENCH["run_seconds"]
  assert isinstance(rs, int) and 1 <= rs <= 51
  assert (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_resolves_to_its_files(cell):
  spec = specs.cell_spec(cell)
  assert issubclass(specs.driver_class(spec["traffic"]["driver"]), Driver)
  assert spec["checks"]["limits"]
  for m in spec["end_to_end"] + spec["per_layer"]:
    assert callable(specs.metric_reader(m["name"]))
  config = next(c for c in BENCH["configs"] if c["name"] ==
                spec["cell"]["config"])
  assert config["file"].startswith(BENCH["paths"][0] + "/")
  assert spec["config"]["reduced"] == config["reduced"]


def test_every_config_is_used_and_files_are_distinct():
  used = {w["config"] for w in BENCH["workloads"]}
  assert used == {c["name"] for c in BENCH["configs"]}
  files = [c["file"] for c in BENCH["configs"]]
  assert len(files) == len(set(files))
