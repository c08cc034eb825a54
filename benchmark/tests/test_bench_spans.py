"""The readers of the program's spans and counters (``metrics/*``, source
``program_span`` / ``program_counter``) on a synthetic summary of a
profiled stretch: each call's total, the calls checked against the outer
span, and nothing where the program has no tracer or the ring dropped
records."""

import json
from pathlib import Path

import pytest

from benchmark.harness import spec as specs
from mode_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
PROGRAM = [m["name"] for m in BENCH["per_layer"]
           if m["source"] in ("program_span", "program_counter")]
CALLS = 3


def _span(count, device_ms, launch_ms=0.0, **counters):
  return {"count": count, "device_ms": device_ms, "host_ms": 1.0,
          "self_ms": 0.0, "self_host_ms": 0.0, "launches": 0,
          "launch_ms": launch_ms, "counters": counters}


SUMMARY = {"spans": {
    "step": _span(CALLS, 1500.0, uploads=54, upload_bytes=1000),
    "step.forward": _span(CALLS, 450.0),
    "step.backward": _span(CALLS, 900.0),
    "step.optimizer": _span(CALLS, 6.0),
    "remat.rerun": _span(8 * CALLS, 120.0),
    "frame": _span(CALLS, 330.0),
    "stage1.aggregation": _span(CALLS, 180.0, launch_ms=162.0)},
    "counters": [], "launches": [], "recorded": 100, "dropped": 0}
# per call: the span's device ms over the 3 calls, the uploads, the share
WANT = {"forward_ms.train_s1": 150.0, "backward_ms.train_s1": 300.0,
        "optimizer_ms.train_s1": 2.0, "recompute_ms.train_s1": 40.0,
        "uploads_per_step.train_s1": 18.0,
        "forward_ms.train_fusion": 150.0, "backward_ms.train_fusion": 300.0,
        "optimizer_ms.train_fusion": 2.0, "aggregation_ms.frame": 60.0,
        "aggregation_kernel_pct.frame": 90.0}


def _read(name, calls=CALLS):
  return specs.metric_reader(name)({"profile": {"calls": calls}})


def test_every_program_metric_has_a_case():
  assert sorted(PROGRAM) == sorted(WANT)


@pytest.mark.parametrize("name", sorted(WANT))
def test_a_reader_divides_its_total_by_the_calls(monkeypatch, name):
  monkeypatch.setattr(profiling, "summary", lambda: SUMMARY)
  assert _read(name) == pytest.approx(WANT[name])
  # the outer span opened once a call, or nothing is read
  assert _read(name, calls=CALLS + 1) is None
  # nor where its span never opened, or the ring dropped records
  span = getattr(specs._module("metrics", name, ROOT), "SPAN", "step")
  unopened = dict(SUMMARY, spans={k: v for k, v in SUMMARY["spans"].items()
                                  if k != span})
  dropped = dict(SUMMARY, dropped=1)
  for summary in (unopened, dropped):
    monkeypatch.setattr(profiling, "summary", lambda: summary)
    assert _read(name) is None
  # a program without the tracer (the parent's) gives nothing, and no error
  monkeypatch.delattr(profiling, "summary")
  assert _read(name) is None
