"""The port's tracer (``mode_tpu_torch/utils/profiling.py``) on the CPU: spans
off and on, their nesting, call ids and threads, the upload counters, the
launch records, the spans of a frame and of a training step, and outputs
left bit-equal by the tracer.

The frame is ``tests/test_torch_pipeline.py``'s (64x32, maxdisp 16, the
trained stage-1 weights, the seeded fusion net, uint8 inputs); the step is
stage 1's at 64x32, batch 1, maxdisp 16, under ``"save_convs"``.
"""

import contextlib
import copy
import gc
import json
import os
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mode_tpu_torch import kernels, training
from mode_tpu_torch.device import upload
from mode_tpu_torch.models.disparity import ModeDisparity
from mode_tpu_torch.utils import profiling
from tests.test_torch_launch_guards import _launches, guard  # noqa: F401
from tests.test_torch_pipeline import (_fusion_variables, _frame, _port,
                                       _views)

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _empty_ring():
  profiling.reset()
  yield
  profiling.reset()


def _names(recs):
  return [r["name"] for r in recs if r["kernel"] is None]


def test_an_off_span_records_nothing_and_opens_no_range(monkeypatch):
  opened = []
  monkeypatch.setattr(profiling, "_Range", lambda name: opened.append(name))
  assert not profiling.on()
  with profiling.span("step") as rec:
    profiling.count("uploads")
    upload(np.zeros(4, np.float32), "cpu")
  assert rec is None and opened == []
  assert profiling.span("a") is profiling.span("b")      # one shared context
  s = profiling.summary()
  assert profiling.records() == [] and s["spans"] == {}
  assert s["counters"] == [] and s["recorded"] == 0


def test_spans_nest_under_the_profiler_with_parent_and_call():
  with profile(activities=[ProfilerActivity.CPU]):
    assert profiling.on()
    for _ in range(2):
      with profiling.span("step"):
        with profiling.span("step.forward"):
          with profiling.span("stage1.features"):
            torch.ones(8, 8) @ torch.ones(8, 8)
        with profiling.span("step.backward"):
          pass
  assert not profiling.on()
  recs = profiling.records()
  by_id = {r["id"]: r for r in recs}
  assert _names(recs) == ["step", "step.forward", "stage1.features",
                          "step.backward"] * 2
  calls = [r["call"] for r in recs]
  assert calls[:4] == [calls[0]] * 4 and calls[4:] == [calls[4]] * 4
  assert calls[0] != calls[4]
  for r in recs:
    parent = by_id.get(r["parent"])
    want = {"step": None, "step.forward": "step", "step.backward": "step",
            "stage1.features": "step.forward"}[r["name"]]
    assert (parent and parent["name"]) == want
    assert r["host_end_ns"] >= r["host_start_ns"]
    assert r["device_ms"] is None                          # no card
  s = profiling.summary()["spans"]
  assert s["step"]["count"] == 2 and s["stage1.features"]["count"] == 2
  assert 0 <= s["step"]["self_host_ms"] <= s["step"]["host_ms"]


def test_trace_writes_the_spans_beside_the_chrome_trace(tmp_path):
  with profiling.trace(str(tmp_path)):
    with profiling.span("frame"):
      with profiling.span("frame.bridge"):
        upload(np.zeros((2, 3), np.float32), "cpu")
  names = sorted(os.listdir(tmp_path))
  assert [n.split(".")[0] for n in names] == ["spans", "trace"]
  events = json.loads((tmp_path / names[1]).read_text())["traceEvents"]
  assert {"frame", "frame.bridge"} <= {e.get("name") for e in events}
  spans = json.loads((tmp_path / names[0]).read_text())
  assert _names(spans["records"]) == ["frame", "frame.bridge"]
  assert spans["summary"]["spans"]["frame"]["counters"] == {
      "uploads": 1, "upload_bytes": 24}


def test_a_span_on_another_thread_keeps_the_call():
  """As remat's rerun in autograd's backward thread: no span open there,
  the call's innermost span its parent."""
  with profiling.tracing():
    with profiling.span("step"):
      with profiling.span("step.backward"):
        worker = threading.Thread(target=_rerun)
        worker.start()
        worker.join(timeout=30)
  assert not worker.is_alive()
  recs = {r["name"]: r for r in profiling.records()}
  assert recs["remat.rerun"]["thread"] != recs["step"]["thread"]
  assert recs["remat.rerun"]["call"] == recs["step"]["call"]
  assert recs["remat.rerun"]["parent"] == recs["step.backward"]["id"]


def test_records_keep_no_object_the_collector_tracks():
  """Spans, counters and launch records leave the collector's work as it
  was: their fields lie in the ring's lists."""
  def record(n):
    with profiling.tracing():
      for _ in range(n):
        with profiling.span("step"):
          profiling.count("uploads")
          rid = profiling.launch_begin("k", (1, 2, 3))
          profiling.launch_end(rid)

  record(10)
  gc.collect()
  before = len(gc.get_objects())
  record(2000)
  gc.collect()
  assert len(gc.get_objects()) - before < 20
  assert profiling.summary()["spans"]["step"]["count"] == 2010


def _rerun():
  with profiling.span("remat.rerun"):
    profiling.count("uploads")


def test_uploads_are_charged_to_the_innermost_span():
  with profiling.tracing():
    upload(np.zeros(2, np.float64), "cpu")
    with profiling.span("step"):
      upload(torch.zeros(3, dtype=torch.uint8), "cpu")
      with profiling.span("step.forward"):
        upload(np.zeros((2, 5), np.float32), "cpu")
        upload(np.zeros(1, np.int32), "cpu")
  s = profiling.summary()
  got = {(c["name"], c["span"]): c["n"] for c in s["counters"]}
  assert got == {("uploads", None): 1, ("upload_bytes", None): 16,
                 ("uploads", "step"): 1, ("upload_bytes", "step"): 3,
                 ("uploads", "step.forward"): 2,
                 ("upload_bytes", "step.forward"): 44}
  assert s["spans"]["step"]["counters"] == {"uploads": 3,
                                            "upload_bytes": 47}


# the extents each wrapper hands its kernel (tests/test_torch_launch_guards.py
# `_launches`' shapes)
SHAPES = {"conv3d_s1_bn_act": [1, 2, 4, 4, 16, 16],
          "deconv3d_bn_act": [1, 2, 4, 4, 16, 16],
          "conv2d_s1_bn_act": [1, 64, 32, 16, 16],
          "fused_disparity_regression": [1, 4, 8, 4, 16, 32, 16],
          "sphere_conv_bn_act": [1, 64, 32, 16, 16],
          "sphere_conv_bwd_input": [1, 64, 32, 16, 16],
          "sphere_conv_bwd_weight": [1, 64, 32, 16, 16]}


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_a_launch_records_its_kernel_shape_and_span(guard, name):  # noqa: F811
  _launches(guard)[name]()                        # off: counted, not kept
  with profiling.tracing(), profiling.span("stage1.aggregation"):
    _launches(guard)[name]()
  assert kernels.LAUNCHES[name] == 2
  (launch,) = profiling.summary()["launches"]
  assert launch == {"kernel": name, "shape": SHAPES[name],
                    "span": "stage1.aggregation", "count": 1,
                    "device_ms": None}
  agg = profiling.summary()["spans"]["stage1.aggregation"]
  assert agg["launches"] == 1


@pytest.mark.parametrize("timing", [None, "stage1.aggregation", "frame"])
def test_only_launches_in_a_timing_span_take_events(monkeypatch, timing):
  """A launch takes a CUDA event pair inside a span opened with
  ``time_launches``, at any depth, and none elsewhere."""
  timed = []
  monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
  monkeypatch.setattr(profiling, "_record", lambda events, i, stream: (
      profiling._kernel[i] and timed.append(profiling._name[i])))

  def launch(kernel):
    profiling.launch_end(profiling.launch_begin(kernel, (1,)))

  with profiling.tracing():
    launch("outside")
    with profiling.span("frame", time_launches=timing == "frame"):
      launch("in_frame")
      with profiling.span("stage1.aggregation",
                          time_launches=timing == "stage1.aggregation"):
        launch("in_aggregation")
      launch("after")
  want = {None: [], "stage1.aggregation": ["in_aggregation"],
          "frame": ["in_frame", "in_aggregation", "after"]}[timing]
  assert timed == [k for k in want for _ in range(2)]


# --- the frame and the step ---------------------------------------------------


@pytest.fixture(scope="module")
def frame_runs():
  """The tiny frame's outputs with the tracer off and on, and the records
  of the traced frame."""
  lefts, rights = _frame()[True]
  pipe = _port(_fusion_variables(), uint8_inputs=True)
  args = [torch.from_numpy(a) for a in (lefts, rights, _views(lefts, rights))]
  off = pipe(*args)
  profiling.reset()
  with profiling.tracing():
    on = pipe(*args)
  return off, on, profiling.records()


@pytest.fixture(scope="module")
def step_runs():
  """One stage-1 step under ``"save_convs"`` from identical models with the
  tracer off and on: the losses, gradients and parameters, and the records
  of the traced step."""
  gen = torch.Generator().manual_seed(3)
  left = torch.randint(0, 256, (1, 64, 32, 3), dtype=torch.uint8,
                       generator=gen)
  gt = torch.full((1, 64, 32), 3.0)
  gt[:, :8] = float("nan")
  model = ModeDisparity(16, remat_policy="save_convs", device="cpu")
  out = []
  for traced in (False, True):
    m = copy.deepcopy(model)
    step = training.make_disparity_train_step(
        m, training.make_optimizer(m.parameters()))
    profiling.reset()
    with profiling.tracing() if traced else contextlib.nullcontext():
      loss = step(left, torch.roll(left, 2, dims=2), gt)
    out.append((loss, [p.grad for p in m.parameters()],
                [p.detach() for p in m.parameters()]))
  return out[0], out[1], profiling.records()


FRAME = ["frame", "frame.stage1", "stage1.features", "stage1.features",
         "stage1.cost_volume", "stage1.aggregation", "stage1.regression",
         "frame.bridge", "frame.fusion"]
FRAME_PARENTS = {"frame": None, "frame.stage1": "frame",
                 "stage1.features": "frame.stage1",
                 "stage1.cost_volume": "frame.stage1",
                 "stage1.aggregation": "frame.stage1",
                 "stage1.regression": "frame.stage1",
                 "frame.bridge": "frame", "frame.fusion": "frame"}
# the forward's spans, then the backward's reruns: the three heads (last
# computed, first rerun), the hourglasses and the feature extractor's calls
STEP = (["step", "step.inputs", "step.forward", "stage1.features",
         "stage1.features", "stage1.cost_volume", "stage1.aggregation",
         "stage1.regression", "step.loss", "step.backward"]
        + ["remat.rerun"] * 8 + ["step.optimizer"])
STEP_PARENTS = {"step": None, "step.inputs": "step", "step.forward": "step",
                "stage1.features": "step.forward",
                "stage1.cost_volume": "step.forward",
                "stage1.aggregation": "step.forward",
                "stage1.regression": "step.forward", "step.loss": "step",
                "step.backward": "step", "remat.rerun": "step.backward",
                "step.optimizer": "step"}


@pytest.mark.parametrize("kind", ["frame", "step"])
def test_a_call_opens_its_spans_in_order(request, kind):
  recs = request.getfixturevalue(f"{kind}_runs")[2]
  order, parents = {"frame": (FRAME, FRAME_PARENTS),
                    "step": (STEP, STEP_PARENTS)}[kind]
  assert _names(recs) == order
  by_id = {r["id"]: r for r in recs}
  assert {r["call"] for r in recs} == {recs[0]["call"]}
  for r in recs:
    parent = by_id.get(r["parent"])
    assert (parent and parent["name"]) == parents[r["name"]], r["name"]
  if kind == "step":
    # the heads' resize matrices: three axes, three heads, forward and rerun
    assert sum(r["counters"].get("uploads", 0) for r in recs) == 18


@pytest.mark.parametrize("kind", ["frame", "step"])
def test_the_tracer_leaves_outputs_bit_equal(request, kind):
  off, on, _ = request.getfixturevalue(f"{kind}_runs")
  if kind == "frame":
    pairs = zip(off, on)
  else:
    pairs = [(off[0], on[0]), *zip(off[1], on[1]), *zip(off[2], on[2])]
  for a, b in pairs:
    assert torch.equal(a, b)
