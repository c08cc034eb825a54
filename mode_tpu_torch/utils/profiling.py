"""The port's tracer: spans, counters and kernel launch records, on the
profiler's clock (``mode_tpu/utils/profiling.py``).

The reference has no profiler, only wall-clock prints (its
``train_disparity.py:234``). Here the program marks its layers with
:func:`span` (the frame's stages, the training step's phases, remat's
reruns, the collectives; ``PERF.md`` lists the names), counts events with
:func:`count` (``device.upload``'s ``uploads`` and ``upload_bytes``), and
``kernels.launch`` records each kernel launch with its shape.

**Off** is the normal state: a span then costs one check and returns a
shared do-nothing context, a counter returns at once, and a launch records
nothing. **On** means a ``torch.profiler`` is recording in this process, or
the code runs inside :func:`tracing`. While on, a span

- enters a profiler range of its name, so the span lies in the profiler's
  trace on the clock of the device's kernels and copies (a function-scope
  range, ``_RecordFunctionFast``: a user-scope ``record_function`` would
  also put an annotation of the span on the device's timeline, from its
  first kernel to its last, idle gaps and all, where a union of the
  device's intervals would count it as busy);
- records its host start and end (``time.perf_counter_ns``);
- records a CUDA event pair on the current stream once CUDA is in use: its
  device time is the device-timeline interval between the two, waits of the
  device inside the span (for the host, for a copy) included;
- records its parent span and the id of the call it belongs to: the
  outermost span (``frame``, ``step``) opens a call, and every span inside
  it shares its id.

A launch record holds the kernel, its extents, the innermost open span and
the host's start and end; a CUDA event pair around the launch too, inside a
span opened with ``time_launches`` (``stage1.aggregation``, whose kernels'
share of its time a metric reads). Under a profiler each CUDA runtime call
is traced, and an event costs the host microseconds: only the launches a
reader times pay for it.

The span stack is per thread. A span opened on a thread with no open span
while a call is open elsewhere (autograd's backward thread, where remat's
rerun runs) takes that call's id, and the innermost span open on the call's
thread as its parent.

Records are kept in memory in a bounded ring (:data:`RING`): a record's
fields lie in lists made once, one slot a record, and each slot's two CUDA
events are made on the slot's first use and recorded again after. A record
keeps no object that the garbage collector tracks, so tracing does not move
the collector's pauses. Their CUDA events are resolved
(``elapsed_time``) only when someone reads them (:func:`summary`,
:func:`records`): the tracer never waits for the device while it records.
:func:`trace` records a block under ``torch.profiler`` and writes the
Chrome trace and the spans beside it.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import socket
import threading
import time
from typing import Optional

import torch
from torch.profiler import ProfilerActivity, profile

# records kept: a stage-1 training step makes ~270 (spans and launches)
RING = 1 << 13

_profiler_enabled = torch._C._autograd._profiler_enabled
_Range = getattr(torch._C._profiler, "_RecordFunctionFast", None)

# the ring: record ``rid`` lies in slot ``rid % RING``
_id = [0] * RING
_name: list = [None] * RING
_kernel: list = [None] * RING         # a launch's kernel; None: a span
_shape: list = [None] * RING
_parent = [0] * RING                  # the innermost open span's id; 0: none
_call = [0] * RING
_thread = [0] * RING
_t0 = [0] * RING
_t1 = [0] * RING                      # 0: still open, or a failed launch
_events = [0] * RING                  # 1: the start recorded, 2: both
_ms: list = [None] * RING             # the device time, once resolved
_counters: list = [None] * RING
_timing = [False] * RING              # a span whose launches take events
_ev0: list = [None] * RING
_ev1: list = [None] * RING
_shapes: dict = {}                    # one tuple kept per launch shape

_calls = itertools.count(1)
_local = threading.local()
_state = {"forced": 0, "next": 1, "first": 1, "root": None, "call": 0,
          "outside": None}
_lock = threading.Lock()


def on() -> bool:
  """Whether the tracer records: a profiler is recording in this process,
  or the code runs inside :func:`tracing`."""
  return _state["forced"] > 0 or _profiler_enabled()


@contextlib.contextmanager
def tracing():
  """Turn the tracer on for the block, without a profiler."""
  with _lock:
    _state["forced"] += 1
  try:
    yield
  finally:
    with _lock:
      _state["forced"] -= 1


def _stack() -> list:
  """This thread's open spans, their ids, innermost last."""
  stack = getattr(_local, "stack", None)
  if stack is None:
    stack = _local.stack = []
  return stack


def _innermost(stack: list) -> int:
  """The innermost open span of this thread, else of the open call's
  thread; 0: none."""
  if stack:
    return stack[-1]
  root = _state["root"]
  return root[-1] if root else 0


def _record(events: list, i: int, stream) -> None:
  """Record slot ``i``'s event of ``events`` on ``stream`` (None: the
  current stream), the event made on the slot's first use: the C type
  under ``torch.cuda.Event``, whose objects the garbage collector does not
  track."""
  ev = events[i]
  if ev is None:
    ev = events[i] = torch._C._CudaEventBase(enable_timing=True)
  ev.record(torch.cuda.current_stream() if stream is None else stream)


def _open(name: str, kernel, shape, parent: int, stream,
          events: bool = True) -> int:
  """A new record in the ring, its start event recorded on ``stream``
  (None: the current stream) once CUDA is in use and ``events``; returns
  its id."""
  with _lock:
    rid = _state["next"]
    _state["next"] = rid + 1
  i = rid % RING
  _id[i], _name[i], _kernel[i], _shape[i] = rid, name, kernel, shape
  _parent[i], _thread[i] = parent, threading.get_ident()
  _call[i] = _state["call"] if parent or kernel is None else 0
  _t1[i], _ms[i], _counters[i], _events[i] = 0, None, None, 0
  if events and torch.cuda.is_initialized():
    _record(_ev0, i, stream)
    _events[i] = 1
  _t0[i] = time.perf_counter_ns()
  return rid


def _close(rid: int, stream) -> None:
  """Record ``rid``'s end (a ring that has wrapped past it: nothing)."""
  i = rid % RING
  if _id[i] != rid:
    return
  _t1[i] = time.perf_counter_ns()
  if _events[i]:
    _record(_ev1, i, stream)
    _events[i] = 2


def _device_ms(i: int) -> Optional[float]:
  """Slot ``i``'s device time (ms), resolved once, after waiting for its
  end event; None without both events."""
  if _events[i] == 2:
    _ev1[i].synchronize()
    _ms[i] = _ev0[i].elapsed_time(_ev1[i])
    _events[i] = 0
  return _ms[i]


def _timed(rid: int) -> bool:
  """Whether span ``rid`` (0: none) times the launches inside it."""
  i = rid % RING
  return rid > 0 and _id[i] == rid and _timing[i]


class _Span:
  __slots__ = ("name", "time_launches", "rid", "range")

  def __init__(self, name: str, time_launches: bool):
    self.name, self.time_launches = name, time_launches

  def __enter__(self):
    stack = _stack()
    parent = _innermost(stack)
    if not parent:
      _state["root"], _state["call"] = stack, next(_calls)
    self.range = _Range(self.name) if _Range is not None else None
    if self.range is not None:
      self.range.__enter__()
    rid = self.rid = _open(self.name, None, None, parent, None)
    _timing[rid % RING] = self.time_launches or _timed(parent)
    stack.append(rid)
    return rid

  def __exit__(self, *exc):
    _close(self.rid, None)
    stack = _stack()
    if stack and stack[-1] == self.rid:
      stack.pop()
    if not stack and _state["root"] is stack:
      _state["root"] = None
    if self.range is not None:
      self.range.__exit__(*exc)
    return False


_OFF = contextlib.nullcontext()


def span(name: str, time_launches: bool = False):
  """A named region of the program (module docstring): a shared
  do-nothing context while the tracer is off. ``time_launches``: the
  kernel launches inside the span, at any depth, each take a CUDA event
  pair (module docstring)."""
  if not on():
    return _OFF
  return _Span(name, time_launches)


def count(name: str, n: int = 1) -> None:
  """Add ``n`` to counter ``name`` of the innermost open span (or of no
  span) while the tracer is on."""
  if not on():
    return
  rid = _innermost(_stack())
  i = rid % RING
  if not rid or _id[i] != rid:
    counters = _state["outside"]
    if counters is None:
      counters = _state["outside"] = {}
  else:
    counters = _counters[i]
    if counters is None:
      counters = _counters[i] = {}
  counters[name] = counters.get(name, 0) + n


def launch_begin(kernel: str, shape: tuple, stream=None) -> int:
  """Open the record of a launch of ``kernel`` at ``shape`` in the
  innermost open span, its start event on ``stream`` where that span times
  its launches (called by ``kernels.launch`` while the tracer is on, the
  launch's device current); returns its id."""
  if shape:
    shape = _shapes.setdefault(tuple(shape), tuple(shape))
  parent = _innermost(_stack())
  return _open(kernel, kernel, shape or None, parent, stream,
               events=_timed(parent))


def launch_end(rid: int, stream=None) -> None:
  """Close a launch's record (after a launch that succeeded; a failed
  one stays open and counts nowhere)."""
  _close(rid, stream)


def reset() -> None:
  """Drop every record and counter."""
  _state.update(first=_state["next"], root=None, call=0, outside=None)


def _kept() -> range:
  """The ids of the records the ring holds, oldest first."""
  return range(max(_state["first"], _state["next"] - RING), _state["next"])


def _recorded() -> int:
  return _state["next"] - _state["first"]


def records() -> list[dict]:
  """The ring's records, oldest first, their device times resolved:
  ``id``, ``name``, ``kernel`` and ``shape`` (launches), ``parent`` (its
  id, None outside every span), ``call`` (None outside every call),
  ``thread``, host start and end (ns; end None while open),
  ``device_ms`` (None without CUDA, and for a launch not timed) and
  ``counters``."""
  out = []
  for rid in _kept():
    i = rid % RING
    out.append({"id": rid, "name": _name[i], "kernel": _kernel[i],
                "shape": list(_shape[i]) if _shape[i] else None,
                "parent": _parent[i] or None, "call": _call[i] or None,
                "thread": _thread[i], "host_start_ns": _t0[i],
                "host_end_ns": _t1[i] or None, "device_ms": _device_ms(i),
                "counters": dict(_counters[i] or {})})
  return out


def _ancestors(i: int, first: int):
  """The names of the kept spans around slot ``i``'s record, innermost
  first, once each."""
  seen, p = set(), _parent[i]
  while p >= first and _id[p % RING] == p:
    j = p % RING
    if _name[j] not in seen:
      seen.add(_name[j])
      yield _name[j]
    p = _parent[j]


def _add(a: Optional[float], b: Optional[float]) -> Optional[float]:
  return None if a is None or b is None else a + b


def summary() -> dict:
  """The ring read by name (device times resolved; None without CUDA, and
  for a launch outside the spans that time theirs):

  - ``spans``: by span name, ``count``, ``device_ms``, ``host_ms``,
    ``self_ms`` and ``self_host_ms`` (the device and host times less those
    of the spans directly inside), and, of whatever ran inside the span at
    any depth, ``launches``, ``launch_ms`` (their device time) and
    ``counters`` (by name);
  - ``counters``: ``[{name, span, n}]``, by the innermost span they were
    charged to (``span`` None: outside every span);
  - ``launches``: ``[{kernel, shape, span, count, device_ms}]``, by
    kernel, shape and innermost span;
  - ``recorded`` and ``dropped``: records made since :func:`reset`, and
    those the ring no longer holds.
  """
  kept = _kept()
  first = kept.start
  spans: dict = {}
  inner: dict = collections.defaultdict(lambda: [0.0, 0.0])
  counters = collections.Counter(
      {(k, None): v for k, v in (_state["outside"] or {}).items()})
  launches: dict = {}

  def entry(name):
    if name not in spans:
      spans[name] = {"count": 0, "device_ms": 0.0, "host_ms": 0.0,
                     "self_ms": 0.0, "self_host_ms": 0.0, "launches": 0,
                     "launch_ms": 0.0, "counters": collections.Counter()}
    return spans[name]

  def parent_name(i):
    p = _parent[i]
    return _name[p % RING] if p >= first and _id[p % RING] == p else None

  for rid in kept:
    i = rid % RING
    ms = _device_ms(i)
    if _kernel[i] is not None:
      if not _t1[i]:
        continue                             # a launch that failed
      key = (_kernel[i], _shape[i], parent_name(i))
      agg = launches.setdefault(key, {"count": 0, "device_ms": 0.0})
      agg["count"] += 1
      agg["device_ms"] = _add(agg["device_ms"], ms)
      for name in _ancestors(i, first):
        e = entry(name)
        e["launches"] += 1
        e["launch_ms"] = _add(e["launch_ms"], ms)
      continue
    host = (_t1[i] - _t0[i]) * 1e-6 if _t1[i] else 0.0
    e = entry(_name[i])
    e["count"] += 1
    e["device_ms"] = _add(e["device_ms"], ms)
    e["host_ms"] += host
    if _parent[i] >= first:
      below = inner[_parent[i]]
      below[0] = _add(below[0], ms)
      below[1] += host
    for k, v in (_counters[i] or {}).items():
      counters[(k, _name[i])] += v
      for name in {_name[i], *_ancestors(i, first)}:
        entry(name)["counters"][k] += v
  for rid in kept:
    i = rid % RING
    if _kernel[i] is None:
      e, (ms, host) = spans[_name[i]], inner[rid]
      e["self_ms"] = _add(e["self_ms"], _add(_ms[i], None if ms is None
                                             else -ms))
      e["self_host_ms"] += ((_t1[i] - _t0[i]) * 1e-6 - host
                            if _t1[i] else 0.0)
  for e in spans.values():
    e["counters"] = dict(e["counters"])
  return {"spans": spans,
          "counters": [{"name": k, "span": s, "n": v}
                       for (k, s), v in counters.items()],
          "launches": [{"kernel": k, "shape": list(sh) if sh else None,
                        "span": s, **v}
                       for (k, sh, s), v in launches.items()],
          "recorded": _recorded(),
          "dropped": _recorded() - len(kept)}


@contextlib.contextmanager
def trace(log_dir: Optional[str], device: str | torch.device = "cpu"):
  """Record the block into ``log_dir/trace.<host>.<pid>.json`` (nothing
  when ``log_dir`` is None or empty), with the tracer's :func:`summary`
  and :func:`records` of the block in ``spans.<host>.<pid>.json`` beside
  it. The host's operations always; the CUDA kernels and copies too when
  ``device`` is a CUDA device. Yields the profiler, or None."""
  if not log_dir:
    yield None
    return
  activities = [ProfilerActivity.CPU]
  if torch.device(device).type == "cuda":
    activities.append(ProfilerActivity.CUDA)
  os.makedirs(log_dir, exist_ok=True)
  reset()
  with profile(activities=activities) as prof:
    yield prof
  tag = f"{socket.gethostname()}.{os.getpid()}"
  prof.export_chrome_trace(os.path.join(log_dir, f"trace.{tag}.json"))
  with open(os.path.join(log_dir, f"spans.{tag}.json"), "w") as f:
    json.dump({"summary": summary(), "records": records()}, f)
