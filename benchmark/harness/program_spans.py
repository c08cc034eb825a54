"""The program's own spans and counters over the profiled stretch
(``mode_tpu_torch/utils/profiling.py:summary``), for the metrics of source
``program_span`` and ``program_counter``.

Nothing is read (None) from a program without the tracer, from a ring that
dropped records, or where the call's outermost span (``step``, ``frame``)
did not open once a call. A span that opens several times a call
(``remat.rerun``, ``stage1.features``) is summed over its openings.
"""

from __future__ import annotations


def spans(run, outer: str):
  """The summary's spans by name, or None (module docstring)."""
  p = run["profile"]
  try:
    from mode_tpu_torch.utils import profiling
  except ImportError:
    return None
  if not p or not p["calls"] or not hasattr(profiling, "summary"):
    return None
  s = profiling.summary()
  if s["dropped"] or s["spans"].get(outer, {}).get("count") != p["calls"]:
    return None
  return s["spans"]


def device_ms_per_call(run, span: str, outer: str):
  """``span``'s device ms over the stretch per call, or None: the span
  never opened, or nothing is read."""
  s = spans(run, outer)
  ms = s.get(span, {}).get("device_ms") if s else None
  return None if ms is None else ms / run["profile"]["calls"]


def counter_per_call(run, counter: str, outer: str):
  """Counter ``counter`` inside ``outer`` per call, or None."""
  s = spans(run, outer)
  if s is None:
    return None
  return s[outer]["counters"].get(counter, 0) / run["profile"]["calls"]
