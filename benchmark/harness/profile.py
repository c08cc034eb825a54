"""A profiled stretch of whole calls: the device's busy time as the union of
its kernel and copy intervals, its idle gaps by what the host was doing,
the device operations that took most time, and the host's synchronisations.

``torch.profiler`` records the CUDA runtime's calls on the host and the
device's kernels, copies and sets through CUPTI on one clock. The stretch
runs after the measured window, so the profiler's cost on the host does not
touch the end-to-end metrics.
"""

from __future__ import annotations

import collections

import torch

CALL = "bench.call"
# runtime calls after which the host waits for the device
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize", "cudaMemcpy", "cudaMemcpy2D",
         "cuStreamSynchronize", "cuCtxSynchronize")
TOP = 10


def _is_device(e) -> bool:
  return getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA


def _merge(intervals):
  merged = []
  for s, e in sorted(intervals):
    if merged and s <= merged[-1][1]:
      merged[-1][1] = max(merged[-1][1], e)
    else:
      merged.append([s, e])
  return merged


def profile_calls(call, indices) -> dict:
  """Run ``call(i)`` for each of ``indices`` under the profiler. Returns
  ``busy_s``, ``window_s`` (from the first call's start to the last's end),
  ``calls``, ``syncs`` (host waits in all), and ``device_ops`` and
  ``idle_gaps``: ``[[name, seconds], ...]``, the longest first, at most
  10 each."""
  from torch.profiler import ProfilerActivity, profile, record_function
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
    for i in indices:
      with record_function(CALL):
        call(i)
    torch.cuda.synchronize()
  events = prof.events()
  calls = [e for e in events if e.name == CALL and not _is_device(e)]
  t0 = min(e.time_range.start for e in calls)
  t1 = max(e.time_range.end for e in calls)
  device, host, syncs = [], [], 0
  by_op = collections.Counter()
  for e in events:
    s, t = e.time_range.start, e.time_range.end
    if _is_device(e):
      if e.name == CALL:       # the range's annotation on the device
        continue
      s, t = max(s, t0), min(t, t1)
      if t > s:
        device.append((s, t))
        by_op[e.name] += (t - s) * 1e-6
    elif e.name != CALL:
      host.append((s, t, e.name))
      syncs += e.name in SYNCS
  busy = _merge(device)
  busy_us = sum(t - s for s, t in busy)
  gaps = collections.Counter()
  edges = [t0] + [x for iv in busy for x in iv] + [t1]
  for (gs, ge), name in zip(zip(edges[0::2], edges[1::2]),
                            _host_doing(host, edges)):
    if ge > gs:
      gaps[name] += (ge - gs) * 1e-6
  return {"busy_s": busy_us * 1e-6, "window_s": (t1 - t0) * 1e-6,
          "calls": len(calls), "syncs": syncs,
          "device_ops": [[k, v] for k, v in by_op.most_common(TOP)],
          "idle_gaps": [[k, v] for k, v in gaps.most_common(TOP)]}


def _host_doing(host, edges):
  """For each gap ``[edges[2k], edges[2k + 1]]``, the innermost host
  operation that spans it, else ``"python between operations"``: one sweep
  over the host operations sorted by start."""
  host = sorted(host)
  j, active, names = 0, [], []
  for gs, ge in zip(edges[0::2], edges[1::2]):
    while j < len(host) and host[j][0] <= gs:
      active.append(host[j])
      j += 1
    active = [h for h in active if h[1] >= ge]
    names.append(min(active, key=lambda h: h[1] - h[0])[2] if active
                 else "python between operations")
  return names
