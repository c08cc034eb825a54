"""The numbers that decide ``correct``: the program's outputs against the
plain reference's on the same inputs. ``benchmark/workloads/<cell>.json``
names the numbers a cell holds and the limit of each (``PERF.md`` gives the
readings each limit was set from); the others are printed as diagnostics.

A frame, the worst over the checked frames: stage 1 from the raw inputs
(``disp_mae_px``, ``conf_mae``: mean absolute gaps of the six pairs'
disparities and confidences); the bridge on the program's own disparities
(``depth_stage_rel``: the bridged depths' absolute gap over the reference's
total; ``depth_conf_stage_mae``); the fusion net on the program's own
bridged maps (``fused_stage_rel``); and the chain end to end from the raw
inputs (``depth_rel``, ``depth_conf_mae``, ``fused_rel``), where the
z-buffer and the fusion net amplify stage 1's rounding.

A training step: ``loss1_gap`` and ``loss_gap``, the relative gap of the
first step's loss and the largest over the checked steps; ``out1_rel``, the
first step's outputs (stage 1's three heads, the fusion net's depth);
``grad_gap`` and ``grad_gap_median``, the worst and the median leaf's gap
between the norms of the first gradient; ``change_gap`` and
``change_gap_median``, the same for the parameters' change over the checked
steps. A leaf's gap is measured against the reference's norm of that leaf
or of the median leaf, whichever is larger. Leaves whose reference gradient
is under a thousandth of the median leaf's move under Adam by rounding
alone and are left out of the change.
"""

from __future__ import annotations

import math
import statistics


def _mean_abs(a, b) -> float:
  if a.shape != b.shape:
    return math.inf
  return float((a.double() - b.double()).abs().mean())


def _rel(a, b) -> float:
  if a.shape != b.shape:
    return math.inf
  return float((a.double() - b.double()).abs().sum()
               / b.double().abs().sum().clamp_min(1e-30))


def frame_numbers(prog: dict, ref: dict) -> dict:
  """``prog``/``ref``: ``{frame: {"disp", "conf", "depth", "depth_conf",
  "fused"}}`` for the same frames."""
  out = {"disp_mae_px": 0.0, "conf_mae": 0.0, "depth_rel": 0.0,
         "depth_conf_mae": 0.0, "fused_rel": 0.0}
  for k, r in ref.items():
    p = prog[k]
    got = {"disp_mae_px": _mean_abs(p["disp"], r["disp"]),
           "conf_mae": _mean_abs(p["conf"], r["conf"]),
           "depth_rel": _rel(p["depth"], r["depth"]),
           "depth_conf_mae": _mean_abs(p["depth_conf"], r["depth_conf"]),
           "fused_rel": _rel(p["fused"], r["fused"])}
    if "fused_given" in r:
      got.update({
          "depth_stage_rel": _rel(p["depth"], r["depth_given"]),
          "depth_conf_stage_mae": _mean_abs(p["depth_conf"],
                                            r["depth_conf_given"]),
          "fused_stage_rel": _rel(p["fused"], r["fused_given"])})
    for name, v in got.items():
      out.setdefault(name, 0.0)
      out[name] = max(out[name], v) if math.isfinite(v) else math.inf
  return out


def _norms(tensors: dict) -> dict:
  return {k: float(v.double().norm()) for k, v in tensors.items()}


def _leaf_gaps(got: dict, want: dict, keys) -> dict:
  floor = statistics.median(want[k] for k in keys)
  return {k: abs(got[k] - want[k]) / max(want[k], floor, 1e-30)
          for k in keys}


def _worst(gaps: dict) -> str:
  return max(gaps, key=lambda k: (not math.isfinite(gaps[k]), gaps[k]))


def train_numbers(prog: dict, ref: dict) -> dict:
  """``prog``: ``losses``, ``grads``, ``params`` (after the checked steps)
  and ``init``; ``ref``: ``losses``, ``grads``, ``params``."""
  gaps = [abs(p - r) / max(abs(r), 1e-30)
          for p, r in zip(prog["losses"], ref["losses"])]
  loss_gap = max(gaps) if all(math.isfinite(g) for g in gaps) else math.inf
  if len(prog["losses"]) != len(ref["losses"]):
    loss_gap = math.inf
  keys = sorted(ref["grads"])
  grad_r = _norms(ref["grads"])
  grad = _leaf_gaps(_norms({k: prog["grads"][k] for k in keys}), grad_r,
                    keys)
  floor = statistics.median(grad_r.values())
  moving = [k for k in keys if grad_r[k] >= 1e-3 * floor]
  change = _leaf_gaps(
      _norms({k: prog["params"][k] - prog["init"][k] for k in moving}),
      _norms({k: ref["params"][k] - prog["init"][k] for k in moving}),
      moving)
  worst_grad, worst_change = _worst(grad), _worst(change)
  return {"loss_gap": loss_gap, "loss1_gap": gaps[0] if gaps else math.inf,
          "out1_rel": _rel(prog["out1"], ref["out1"]),
          "grad_gap": grad[worst_grad], "change_gap": change[worst_change],
          "grad_gap_median": statistics.median(grad.values()),
          "change_gap_median": statistics.median(change.values()),
          "_leaves": {"grad_gap": worst_grad, "change_gap": worst_change,
                      "left_out": len(keys) - len(moving)}}


def judge(numbers: dict, limits: dict) -> dict:
  """``{name: {"value": v, "limit": l}}`` for every limited number, and
  whether all are finite and within their limits."""
  checks = {name: {"value": numbers[name], "limit": limit}
            for name, limit in limits.items()}
  ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
           for c in checks.values())
  return {"correct": ok, "checks": checks}

