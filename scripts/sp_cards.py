#!/usr/bin/env python3
"""The stage-1 eval forward over a ``(data, spatial)`` mesh of the cards of
one host: NCCL, one process a card.

    python3 scripts/sp_cards.py [--meshes 1x4 2x2]

Builds the port's kernels, then for each mesh ``DxS`` (``D * S`` cards)
starts one rank a card (``mode_tpu_torch/parallel/launch.py``, NCCL, rank r
on ``cuda:r`` at mesh place ``(r // S, r % S)``), each with the trained mid
weights (``tests/data/trained_mirror_mid.npz``) and a ``sphere_b6``-shaped
call: six 1024x512 pairs (``chip_smoke.py``'s textured anchor inputs, one
disparity a pair), maxdisp 192, f32. Each rank serves its ``6 / D`` pairs'
``H / S`` rows (``with activate(mesh)``): one call with its launches
counted, which must be one process's per call (``chip_smoke.PATHS
["sphere_b6"]``, the 3-D convs and K2 on their halo forms, 29 collectives a
call), then three timed and one profiled (its NCCL kernels' device time,
its all-gathers' host time). The maps gathered from every rank
(``gather_rows``, then ``global_batch_from_local``) are held against one
process's call on card 0 at ``chip_smoke.PRED_MAE``/``PRED_MAX``/
``CONF_MAE``, and that call's time is the one-card yardstick.

``--device cpu --height 64 --width 32 --maxdisp 16`` rehearses it on the
CPU over gloo (no launches, no timing). The last line is a JSON summary.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402

PAIRS = 6
CALLS = 3


def _pairs(h: int, w: int, device: str):
  """Six textured pairs ``(6, h, w, 3)`` f32, the same on every process:
  ``chip_smoke._make_anchor_batch`` with ``FRAME_DISPS``' disparities."""
  with np.load(chip_smoke.ROOT / "tests/data/fullres_torch_frame.npz") as z:
    seed = int(z["seed"]) + 300
  made = [chip_smoke._make_anchor_batch(seed + k, d, h, w)
          for k, d in enumerate(chip_smoke.FRAME_DISPS[:PAIRS])]
  return tuple(torch.cat([m[i] for m in made]).permute(0, 2, 3, 1)
               .contiguous().to(device) for i in (0, 1))


def _profiled(fn, args, cuda: bool) -> dict:
  """One call under ``torch.profiler``: host ms, device ms, the NCCL
  kernels' device ms and the all-gathers' host ms."""
  from torch.profiler import ProfilerActivity, profile
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
    t = time.perf_counter()
    fn(*args)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t) * 1e3
  events = prof.key_averages()
  on_card = [e for e in events
             if str(getattr(e, "device_type", "")).endswith("CUDA")]
  return {"host_ms": host_ms,
          "device_ms": sum(e.self_device_time_total for e in on_card) / 1e3,
          "nccl_device_ms": sum(e.self_device_time_total for e in on_card
                                if "nccl" in e.key.lower()) / 1e3,
          **chip_smoke._allreduce_share(events, host_ms, r"all_?gather")}


def _rank(cfg: dict, data: int, spatial: int) -> dict:
  from mode_tpu_torch import kernels
  from mode_tpu_torch.parallel import mesh as pmesh
  cuda = cfg["device"] != "cpu"
  mesh = pmesh.make_mesh(data=data, spatial=spatial,
                         device=None if cuda else "cpu")
  model = chip_smoke._sp_model(str(mesh.device), cfg["maxdisp"])
  rows = pmesh.shard_batch(mesh, _pairs(cfg["h"], cfg["w"],
                                        str(mesh.device)))
  out = {"place": (mesh.rank, mesh.spatial_rank), "device": str(mesh.device)}
  with pmesh.activate(mesh):
    model(*rows)                                   # warm-up
    if cuda:
      torch.cuda.synchronize()
    kernels.reset_launches()
    before = mesh.collectives
    pred, conf = model(*rows)
    if cuda:
      torch.cuda.synchronize()
    out.update(launches=dict(kernels.LAUNCHES),
               halo=dict(kernels.HALO_LAUNCHES),
               collectives=mesh.collectives - before, rows=tuple(pred.shape))
    whole = [pmesh.global_batch_from_local(mesh, pmesh.gather_rows(t, 1, mesh))
             for t in (pred, conf)]
    if mesh.rank == 0 and mesh.spatial_rank == 0:
      out["pred"], out["conf"] = (t.cpu() for t in whole)
    if cuda:
      out["call_ms"] = []
      for _ in range(CALLS):
        t = time.perf_counter()
        model(*rows)
        torch.cuda.synchronize()
        out["call_ms"].append((time.perf_counter() - t) * 1e3)
      out["profile"] = _profiled(model, rows, cuda)
      out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
  return out


def main() -> int:
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument("--meshes", nargs="+", default=["1x4", "2x2"])
  parser.add_argument("--device", default="cuda")
  parser.add_argument("--height", type=int, default=1024)
  parser.add_argument("--width", type=int, default=512)
  parser.add_argument("--maxdisp", type=int, default=chip_smoke.MAXDISP)
  args = parser.parse_args()
  from mode_tpu_torch.parallel.launch import run_ranks
  cuda = args.device != "cpu"
  card = "CPU rehearsal"
  if cuda:
    if not torch.cuda.is_available():
      print("sp_cards: no CUDA device is available", file=sys.stderr)
      return 1
    from mode_tpu_torch.kernels import build
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60,
                          check=True).stdout.strip().replace("\n", "; ")
    build.build()
  device = "cuda:0" if cuda else "cpu"
  cfg = {"device": args.device, "h": args.height, "w": args.width,
         "maxdisp": args.maxdisp}
  print(f"sp_cards: meshes {' '.join(args.meshes)}, {card}", flush=True)

  # one process on card 0: the reference maps and the one-card time
  model = chip_smoke._sp_model(device, args.maxdisp)
  pairs = _pairs(args.height, args.width, device)
  with torch.no_grad():
    ref_pred, ref_conf = model(*pairs)
  summary = {"card": card, "pairs": PAIRS, "meshes": {}, "ok": True}
  if cuda:
    torch.cuda.synchronize()
    one_ms = []
    for _ in range(CALLS):
      t = time.perf_counter()
      model(*pairs)
      torch.cuda.synchronize()
      one_ms.append((time.perf_counter() - t) * 1e3)
    summary["one_card_ms"] = one_ms
    print(f"one card, {PAIRS} pairs a call: "
          f"{', '.join(f'{t:.1f}' for t in one_ms)} ms", flush=True)
  del model
  served = {k: n for k, (_, n) in chip_smoke.PATHS["sphere_b6"][4].items()}
  for spec in args.meshes:
    data, spatial = (int(n) for n in spec.split("x"))
    t0 = time.perf_counter()
    ranks = run_ranks(_rank, data * spatial, (cfg, data, spatial),
                      timeout=1200, backend="nccl" if cuda else "gloo",
                      device=None if cuda else "cpu")
    wall = time.perf_counter() - t0
    for r in ranks:
      label = f"sp_cards {spec} rank {r['place']} ({r['device']})"
      if cuda:
        chip_smoke._launch_check(label, r["launches"], served)
        chip_smoke._launch_check(f"{label} halo", r["halo"],
                                 chip_smoke.SP_HALO)
      if r["collectives"] != chip_smoke.SP_COLLECTIVES:
        chip_smoke._fail(f"{label}: {r['collectives']} collectives a call")
      if r["rows"] != (PAIRS // data, args.height // spatial, args.width):
        chip_smoke._fail(f"{label}: its rows have the shape {r['rows']}")
    pred, conf = (torch.from_numpy(ranks[0][k]).to(device)
                  for k in ("pred", "conf"))
    check = chip_smoke._check_output(f"sp_cards {spec} vs one process", pred,
                                     conf, ref_pred, ref_conf,
                                     (PAIRS, args.height, args.width),
                                     seeded=False)
    got = {"wall_s": wall, "check": check}
    if cuda:
      got["ranks"] = [{k: r[k] for k in ("place", "device", "call_ms",
                                         "profile", "peak_gib", "launches",
                                         "halo")} for r in ranks]
      for r in ranks:
        p = r["profile"]
        print(f"{spec} rank {r['place']} on {r['device']}: ms/call "
              f"{', '.join(f'{t:.1f}' for t in r['call_ms'])}; profiled "
              f"call host {p['host_ms']:.1f} ms, device {p['device_ms']:.1f}"
              f" ms, NCCL kernels {p['nccl_device_ms']:.1f} ms, all-gathers "
              f"{p['allreduce_ms']:.1f} ms on the host; peak "
              f"{r['peak_gib']:.2f} GiB", flush=True)
    summary["meshes"][spec] = got
  print(json.dumps(summary, default=str), flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
