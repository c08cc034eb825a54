#!/usr/bin/env python3
"""Data-parallel stage-1 training over the cards of one host: NCCL, one
process a card.

    python3 scripts/ddp_cards.py [--world N]

Builds the port's kernels, then starts N ranks (default: every card;
``mode_tpu_torch/parallel/launch.py``, NCCL, rank r on ``cuda:r``), each
with ``chip_smoke.py``'s seeded Sphere model and two pairs of a global
batch of 2N at 1024x512, maxdisp 192, f32, ``remat_policy="save_convs"``:
``train_b2``'s per-card batch, so every card launches every training
kernel of the step. Each rank takes one step with its launches counted
(``chip_smoke.train_expect("train_b2")``), ends it bit-equal with the
others (parameters, gradients, buffers), then takes two timed steps and
one profiled (the share of the host time in collectives, the NCCL
kernels' device time). On card 0 afterwards: one process's step at the
global batch from the same weights, rank 0's loss and gradients held
against its plain step at ``chip_smoke.STEP_BARS`` and its BN statistics
against its kernel step within 1e-3 of their norm; and the one-card step
at batch 2 timed, against which a rank's step time reads as scaling.

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

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402

PER_RANK = 2


def _batch(n: int, h: int, w: int, maxdisp: int, device: str):
  """A global batch of ``n`` uint8 pairs (the right views rolled by 24 and
  64 columns in turns) and ground truth in [0, maxdisp) with NaN patches
  of different sizes, the same on every process."""
  gen = torch.Generator(device=device).manual_seed(21)
  left = torch.randint(0, 256, (n, h, w, 3), generator=gen, device=device,
                       dtype=torch.uint8)
  right = torch.stack([torch.roll(left[b], -(24, 64)[b % 2] * w // 512,
                                  dims=1) for b in range(n)])
  gt = torch.rand((n, h, w), generator=gen, device=device) * maxdisp
  for b in range(n):
    gt[b, h // 4: h // 4 + (b + 1) * h // 16, w // 8: w // 2] = float("nan")
  return left, right.contiguous(), gt


def _rank(cfg: dict) -> dict:
  from mode_tpu_torch import kernels, training
  from mode_tpu_torch.models.disparity import ModeDisparity
  from mode_tpu_torch.parallel import mesh as pmesh
  cuda = cfg["device"] != "cpu"
  mesh = pmesh.make_mesh(device=cfg["device"] if not cuda else None)
  model = ModeDisparity(cfg["maxdisp"], device=mesh.device,
                        generator=torch.Generator().manual_seed(0))
  optimizer = training.make_optimizer(model.parameters())
  step = training.make_disparity_train_step(model, optimizer, mesh=mesh)
  rows = pmesh.shard_batch(mesh, _batch(
      PER_RANK * mesh.data, cfg["h"], cfg["w"], cfg["maxdisp"],
      str(mesh.device)))
  kernels.reset_launches()
  out = {"rank": mesh.rank, "device": str(mesh.device),
         "loss": float(step(*rows))}
  if cuda:
    torch.cuda.synchronize()
  out["launches"] = dict(kernels.LAUNCHES)
  params = list(model.parameters())
  out["same"] = pmesh.same_on_every_rank(
      params + [p.grad for p in params] + list(model.buffers()), mesh)
  if mesh.rank == 0:
    out["grads"] = {n: p.grad.cpu() for n, p in model.named_parameters()}
    out["stats"] = {n: b.cpu() for n, b in model.named_buffers()
                    if n.endswith(("running_mean", "running_var"))}
  if cuda:
    out["step_ms"] = []
    for _ in range(2):
      t = time.perf_counter()
      step(*rows)
      torch.cuda.synchronize()
      out["step_ms"].append((time.perf_counter() - t) * 1e3)
    out["profile"] = chip_smoke._profiled_step(step, rows)
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
  return out


def main() -> int:
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument("--world", type=int, default=None)
  parser.add_argument("--device", default="cuda")
  parser.add_argument("--height", type=int, default=1024)
  parser.add_argument("--width", type=int, default=512)
  parser.add_argument("--maxdisp", type=int, default=chip_smoke.MAXDISP)
  args = parser.parse_args()
  from mode_tpu_torch import training
  from mode_tpu_torch.models.disparity import ModeDisparity
  from mode_tpu_torch.parallel.launch import run_ranks
  cuda = args.device != "cpu"
  card = "CPU rehearsal"
  if cuda:
    if not torch.cuda.is_available():
      print("ddp_cards: no CUDA device is available", file=sys.stderr)
      return 1
    from mode_tpu_torch.kernels import build
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60,
                          check=True).stdout.strip().replace("\n", "; ")
    build.build()
  chip_smoke.DEVICE = "cuda:0" if cuda else "cpu"
  world = args.world or (torch.cuda.device_count() if cuda else 2)
  cfg = {"device": args.device, "h": args.height, "w": args.width,
         "maxdisp": args.maxdisp}
  print(f"ddp_cards: {world} ranks, {card}", flush=True)
  t0 = time.perf_counter()
  ranks = run_ranks(_rank, world, (cfg,), timeout=1200,
                    backend="nccl" if cuda else "gloo",
                    device=None if cuda else "cpu")
  wall = time.perf_counter() - t0
  expect = chip_smoke.train_expect("train_b2") if cuda else {}
  for r in ranks:
    chip_smoke._launch_check(f"ddp_cards rank {r['rank']} ({r['device']})",
                             r["launches"], expect)
    if not r["same"] or r["loss"] != ranks[0]["loss"]:
      chip_smoke._fail(f"ddp_cards rank {r['rank']}: parted from rank 0")
  rank0 = ranks[0]

  # one process at the global batch, from the same weights, on card 0
  model = ModeDisparity(args.maxdisp, device=chip_smoke.DEVICE,
                        generator=torch.Generator().manual_seed(0))
  batch = _batch(PER_RANK * world, args.height, args.width, args.maxdisp,
                 chip_smoke.DEVICE)
  plain_step = chip_smoke.plain_stepper(model, chip_smoke._stage1_step, (
      training.normalize_rgb_on_device(batch[0]),
      training.normalize_rgb_on_device(batch[1]), batch[2]))
  chip_smoke._stage1_step(model)(*batch)
  check = chip_smoke.grad_check(
      "ddp_cards rank 0", plain_step, rank0["loss"],
      {n: torch.from_numpy(g).to(chip_smoke.DEVICE)
       for n, g in rank0["grads"].items()})
  stats_rel = max(
      float(torch.linalg.vector_norm(torch.from_numpy(rank0["stats"][n]).to(
          b.device) - b) / torch.linalg.vector_norm(b))
      for n, b in model.named_buffers() if n in rank0["stats"])
  del model, plain_step, batch
  summary = {"world": world, "card": card, "wall_s": wall,
             "loss": rank0["loss"], "stats_rel": stats_rel,
             "check": {k: v for k, v in check.items() if k != "worst_leaf"},
             "ok": bool(check["ok"]) and stats_rel <= chip_smoke.GRAD_RTOL}
  if cuda:
    torch.cuda.empty_cache()
    one = ModeDisparity(args.maxdisp, device=chip_smoke.DEVICE,
                        generator=torch.Generator().manual_seed(0))
    step = chip_smoke._stage1_step(one)
    pair = _batch(PER_RANK, args.height, args.width, args.maxdisp,
                  chip_smoke.DEVICE)
    step(*pair)
    one_ms = []
    for _ in range(2):
      torch.cuda.synchronize()
      t = time.perf_counter()
      step(*pair)
      torch.cuda.synchronize()
      one_ms.append((time.perf_counter() - t) * 1e3)
    summary.update({
        "one_card_ms": one_ms,
        "ranks": [{k: r[k] for k in ("rank", "device", "step_ms", "profile",
                                     "peak_gib", "launches")}
                  for r in ranks]})
    for r in ranks:
      p = r["profile"]
      print(f"rank {r['rank']} on {r['device']}: ms/step "
            f"{', '.join(f'{t:.1f}' for t in r['step_ms'])}; profiled step "
            f"host {p['host_ms']:.1f} ms, collectives {p['allreduce_ms']:.1f}"
            f" ms on the host ({100 * p['share']:.1f}%), NCCL kernels "
            f"{p['nccl_device_ms']:.1f} ms; peak {r['peak_gib']:.2f} GiB",
            flush=True)
    print(f"one card, the same step at batch {PER_RANK}: "
          f"{', '.join(f'{t:.1f}' for t in one_ms)} ms", flush=True)
  print(f"ddp_cards: rank 0's step against one process at batch "
        f"{PER_RANK * world}: loss rel {check['loss_rel']:.3g}, gradients "
        f"{'within' if check['ok'] else 'OUTSIDE'} STEP_BARS, BN statistics "
        f"{stats_rel:.3g} of their norm", flush=True)
  print(json.dumps(summary, default=str), flush=True)
  return 0 if summary["ok"] else 1


if __name__ == "__main__":
  sys.exit(main())
