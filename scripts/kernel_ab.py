#!/usr/bin/env python3
"""Time the implicit-GEMM conv kernels of the checkout in the working
directory at the served stage-1 shapes, to compare two checkouts on one
card.

    cd OTHER_CHECKOUT && python3 /path/to/scripts/kernel_ab.py

Imports ``mode_tpu_torch`` from the working directory (so a second
checkout, e.g. the parent commit unpacked with ``git archive``, times its
own kernels), builds its 3-D and 2-D conv sources, and times each kernel
through its public wrapper (the unsharded call, which every commit has) at
the whole-volume shapes of a 1024x512 pair: the stride-1 conv at the 1/4,
1/8 and 1/16 levels and its Cout-1 head (and at the stage-1 training
step's batch 16 of 512x256 pairs: the 1/4, 1/8 and 1/16 levels and the
grad-input of dres0's first conv, 32 -> 64 at 1/4), the stride-2 conv, the
deconv at both levels; and the 2-D conv (K8/K9) at the feature extractor's
batch-6 shape, the Sphere stem at batch 1 (``sphere_b1``), the training
step's batch-2 shapes (``train_b2``) and the fusion net's 1024x512 levels;
f32 and bf16, CUDA events over at least ``REPS`` launches and
``WINDOW_MS`` of device time after a warm-up, the fastest of ``ROUNDS``
rounds. Prints the card, one JSON line ``{case: ms}`` and one of the 2-D
source's registers per unsharded kernel (``ptxas -v`` in its build log,
keyed by the kernel's tile and dtype: the parent's and a change's must
agree).
Run the two checkouts in turns (A, B, B, A) in one call. Arguments, if
any, keep only the cases whose name starts with one of them (``s1``,
``s2``, ``deconv``, ``2d``).
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

REPS = 20
WINDOW_MS = 25.0     # a kernel of tens of microseconds: hundreds of launches
ROUNDS = 3
# (kernel, x shape (NDHWC / NHWC), Cout)
CASES = [("s1", (1, 48, 256, 128, 32), 32), ("s1", (1, 48, 256, 128, 64), 32),
         ("s1", (1, 24, 128, 64, 64), 64), ("s1", (1, 12, 64, 32, 64), 64),
         ("s1", (1, 48, 256, 128, 32), 1),
         # the 3D60 training step at batch 16: 1/4 (64 -> 32, 32 -> 32, the
         # grad-input 32 -> 64), 1/8 and 1/16
         ("s1", (16, 48, 128, 64, 64), 32), ("s1", (16, 48, 128, 64, 32), 32),
         ("s1", (16, 48, 128, 64, 32), 64), ("s1", (16, 24, 64, 32, 64), 64),
         ("s1", (16, 12, 32, 16, 64), 64), ("s2", (1, 48, 256, 128, 32), 64),
         ("s2", (1, 24, 128, 64, 64), 64), ("deconv", (1, 12, 64, 32, 64), 64),
         ("deconv", (1, 24, 128, 64, 64), 32), ("2d", (6, 128, 64, 64), 64),
         # K8 at the stem (sphere_b1), K9 at train_b2's feature extractor,
         # K8 at the fusion net's levels
         ("2d", (1, 512, 256, 32), 32), ("2d", (2, 512, 256, 64), 64),
         ("2d", (2, 256, 128, 64), 64), ("2d", (1, 1024, 512, 16), 32),
         ("2d", (1, 1024, 512, 32), 32), ("2d", (1, 512, 256, 64), 64),
         ("2d", (1, 256, 128, 128), 128)]


def _window(fn, reps: int) -> float:
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  torch.cuda.synchronize()
  start.record()
  for _ in range(reps):
    fn()
  end.record()
  torch.cuda.synchronize()
  return start.elapsed_time(end) / reps


def _time(fn) -> float:
  reps = max(REPS, int(WINDOW_MS / _window(fn, REPS)))
  return min(_window(fn, reps) for _ in range(ROUNDS))


def _registers(log: str) -> dict:
  """``{tile and dtype: registers}`` of the unsharded kernels in a
  ``ptxas -v`` log: the entries whose template arguments carry no halo
  flag set (a parent without halo forms has none)."""
  out, name = {}, None
  for line in log.splitlines():
    entry = re.search(r"Compiling entry function '(\w+)'", line)
    if entry:
      name = entry[1]
      continue
    used = re.search(r"Used (\d+) registers", line)
    if used is None or name is None or "Lb1E" in name:  # Lb1E: HALOED
      continue
    args = re.search(r"I(f|13__nv_bfloat16)Li(\d+)ELi(\d+)E", name)
    key = name if args is None else (
        f"{'f32' if args[1] == 'f' else 'bf16'} {args[2]}x{args[3]}")
    out[key] = int(used[1])
    name = None
  return out


def main() -> int:
  if not torch.cuda.is_available():
    print("kernel_ab: no CUDA device is available", file=sys.stderr)
    return 1
  from mode_tpu_torch.kernels import build
  from mode_tpu_torch.ops import conv2d, conv3d
  build.build(("conv3d", "conv3d_s1", "conv3d_s2", "conv2d"))
  card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                         "--format=csv,noheader"], capture_output=True,
                        text=True, timeout=60, check=True).stdout.strip()
  gen = torch.Generator(device="cuda").manual_seed(0)
  out = {}
  cases = [c for c in CASES if not sys.argv[1:] or c[0] in sys.argv[1:]]
  for dtype in (torch.float32, torch.bfloat16):
    for kind, xs, cout in cases:
      cin = xs[-1]
      x = torch.randn(xs, generator=gen, device="cuda").to(dtype)
      one = torch.ones(cout, device="cuda")
      if kind == "2d":
        w = torch.randn((cout, cin, 3, 3), generator=gen, device="cuda")
        packed = conv2d.pack_weight_tc(w.to(dtype))
        def fn():
          return conv2d.conv2d_s1_bn_act(x, packed, one, 0 * one, None, True)
      elif kind == "deconv":
        w = torch.randn((cin, cout, 3, 3, 3), generator=gen, device="cuda")
        packed = conv3d.pack_weight_tc(w.to(dtype), transpose=True)
        def fn():
          return conv3d.deconv3d_bn_act(x, packed, one, 0 * one, relu=True)
      else:
        stride = 1 if kind == "s1" else 2
        w = torch.randn((cout, cin, 3, 3, 3), generator=gen, device="cuda")
        packed = conv3d.pack_weight_tc(w.to(dtype), stride)
        conv = (conv3d.conv3d_s1_bn_act if stride == 1
                else conv3d.conv3d_s2_bn_act)
        def fn():
          return conv(x, packed, one, 0 * one, relu=True)
      out[f"{kind} {xs}->{cout} {str(dtype)[6:]}"] = _time(fn)
  print(f"kernel_ab: {os.getcwd()} on {card}", flush=True)
  print(json.dumps(out), flush=True)
  print("registers conv2d " + json.dumps(_registers(
      (build.BUILD_DIR / "conv2d.log").read_text())), flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
