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
1/8 and 1/16 levels and its Cout-1 head, the stride-2 conv, the deconv at
both levels, and the 2-D conv at the feature extractor's batch-6 shape;
f32 and bf16, CUDA events over ``REPS`` launches after a warm-up, the
faster of two rounds. Prints the card and one JSON line ``{case: ms}``.
Run the two checkouts in turns (A, B, B, A) in one call. Arguments, if
any, keep only the cases whose name starts with one of them (``s1``,
``s2``, ``deconv``, ``2d``).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

REPS = 20
# (kernel, x shape (NDHWC / NHWC), Cout)
CASES = [("s1", (1, 48, 256, 128, 32), 32), ("s1", (1, 48, 256, 128, 64), 32),
         ("s1", (1, 24, 128, 64, 64), 64), ("s1", (1, 12, 64, 32, 64), 64),
         ("s1", (1, 48, 256, 128, 32), 1), ("s2", (1, 48, 256, 128, 32), 64),
         ("s2", (1, 24, 128, 64, 64), 64), ("deconv", (1, 12, 64, 32, 64), 64),
         ("deconv", (1, 24, 128, 64, 64), 32), ("2d", (6, 128, 64, 64), 64)]


def _time(fn) -> float:
  fn()
  best = float("inf")
  for _ in range(2):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(REPS):
      fn()
    end.record()
    torch.cuda.synchronize()
    best = min(best, start.elapsed_time(end) / REPS)
  return best


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
  return 0


if __name__ == "__main__":
  sys.exit(main())
