#!/usr/bin/env python3
"""Time the transposed 3-D conv kernel (K5/K7, ``deconv3d_bn_act``) beside
the stride-1 3-D conv kernel (K1/K6, ``conv3d_s1_bn_act``) at the same
implicit-GEMM dimensions, on one CUDA card.

    python3 scripts/deconv_vs_conv.py

Both run ``igemm_tc.cuh:conv_body`` with M = the input grid, N = Cout and
K = 27 x Cin, so the same tiles, stages and products; what differs is the
deconv's walk (its taps in output parity phases, an epilogue after each
phase) and its output, eight times the conv's. The shapes are the served
K5 and K7 calls of ``chip_smoke.py`` (1/8 -> 1/4, 64 -> 32; 1/16 -> 1/8,
64 -> 64 with and without the residual), K5 at batch 2 (a training step's)
and K7 at batch 6 (a frame's six pairs), in f32 and bf16, with
``chip_smoke.py``'s inputs (x * 0.5, He-scaled weights, each kernel's
weight packed once as the layers keep it). Each result is held against its
plain version within ``chip_smoke.py``'s bars; the two kernels are timed
with CUDA events in turns (deconv, conv, conv, deconv; the faster of each
pair). Prints the card's name and power limit first, then one JSON object
per shape; exits non-zero without a card or on a failed check.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

REPS = 20
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-2, 1e-2)}
# (input NDHWC, Cout, residual, what it is)
SHAPES = (((1, 24, 128, 64, 64), 32, False, "K5, served"),
          ((2, 24, 128, 64, 64), 32, False, "K5, training batch 2"),
          ((1, 12, 64, 32, 64), 64, True, "K7, served"),
          ((1, 12, 64, 32, 64), 64, False, "K7 without the residual"),
          ((6, 12, 64, 32, 64), 64, True, "K7, six pairs"))


def _time_ms(fn) -> float:
  fn()
  torch.cuda.synchronize()
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  start.record()
  for _ in range(REPS):
    fn()
  end.record()
  torch.cuda.synchronize()
  return start.elapsed_time(end) / REPS


def _check(name, got, want, dtype):
  atol, rtol = TOL[dtype]
  diff = (got.float() - want.float()).abs()
  if not bool((diff <= atol + rtol * want.float().abs()).all()):
    raise SystemExit(f"FAIL: {name} is off its plain version by "
                     f"{float(diff.max()):.3g}")
  return float(diff.max())


def main() -> int:
  if not torch.cuda.is_available():
    print("FAIL: no CUDA card", flush=True)
    return 1
  smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True)
  print(smi.stdout.strip() or "nvidia-smi: " + smi.stderr.strip(),
        flush=True)
  from mode_tpu_torch.device import ieee_f32_convs
  from mode_tpu_torch.ops import conv3d as C
  dev = torch.device("cuda")
  gen = torch.Generator(device=dev).manual_seed(0)
  for dtype in (torch.float32, torch.bfloat16):
    for xs, cout, res, what in SHAPES:
      cin = xs[-1]
      x = (torch.randn(xs, generator=gen, device=dev) * 0.5).to(dtype)
      wd = (torch.randn((cin, cout, 3, 3, 3), generator=gen, device=dev)
            * (2.0 / (27 * cout)) ** 0.5).to(dtype)
      wc = (torch.randn((cout, cin, 3, 3, 3), generator=gen, device=dev)
            * (2.0 / (27 * cout)) ** 0.5).to(dtype)
      scale = torch.rand(cout, generator=gen, device=dev) * 0.4 + 0.8
      bias = torch.randn(cout, generator=gen, device=dev) * 0.1
      oshape = (xs[0], 2 * xs[1], 2 * xs[2], 2 * xs[3], cout)
      r = ((torch.randn(oshape, generator=gen, device=dev) * 0.5).to(dtype)
           if res else None)
      td = C.pack_weight_tc(wd, transpose=True)
      tc = C.pack_weight_tc(wc)

      def deconv(plain=False):
        return C.deconv3d_bn_act(x, wd if plain else td, scale, bias, r,
                                 True, plain=plain)

      def conv(plain=False):
        return C.conv3d_s1_bn_act(x, wc if plain else tc, scale, bias,
                                  None, True, plain=plain)

      with ieee_f32_convs():
        err_d = _check("deconv3d_bn_act", deconv(), deconv(True), dtype)
        err_c = _check("conv3d_s1_bn_act", conv(), conv(True), dtype)
      times = [_time_ms(deconv), _time_ms(conv), _time_ms(conv),
               _time_ms(deconv)]
      d_ms, c_ms = min(times[0], times[3]), min(times[1], times[2])
      flops = 2 * torch.Size(xs[:4]).numel() * 27 * cin * cout
      print(json.dumps({
          "dtype": str(dtype).split(".")[1], "shape": f"{xs}->{cout}"
          + (" +res" if res else ""), "what": what,
          "deconv_ms": d_ms, "conv_s1_ms": c_ms,
          "deconv_tflops": flops / d_ms / 1e9,
          "conv_s1_tflops": flops / c_ms / 1e9,
          "deconv_max_abs_err": err_d, "conv_s1_max_abs_err": err_c}),
          flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
