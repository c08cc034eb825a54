#!/usr/bin/env python3
"""Time the sphere conv's grad-input kernel (K3b / K10b dx) at 1, 2 and 4
halo tiles per K stage, on one CUDA card.

    python3 scripts/sphere_dx_tiles.py

Builds ``mode_tpu_torch/kernels/csrc/sphere_conv_bwd.cu`` once per tile
count (its line ``constexpr int MAXT = 2;`` set to n in a copy) into
``mode_tpu_torch/kernels/build/``, calls each library's dx entry with the
arguments of ``ops/sphere_conv.py:_launch_bwd_input`` at the layer-4 shapes
of a batch-2 training step (Cassini 256x128 and ERP 128x256, Cin 128 and
64, Cout 128, f32 and bf16, chip_smoke.py's inputs), holds each result
against the plain grad-input within chip_smoke.py's bars, and times the
kernels alone with CUDA events in turns (1, 2, 4, 4, 2, 1; the faster of
each pair). It also times the wrapper, whose per-call weight pack the
training step pays, beside the kernel it launches. Prints the card's name
and power limit first; exits non-zero without a card or on a failed check.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

TILES = (1, 2, 4)
REPS = 20
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-2, 1e-2)}


def _build(tiles: int) -> ctypes.CDLL:
  from mode_tpu_torch.kernels import build
  from mode_tpu_torch.ops import sphere_conv as S
  build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
  line = "constexpr int MAXT = 2;"
  text = (build.CSRC_DIR / "sphere_conv_bwd.cu").read_text()
  if text.count(line) != 1:
    raise SystemExit(f"sphere_conv_bwd.cu has no single line {line!r}")
  src = build.BUILD_DIR / f"sphere_conv_bwd_tiles{tiles}.cu"
  src.write_text(text.replace(line, f"constexpr int MAXT = {tiles};"))
  out = src.with_suffix(".so")
  cmd = [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC_DIR),
         "-o", str(out), str(src)]
  proc = subprocess.run(cmd, capture_output=True, text=True)
  if proc.returncode:
    raise SystemExit(f"build with {tiles} tiles failed:\n{proc.stdout}"
                     f"{proc.stderr}")
  lib = ctypes.CDLL(str(out))
  for name in S.BWD_INPUT.values():
    fn = getattr(lib, name)
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 6
                   + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
  return lib


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


def main() -> int:
  if not torch.cuda.is_available():
    print("sphere_dx_tiles: no CUDA device is available", file=sys.stderr)
    return 1
  from mode_tpu_torch.ops import kmajor
  from mode_tpu_torch.ops import sphere_conv as S
  smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True)
  print(smi.stdout.strip().splitlines()[0], flush=True)
  libs = {t: _build(t) for t in TILES}
  gen = torch.Generator(device="cuda").manual_seed(0)
  ok = True
  for sphere_type, (h, w) in (("Cassini", (256, 128)), ("ERP", (128, 256))):
    for cin in (128, 64):
      for dtype in (torch.float32, torch.bfloat16):
        cout, split = 128, dtype == torch.float32
        g = (torch.randn((2, h, w, cout), generator=gen, device="cuda")
             * 0.5).to(dtype)
        wt = (torch.randn((cout, cin, 3, 3), generator=gen, device="cuda")
              * (2.0 / (9 * cout)) ** 0.5).to(dtype)
        wk = S.pack_weight(wt)
        parts = kmajor.pack(wk, wk, split).parts
        entries, weights = S._device_tables("transpose", h, w, sphere_type,
                                            g.device)
        want = S._plain_bwd_input(g, wt, sphere_type)
        atol, rtol = TOL[dtype]
        fns, errs = {}, {}
        for t, lib in libs.items():
          dx = torch.empty((2, h, w, cin), dtype=dtype, device="cuda")

          def run(lib=lib, dx=dx):
            err = getattr(lib, S.BWD_INPUT[sphere_type])(
                int(not split), g.data_ptr(), parts[0].data_ptr(),
                parts[1].data_ptr() if split else None, entries.data_ptr(),
                weights.data_ptr(), dx.data_ptr(), 2, h, w, cin, cout,
                torch.cuda.current_stream().cuda_stream)
            if err:
              raise RuntimeError(f"launch failed with CUDA error {err}")
            return dx

          diff = (run().float() - want).abs()
          torch.cuda.synchronize()
          errs[t] = float(diff.max())
          ok &= bool((diff <= atol + rtol * want.abs()).all())
          fns[t] = run
        order = list(fns) + list(fns)[::-1]
        times = {t: [] for t in fns}
        for t in order:
          times[t].append(_time_ms(fns[t]))
        wrapper = _time_ms(lambda: S.sphere_conv_bwd_input(
            g, wk, sphere_type=sphere_type))
        print(f"{sphere_type} (2, {h}, {w}) {cin} <- {cout} "
              f"{str(dtype)[6:]}: " + ", ".join(
                  f"{t} tiles {min(v):.4f} ms (err {errs[t]:.3g})"
                  for t, v in times.items())
              + f"; the wrapper with its weight pack {wrapper:.4f} ms",
              flush=True)
  if not ok:
    print("FAIL: a build disagrees with the plain grad-input")
    return 1
  return 0


if __name__ == "__main__":
  sys.exit(main())
