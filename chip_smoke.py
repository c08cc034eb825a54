#!/usr/bin/env python3
"""Drive the PyTorch port (``mode_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

1. Prints the card's name and power limit (``nvidia-smi``), builds the
   port's CUDA kernels from ``mode_tpu_torch/kernels/csrc`` (one ``nvcc``
   per source, in parallel) and prints the build time.
2. Three served paths, each with seeded random weights and BN statistics,
   scaled so the features have unit std and the softmax is neither flat
   nor one-hot (measured on the path's first pair, which also records every
   kernel call its layers make):
   * ``regular_b1``: ``ModeDisparity(192, "Regular")``, one 1024x512
     Cassini pair per call;
   * ``sphere_b1``: ``ModeDisparity(192)``, the flagship ``conv="Sphere"``
     model, one pair per call;
   * ``sphere_b6``: the same model, a frame's six pairs per call.
   Each path serves a few calls with every launch count set to 0 just
   before and read just after, checks that every kernel of the path ran, at
   the recorded count, and runs one call again through the plain versions
   and compares; the output must not be degenerate.
3. Kernel phase: calls each kernel's wrapper at every shape the paths gave
   it (the recorded calls) and the regression shapes, in f32 and bf16,
   holds the result against the kernel's plain PyTorch version on the same
   inputs, and times the kernel, the plain version and one PyTorch library
   call of the same function where there is one.
4. Full-resolution anchor: the trained reference weights
   (``tests/data/trained_mirror_mid.npz``) on the inputs of
   ``tests/data/fullres_torch_frame.npz``, regenerated from its seed, held
   against the frame's committed (pred, conf).
5. Prints a ``{"kernels": [...]}`` line, then as the last line
   ``{"ok": true, "device": {...}}``.

Exits non-zero, before the last line, when there is no card or when any
check fails. Needs one card, the CUDA toolkit (``nvcc``) and no network.
"""

from __future__ import annotations

import inspect
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
DEVICE = "cuda"
# peaks of one H100 SXM (NVIDIA data sheet, dense, 700 W)
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.float32: 67e12, torch.bfloat16: 989e12}
CONV_PY = "mode_tpu/ops/pallas/conv3d_kernel.py"
CONV2D_PY = "mode_tpu/ops/pallas/conv2d_kernel.py"
# kernel: (source, the TPU kernels it replaces as file:line)
KERNELS = {
    "conv3d_s1_bn_act": ("mode_tpu_torch/kernels/csrc/conv3d.cu",
                         (f"{CONV_PY}:269", f"{CONV_PY}:866")),
    "conv3d_s2_bn_act": ("mode_tpu_torch/kernels/csrc/conv3d.cu",
                         (f"{CONV_PY}:480",)),
    "deconv3d_bn_act": ("mode_tpu_torch/kernels/csrc/conv3d.cu",
                        (f"{CONV_PY}:677", f"{CONV_PY}:1042")),
    "fused_disparity_regression": (
        "mode_tpu_torch/kernels/csrc/regression.cu",
        ("mode_tpu/ops/pallas/regression_kernel.py:107",)),
    "sphere_conv_bn_act": (
        "mode_tpu_torch/kernels/csrc/sphere_conv.cu",
        ("mode_tpu/ops/pallas/sphere_conv_kernel.py:272",)),
    "conv2d_s1_bn_act": ("mode_tpu_torch/kernels/csrc/conv2d.cu",
                         (f"{CONV2D_PY}:162", f"{CONV2D_PY}:346")),
}
# The TPU kernel (ROADMAP's numbering) each kernel took over; the hourglass
# layers at the 1/16 level, which the TPU ran M*L-folded; and the 2-D band
# kernel, per-image at batch 1 and batch-packed above.
TPU_KERNEL = {"conv3d_s1_bn_act": "K1", "conv3d_s2_bn_act": "K4",
              "deconv3d_bn_act": "K5", "fused_disparity_regression": "K2",
              "sphere_conv_bn_act": "K3"}
TPU_FOLDED = {"conv4": "K6", "conv5": "K7"}
H, W, MAXDISP = 1024, 512, 192
# path: (conv, pairs per call, calls served, the JAX path's launches per
# call, by kernel)
JAX_3D = {"conv3d_s1_bn_act": "K1 13 + K6 3", "conv3d_s2_bn_act": "K4 6",
          "deconv3d_bn_act": "K5 3 + K7 3",
          "fused_disparity_regression": "K2 1"}
PATHS = {
    "regular_b1": ("Regular", 1, 2, JAX_3D),
    "sphere_b1": ("Sphere", 1, 3, {**JAX_3D, "sphere_conv_bn_act": "K3 32",
                                   "conv2d_s1_bn_act": "K8 4"}),
    "sphere_b6": ("Sphere", 6, 2, {**JAX_3D, "sphere_conv_bn_act": "K3 32",
                                   "conv2d_s1_bn_act": "K9 64"}),
}
# the path whose per-pair numbers the kernels line carries
MAIN_PATH = "sphere_b1"
# Spread of the served model's final logits (std over the volume): enough
# for a softmax that is neither flat nor one-hot
LOGIT_STD = 4.0
# |kernel - plain| <= ATOL + RTOL * |plain| elementwise. f32: both sides sum
# up to 27 * 64 (3-D) or 9 * 320 (2-D, sphere) f32 products in different
# orders. bf16: both sides compute in f32 from the same bf16 inputs and
# round once, so they may land one bf16 step (2^-8 relative) apart.
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-2, 1e-2)}
# A served path on the card against its plain path, f32: the bars of
# tests/test_trained_parity_midres.py.
PRED_MAE, PRED_MAX, CONF_MAE = 1e-3, 1e-2, 1e-3
# The full-resolution anchor: the bars of
# tests/test_trained_parity_fullres.py.
ANCHOR_MAE, ANCHOR_MAX, ANCHOR_CONF_MAE = 1e-3, 5e-2, 1e-3


def _fail(msg: str) -> None:
  print(f"FAIL: {msg}", flush=True)
  raise SystemExit(1)


def _time_ms(fn, reps: int) -> float:
  """Mean device time of ``fn`` over ``reps`` calls, after one warm-up."""
  fn()
  torch.cuda.synchronize()
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  start.record()
  for _ in range(reps):
    fn()
  end.record()
  torch.cuda.synchronize()
  return start.elapsed_time(end) / reps


def _time_in_turns(fns, reps: int) -> list[float]:
  """Times of ``fns`` on one card, each taken twice in the turns a, b, ...,
  ..., b, a; the faster of its two runs for each."""
  first = [_time_ms(fn, reps) for fn in fns]
  second = [_time_ms(fn, reps) for fn in reversed(fns)][::-1]
  return [min(a, b) for a, b in zip(first, second)]


def _close(got, want, dtype):
  """(max abs err, max rel err, within tolerance)."""
  atol, rtol = TOL[dtype]
  g, w = got.float(), want.float()
  diff = (g - w).abs()
  ok = bool((diff <= atol + rtol * w.abs()).all())
  rel = float((diff / w.abs().clamp_min(1e-6)).max())
  return float(diff.max()), rel, ok


def _bound(ops_n, nbytes, dtype):
  t_ops = ops_n / PEAK_OPS_PER_S[dtype] * 1e3
  t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
  return {"bound_ms": max(t_ops, t_bytes),
          "bound_by": "operations" if t_ops >= t_bytes else "bytes",
          "ops_ms": t_ops, "bytes_ms": t_bytes}


def _conv_case(case, dtype, gen):
  """Compare and time one recorded conv shape; returns the row it prints.
  The kernel gets its weight packed once, as the model's layers keep it."""
  from mode_tpu_torch.ops import conv2d, conv3d, sphere_conv
  name, xs, cout, res, relu, dil = case
  dev = torch.device(DEVICE)
  cin = xs[-1]
  deconv = name == "deconv3d_bn_act"
  two_d = name in ("conv2d_s1_bn_act", "sphere_conv_bn_act")
  x = (torch.randn(xs, generator=gen, device=dev) * 0.5).to(dtype)
  if two_d:
    wshape = (cout, cin, 3, 3)
  else:
    wshape = (cin, cout, 3, 3, 3) if deconv else (cout, cin, 3, 3, 3)
  taps = 9 if two_d else 27
  w = (torch.randn(wshape, generator=gen, device=dev)
       * (2.0 / (taps * cout)) ** 0.5).to(dtype)
  scale = torch.rand(cout, generator=gen, device=dev) * 0.4 + 0.8
  bias = torch.randn(cout, generator=gen, device=dev) * 0.1
  if name == "conv3d_s2_bn_act":
    oshape = (xs[0], *[(n - 1) // 2 + 1 for n in xs[1:4]], cout)
  elif deconv:
    oshape = (xs[0], *[2 * n for n in xs[1:4]], cout)
  else:
    oshape = (*xs[:-1], cout)
  r = (torch.randn(oshape, generator=gen, device=dev) * 0.5).to(dtype)
  kw = {"relu": relu}
  if res:
    kw["residual"] = r
  if name == "conv2d_s1_bn_act":
    kw["dilation"] = dil
    fn, packed = conv2d.conv2d_s1_bn_act, conv2d.pack_weight(w)
  elif name == "sphere_conv_bn_act":
    fn, packed = sphere_conv.sphere_conv_bn_act, conv2d.pack_weight(w)
  else:
    fn, packed = getattr(conv3d, name), conv3d.pack_weight(w, deconv)

  def run(plain):
    return fn(x, w if plain else packed, scale, bias, plain=plain, **kw)

  got, want = run(False), run(True)
  torch.cuda.synchronize()
  abs_err, rel_err, ok = _close(got, want, dtype)

  lib = None
  if name == "conv2d_s1_bn_act":
    x_cl = x.permute(0, 3, 1, 2)          # channels-last view for cuDNN
    w_cl = w.contiguous(memory_format=torch.channels_last)
    def lib():
      return F.conv2d(x_cl, w_cl, padding=dil, dilation=dil)
  elif not two_d:
    x_cl = x.permute(0, 4, 1, 2, 3)       # channels-last 3-D view
    w_cl = w.contiguous(memory_format=torch.channels_last_3d)
    if deconv:
      def lib():
        return F.conv_transpose3d(x_cl, w_cl, stride=2, padding=1,
                                  output_padding=1)
    else:
      s = 1 if name == "conv3d_s1_bn_act" else 2
      def lib():
        return F.conv3d(x_cl, w_cl, stride=s, padding=1)

  fns = [lambda: run(False), lambda: run(True)] + ([lib] if lib else [])
  times = _time_in_turns(fns, 10)
  kernel_ms, plain_ms = times[:2]
  grid = xs[:4] if deconv else oshape[:-1]
  m = torch.Size(grid).numel()
  ops_n = 2 * m * taps * cin * cout
  isz = x.element_size()
  nbytes = (x.numel() + w.numel() + (r.numel() if res else 0)
            + torch.Size(oshape).numel()) * isz + 2 * cout * 4
  if name == "sphere_conv_bn_act":
    # the bilinear blend: 4 products and 3 sums per (pixel, tap, channel);
    # the shift tables: an int4 and a float4 per (column, tap)
    ops_n += 7 * m * taps * cin
    nbytes += xs[2] * taps * 32
  return {"name": name, "dtype": str(dtype).split(".")[1],
          "shape": f"{xs}->{cout}" + (" +res" if res else "")
                   + (" relu" if relu else "") + (f" dil{dil}" if dil > 1
                                                  else ""),
          "max_abs_err": abs_err, "max_rel_err": rel_err, "pass": ok,
          "kernel_ms": kernel_ms, "plain_ms": plain_ms,
          "library_ms": times[2] if lib else None,
          **_bound(ops_n, nbytes, dtype),
          "tflops": ops_n / kernel_ms / 1e9}


def _regression_case(case, dtype, gen):
  from mode_tpu_torch.ops import regression
  (n, d, hq, wq), maxdisp, h, w = case
  fn = regression.fused_disparity_regression
  cost = (torch.randn((n, d, hq, wq), generator=gen, device=DEVICE)
          * 2.0).to(dtype)
  (kp, kc), (pp, pc) = (fn(cost, maxdisp, h, w, plain=plain)
                        for plain in (False, True))
  torch.cuda.synchronize()
  # conf jumps where round(pred) does: pixels whose pred lies within f32
  # noise of k + 0.5 may probe different slices on the two sides
  tie = (pp - pp.floor() - 0.5).abs() < 1e-3
  pred_err, pred_rel, pred_ok = _close(kp, pp, torch.float32)
  conf_err, _, conf_ok = _close(kc[~tie], pc[~tie], torch.float32)
  kernel_ms, plain_ms = _time_in_turns(
      [lambda: fn(cost, maxdisp, h, w),
       lambda: fn(cost, maxdisp, h, w, plain=True)], 5)
  # operations: per output pixel, a bilinear blend of each of the d source
  # levels (3 lerps, 6 flops) and per disparity level one lerp, one exp and
  # the three running sums (6 operations)
  ops_n = n * h * w * (6 * d + 6 * maxdisp)
  nbytes = cost.numel() * cost.element_size() + 2 * n * h * w * 4
  return {"name": "fused_disparity_regression",
          "dtype": str(dtype).split(".")[1],
          "shape": f"{(n, d, hq, wq)} maxdisp {maxdisp} -> {h}x{w}",
          "max_abs_err": max(pred_err, conf_err), "pred_max_abs_err": pred_err,
          "conf_max_abs_err": conf_err, "conf_ties_left_out": int(tie.sum()),
          "max_rel_err": pred_rel, "pass": pred_ok and conf_ok,
          "kernel_ms": kernel_ms, "plain_ms": plain_ms, "library_ms": None,
          **_bound(ops_n, nbytes, torch.float32)}


def _randomize_for_serving(model, seed: int) -> None:
  """Random BN statistics, so the folded affine is not the identity."""
  from mode_tpu_torch.models.blocks import TorchBatchNorm
  gen = torch.Generator().manual_seed(seed)
  with torch.no_grad():
    for m in model.modules():
      if isinstance(m, TorchBatchNorm):
        c = m.weight.numel()
        m.weight.copy_(torch.rand(c, generator=gen) * 0.4 + 0.8)
        m.bias.copy_(torch.randn(c, generator=gen) * 0.05)
        m.running_mean.copy_(torch.randn(c, generator=gen) * 0.05)
        m.running_var.copy_(torch.rand(c, generator=gen) * 0.4 + 0.8)


def _scale_features(model, factor: float) -> None:
  """Scale the feature extractor's output by ``factor``: its last conv
  (Regular, no BN after it), or its last BN's weight and bias (Sphere,
  whose ReLU after the BN keeps the scaling)."""
  from mode_tpu_torch.models.disparity import SphereFeatureExtraction
  fe = model.feature_extraction
  with torch.no_grad():
    if isinstance(fe, SphereFeatureExtraction):
      fe.lastconv[4][1].weight.mul_(factor)
      fe.lastconv[4][1].bias.mul_(factor)
    else:
      fe.lastconv[2].weight.mul_(factor)


def _record_calls(model, left, right):
  """Run one call and record the kernel calls of the model's layers:
  ``{(kernel, x shape (NHWC / NDHWC), Cout, residual, relu, dilation):
  [layer names]}`` in call order, and the summed classifier logits."""
  from mode_tpu_torch.models.blocks import (ConvBn2d, Conv3dWeight, ConvBn3d,
                                            DeconvBn3d, SphereConvBn)
  calls, logits = {}, []

  def conv_hook(name):
    def hook(mod, args, kwargs, out):
      a = inspect.signature(mod.forward).bind(*args, **kwargs).arguments
      xs, cout, dil = tuple(a["x"].shape), out.shape[-1], 1
      if isinstance(mod, (ConvBn2d, SphereConvBn)):
        if isinstance(mod, ConvBn2d) and not a.get("fused", False):
          return                           # F.conv2d, not a kernel of ours
        kernel = ("sphere_conv_bn_act" if isinstance(mod, SphereConvBn)
                  else "conv2d_s1_bn_act")
        xs = (xs[0], xs[2], xs[3], xs[1])  # the NHWC shape of an NCHW view
        cout = out.shape[1]
        if isinstance(mod, ConvBn2d):
          dil = mod[0].dilation[0]
      elif isinstance(mod, DeconvBn3d):
        kernel = "deconv3d_bn_act"
      else:
        stride = (mod if isinstance(mod, Conv3dWeight) else mod[0]).stride
        kernel = "conv3d_s1_bn_act" if stride == 1 else "conv3d_s2_bn_act"
      key = (kernel, xs, cout, a.get("residual") is not None,
             bool(a.get("relu", False)), dil)
      calls.setdefault(key, []).append(name)
    return hook

  # a ConvBn3d runs its conv itself, so a Conv3dWeight is called (and its
  # hook fires) only where it stands alone: the classifier heads' last conv
  kinds = (ConvBn3d, DeconvBn3d, Conv3dWeight, ConvBn2d, SphereConvBn)
  handles = [m.register_forward_hook(conv_hook(n), with_kwargs=True)
             for n, m in model.named_modules() if isinstance(m, kinds)]
  handles += [getattr(model, f"classif{i}").register_forward_hook(
      lambda mod, args, out: logits.append(out)) for i in (1, 2, 3)]
  with torch.no_grad():
    model(left, right)
  for h in handles:
    h.remove()
  return calls, sum(logits)


def _calibrate(model, left) -> float:
  """Scale the served model's features to unit std. With random weights
  nothing calibrates the BN statistics, and the feature extractor's
  residual blocks grow the activations to ~1e6."""
  with torch.no_grad():
    feat_std = float(model.feature_extraction(left).std())
  _scale_features(model, 1.0 / feat_std)
  return feat_std


def _scale_heads(model, raw_std: float) -> None:
  """Scale the three 1-channel classifier heads, which the final logits are
  linear in, so those have std ``LOGIT_STD``."""
  with torch.no_grad():
    for i in (1, 2, 3):
      getattr(model, f"classif{i}")[2].weight.mul_(LOGIT_STD / raw_std)


def _tpu_kernel(kernel, layers, batch):
  """The TPU kernel that ran these layers' calls."""
  if kernel == "conv2d_s1_bn_act":
    return "K8" if batch == 1 else "K9"
  folded = {TPU_FOLDED.get(seg) for n in layers for seg in n.split(".")}
  folded.discard(None)
  return folded.pop() if folded else TPU_KERNEL[kernel]


def _pairs(gen, batch, count, first_shift):
  """``count`` calls of ``batch`` random pairs; the right view is the left
  rolled along W by a shift that differs between pairs."""
  out = []
  for i in range(count):
    left = torch.randn((batch, H, W, 3), generator=gen, device=DEVICE) * 0.5
    right = torch.stack([torch.roll(left[b], shifts=first_shift + 8 * (
        i * batch + b) % 160, dims=1) for b in range(batch)])
    out.append((left, right.contiguous()))
  return out


def _check_output(label, pred, conf, ref_pred, ref_conf, batch):
  if pred.shape != (batch, H, W) or conf.shape != (batch, H, W):
    _fail(f"{label}: output shapes {tuple(pred.shape)} {tuple(conf.shape)}")
  if not (torch.isfinite(pred).all() and torch.isfinite(conf).all()):
    _fail(f"{label}: non-finite outputs")
  # conf sums three probabilities; a round(pred) at a border clips one tap
  # onto the border slice, counted twice, so only there may conf exceed 1
  rp = pred.round()
  inner = (rp >= 1) & (rp <= MAXDISP - 2)
  if (conf < 0).any() or (conf[inner] > 1 + 1e-5).any() or (conf > 2).any():
    _fail(f"{label}: confidence out of range")
  err = (pred - ref_pred).abs()
  conf_mae = float((conf - ref_conf).abs().mean())
  print(f"{label} vs plain path (f32, one call): pred MAE "
        f"{float(err.mean()):.3g} px (bar {PRED_MAE}), max "
        f"{float(err.max()):.3g} px (bar {PRED_MAX}), conf MAE {conf_mae:.3g}"
        f" (bar {CONF_MAE}); pred mean {float(pred.mean()):.3f} std "
        f"{float(pred.std()):.3f}, conf mean {float(conf.mean()):.4f}",
        flush=True)
  # as tests/test_torch_disparity.py: disparities spread and the softmax is
  # neither flat nor one-hot, so the comparison can see a wrong kernel
  if float(pred.std()) <= 0.5 or float(conf.mean()) >= 0.9:
    _fail(f"{label}: degenerate output: pred std must exceed 0.5 px and "
          "conf mean stay below 0.9")
  if (float(err.mean()) > PRED_MAE or float(err.max()) > PRED_MAX
      or conf_mae > CONF_MAE):
    _fail(f"{label}: the served path disagrees with its plain path")
  return {"pred_mae": float(err.mean()), "pred_max": float(err.max()),
          "conf_mae": conf_mae, "pred_std": float(pred.std()),
          "conf_mean": float(conf.mean())}


def _serve_path(label, model, gen, seed_shift):
  """Calibrate, record, serve and check one path; returns what it saw."""
  from mode_tpu_torch import kernels
  conv, batch, ncalls, jax_counts = PATHS[label]
  inputs = _pairs(gen, batch, ncalls + 1, seed_shift)
  calls, logits = _record_calls(model, *inputs[0])
  if label != "sphere_b6":          # the b6 path serves the b1 model as is
    _scale_heads(model, float(logits.std()))
  expect = {name: 0 for name in KERNELS}
  for case, layers in calls.items():
    expect[case[0]] += len(layers)
  expect["fused_disparity_regression"] = 1
  expect = {k: v for k, v in expect.items() if v}

  with torch.no_grad():
    model(*inputs[0])                                 # warm-up
    torch.cuda.synchronize()
    fe_ms = _time_ms(lambda: model.feature_extraction(inputs[0][0]), 3) * 2
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  kernels.reset_launches()
  outputs, call_ms = [], []
  for left, right in inputs[1:]:
    t = time.perf_counter()
    outputs.append(model(left, right))
    torch.cuda.synchronize()
    call_ms.append((time.perf_counter() - t) * 1e3)
  launches = dict(kernels.LAUNCHES)
  peak_gib = torch.cuda.max_memory_allocated() / 2**30
  unit = "pair" if batch == 1 else f"{batch}-pair call"
  print(f"{label}: {conv}, {ncalls} calls of ({batch}, {H}, {W}, 3) maxdisp "
        f"{MAXDISP}, median {statistics.median(call_ms):.2f} ms/{unit} "
        f"(all: " + ", ".join(f"{t:.2f}" for t in call_ms)
        + f"), feature extraction of both views {fe_ms:.2f} ms, peak memory "
        f"{peak_gib:.2f} GiB", flush=True)
  print(f"{label} launches per call: " + json.dumps(
      {k: launches.get(k, 0) / ncalls for k in KERNELS})
        + " (JAX path: " + ", ".join(jax_counts.values()) + ")", flush=True)
  for name in set(expect) | set(launches):
    if launches.get(name, 0) != expect.get(name, 0) * ncalls:
      _fail(f"{label}: {name} launched {launches.get(name, 0)} times in "
            f"{ncalls} calls, expected {expect.get(name, 0) * ncalls}")
  missing = [k for k in jax_counts if not expect.get(k)]
  if missing:
    _fail(f"{label}: kernels of the path not launched: {missing}")

  pred, conf = outputs[0]
  with torch.no_grad():
    ref_pred, ref_conf = model(*inputs[1], plain=True)
  torch.cuda.synchronize()
  check = _check_output(label, pred, conf, ref_pred, ref_conf, batch)
  return {"calls": calls, "batch": batch, "ncalls": ncalls,
          "launches": launches, "call_ms": call_ms, "fe_ms": fe_ms,
          "peak_gib": peak_gib, "check": check}


def _make_anchor_batch(seed: int, disp: int, h: int, w: int):
  """The inputs of ``tests/trained_mirror.py:_make_batch`` for one pair,
  made on the CPU: half-resolution noise upsampled x2 plus a coarse layer;
  the right view is the left rolled left by ``disp``. NCHW."""
  rng = np.random.default_rng(seed)
  fine = rng.normal(size=(3, h // 2, w // 2)).astype(np.float32)
  coarse = rng.normal(size=(3, h // 8, w // 8)).astype(np.float32)

  def up(a):
    return F.interpolate(torch.from_numpy(a)[None], size=(h, w),
                         mode="bilinear", align_corners=False)[0]

  left = up(fine) + 0.5 * up(coarse)
  return left[None], torch.roll(left, -disp, dims=2)[None]


def _anchor():
  """The whole flagship path with trained weights at the production shape,
  against the committed full-resolution frame."""
  from mode_tpu_torch.models.disparity import ModeDisparity
  from mode_tpu_torch.utils.convert import load_npz
  with np.load(ROOT / "tests/data/fullres_torch_frame.npz") as z:
    want_pred, want_conf = z["pred"], z["conf"]
    seed, disp = int(z["seed"]), int(z["disp"])
    maxdisp, h, w = int(z["maxdisp"]), int(z["h"]), int(z["w"])
  left, right = _make_anchor_batch(seed, disp, h, w)
  model = load_npz(ModeDisparity(maxdisp, out_conf=True, device=DEVICE),
                   ROOT / "tests/data/trained_mirror_mid.npz")
  with torch.no_grad():
    pred, conf = model(left.permute(0, 2, 3, 1).contiguous().to(DEVICE),
                       right.permute(0, 2, 3, 1).contiguous().to(DEVICE))
  err = np.abs(pred.cpu().numpy() - want_pred)
  conf_mae = float(np.abs(conf.cpu().numpy() - want_conf).mean())
  print(f"anchor: trained weights (trained_mirror_mid.npz) at "
        f"{h}x{w}/{maxdisp}, seed {seed}, disparity {disp}, against "
        f"fullres_torch_frame.npz: pred MAE {float(err.mean()):.3g} px (bar "
        f"{ANCHOR_MAE}), max {float(err.max()):.3g} px (bar {ANCHOR_MAX}), "
        f"conf MAE {conf_mae:.3g} (bar {ANCHOR_CONF_MAE}); pred mean "
        f"{float(pred.mean()):.3f}", flush=True)
  if (float(err.mean()) > ANCHOR_MAE or float(err.max()) > ANCHOR_MAX
      or conf_mae > ANCHOR_CONF_MAE):
    _fail("the flagship path disagrees with the full-resolution frame")
  return {"pred_mae": float(err.mean()), "pred_max": float(err.max()),
          "conf_mae": conf_mae}


def main() -> int:
  if not torch.cuda.is_available():
    print("chip_smoke: no CUDA device is available", file=sys.stderr)
    return 1
  from mode_tpu_torch.kernels import build
  from mode_tpu_torch.models.disparity import ModeDisparity

  t_start = time.time()
  smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
  card = smi.stdout.strip().splitlines()[0]
  print(card, flush=True)
  print(f"card: {card} (nvidia-smi name, power.limit); torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}", flush=True)
  torch.backends.cudnn.allow_tf32 = False
  torch.backends.cuda.matmul.allow_tf32 = False

  # ---- build
  t0 = time.time()
  build.build()
  print(f"build: {time.time() - t0:.1f} s for {len(build.SOURCES)} sources "
        f"(nvcc {' '.join(build.NVCC_FLAGS)})", flush=True)
  for name in build.SOURCES:
    log = (build.BUILD_DIR / f"{name}.log").read_text()
    regs = [int(t) for t in re.findall(r"Used (\d+) registers", log)]
    spills = [int(t) for t in re.findall(r"(\d+) bytes spill stores", log)]
    print(f"  ptxas {name}: {len(regs)} kernels, {min(regs)}-{max(regs)} "
          f"registers, spill stores up to {max(spills)} bytes", flush=True)

  # ---- served paths
  gen = torch.Generator(device=DEVICE).manual_seed(0)
  seen = {}
  for label, conv in (("regular_b1", "Regular"), ("sphere_b1", "Sphere")):
    model = ModeDisparity(MAXDISP, conv, out_conf=True, device=DEVICE,
                          generator=torch.Generator().manual_seed(0))
    _randomize_for_serving(model, 1)
    left = torch.randn((1, H, W, 3), generator=gen, device=DEVICE) * 0.5
    feat_std = _calibrate(model, left)
    print(f"{label}: features scaled by 1/{feat_std:.4g} to unit std",
          flush=True)
    seen[label] = _serve_path(label, model, gen, 4)
  seen["sphere_b6"] = _serve_path("sphere_b6", model, gen, 12)
  del model
  torch.cuda.empty_cache()

  # ---- kernel phase: every recorded shape once, f32 and bf16
  cases = {}                 # case -> {path: launches per call}, layers
  for label, s in seen.items():
    for case, layers in s["calls"].items():
      entry = cases.setdefault(case, ({}, layers, s["batch"]))
      entry[0][label] = len(layers)
  reg_cases = {((s["batch"], MAXDISP // 4, H // 4, W // 4), MAXDISP, H, W):
               {label: 1 for label, t in seen.items()
                if t["batch"] == s["batch"]} for s in seen.values()}
  rows = []
  for dtype in (torch.float32, torch.bfloat16):
    for case, (per_call, layers, batch) in cases.items():
      row = _conv_case(case, dtype, gen)
      row.update(per_call=per_call, tpu=_tpu_kernel(case[0], layers, batch),
                 layers=" ".join(layers[:4]) + (" ..." if len(layers) > 4
                                                else ""))
      rows.append(row)
      print("kernel " + json.dumps(row), flush=True)
    for case, per_call in reg_cases.items():
      row = _regression_case(case, dtype, gen)
      row.update(per_call=per_call, tpu="K2")
      rows.append(row)
      print("kernel " + json.dumps(row), flush=True)
  bad = [r for r in rows if not r["pass"]]
  if bad:
    _fail(f"{len(bad)} kernel comparisons out of tolerance: "
          + "; ".join(f"{r['name']} {r['dtype']} {r['shape']}" for r in bad))

  # ---- full-resolution anchor
  anchor = _anchor()

  # ---- summary: per kernel, the f32 time of each path's calls, each shape's
  # time alone times its launches per call, summed
  summary = []
  for name, (source, replaces) in KERNELS.items():
    f32 = [r for r in rows if r["name"] == name and r["dtype"] == "float32"]
    b16 = [r for r in rows if r["name"] == name and r["dtype"] == "bfloat16"]
    per_path = {}
    for label, s in seen.items():
      mine = [r for r in f32 if r["per_call"].get(label)]
      if not mine:
        continue

      def total(key, mine=mine, label=label):
        if any(r[key] is None for r in mine):
          return None
        return sum(r[key] * r["per_call"][label] for r in mine)

      per_path[label] = {
          "launches": s["launches"].get(name, 0),
          "launches_per_call": s["launches"].get(name, 0) / s["ncalls"],
          "pairs_per_call": s["batch"], "ms": total("kernel_ms"),
          "plain_ms": total("plain_ms"), "bound_ms": total("bound_ms"),
          "library_ms": total("library_ms"),
          "bound_by": ("operations" if total("ops_ms") >= total("bytes_ms")
                       else "bytes")}
    main = per_path[MAIN_PATH]
    summary.append({
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces[0], "also_replaces": list(replaces[1:]),
        "launches": main["launches"],
        "launches_per_pair": main["launches_per_call"],
        "max_abs_err": max(r["max_abs_err"] for r in f32),
        "max_abs_err_bf16": max(r["max_abs_err"] for r in b16),
        "ms": main["ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": main["library_ms"],
        "times": f"f32, ms per pair on the {MAIN_PATH} path: each shape's "
                 "time alone times its launches per pair, summed; per_path "
                 "gives every served path, per call",
        "per_path": per_path,
        "pass": all(r["pass"] for r in f32 + b16)})
  print("kernels: " + ", ".join(
      f"{s['name']} (replaces {', '.join(KERNELS[s['name']][1])}) "
      f"{'pass' if s['pass'] else 'FAIL'}" for s in summary))
  print("paths: " + json.dumps({label: {
      "median_ms_per_call": statistics.median(s["call_ms"]),
      "pairs_per_call": s["batch"], "fe_ms": s["fe_ms"],
      "peak_gib": s["peak_gib"], **s["check"]}
      for label, s in seen.items()} | {"anchor": anchor}))
  print(f"total {time.time() - t_start:.1f} s", flush=True)
  print(json.dumps({"kernels": summary}), flush=True)
  print(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count()}}), flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
