#!/usr/bin/env python3
"""How far two f32 stage-1 training steps that compute the same sum lie
apart on the training CLI's batch, leaf by leaf, on one CUDA card.

    python3 scripts/train_cli_step_noise.py

Builds the port's kernels and ``chip_smoke.py``'s Deep360 tree, takes the
batch that ``train_disparity``'s first step takes in ``chip_smoke.py``'s
``train_cli`` phase (batch 4 of 1024x512 pairs, shuffle seed 123, epoch
1) and the trained mid-resolution weights, and runs the f32 step
(``make_disparity_train_step`` with a fresh Adam) from those weights on
it: through the kernels and through their plain versions, each on the
batch as it comes and on the batch in reverse order (the same loss and
gradient in exact arithmetic: the batch only sums in another order), and
each step on ``STEP_BARS``'s jittered inputs (``chip_smoke.grad_check``'s
spread, and the same for the kernel step). For every leaf it reads,
relative to the plain step's gradient norm: the kernel step's distance to
the plain step, each step's distance to itself on the reversed batch, and
the two jitter spreads. Whether a batch position changes what a kernel
computes for a pair: the gradient of the loss with respect to the input
images, with every BN on its running statistics (so a pair's result
depends on that pair alone and the batch's order only permutes it), on
the batch and on the reversed batch, must agree bit for bit, through the
kernels (forward and grad-input) and through the plain versions. Last,
each recorded kernel call of the kernel step is held against its plain
version at ``chip_smoke.py``'s elementwise bars (``TOL``).

Prints the card's name and power limit first, then one JSON line per
leaf among the 12 whose kernel distance is largest, then the kernel rows
(f32 and bf16), then a JSON summary; exits non-zero without a card.
"""

from __future__ import annotations

import copy
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402

SHOWN = 12


def _grads(model, inputs, plain, order):
  """One f32 step of a copy of ``model`` on the batch taken in ``order``:
  its loss and ``{leaf: gradient}``."""
  m = copy.deepcopy(model)
  step = cs._stage1_step(m, plain=plain)
  loss = float(step(*[x[order] for x in inputs]))
  return loss, {n: p.grad.clone() for n, p in m.named_parameters()}


def _input_grads(model, inputs, plain, order):
  """d loss / d (left, right) of a copy of ``model`` in training with every
  BN on its running statistics, on the batch taken in ``order``, put back
  in the batch's own order."""
  from mode_tpu_torch.device import ieee_f32_convs
  from mode_tpu_torch.models.blocks import TorchBatchNorm
  from mode_tpu_torch.utils.losses import disparity_deep_supervision
  m = copy.deepcopy(model).train()
  for mod in m.modules():
    if isinstance(mod, TorchBatchNorm):
      mod.eval()
  left, right, gt = (x[order].clone() for x in inputs)
  left.requires_grad_()
  right.requires_grad_()
  mask = ~torch.isnan(gt)
  with ieee_f32_convs():
    preds = m(left, right, plain=plain)
    disparity_deep_supervision(preds, torch.where(mask, gt, 0.0),
                               mask).backward()
  back = [order.index(i) for i in range(len(order))]
  return torch.cat([left.grad[back], right.grad[back]])


def _spread(stepper, ref, draws, jitter, **kw):
  """The largest distance of ``ref`` to ``stepper``'s gradients on
  ``draws`` jittered inputs (the jitter drawn from seed 7), by leaf."""
  jgen = torch.Generator(device=cs.DEVICE).manual_seed(7)
  spread = dict.fromkeys(ref, 0.0)
  for _ in range(draws):
    _, other = stepper(jgen, jitter, **kw)
    for n, g in other.items():
      spread[n] = max(spread[n], float(torch.linalg.vector_norm(
          g - ref[n])))
  return spread


def _rel(a, b, norms):
  return {n: float(torch.linalg.vector_norm(a[n] - b[n]))
          / max(norms[n], 1e-30) for n in norms}


def main() -> int:
  if not torch.cuda.is_available():
    print("train_cli_step_noise: no CUDA device is available",
          file=sys.stderr)
    return 1
  from mode_tpu_torch.cli import common
  from mode_tpu_torch.data.deep360 import Deep360DatasetDisparity
  from mode_tpu_torch.data.file_lists import list_deep360_disparity_train
  from mode_tpu_torch.data.loader import DataLoader
  from mode_tpu_torch.device import ieee_f32_convs
  from mode_tpu_torch.kernels import build
  from mode_tpu_torch.models.disparity import ModeDisparity
  from mode_tpu_torch.models.fusion import ModeFusion
  card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                         "--format=csv,noheader"], capture_output=True,
                        text=True, timeout=60, check=True).stdout.strip()
  print(card, flush=True)
  build.build()
  h, w = cs.GEOMETRY["Cassini"]
  fusion_state = ModeFusion(cs.MAX_DEPTH, device="cpu").state_dict()
  with tempfile.TemporaryDirectory() as tmp:
    data, _, _, disp_tar, _, _ = cs._cli_setup(Path(tmp), fusion_state)
    lists = list_deep360_disparity_train(str(data))
    ds = Deep360DatasetDisparity(*lists[:3], shape=(h, w))
    loader = DataLoader(ds, batch_size=cs.TRAIN_CLI_BATCH, num_workers=4,
                        shuffle=True, seed=123)
    loader.set_epoch(1)
    batch = next(iter(loader))
    inputs = [torch.from_numpy(batch[k]).to(cs.DEVICE)
              for k in ("leftImg", "rightImg", "dispMap")]
    model = ModeDisparity(cs.MAXDISP, device=cs.DEVICE)
    common.load_model_checkpoint(disp_tar, model)

  fwd = list(range(cs.TRAIN_CLI_BATCH))
  rev = fwd[::-1]
  with cs._recorded_launches() as calls:
    k_loss, kernel = _grads(model, inputs, False, fwd)
  _, kernel_rev = _grads(model, inputs, False, rev)
  p_loss, plain = _grads(model, inputs, True, fwd)
  _, plain_rev = _grads(model, inputs, True, rev)
  stepper = cs.plain_stepper(model, cs._stage1_step, inputs)
  bars = cs.STEP_BARS[torch.float32]
  spread = _spread(stepper, plain, bars["draws"], bars["jitter"])
  kspread = _spread(stepper, kernel, bars["draws"], bars["jitter"],
                    plain=False)
  position = {}
  for label, plain_path in (("kernels", False), ("plain", True)):
    a = _input_grads(model, inputs, plain_path, fwd)
    b = _input_grads(model, inputs, plain_path, rev)
    position[label] = float((a - b).abs().max())
    print(f"input gradients on the reversed batch against the batch "
          f"({label}): largest difference {position[label]:.3g} (of "
          f"{float(a.abs().max()):.3g})", flush=True)
  norms = {n: float(torch.linalg.vector_norm(g)) for n, g in plain.items()}
  k_vs_p = _rel(kernel, plain, norms)
  p_vs_p = _rel(plain_rev, plain, norms)
  k_vs_k = _rel(kernel_rev, kernel, norms)
  rows = []
  for n in sorted(norms, key=lambda n: -k_vs_p[n])[:SHOWN]:
    rows.append({"leaf": n, "kernel_vs_plain": k_vs_p[n],
                 "plain_reversed_vs_plain": p_vs_p[n],
                 "kernel_reversed_vs_kernel": k_vs_k[n],
                 "jitter_spread": spread[n] / norms[n],
                 "kernel_jitter_spread": kspread[n] / norms[n]})
    print(json.dumps(rows[-1]), flush=True)

  cases = {case: ({"train_cli_disp_f32": len(layers)}, layers,
                  cs.TRAIN_CLI_BATCH) for case, layers in calls.items()}
  with ieee_f32_convs():
    kernel_rows = [
        r for r in cs._kernel_phase(cases, {}, torch.Generator(
            device=cs.DEVICE).manual_seed(0)) if r["dtype"] == "float32"]
  summary = {
      "card": card, "leaves": len(norms), "loss": k_loss,
      "plain_loss": p_loss, "loss_rel": abs(k_loss - p_loss) / abs(p_loss),
      "leaves_kernel_vs_plain_over_1e-3": sum(v > 1e-3 for v in
                                              k_vs_p.values()),
      "leaves_plain_reversed_over_1e-3": sum(v > 1e-3 for v in
                                             p_vs_p.values()),
      "leaves_kernel_reversed_over_1e-3": sum(v > 1e-3 for v in
                                              k_vs_k.values()),
      "max_kernel_vs_plain": max(k_vs_p.values()),
      "max_plain_reversed_vs_plain": max(p_vs_p.values()),
      "max_kernel_reversed_vs_kernel": max(k_vs_k.values()),
      "input_grads_position_diff": position,
      "kernel_cases_f32": len(kernel_rows),
      "kernel_cases_f32_pass": sum(r["pass"] for r in kernel_rows),
      "kernel_max_rel_err_f32": max(r["max_rel_err"] for r in kernel_rows)}
  print(json.dumps(summary), flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
