"""The mixed-precision (bf16) stage-1 training step of mode_tpu_torch against
the JAX package's, on the CPU, and its routing.

One step of ``make_disparity_train_step(compute_dtype=torch.bfloat16)``
against ``mode_tpu.training.make_disparity_train_step(compute_dtype=
jnp.bfloat16)``: the Sphere Cassini model with the trained reference
weights (``tests/data/trained_mirror.npz``), the uint8 pair and ground
truth of ``tests/test_torch_train_step.py`` (64x32, maxdisp 16, batch 2),
whose helpers this file uses. Both steps keep f32 master weights and cast
the images and conv weights to bf16 inside the differentiated function.
The JAX bf16 step is built and run once per module (~50 s of XLA
compilation on the CPU).

Bars, with ``gap = ||jax_bf16 - f32||`` (what bf16 moves JAX's step from
its f32 twin): each quantity of the port's bf16 step lies near JAX's bf16
step, and away from the f32 step, so that a step which ignored
``compute_dtype`` fails. The gradients in global norm, ``||port_bf16 -
jax_bf16|| <= gap / 2`` and ``||port_bf16 - f32|| >= gap / 2`` (the trained
weights give a well-conditioned gradient: gap 9.3% of its norm,
``||port_bf16 - jax_bf16||`` 0.28 gap, ``||port_bf16 - f32||`` 1.0 gap,
measured); the BN running statistics within twice the gap and at least half
of it from f32; the loss within twice the larger of JAX's and the port's
own bf16-to-f32 gaps (a single scalar's gap is one draw of the rounding
noise) and at least half JAX's gap from the f32 loss. The f32 twin is the
port's f32 step, which ``tests/test_torch_train_step.py`` holds to JAX's
f32 step within 1e-4 of the gradients' norm (the median leaf within 1e-5):
rebuilding JAX's f32 step here would cost ~40 s more of
compilation. The parameters, their gradients, Adam's moments and the BN
statistics stay f32. The routing: at 64x32 no conv takes a kernel, in bf16
as in f32; at ``chip_smoke.py``'s ``train_b2_bf16`` shape the JAX gates
traced on the bf16 forward give its ``TRAIN_TRACED``, the f32 path's
counts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from mode_tpu import training as jtraining
from mode_tpu_torch.utils.convert import grads_from_jax
from tests.background import started
from tests.test_torch_train_step import (FAMILIES, MAXDISP, _batch,
                                         _count_jax, _count_port, _jax_state,
                                         _numpy, _port_run)

torch.set_num_threads(2)


def _jax_bf16_step():
  model, optimizer, state = _jax_state()
  step = jtraining.make_disparity_train_step(model, optimizer,
                                             compute_dtype=jnp.bfloat16)
  left, right, gt = _batch(0)
  state, loss = step(state, jnp.asarray(left), jnp.asarray(right),
                     jnp.asarray(gt))
  mu = state.opt_state.inner_state[0].mu
  return {"loss": float(loss), "stats": _numpy(state.batch_stats),
          "grads": jax.tree_util.tree_map(lambda m: np.asarray(m) / 0.1, mu),
          "params": state.params}


@pytest.fixture(scope="module")
def steps():
  """JAX's bf16 step and the port's bf16 and f32 steps, from the same
  weights on the same batch (the JAX step in a thread of its own, while
  the port's run)."""
  jax_bf16 = started(_jax_bf16_step)
  optimizers = []
  port_bf16 = _port_run(compute_dtype=torch.bfloat16,
                        optimizer_out=optimizers)
  return {"port_bf16": port_bf16, "port_f32": _port_run(),
          "optimizer": optimizers[0], "jax_bf16": jax_bf16.result()}


def _dist(a, b):
  return sum(float(torch.linalg.vector_norm(a[k] - b[k]))**2 for k in a)**0.5


def _stats(model_or_tree):
  """BN running statistics by port name: from a model, or from a JAX
  ``batch_stats`` tree."""
  if isinstance(model_or_tree, torch.nn.Module):
    return {k: v for k, v in model_or_tree.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}
  out = {}
  for path, value in jax.tree_util.tree_leaves_with_path(model_or_tree):
    keys = [p.key for p in path]
    out[".".join(keys[:-1]) + (".running_mean" if keys[-1] == "mean"
                               else ".running_var")] = torch.from_numpy(
                                   np.asarray(value))
  return out


def _grads(model):
  return {n: p.grad for n, p in model.named_parameters()}


def _readings(got, jb, f32):
  """``||got - jax_bf16||`` and ``||got - f32||`` in units of the gap
  ``||jax_bf16 - f32||``, and the gap in units of ``||jax_bf16||``;
  printed."""
  gap = _dist(jb, f32)
  norm = _dist(jb, {k: torch.zeros_like(v) for k, v in jb.items()})
  out = {"to_jax_bf16": _dist(got, jb) / gap, "to_f32": _dist(got, f32) / gap,
         "gap_over_norm": gap / norm}
  print(out)
  return out


def test_bf16_loss_matches_jax(steps):
  jb = steps["jax_bf16"]["loss"]
  pb, pf = steps["port_bf16"][1], steps["port_f32"][1]
  assert np.isfinite(pb) and pb > 0
  assert 0 < abs(pb - jb) <= 2 * max(abs(jb - pf), abs(pb - pf)), (pb, jb,
                                                                  pf)
  assert abs(pb - pf) >= 0.5 * abs(jb - pf), (pb, jb, pf)


def test_bf16_gradients_match_jax(steps):
  got = _grads(steps["port_bf16"][0])
  jb = grads_from_jax(steps["jax_bf16"]["grads"])
  f32 = _grads(steps["port_f32"][0])
  assert set(got) == set(jb)
  r = _readings(got, jb, f32)
  assert 0 < r["gap_over_norm"] < 0.5, r
  assert r["to_jax_bf16"] <= 0.5 and r["to_f32"] >= 0.5, r


def test_bf16_bn_statistics_match_jax(steps):
  got = _stats(steps["port_bf16"][0])
  jb, jf = _stats(steps["jax_bf16"]["stats"]), _stats(steps["port_f32"][0])
  assert set(got) == set(jb) and all(v.dtype == torch.float32
                                     for v in got.values())
  r = _readings(got, jb, jf)
  assert 0 < r["to_jax_bf16"] <= 2 and r["to_f32"] >= 0.5, r


def test_bf16_step_keeps_f32_masters(steps):
  """The parameters, their gradients and Adam's moments are f32 after the
  bf16 step, as JAX's master parameters are."""
  model = steps["port_bf16"][0]
  optimizer = steps["optimizer"]
  jax_dtypes = {a.dtype for a in jax.tree_util.tree_leaves(
      steps["jax_bf16"]["params"])}
  assert jax_dtypes == {np.dtype(np.float32)}
  for name, p in model.named_parameters():
    state = optimizer.state[p]
    assert p.dtype == p.grad.dtype == torch.float32, name
    assert state["exp_avg"].dtype == state["exp_avg_sq"].dtype == (
        torch.float32), name


def test_no_kernel_at_the_small_test_shape_in_bf16(monkeypatch):
  zero = dict.fromkeys(FAMILIES, 0)
  assert _count_jax(monkeypatch, 2, 64, 32, MAXDISP,
                    dtype=jnp.bfloat16) == zero
  assert _count_port(monkeypatch, 2, 64, 32, MAXDISP,
                     dtype=torch.bfloat16) == zero


def test_chip_smoke_expects_the_bf16_traced_launches(monkeypatch):
  """``chip_smoke.py``'s ``train_b2_bf16``: the JAX gates traced on the
  bf16 forward at its shape give its ``TRAIN_TRACED``, which are the f32
  path's counts."""
  sphere_type, batch, (h, w), dtype = chip_smoke.TRAINS["train_b2_bf16"]
  assert dtype == torch.bfloat16
  traced = _count_jax(monkeypatch, batch, h, w, chip_smoke.MAXDISP,
                      sphere_type, dtype=jnp.bfloat16)
  assert traced == chip_smoke.TRAIN_TRACED["train_b2_bf16"]
  assert traced == chip_smoke.TRAIN_TRACED["train_b2"]
