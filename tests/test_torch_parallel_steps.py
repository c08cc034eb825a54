"""The data-parallel steps of mode_tpu_torch against the JAX package's
``data=2`` mesh steps, with ``tests/test_torch_parallel.py``'s helpers and
bars (its docstring): the stage-1 step and the fusion step, each as two
gloo ranks started before the JAX step compiles, so that the two overlap.
"""

import jax
import numpy as np
import pytest
import torch

from mode_tpu.models import fusion as jfusion
from mode_tpu_torch.models import fusion as tfusion
from mode_tpu_torch.parallel.launch import run_ranks
from mode_tpu_torch.utils.convert import grads_from_jax
from tests import test_torch_fusion_train as fusion_train
from tests import test_torch_train_step as train_step
from tests import torch_parallel_ranks as ranks
from tests.background import started
from tests.port_weights import numpy_variables
from tests.test_torch_parallel import (MAXDISP, NOISE, NORM_BAR, NPZ,
                                       TIMEOUT, WORLD, _as_model, _batch,
                                       _fusion_ranks, _jax_fusion_step,
                                       _jax_stage1_step, _reversed)
from tests.test_torch_train_cli import _assert_state_matches

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def port_stage1_started():
  """The port's two ranks, started first: they run while the JAX step
  compiles."""
  return started(run_ranks, ranks.stage1_step, WORLD,
                  (NPZ, MAXDISP, _batch()), timeout=TIMEOUT, device="cpu",
                  threads=2)


@pytest.fixture(scope="module")
def jax_stage1(port_stage1_started):
  return _jax_stage1_step()


@pytest.fixture(scope="module")
def port_stage1(port_stage1_started):
  return port_stage1_started.result()


def test_stage1_step_matches_the_jax_mesh_step(jax_stage1, port_stage1):
  for out in port_stage1:
    assert out["same"], "the ranks parted"
    assert out["loss"] == port_stage1[0]["loss"]
  model = _as_model(port_stage1[0])
  train_step._assert_loss_matches(jax_stage1, (model, port_stage1[0]["loss"]))
  spread = train_step._port_spread((model, None))
  train_step._assert_gradients_match(jax_stage1, (model, None), spread)
  train_step._assert_bn_statistics_match(jax_stage1, (model, None))
  # Adam's step: the parameters after it against JAX's
  before = grads_from_jax(jax_stage1["before"])
  want = grads_from_jax(jax_stage1["after"])
  got = {n: p.detach() for n, p in model.named_parameters()}
  _assert_state_matches(got, want, before, 1e-3, 1e-6)
  # the all-reduce path ran: one broadcast per tensor, the BN and loss
  # sums, one gradient all-reduce
  assert port_stage1[0]["collectives"] > len(model.state_dict())


@pytest.fixture(scope="module")
def fusion_setup():
  wire = fusion_train._wire()
  zeros = [np.zeros((fusion_train.B, fusion_train.H, fusion_train.W, 1),
                    np.float32)] * 6
  views = [np.zeros((fusion_train.B, fusion_train.H, fusion_train.W, 3),
                    np.float32)] * 4
  shapes = jax.eval_shape(lambda: jfusion.ModeFusion(
      fusion_train.MAX_DEPTH, fusion_train.SMALL).init(
          jax.random.PRNGKey(0), zeros, zeros, views, False))
  variables = numpy_variables(shapes, 3,
                              head_scale=fusion_train.TRAIN_HEAD_SCALE)
  return wire, variables


def test_fusion_step_matches_the_jax_mesh_step(fusion_setup):
  """The seeded fusion net's f32 gradients are chaotic: a change in the
  order of the sums moves the median leaf by ~2% (a CPU thread count, in
  ``tests/test_torch_fusion_train.py``; splitting the batch over two ranks
  as much). So a leaf's spread is the one-process step's own, over thread
  counts (1, 2, 3) with the batch's two examples in order and swapped, the
  reordering of the batch sums that the split over ranks makes; the
  two-rank result itself never widens it. Since a spread can hide a leaf
  scaled by a constant (a gradient not averaged over the ranks is W times
  too large, and Adam's first step does not see the scale), each leaf whose
  spread is under ``NOISE`` of its norm also has its norm within
  ``NORM_BAR`` of JAX's (measured: at most 0.5% off; the leaves that are
  rounding noise, the biases whose gradient under the next BN is zero, are
  not held), and the whole gradient is held to JAX's in direction (cosine
  >= 0.999) and norm (within 1%), which rounding does not move (measured
  0.99996 and 0.01%)."""
  wire, variables = fusion_setup
  outs = started(_fusion_ranks, fusion_setup)
  want = _jax_fusion_step(variables, wire)
  outs = outs.result()
  for out in outs:
    assert out["same"], "the ranks parted"
  loss = outs[0]["loss"]
  assert abs(loss - want["loss"]) <= 1e-5 * abs(want["loss"]), (
      loss, want["loss"])
  got = {n: torch.from_numpy(g) for n, g in outs[0]["grads"].items()}

  def single(frame=wire):
    return fusion_train._grads(fusion_train._port_step(
        variables, frame, False, fusion_train.F32)[0])

  one = single()
  spread = fusion_train._spread(single, one)
  swapped = fusion_train._spread(lambda: single(_reversed(wire)), one)
  for name, g in single(_reversed(wire)).items():
    spread[name] = max(spread[name], swapped[name],
                       float(torch.linalg.vector_norm(g - one[name])))
  held = 0
  for name, g in got.items():
    norm = float(torch.linalg.vector_norm(want["grads"][name]))
    if spread[name] < NOISE * norm:
      held += 1
      ratio = float(torch.linalg.vector_norm(g)) / norm
      assert abs(ratio - 1) <= NORM_BAR, (name, ratio)
  print(f"{held} of {len(got)} leaves within {NORM_BAR} of JAX's norm")
  assert held >= 0.9 * len(got)
  flat = torch.cat([g.reshape(-1) for g in got.values()])
  ref = torch.cat([want["grads"][n].reshape(-1) for n in got])
  cos = float(flat @ ref / (flat.norm() * ref.norm()))
  ratio = float(flat.norm() / ref.norm())
  print(f"two-rank fusion gradient against JAX's: cosine {cos:.6f}, norm "
        f"ratio {ratio:.5f}")
  assert cos >= 0.999 and abs(ratio - 1) <= 1e-2, (cos, ratio)
  fusion_train._assert_grads_within_spread(got, want["grads"], spread)
  trained = tfusion.ModeFusion(fusion_train.MAX_DEPTH, fusion_train.SMALL,
                               device="cpu")
  trained.load_state_dict({k: torch.from_numpy(v)
                           for k, v in outs[0]["state"].items()})
  fusion_train._assert_bn_statistics_match(trained, want["stats"])
  before = grads_from_jax(want["before"])
  after = grads_from_jax(want["after"])
  lr = fusion_train.ttraining.FUSION_LR
  _assert_state_matches({n: p.detach() for n, p in trained.named_parameters()},
                        after, before, lr, lr / 2)
