"""The stage-1 training step of the ERP Sphere model in mode_tpu_torch
against the JAX package's, f32 on the CPU, and which convs take the port's
kernels in training.

One step of ``mode_tpu_torch.training.make_disparity_train_step`` against
``mode_tpu.training.make_disparity_train_step`` on
``ModeDisparity(16, "Sphere", "ERP")`` with the trained reference weights
(``tests/data/trained_mirror.npz`` on both sides; the ERP model has the
Cassini model's parameters), a uint8 ERP pair and ground truth with a NaN
patch, 32x64, maxdisp 16, batch 2: the bars and the spread method of
``tests/test_torch_train_step.py``, whose helpers this file uses.

The JAX step it is held against runs in f64 (``compute_dtype=float64``
under ``jax.enable_x64``). At this operating point the JAX package's own
f32 step parts from its f64 step by more than 1e-4 of the norm on some
leaves of the first ERP block, while the port's f32 step stays within 1e-5
of it; ``test_erp_port_f32_is_nearer_the_f64_step_than_jax_f32`` shows
both. So the f32 JAX step is no reference at the 1e-4 bar, and the f64 one
is.

Both JAX steps are built in one module fixture, in two threads.

The routing: the JAX package's Pallas training gates traced with counting
stubs (``_count_jax``) against the port's Functions at 256x512, and at each
of ``chip_smoke.py``'s training paths against the launch counts it expects.
"""

import pytest
import torch

import chip_smoke
from mode_tpu_torch.utils.convert import grads_from_jax
from tests.background import started
from tests.test_torch_train_step import (FAMILIES, MAXDISP,
                                         _assert_bn_statistics_match,
                                         _assert_gradients_match,
                                         _assert_loss_matches, _count_jax,
                                         _count_port, _jax_step, _port_run,
                                         _port_spread)

torch.set_num_threads(2)

ERP = ("ERP", 32, 64)


@pytest.fixture(scope="module")
def jax_steps_started():
  """The JAX step in f64 and in f32, each built and run in a thread of its
  own (tracing takes turns, XLA compiles the two at once; ``x64`` is a
  thread's own setting)."""
  return {"f64": started(_jax_step, *ERP, x64=True),
          "f32": started(_jax_step, *ERP)}


@pytest.fixture(scope="module")
def jax_steps(jax_steps_started, port_step, port_spread):
  """(The port's step and its spread run meanwhile, in this thread.)"""
  return {k: f.result() for k, f in jax_steps_started.items()}


@pytest.fixture(scope="module")
def jax_step(jax_steps):
  return jax_steps["f64"]


@pytest.fixture(scope="module")
def port_step():
  return _port_run(*ERP)


@pytest.fixture(scope="module")
def port_spread(port_step):
  return _port_spread(port_step, *ERP)


def test_erp_loss_matches_jax(jax_step, port_step):
  _assert_loss_matches(jax_step, port_step)


def test_erp_gradients_match_jax(jax_step, port_step, port_spread):
  _assert_gradients_match(jax_step, port_step, port_spread)


def test_erp_bn_statistics_match_jax(jax_step, port_step):
  _assert_bn_statistics_match(jax_step, port_step)


def test_erp_port_f32_is_nearer_the_f64_step_than_jax_f32(jax_steps,
                                                          port_step):
  """Each leaf's distance from the f64 JAX step, relative to its norm: the
  port's f32 gradients within 1e-5 on every leaf, the JAX package's f32
  gradients beyond 1e-4 on some."""
  want = grads_from_jax(jax_steps["f64"]["grads"])
  jax_f32 = grads_from_jax(jax_steps["f32"]["grads"])
  model, _ = port_step

  def rel(got):
    return {name: float(torch.linalg.vector_norm(got[name].double() - ref)
                        / torch.linalg.vector_norm(ref))
            for name, ref in want.items()}

  port = rel({name: p.grad for name, p in model.named_parameters()})
  jax32 = rel(jax_f32)
  assert max(port.values()) <= 1e-5, max(port.items(), key=lambda kv: kv[1])
  assert max(jax32.values()) > 1e-4, max(jax32.values())


@pytest.mark.parametrize("batch,want", [
    # 256x512: the 1/4-level volume is (48, 64, 128), its W on the lanes.
    # batch 2: the 1/4-level stride-1 convs (dres 4, classif 3), conv1 of
    # each hourglass and conv6; every stride-1 3x3 FE conv (32 per view)
    # and the 16 ERP sphere convs per view.
    (2, {"conv3d_s1": 7, "conv3d_s2": 3, "deconv3d": 3, "conv2d": 64,
         "sphere": 32}),
    # batch 1: the stride-1 3-D and the 2-D convs need batch >= 2
    (1, {"conv3d_s1": 0, "conv3d_s2": 3, "deconv3d": 3, "conv2d": 0,
         "sphere": 32}),
])
def test_erp_training_routes_as_the_jax_package(monkeypatch, batch, want):
  jax_calls = _count_jax(monkeypatch, batch, 256, 512, 16, "ERP")
  port_calls = _count_port(monkeypatch, batch, 256, 512, 16, "ERP")
  assert jax_calls == want
  assert port_calls == want


def test_no_kernel_at_the_small_erp_shape(monkeypatch):
  """At 32x64 no axis reaches the TPU kernels' 128 lanes: the train-step
  comparison above holds the ERP layers' training semantics on PyTorch
  autograd, and the ERP Function is held in
  tests/test_torch_erp_sphere_conv.py."""
  zero = dict.fromkeys(FAMILIES, 0)
  assert _count_jax(monkeypatch, 2, *ERP[1:], MAXDISP, "ERP") == zero
  assert _count_port(monkeypatch, 2, *ERP[1:], MAXDISP, "ERP") == zero


@pytest.mark.parametrize("label", sorted(chip_smoke.TRAINS))
def test_chip_smoke_expects_the_traced_launches(monkeypatch, label):
  """``chip_smoke.py``'s launch counts per training step are the JAX
  package's gates traced at the path's full shape and batch: in both
  layouts 20, 12, 12 and 128 of the 3-D and 2-D kernels and 32 of each
  sphere kernel of the path's layout."""
  sphere_type, batch, (h, w) = chip_smoke.TRAINS[label][:3]
  traced = chip_smoke.TRAIN_TRACED[label]
  assert _count_jax(monkeypatch, batch, h, w, chip_smoke.MAXDISP,
                    sphere_type) == traced
  expect = chip_smoke.train_expect(label)
  assert expect["conv3d_s1_bn_act"] == 20
  assert expect["conv3d_s2_bn_act"] == expect["deconv3d_bn_act"] == 12
  assert expect["conv2d_s1_bn_act"] == 128
  sphere = {k: v for k, v in expect.items() if k.startswith("sphere")}
  assert sphere == dict.fromkeys(chip_smoke.SPHERE_KERNELS[sphere_type], 32)
