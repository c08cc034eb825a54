"""The training Functions of mode_tpu_torch's conv ops (CPU, f32):
each Function's gradients, whose grad-input runs the port's kernel (here its
plain version) with the adjoint's weight layout, against autograd of the
plain forward. This holds the adjoint identities and the weight layouts the
card will use: the flipped, io-swapped weight of the stride-1 convs, the
same tensor read as the transpose conv's weight for the stride-2 conv, and
as the conv's weight for the deconv; and the Functions' training gates
against the JAX package's.

Bar 1e-5 relative to the largest gradient, f32: both sides sum the same
products in other orders.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mode_tpu.ops.pallas import conv2d_kernel as c2k
from mode_tpu.ops.pallas import conv3d_kernel as c3k
from mode_tpu_torch.ops import conv2d as conv2d_ops
from mode_tpu_torch.ops import conv3d as conv3d_ops
from mode_tpu_torch.ops import sphere_conv as sphere_ops

torch.set_num_threads(2)


def _tensor(rng, shape, scale=1.0):
  return torch.from_numpy((rng.normal(size=shape) * scale).astype(
      np.float32)).requires_grad_()


def _assert_grads(fn, ref, inputs, out_shape, seed):
  """``fn`` and ``ref`` on the same inputs: same output, and the same
  gradients of ``<out, g>`` for a random cotangent ``g``."""
  g = torch.from_numpy(np.random.default_rng(seed).normal(
      size=out_shape).astype(np.float32))
  got = fn(*inputs)
  want = ref(*inputs)
  assert got.shape == want.shape == out_shape
  torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
  gots = torch.autograd.grad(got, inputs, g)
  wants = torch.autograd.grad(want, inputs, g)
  for a, b in zip(gots, wants):
    assert a.shape == b.shape
    scale = float(b.abs().max())
    assert float((a - b).abs().max()) <= 1e-5 * scale, (
        float((a - b).abs().max()), scale)


def _ncdhw(x):
  return x.permute(0, 4, 1, 2, 3)


@pytest.mark.parametrize("x_shape,cout", [((2, 4, 6, 8, 8), 16),
                                          ((1, 3, 5, 4, 16), 8)])
def test_stride1_conv3d_gradients(x_shape, cout):
  rng = np.random.default_rng(0)
  x = _tensor(rng, x_shape)
  w = _tensor(rng, (cout, x_shape[-1], 3, 3, 3), 0.2)
  _assert_grads(
      lambda a, b: conv3d_ops.conv3d_train(a, b, 1),
      lambda a, b: F.conv3d(_ncdhw(a), b, padding=1).permute(0, 2, 3, 4, 1),
      (x, w), (*x_shape[:4], cout), 1)


@pytest.mark.parametrize("x_shape,cout", [((2, 4, 6, 8, 8), 16),
                                          ((1, 2, 4, 6, 16), 8)])
def test_stride2_conv3d_gradients(x_shape, cout):
  """The grad-input is the deconv kernel with the conv's own weight."""
  rng = np.random.default_rng(2)
  x = _tensor(rng, x_shape)
  w = _tensor(rng, (cout, x_shape[-1], 3, 3, 3), 0.2)
  out = (x_shape[0], *[n // 2 for n in x_shape[1:4]], cout)
  _assert_grads(
      lambda a, b: conv3d_ops.conv3d_train(a, b, 2),
      lambda a, b: F.conv3d(_ncdhw(a), b, stride=2,
                            padding=1).permute(0, 2, 3, 4, 1),
      (x, w), out, 3)


@pytest.mark.parametrize("x_shape,cout", [((2, 2, 3, 4, 16), 8),
                                          ((1, 3, 2, 2, 8), 16)])
def test_deconv3d_gradients(x_shape, cout):
  """The grad-input is the stride-2 kernel with the deconv's own weight,
  and the grad-weight the stride-2 conv's, with the roles swapped."""
  rng = np.random.default_rng(4)
  x = _tensor(rng, x_shape)
  w = _tensor(rng, (x_shape[-1], cout, 3, 3, 3), 0.2)
  out = (x_shape[0], *[2 * n for n in x_shape[1:4]], cout)
  _assert_grads(
      lambda a, b: conv3d_ops.deconv3d_train(a, b),
      lambda a, b: F.conv_transpose3d(_ncdhw(a), b, stride=2, padding=1,
                                      output_padding=1).permute(
                                          0, 2, 3, 4, 1),
      (x, w), out, 5)


def test_stride2_conv3d_refuses_odd_extents():
  x = torch.zeros((1, 3, 4, 4, 8))
  with pytest.raises(ValueError, match="even"):
    conv3d_ops.conv3d_train(x, torch.zeros((8, 8, 3, 3, 3)), 2)


@pytest.mark.parametrize("dilation", [1, 2])
@pytest.mark.parametrize("x_shape,cout", [((2, 9, 10, 8), 16),
                                          ((3, 6, 5, 16), 8)])
def test_conv2d_gradients(x_shape, cout, dilation):
  rng = np.random.default_rng(6)
  x = _tensor(rng, x_shape)
  w = _tensor(rng, (cout, x_shape[-1], 3, 3), 0.2)
  _assert_grads(
      lambda a, b: conv2d_ops.conv2d_train(a, b, dilation),
      lambda a, b: F.conv2d(a.permute(0, 3, 1, 2), b, padding=dilation,
                            dilation=dilation).permute(0, 2, 3, 1),
      (x, w), (*x_shape[:3], cout), 7)


@pytest.mark.parametrize("x_shape,cout", [((2, 32, 16, 8), 16),
                                          ((1, 64, 32, 16), 8)])
def test_sphere_conv_gradients(x_shape, cout):
  """The Function's backward is the explicit transpose of the gather
  (``sphere_conv_backward``), not autograd; here against autograd of the
  plain forward."""
  rng = np.random.default_rng(8)
  x = _tensor(rng, x_shape)
  w = _tensor(rng, (cout, x_shape[-1], 3, 3), 0.2)
  _assert_grads(sphere_ops.sphere_conv_train, sphere_ops.sphere_conv,
                (x, w), (*x_shape[:3], cout), 9)


def test_functions_pass_the_weight_gradient_to_the_parameter():
  """The Functions take the torch-layout Parameter and pack it inside, so
  ``.grad`` reaches it, also after an in-place update of the weight."""
  rng = np.random.default_rng(10)
  w = torch.nn.Parameter(torch.from_numpy(
      rng.normal(size=(8, 8, 3, 3, 3)).astype(np.float32)))
  x = torch.from_numpy(rng.normal(size=(2, 2, 4, 4, 8)).astype(np.float32))
  for _ in range(2):
    w.grad = None
    conv3d_ops.conv3d_train(x, w, 1).sum().backward()
    assert w.grad is not None and w.grad.shape == w.shape
    with torch.no_grad():
      w.sub_(0.01 * w.grad)


@pytest.mark.parametrize("x_shape,cout", [
    ((2, 48, 256, 128, 64), 32),      # dres0.0, 1/4 level
    ((2, 24, 128, 64, 64), 64),       # hourglass conv2, 1/8 level
    ((2, 12, 64, 32, 64), 64),        # conv4, 1/16: no lane axis
    ((2, 48, 256, 128, 32), 1),       # a classifier head
    ((1, 48, 256, 128, 32), 32),      # batch 1
])
def test_stride1_gate_is_the_jax_gate(monkeypatch, x_shape, cout):
  monkeypatch.setattr(c3k, "_CONV3D_MODE", "on")
  assert (conv3d_ops.train_s1_eligible(x_shape, cout)
          == c3k.train_conv3d_eligible(x_shape, cout))


@pytest.mark.parametrize("x_shape,cout", [
    ((2, 48, 256, 128, 32), 64),      # hourglass conv1
    ((2, 24, 128, 64, 64), 64),       # conv3: its grad-input deconv folds
    ((1, 4, 16, 8, 32), 64),          # no lane axis
])
def test_stride2_and_deconv_gates_are_the_jax_gates(monkeypatch, x_shape,
                                                    cout):
  monkeypatch.setattr(c3k, "_CONV3D_MODE", "on")
  assert (conv3d_ops.train_s2_eligible(x_shape, cout)
          == c3k.train_s2_eligible(x_shape, cout, 2))
  half = (x_shape[0], *[n // 2 for n in x_shape[1:4]], cout)
  assert (conv3d_ops.train_deconv_eligible(half, x_shape[-1])
          == c3k.train_deconv_eligible(half, x_shape[-1], 2))


@pytest.mark.parametrize("x_shape,cout", [
    ((2, 512, 256, 32), 32), ((2, 256, 128, 64), 64), ((1, 512, 256, 32), 32),
    ((5, 256, 128, 64), 64), ((2, 16, 8, 64), 64), ((2, 256, 128, 3), 32)])
def test_conv2d_gate_is_the_jax_gate(monkeypatch, x_shape, cout):
  monkeypatch.setattr(c3k, "_CONV3D_MODE", "on")
  assert (conv2d_ops.train_kernel_eligible(x_shape, cout)
          == (c2k.train_bpack2d_g(x_shape, cout) is not None))
