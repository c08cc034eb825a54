"""mode_tpu_torch.ops.conv3d (plain path, CPU, f32) against the JAX package's
Pallas conv3d kernels in interpret mode, at the shapes the JAX kernel tests
use. The JAX side takes lane-major (B, D, M, C, L) volumes; the port takes
NDHWC, so layouts are converted on the JAX side with ``ck.to_lane_major``
and ``ck.weight_lane_major``.

Tolerance rtol = atol = 1e-5, as the JAX kernel tests use: both sides sum
27 * Cin f32 products, in different orders.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from mode_tpu.ops.pallas import conv3d_kernel as ck
from mode_tpu_torch.ops.conv3d import (conv3d_s1_bn_act, conv3d_s2_bn_act,
                                       deconv3d_bn_act, pack_weight,
                                       pack_weight_tc)

torch.set_num_threads(2)


@pytest.fixture
def interpret_pallas(monkeypatch):
  orig = pl.pallas_call
  monkeypatch.setattr(pl, "pallas_call",
                      functools.partial(orig, interpret=True))


def _inputs(seed, x_shape, w_shape, cout, res_shape=None):
  rng = np.random.default_rng(seed)
  x = (rng.normal(size=x_shape) * 0.3).astype(np.float32)
  w = (rng.normal(size=w_shape) * 0.1).astype(np.float32)
  scale = (rng.normal(size=(cout,)) * 0.2 + 1.0).astype(np.float32)
  bias = (rng.normal(size=(cout,)) * 0.1).astype(np.float32)
  res = (None if res_shape is None
         else (rng.normal(size=res_shape) * 0.3).astype(np.float32))
  return x, w, scale, bias, res


def _t(a):
  return None if a is None else torch.from_numpy(a)


def _conv_weight(w_dhwio):
  """Flax (3, 3, 3, I, O) -> torch (O, I, 3, 3, 3)."""
  return torch.from_numpy(np.ascontiguousarray(
      np.transpose(w_dhwio, (4, 3, 0, 1, 2))))


@pytest.mark.parametrize("shape,cout,res,relu", [
    ((1, 4, 8, 128, 8), 16, False, True),     # lanes = W
    ((2, 4, 16, 128, 16), 8, True, True),     # batch, residual
    ((1, 4, 128, 16, 8), 8, True, False),     # lanes = H
    ((1, 8, 24, 256, 8), 8, False, False),    # 256 lanes, odd-ish M
    ((1, 4, 8, 128, 8), 1, False, False),     # narrow head (Cout 1)
])
def test_conv3d_s1_vs_band_pallas(interpret_pallas, shape, cout, res, relu):
  b, d, h, w, c = shape
  x, wgt, scale, bias, r = _inputs(0, shape, (3, 3, 3, c, cout), cout,
                                   (b, d, h, w, cout) if res else None)
  la = ck.lane_axis_for(shape)
  want = ck.from_lane_major(ck.conv3d_band_pallas(
      ck.to_lane_major(jnp.asarray(x), la),
      ck.weight_lane_major(jnp.asarray(wgt), la), jnp.asarray(scale),
      jnp.asarray(bias),
      None if r is None else ck.to_lane_major(jnp.asarray(r), la),
      relu=relu), la)
  got = conv3d_s1_bn_act(_t(x), _conv_weight(wgt), _t(scale), _t(bias),
                         _t(r), relu)
  np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                             atol=1e-5)


def test_conv3d_s1_vs_fold_pallas(interpret_pallas):
  """The 1/16-level conv (K6): lane-major (1, 3, 32, 16, 64) = NDHWC
  (1, 3, 32, 64, 16), W on the lanes."""
  xl, wgt, scale, bias, _ = _inputs(1, (1, 3, 32, 16, 64), (3, 3, 3, 16, 16),
                                    16)
  want = ck.from_lane_major(ck.conv3d_fold_pallas(
      jnp.asarray(xl), jnp.asarray(wgt), jnp.asarray(scale),
      jnp.asarray(bias), relu=True), 3)
  x = np.ascontiguousarray(np.transpose(xl, (0, 1, 2, 4, 3)))
  got = conv3d_s1_bn_act(_t(x), _conv_weight(wgt), _t(scale), _t(bias),
                         relu=True)
  np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                             atol=1e-5)


@pytest.mark.parametrize("shape,cout,relu", [
    ((1, 4, 8, 16, 128), 16, True),
    ((2, 4, 16, 8, 256), 8, False),
    ((1, 8, 4, 8, 128), 8, True),
])
def test_conv3d_s2_vs_band_s2_pallas(interpret_pallas, shape, cout, relu):
  """Lane-major (B, D, M, C, L) with L playing W."""
  b, d, m, c, lanes = shape
  xl, wgt, scale, bias, _ = _inputs(3, shape, (3, 3, 3, c, cout), cout)
  want = ck.conv3d_band_s2_pallas(jnp.asarray(xl), jnp.asarray(wgt),
                                  jnp.asarray(scale), jnp.asarray(bias),
                                  relu=relu)
  want = np.transpose(np.asarray(want), (0, 1, 2, 4, 3))
  x = np.ascontiguousarray(np.transpose(xl, (0, 1, 2, 4, 3)))
  got = conv3d_s2_bn_act(_t(x), _conv_weight(wgt), _t(scale), _t(bias),
                         relu)
  assert got.shape == (b, d // 2, m // 2, lanes // 2, cout)
  np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def _deconv_case(xl, kernel_t, la):
  """NDHWC input and torch (I, O, 3, 3, 3) weight for a lane-major deconv
  case. ``kernel_t`` is (kd, kh, kw, O, I) in NDHWC terms whichever axis
  rides the lanes (the JAX kernel reorders its taps by ``lane_axis``)."""
  x = ck.from_lane_major(jnp.asarray(xl), la)
  return (torch.from_numpy(np.array(x)),
          torch.from_numpy(np.ascontiguousarray(
              np.transpose(kernel_t, (4, 3, 0, 1, 2)))))


@pytest.mark.parametrize("kernel,shape,cout,relu,la", [
    ("band", (1, 4, 8, 16, 128), 16, True, 3),
    ("band", (2, 2, 4, 8, 256), 8, False, 3),
    ("band", (1, 4, 8, 8, 128), 8, True, 2),
    ("fold", (1, 4, 8, 16, 16), 16, True, 3),
    ("fold", (2, 2, 4, 8, 32), 8, False, 3),
    ("fold", (1, 3, 16, 8, 16), 8, True, 2),
])
def test_deconv3d_vs_deconv_pallas(interpret_pallas, kernel, shape, cout,
                                   relu, la):
  b, d, m, c, lanes = shape
  xl, kernel_t, scale, bias, _ = _inputs(5, shape, (3, 3, 3, cout, c), cout)
  fn = (ck.conv3d_band_deconv_pallas if kernel == "band"
        else ck.conv3d_fold_deconv_pallas)
  want = fn(jnp.asarray(xl), jnp.asarray(kernel_t), jnp.asarray(scale),
            jnp.asarray(bias), relu=relu, lane_axis=la)
  want = ck.from_lane_major(want, la)
  x, w = _deconv_case(xl, kernel_t, la)
  got = deconv3d_bn_act(x, w, _t(scale), _t(bias), relu=relu)
  np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                             atol=1e-5)


def test_deconv3d_residual_epilogue():
  """conv5's ``relu(deconv * s + b + res)`` in one call equals the
  unfused sum."""
  rng = np.random.default_rng(7)
  x = torch.from_numpy(rng.normal(size=(1, 2, 3, 4, 8)).astype(np.float32))
  w = torch.from_numpy(rng.normal(size=(8, 6, 3, 3, 3)).astype(np.float32))
  s = torch.from_numpy(rng.normal(size=(6,)).astype(np.float32))
  b = torch.from_numpy(rng.normal(size=(6,)).astype(np.float32))
  r = torch.from_numpy(rng.normal(size=(1, 4, 6, 8, 6)).astype(np.float32))
  fused = deconv3d_bn_act(x, w, s, b, r, relu=True)
  unfused = torch.relu(deconv3d_bn_act(x, w, s, b) + r)
  torch.testing.assert_close(fused, unfused, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("fn,transpose", [
    (conv3d_s1_bn_act, False),
    (conv3d_s2_bn_act, False),
    (deconv3d_bn_act, True),
])
def test_packed_weight_gives_the_same_conv(fn, transpose):
  """A weight in the (27, Cin, Cout) layout, or in the tensor-core kernels'
  K-major TcWeight (the deconv's with ``transpose``), is the same conv as
  the torch layout it was packed from; tap t is (kd, kh, kw) = divmod."""
  rng = np.random.default_rng(8)
  x = torch.from_numpy(rng.normal(size=(1, 3, 4, 5, 6)).astype(np.float32))
  shape = (6, 5, 3, 3, 3) if transpose else (5, 6, 3, 3, 3)
  w = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
  s = torch.from_numpy(rng.normal(size=(5,)).astype(np.float32))
  packed = pack_weight(w, transpose)
  assert packed.shape == (27, 6, 5) and packed.is_contiguous()
  kd, kh, kw = 2, 0, 1
  want_tap = w[:, :, kd, kh, kw] if transpose else w[:, :, kd, kh, kw].T
  torch.testing.assert_close(packed[9 * kd + 3 * kh + kw], want_tap,
                             rtol=0, atol=0)
  torch.testing.assert_close(fn(x, packed, s, relu=True),
                             fn(x, w, s, relu=True), rtol=0, atol=0)
  tc = pack_weight_tc(w, 2 if fn is conv3d_s2_bn_act else 1, transpose)
  assert tc.transposed == transpose and tc.cout == 5
  torch.testing.assert_close(fn(x, tc, s, relu=True),
                             fn(x, w, s, relu=True), rtol=0, atol=0)
