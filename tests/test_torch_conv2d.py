"""mode_tpu_torch.ops.conv2d (plain path, CPU, f32) against the JAX package's
2-D band kernels in interpret mode, at the cases of
``tests/test_conv2d_lane.py``: ``conv2d_band_pallas`` (K8, one image per
grid step) and ``conv2d_band_bpack`` (K9, packed batch, dilation 1 or 2).
The JAX side takes lane-major ``(B, M, C, L)`` maps; the port takes NHWC, so
layouts are converted on the JAX side.

Tolerance rtol = atol = 1e-4, as those tests use: both sides sum 9 * Cin f32
products, in different orders.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from mode_tpu.ops.pallas import conv2d_kernel as c2
from mode_tpu_torch.ops.conv2d import conv2d_s1_bn_act, pack_weight

torch.set_num_threads(2)


@pytest.fixture
def interpret_pallas(monkeypatch):
  orig = pl.pallas_call
  monkeypatch.setattr(pl, "pallas_call",
                      functools.partial(orig, interpret=True))


def _inputs(seed, x_shape, cin, cout, res):
  rng = np.random.default_rng(seed)
  x = (rng.normal(size=x_shape) * 0.3).astype(np.float32)
  w = (rng.normal(size=(3, 3, cin, cout)) * 0.1).astype(np.float32)
  scale = (rng.normal(size=(cout,)) * 0.2 + 1.0).astype(np.float32)
  bias = (rng.normal(size=(cout,)) * 0.1).astype(np.float32)
  r = ((rng.normal(size=(*x_shape[:3], cout)) * 0.3).astype(np.float32)
       if res else None)
  return x, w, scale, bias, r


def _t(a):
  return None if a is None else torch.from_numpy(a)


def _torch_weight(w_hwio):
  """Flax (3, 3, I, O) -> torch (O, I, 3, 3)."""
  return torch.from_numpy(np.ascontiguousarray(
      np.transpose(w_hwio, (3, 2, 0, 1))))


@pytest.mark.parametrize("shape,cout,res,relu", [
    ((1, 16, 128, 8), 16, False, True),       # lanes = W
    ((2, 8, 256, 16), 8, True, True),         # batch, residual, 256 lanes
    ((1, 128, 24, 8), 8, False, False),       # lanes = H
    ((1, 12, 128, 8), 8, True, False),        # odd-ish M
])
def test_conv2d_vs_band_pallas(interpret_pallas, shape, cout, res, relu):
  x, w, scale, bias, r = _inputs(0, shape, shape[-1], cout, res)
  # conv2d_fused puts the 128-multiple axis on the lanes, runs
  # conv2d_band_pallas and transposes back to NHWC
  want = c2.conv2d_fused(jnp.asarray(x), jnp.asarray(w), jnp.asarray(scale),
                         jnp.asarray(bias),
                         None if r is None else jnp.asarray(r), relu=relu)
  got = conv2d_s1_bn_act(_t(x), _torch_weight(w), _t(scale), _t(bias),
                         _t(r), relu)
  np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                             atol=1e-4)


@pytest.mark.parametrize("b,m,c,cout,lanes,g,dil,res,relu", [
    (4, 8, 8, 8, 128, 2, 1, False, True),
    (6, 8, 16, 8, 128, 3, 1, True, True),
    (6, 16, 8, 16, 128, 6, 1, True, False),
    (6, 8, 16, 16, 128, 3, 2, True, True),    # layer3 config: dilation 2
    (2, 8, 8, 8, 256, 2, 2, False, False),
])
def test_conv2d_vs_band_bpack(interpret_pallas, b, m, c, cout, lanes, g, dil,
                              res, relu):
  x, w, scale, bias, r = _inputs(1, (b, m, lanes, c), c, cout, res)
  lane_major = functools.partial(jnp.transpose, axes=(0, 1, 3, 2))
  want = lane_major(c2.conv2d_band_bpack(
      lane_major(jnp.asarray(x)), jnp.asarray(w), jnp.asarray(scale),
      jnp.asarray(bias), None if r is None else lane_major(jnp.asarray(r)),
      relu=relu, g=g, dilation=dil))
  got = conv2d_s1_bn_act(_t(x), pack_weight(_torch_weight(w)), _t(scale),
                         _t(bias), _t(r), relu, dilation=dil)
  np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                             atol=1e-4)


def test_conv2d_refuses_other_dilations():
  x = torch.zeros(1, 4, 4, 8)
  with pytest.raises(ValueError, match="dilation"):
    conv2d_s1_bn_act(x, torch.zeros(8, 8, 3, 3), dilation=3)
