"""mode_tpu_torch.ops.regression (plain path, CPU, f32) against the JAX
package's fused regression kernel in interpret mode, the soft-argmin /
confidence functions against their JAX twins at the clamped borders, and a
numpy model of the CUDA kernel's arithmetic (``kernels/csrc/regression.cu``:
the source levels interpolated once, their maximum as the softmax shift,
one exp per level) against the plain path and the Pallas kernel."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from mode_tpu.models import disparity as jdisp
from mode_tpu.ops.pallas.regression_kernel import (
    fused_disparity_regression as jax_fused_regression)
from mode_tpu_torch.ops import regression as treg
from mode_tpu_torch.ops.resize import linear_taps

torch.set_num_threads(2)


@pytest.fixture
def interpret_pallas(monkeypatch):
  orig = pl.pallas_call
  monkeypatch.setattr(pl, "pallas_call",
                      functools.partial(orig, interpret=True))


def test_regression_vs_fused_pallas(interpret_pallas):
  """The shape of tests/test_fused_regression.py; atol 1e-4 as there (the
  kernel and the plain path sum the softmax in different orders)."""
  n, d, hq, wq = 2, 16, 32, 128
  maxdisp, h, w = 48, 128, 512
  cost = (np.random.default_rng(0).normal(size=(n, d, hq, wq)) * 2.0).astype(
      np.float32)
  want_pred, want_conf = jax_fused_regression(jnp.asarray(cost), maxdisp, h,
                                              w)
  pred, conf = treg.fused_disparity_regression(torch.from_numpy(cost),
                                               maxdisp, h, w)
  assert pred.dtype == conf.dtype == torch.float32
  assert pred.shape == conf.shape == (n, h, w)
  np.testing.assert_allclose(pred.numpy(), np.asarray(want_pred), rtol=1e-4,
                             atol=1e-4)
  # conf jumps where round(pred) does: at a pred within f32 noise of k + 0.5
  # (22.5 here against 22.500002) the two sides may probe different slices,
  # so those pixels are left out of the conf comparison; they are rare
  want_pred = np.asarray(want_pred)
  tie = np.abs(want_pred - np.floor(want_pred) - 0.5) < 1e-4
  assert tie.mean() < 1e-3
  np.testing.assert_allclose(conf.numpy()[~tie], np.asarray(want_conf)[~tie],
                             rtol=1e-4, atol=1e-4)


def test_confidence_at_clamped_borders():
  """round(pred) at 0 and at maxdisp - 1 clips a tap onto the border slice,
  which is then counted twice; ties round half to even, as jnp.round."""
  maxdisp = 6
  rng = np.random.default_rng(1)
  logits = rng.normal(size=(1, maxdisp, 2, 4)).astype(np.float32)
  prob = np.exp(logits) / np.exp(logits).sum(axis=1, keepdims=True)
  pred = np.array([[[0.2, 5.0, 2.5, 3.5], [-0.4, 4.7, 0.5, 1.5]]],
                  np.float32)
  want = jdisp.confidence_from_prob(jnp.asarray(prob), jnp.asarray(pred),
                                    maxdisp)
  got = treg.confidence_from_prob(torch.from_numpy(prob),
                                  torch.from_numpy(pred), maxdisp)
  np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                             atol=1e-7)
  # pixel (0, 0): round(0.2) = 0 -> taps clip to {0, 0, 1}
  assert got[0, 0, 0] == pytest.approx(2 * prob[0, 0, 0, 0]
                                       + prob[0, 1, 0, 0], abs=1e-7)
  # pixel (0, 1): round(5.0) = 5 -> taps {4, 5, 5}
  assert got[0, 0, 1] == pytest.approx(prob[0, 4, 0, 1]
                                       + 2 * prob[0, 5, 0, 1], abs=1e-7)
  want_pred = jdisp.disparity_regression(jnp.asarray(prob), maxdisp)
  got_pred = treg.disparity_regression(torch.from_numpy(prob), maxdisp)
  np.testing.assert_allclose(got_pred.numpy(), np.asarray(want_pred),
                             rtol=0, atol=1e-6)


LOG2E = np.float32(1.4426950408889634)


def _block_columns(wq, w):
  """regression.cu:block_columns: the most source columns the 128 output
  pixels of one of the kernel's blocks read."""
  return min(wq, 127 * (wq - 1) // max(w - 1, 1) + 4)


def _fma(a, b, c):
  """fmaf on f32 values: one rounding (through f64)."""
  return (np.float64(1) * a * b + c).astype(np.float32)


def _regression_like_the_kernel(cost, maxdisp, h, w, shift="max"):
  """regression.cu's arithmetic in numpy, f32, on the host's tap tables
  (``ops/regression.py:_tap_tables``): each source level's row lerp with
  the weights scaled by log2(e) (the staged columns), then its column lerp
  at every output pixel; the maximum over the source levels as the softmax
  shift (``shift="min"`` shifts by the minimum instead, a wrong shift); one
  pass over the disparity levels by source interval (from each level's
  first disparity level in the table): a lerp of the interval's two source
  levels, one exp2, the sum and the disparity-weighted sum; the confidence
  from the same levels. Returns (pred, conf, the largest upsampled logit
  less the shift at each pixel, in log2 units)."""
  n, d, hq, wq = cost.shape
  idx, wgt = (t.numpy() for t in treg._tap_tables(d, hq, wq, maxdisp, h, w,
                                                  torch.device("cpu")))
  dlo, dwl, dwh = idx[0:2 * maxdisp:2], wgt[:maxdisp, 0], wgt[:maxdisp, 1]
  rows = slice(2 * maxdisp, 2 * (maxdisp + h))
  cols = slice(2 * (maxdisp + h), 2 * (maxdisp + h + w))
  rlo, rhi = idx[rows][0::2], idx[rows][1::2]
  clo, chi = idx[cols][0::2], idx[cols][1::2]
  starts = idx[2 * (maxdisp + h + w):]
  rw, cw = wgt[maxdisp:maxdisp + h], wgt[maxdisp + h:]
  c = cost.astype(np.float32)
  a0 = (rw[:, 0] * LOG2E).astype(np.float32)[:, None]
  a1 = (rw[:, 1] * LOG2E).astype(np.float32)[:, None]
  staged = _fma(a1, c[:, :, rhi], (a0 * c[:, :, rlo]).astype(np.float32))
  b0, b1 = cw[:, 0], cw[:, 1]

  def level(k):                                     # (n, h, w), log2 units
    return _fma(b1, staged[:, k][..., chi],
                (b0 * staged[:, k][..., clo]).astype(np.float32))
  lv = np.stack([level(k) for k in range(d)], axis=1)
  mx = lv.max(axis=1) if shift == "max" else lv.min(axis=1)
  s = np.zeros((n, h, w), np.float32)
  sd = np.zeros((n, h, w), np.float32)
  top_logit = np.full((n, h, w), -np.inf, np.float32)
  with np.errstate(over="ignore", invalid="ignore"):
    t = 0
    for k in range(d):
      va, vb = lv[:, k], lv[:, min(k + 1, d - 1)]
      for t in range(t, starts[k + 1]):
        logit = _fma(dwh[t], vb, (dwl[t] * va).astype(np.float32))
        top_logit = np.maximum(top_logit, logit)
        e = np.exp2((logit - mx).astype(np.float32)).astype(np.float32)
        s = (s + e).astype(np.float32)
        sd = _fma(e, np.float32(t), sd)
      t = starts[k + 1]
    pred = (sd / s).astype(np.float32)
    ce = np.zeros_like(s)
    for delta in (-1, 0, 1):
      t = np.clip(np.rint(pred) + delta, 0, maxdisp - 1).astype(np.int64)
      t = np.where(np.isfinite(pred), t, 0)
      lo = np.take_along_axis(lv, dlo[t][:, None], axis=1)[:, 0]
      hi = np.take_along_axis(lv, np.minimum(dlo[t] + 1, d - 1)[:, None],
                              axis=1)[:, 0]
      logit = _fma(dwh[t], hi, (dwl[t] * lo).astype(np.float32))
      ce = (ce + np.exp2((logit - mx).astype(np.float32))).astype(np.float32)
    conf = (ce / s).astype(np.float32)
  return pred, conf, top_logit - mx


@pytest.mark.parametrize("spread", ["normal", "60"])
def test_kernel_model_matches_plain_and_pallas(interpret_pallas, spread):
  """The kernel's pass (max-of-sources shift, one exp2 per level) against
  the plain path at chip_smoke.py's f32 bar (|got - want| <= 1e-4 + 1e-4
  |want|) and against the Pallas kernel in interpret mode at this file's
  1e-4, conf left out within f32 noise of a round(pred) tie. The largest
  upsampled logit is never above the shift, so no rescale is needed. Logits
  uniform in +-60 make the softmax sharp: there it lies up to ~14 (in
  log2 units ~21) below the shift at some pixels, so the sum's top term
  stays far above f32's underflow (2^-126), while a shift by the minimum
  overflows."""
  n, d, hq, wq = 1, 16, 32, 128
  maxdisp, h, w = 48, 128, 512
  rng = np.random.default_rng(3)
  if spread == "normal":
    cost = (rng.normal(size=(n, d, hq, wq)) * 2.0).astype(np.float32)
  else:
    cost = rng.uniform(-60, 60, size=(n, d, hq, wq)).astype(np.float32)
  pred, conf, gap = _regression_like_the_kernel(cost, maxdisp, h, w)
  assert gap.max() <= 0 and gap.min() > -30 and np.isfinite(pred).all()
  assert np.isfinite(conf).all()
  want_pred, want_conf = treg.fused_disparity_regression(
      torch.from_numpy(cost), maxdisp, h, w, plain=True)
  want_pred, want_conf = want_pred.numpy(), want_conf.numpy()
  tie = np.abs(want_pred - np.floor(want_pred) - 0.5) < 1e-3
  assert tie.mean() < 1e-2
  assert (np.abs(pred - want_pred) <= 1e-4 + 1e-4 * np.abs(want_pred)).all()
  assert (np.abs(conf - want_conf)[~tie]
          <= 1e-4 + 1e-4 * np.abs(want_conf[~tie])).all()
  jpred, jconf = (np.asarray(a) for a in jax_fused_regression(
      jnp.asarray(cost), maxdisp, h, w))
  np.testing.assert_allclose(pred, jpred, rtol=1e-4, atol=1e-4)
  np.testing.assert_allclose(conf[~tie], jconf[~tie], rtol=1e-4, atol=1e-4)
  if spread == "60":
    wrong, _, _ = _regression_like_the_kernel(cost, maxdisp, h, w, "min")
    assert not np.isfinite(wrong).all()


@pytest.mark.parametrize("shape,maxdisp,h,w", [
    ((2, 6, 5, 7), 24, 17, 30),
    ((1, 4, 1, 3), 8, 4, 300),      # one source row; 128-pixel blocks
    ((1, 3, 4, 4), 3, 4, 4),        # no upsample
    ((1, 1, 2, 2), 5, 3, 3),        # one source level
])
def test_kernel_model_at_ragged_shapes(shape, maxdisp, h, w):
  """The kernel's arithmetic at the card tests' ragged shapes (and one
  source level), against the plain path at chip_smoke.py's f32 bar."""
  cost = (np.random.default_rng(4).normal(size=shape) * 2.0).astype(
      np.float32)
  pred, conf, _ = _regression_like_the_kernel(cost, maxdisp, h, w)
  want_pred, want_conf = (a.numpy() for a in treg.fused_disparity_regression(
      torch.from_numpy(cost), maxdisp, h, w, plain=True))
  tie = np.abs(want_pred - np.floor(want_pred) - 0.5) < 1e-3
  assert (np.abs(pred - want_pred) <= 1e-4 + 1e-4 * np.abs(want_pred)).all()
  assert (np.abs(conf - want_conf)[~tie]
          <= 1e-4 + 1e-4 * np.abs(want_conf[~tie])).all()
  # every column a block of 128 output pixels reads lies within the
  # kernel's staged span
  idx = treg._tap_tables(*shape[1:], maxdisp, h, w, torch.device("cpu"))[0]
  cols = idx[2 * (maxdisp + h):2 * (maxdisp + h + w)].numpy()
  for xb in range(0, w, 128):
    last = min(w, xb + 128) - 1
    assert cols[2 * last + 1] - cols[2 * xb] < _block_columns(shape[3], w)


@pytest.mark.parametrize("wq,w", [(128, 512), (256, 1024), (7, 30), (3, 300),
                                  (4, 4), (100, 37), (2, 1)])
def test_block_columns_cover_a_block(wq, w):
  """``_block_columns`` (regression.cu:block_columns) bounds the source
  columns any block of 128 output pixels reads, at the served widths
  (Cassini 512, ERP 1024), ragged ones and a downsample; its shared memory
  (regression.cu:smem_bytes) at the served shapes is ~9 KB, inside the 48
  KB past which the C entry refuses a launch."""
  lo, hi = linear_taps(w, wq)[:2]
  for xb in range(0, w, 128):
    last = min(w, xb + 128) - 1
    assert hi[last] - lo[xb] < _block_columns(wq, w) <= wq
  for wq_, w_ in ((128, 512), (256, 1024)):
    assert 12 * 192 + 4 * 49 + 4 * 48 * _block_columns(wq_, w_) < 10_000
