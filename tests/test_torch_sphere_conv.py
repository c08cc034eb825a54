"""mode_tpu_torch.ops.sphere_conv (tables and plain path, CPU, f32) against
the JAX package: its tables bit for bit, ``sphere_conv_xla`` and the Pallas
kernel ``sphere_conv_cassini_pallas`` in interpret mode.

Tolerance rtol = atol = 1e-4, the JAX package's own bar between its Pallas
kernel and its gather path (``tests/test_pallas_sphere_conv.py``): the two
blend the corners and sum the taps in other orders, and the kernel's row
weights come from the row-0 position of each column, which differs from the
other rows' positions by f32 noise.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from mode_tpu.models import blocks as jblocks
from mode_tpu.ops.pallas import sphere_conv_kernel as jsck
from mode_tpu_torch.models.blocks import TorchBatchNorm
from mode_tpu_torch.ops import sphere_conv as tsc

# the module, not the function ``mode_tpu.ops`` exports under its name
jsc = importlib.import_module("mode_tpu.ops.sphere_conv")
torch.set_num_threads(2)


@pytest.fixture
def interpret_pallas(monkeypatch):
  orig = pl.pallas_call
  monkeypatch.setattr(pl, "pallas_call",
                      functools.partial(orig, interpret=True))


def _torch_weight(w_hwio):
  """Flax (3, 3, I, O) -> torch (O, I, 3, 3)."""
  return torch.from_numpy(np.ascontiguousarray(
      np.transpose(w_hwio, (3, 2, 0, 1))))


@pytest.mark.parametrize("h,w", [(32, 16), (64, 32), (256, 128)])
def test_tables_are_bit_equal(h, w):
  np.testing.assert_array_equal(tsc.gen_sphere_positions(h, w, 3, 3),
                                jsc.gen_sphere_positions(h, w, 3, 3))
  pos = tsc.gen_sphere_positions(h, w, 3, 3)
  np.testing.assert_array_equal(tsc.positions_reference_layout(pos),
                                jsc.positions_reference_layout(pos))
  for got, want in zip(
      tsc.build_gather_tables(h, w, 3, 3, "Cassini", 1, 1, 1),
      jsc.build_gather_tables(h, w, 3, 3, "Cassini", 1, 1, 1)):
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
  for got, want in zip(tsc.build_shift_tables(h, w, 3),
                       jsck.build_shift_tables(h, w, 3)):
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("h,w,cin,cout,bj", [(32, 16, 8, 16, 8),
                                             (64, 32, 64, 64, 8),
                                             (64, 32, 16, 8, 4)])
def test_plain_matches_xla_and_pallas(interpret_pallas, h, w, cin, cout, bj):
  rng = np.random.default_rng(0)
  x = rng.normal(size=(2, h, w, cin)).astype(np.float32)
  wgt = (rng.normal(size=(3, 3, cin, cout)) * 0.2).astype(np.float32)
  got = tsc.sphere_conv_bn_act(torch.from_numpy(x), _torch_weight(wgt))
  xla = np.asarray(jsc.sphere_conv_xla(jnp.asarray(x), jnp.asarray(wgt)))
  pallas = np.asarray(jsck.sphere_conv_cassini_pallas(
      jnp.asarray(x), jnp.asarray(wgt), block_j=bj))
  np.testing.assert_allclose(got.numpy(), xla, rtol=1e-4, atol=1e-4)
  np.testing.assert_allclose(got.numpy(), pallas, rtol=1e-4, atol=1e-4)


def test_packed_weight_keeps_the_tap_order():
  """The (9, Cin, Cout) packing is row-major over (kh, kw), as the JAX
  package's ``weight.reshape(9, cin, cout)``: an asymmetric weight would
  expose a transposed tap order."""
  rng = np.random.default_rng(1)
  wgt = rng.normal(size=(3, 3, 4, 5)).astype(np.float32)
  packed = tsc.pack_weight(_torch_weight(wgt))
  np.testing.assert_array_equal(packed.numpy(), wgt.reshape(9, 4, 5))


@pytest.mark.parametrize("residual", [False, True])
def test_epilogue_matches_flax_batchnorm(residual):
  """``sphere_conv_bn_act`` with the folded BN, the shortcut and the ReLU
  equals ``sphere_conv_xla`` followed by the Flax eval BatchNorm, the add
  and the ReLU, as ``SphereBasicBlock`` applies them."""
  rng = np.random.default_rng(2)
  h, w, cin, cout = 32, 16, 8, 16
  x = rng.normal(size=(1, h, w, cin)).astype(np.float32)
  wgt = (rng.normal(size=(3, 3, cin, cout)) * 0.2).astype(np.float32)
  res = rng.normal(size=(1, h, w, cout)).astype(np.float32)
  stats = {"scale": rng.uniform(0.8, 1.2, cout), "bias": rng.normal(
      size=cout) * 0.1, "mean": rng.normal(size=cout) * 0.1,
           "var": rng.uniform(0.8, 1.2, cout)}
  stats = {k: v.astype(np.float32) for k, v in stats.items()}

  y = jsc.sphere_conv_xla(jnp.asarray(x), jnp.asarray(wgt))
  y = jblocks.TorchBatchNorm().apply(
      {"params": {"scale": stats["scale"], "bias": stats["bias"]},
       "batch_stats": {"mean": stats["mean"], "var": stats["var"]}}, y, False)
  if residual:
    y = y + res
  want = np.asarray(jax.nn.relu(y))

  bn = TorchBatchNorm(cout)
  bn.load_state_dict({
      "weight": torch.from_numpy(stats["scale"]),
      "bias": torch.from_numpy(stats["bias"]),
      "running_mean": torch.from_numpy(stats["mean"]),
      "running_var": torch.from_numpy(stats["var"]),
      "num_batches_tracked": torch.tensor(0)})
  scale, bias = bn.folded()
  with torch.no_grad():
    got = tsc.sphere_conv_bn_act(
        torch.from_numpy(x), _torch_weight(wgt), scale, bias,
        torch.from_numpy(res) if residual else None, relu=True)
  np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def _shift_sample(x, h, w, seam=True, drop=True):
  """The 9 taps' samples ``(N, 9, H, W, C)`` formed from the shift tables
  as ``kernels/csrc/sphere_conv.cu`` forms them: row s = (i + sigma) mod H,
  corners (s, c0), (s+1, c0), (s, c1), (s+1, c1) with the table's weights;
  the successor of row H-1 weighs zero (``seam``) and the sample at
  drop_row is zero (``drop``)."""
  sigma, colint, quad, drop_row = tsc.build_shift_tables(h, w, 3)
  i = np.arange(h)[:, None, None]                      # (H, 1, 1)
  s = (i + sigma[None]) % h                            # (H, W, 9)
  nxt = (s + 1) % h
  c0 = colint[None, ..., 0].astype(np.int64)
  c1 = colint[None, ..., 1].astype(np.int64)
  q = np.broadcast_to(quad[None], (h, w, 9, 4)).copy()
  if seam:
    q[..., 1] = np.where(s == h - 1, 0.0, q[..., 1])
    q[..., 3] = np.where(s == h - 1, 0.0, q[..., 3])
  if drop:
    q = np.where((i == drop_row[None])[..., None], 0.0, q)
  c0 = np.broadcast_to(c0, s.shape)
  c1 = np.broadcast_to(c1, s.shape)
  col = (q[..., 0, None] * x[:, s, c0] + q[..., 1, None] * x[:, nxt, c0]
         + q[..., 2, None] * x[:, s, c1] + q[..., 3, None] * x[:, nxt, c1])
  return col.transpose(0, 3, 1, 2, 4)                  # (N, 9, H, W, C)


def _gather_sample(x, h, w):
  idx, wgt = tsc.build_gather_tables(h, w, 3, 3, "Cassini", 1, 1, 1)
  xf = x.reshape(x.shape[0], h * w, -1)
  return sum(wgt[c][None, ..., None] * xf[:, idx[c]] for c in range(4))


def test_shift_tables_keep_the_edge_rules():
  """At 64x32 the tables have a drop_row (column 0, tap 5) and every tap
  with a row weight reaches the seam row H-1. Sampling as the CUDA kernel
  does equals the plain gather's sampling there, and each edge rule is
  needed for that: without the seam or the drop rule the two part."""
  h, w = 64, 32
  _, _, quad, drop_row = tsc.build_shift_tables(h, w, 3)
  assert (drop_row >= 0).sum() >= 1
  assert ((quad[..., 1] + quad[..., 3]) > 0).any()
  x = np.random.default_rng(3).normal(size=(1, h, w, 4)).astype(np.float32)
  want = _gather_sample(x, h, w)
  np.testing.assert_allclose(_shift_sample(x, h, w), want, rtol=1e-4,
                             atol=1e-4)
  for rule in ("seam", "drop"):
    wrong = _shift_sample(x, h, w, **{rule: False})
    assert np.abs(wrong - want).max() > 0.1, rule
