"""The ERP sphere conv of mode_tpu_torch (tables, plain forward and backward,
CPU, f32) against the JAX package: its ERP shift tables bit for bit,
``sphere_conv_xla(sphere_type="ERP")``, and the Pallas kernels
``sphere_conv_erp_pallas`` and ``sphere_conv_erp_pallas_bwd`` in interpret
mode; and numpy models of the CUDA kernels' band/lane arithmetic (the
forward's table-driven sample, the dx gather, the dw sample rebuild) against
the plain versions, with the edge rules the kernels must keep.

Tolerances are the JAX package's own (``tests/test_pallas_sphere_conv.py``):
1e-4 between the Pallas forward and the gather path, 2e-4 between the
Pallas backward and the XLA VJP; against autograd, which sums the same
products in another order, 1e-5 of the largest gradient.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from mode_tpu.ops.pallas import sphere_conv_kernel as jsck
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


def _case(h, w, cin, cout, seed=0):
  rng = np.random.default_rng(seed)
  x = rng.normal(size=(2, h, w, cin)).astype(np.float32)
  wgt = (rng.normal(size=(3, 3, cin, cout)) * 0.2).astype(np.float32)
  g = rng.normal(size=(2, h, w, cout)).astype(np.float32)
  return x, wgt, g


@pytest.mark.parametrize("h,w", [(16, 32), (32, 64), (128, 256)])
def test_erp_tables_are_bit_equal(h, w):
  np.testing.assert_array_equal(tsc.gen_sphere_positions(h, w, 3, 3, "ERP"),
                                jsc.gen_sphere_positions(h, w, 3, 3, "ERP"))
  for got, want in zip(
      tsc.build_gather_tables(h, w, 3, 3, "ERP", 1, 1, 1),
      jsc.build_gather_tables(h, w, 3, 3, "ERP", 1, 1, 1)):
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
  for got, want in zip(tsc.build_shift_tables_erp(h, w, 3),
                       jsck.build_shift_tables_erp(h, w, 3)):
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("h,w,cin,cout,bj", [(16, 32, 8, 16, 8),
                                             (32, 64, 16, 8, 4)])
def test_erp_plain_matches_xla_and_pallas(interpret_pallas, h, w, cin, cout,
                                          bj):
  x, wgt, _ = _case(h, w, cin, cout)
  got = tsc.sphere_conv_bn_act(torch.from_numpy(x), _torch_weight(wgt),
                               sphere_type="ERP")
  xla = np.asarray(jsc.sphere_conv_xla(jnp.asarray(x), jnp.asarray(wgt),
                                       sphere_type="ERP"))
  pallas = np.asarray(jsck.sphere_conv_erp_pallas(
      jnp.asarray(x), jnp.asarray(wgt), block_j=bj))
  np.testing.assert_allclose(got.numpy(), xla, rtol=1e-4, atol=1e-4)
  np.testing.assert_allclose(got.numpy(), pallas, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("h,w,cin,cout,bj", [(16, 32, 8, 16, 8),
                                             (32, 64, 16, 8, 4)])
def test_erp_plain_backward_matches_pallas(interpret_pallas, h, w, cin, cout,
                                           bj):
  x, wgt, g = _case(h, w, cin, cout, 1)
  dx, dw = tsc.sphere_conv_backward(torch.from_numpy(x), _torch_weight(wgt),
                                    torch.from_numpy(g), sphere_type="ERP")
  jdx, jdw = jsck.sphere_conv_erp_pallas_bwd(
      jnp.asarray(x), jnp.asarray(wgt), jnp.asarray(g), block_j=bj)
  assert dx.dtype == torch.float32 and dw.dtype == torch.float32
  np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), rtol=2e-4,
                             atol=2e-4)
  np.testing.assert_allclose(dw.permute(2, 3, 1, 0).numpy(), np.asarray(jdw),
                             rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("h,w,cin,cout", [(16, 32, 8, 16), (32, 64, 16, 8)])
def test_erp_plain_backward_matches_autograd(h, w, cin, cout):
  """The explicit transpose equals autograd of the plain forward, and the
  training Function's gradients are that transpose."""
  x, wgt, g = (torch.from_numpy(a) for a in _case(h, w, cin, cout, 2))
  wt = _torch_weight(wgt.numpy()).requires_grad_()
  xg = x.clone().requires_grad_()
  want_dx, want_dw = torch.autograd.grad(
      tsc.sphere_conv(xg, wt, "ERP"), (xg, wt), g)
  dx, dw = tsc.sphere_conv_backward(x, wt.detach(), g, sphere_type="ERP")
  fn_dx, fn_dw = torch.autograd.grad(
      tsc.sphere_conv_train(xg, wt, sphere_type="ERP"), (xg, wt), g)
  for got, want in ((dx, want_dx), (dw, want_dw), (fn_dx, want_dx),
                    (fn_dw, want_dw)):
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_maps_of_the_other_layout_are_refused():
  """The layout is checked on the CPU too: an ERP map is not a Cassini one."""
  x = torch.zeros((1, 16, 32, 8))
  w = torch.zeros((8, 8, 3, 3))
  with pytest.raises(ValueError, match="Cassini"):
    tsc.sphere_conv_bn_act(x, w)
  with pytest.raises(ValueError, match="ERP"):
    tsc.sphere_conv_bn_act(x.transpose(1, 2), w, sphere_type="ERP")
  with pytest.raises(ValueError, match="ERP"):
    tsc.sphere_conv_bwd_input(x.transpose(1, 2), w, sphere_type="ERP")
  with pytest.raises(ValueError, match="unknown"):
    tsc.sphere_conv_bn_act(x, w, sphere_type="Fisheye")


# --- numpy models of the kernels' band/lane arithmetic -----------------------

def _bands(a, sphere_type):
  """An (N, H, W, ...) array as (N, band, lane, ...): Cassini bands are
  columns, ERP bands are rows."""
  return np.swapaxes(a, 1, 2) if sphere_type == "Cassini" else a


def _sample_like_the_kernel(x, sphere_type, seam=True, drop=True):
  """The 9 taps' samples ``(N, 9, H, W, C)`` as ``sphere_conv.cu`` forms
  them for either layout: at band b, lane l, tap k the lane
  s = (l + sigma) mod L of source bands b0, b1, blended with the table's
  corner weights; the lane successor of L-1 weighs zero (``seam``) and the
  whole sample at lane ``drop`` is zero (``drop``)."""
  h, w = x.shape[1:3]
  sigma, pairint, quad, drop_at = tsc.shift_tables(h, w, sphere_type)
  xb = _bands(x, sphere_type)                          # (N, B, L, C)
  lanes = xb.shape[2]
  l = np.arange(lanes)[None, :, None]                  # (1, L, 1)
  s = (l + sigma[:, None]) % lanes                     # (B, L, 9)
  nxt = (s + 1) % lanes
  b0 = np.broadcast_to(pairint[:, None, :, 0].astype(np.int64), s.shape)
  b1 = np.broadcast_to(pairint[:, None, :, 1].astype(np.int64), s.shape)
  q = np.broadcast_to(quad[:, None], s.shape + (4,)).copy()
  if seam:
    q[..., 1] = np.where(s == lanes - 1, 0.0, q[..., 1])
    q[..., 3] = np.where(s == lanes - 1, 0.0, q[..., 3])
  if drop:
    q = np.where((l == drop_at[:, None])[..., None], 0.0, q)
  col = (q[..., 0, None] * xb[:, b0, s] + q[..., 1, None] * xb[:, b0, nxt]
         + q[..., 2, None] * xb[:, b1, s] + q[..., 3, None] * xb[:, b1, nxt])
  col = col.transpose(0, 3, 1, 2, 4)                   # (N, 9, B, L, C)
  return col.transpose(0, 1, 3, 2, 4) if sphere_type == "Cassini" else col


def _dx_like_the_kernel(g, wk, sphere_type, seam=True, drop=True,
                        found=None):
  """dx as the gather that ``sphere_conv_bwd.cu:bwd_input_tc_kernel`` runs
  for either layout: each input pixel (band c, lane l) gathers, for each
  tap k, from the output bands j within ``reach`` of c whose source band b0
  or b1 is c (the kernel reads them from ``transpose_table``); from output
  lane (l - sigma) mod L through the (., s) corners and (l - 1 - sigma) mod
  L through the successor corners; nothing through a successor corner at
  l = 0 (``seam``) or from the output lane ``drop`` (``drop``). ``found``,
  a dict, collects the (j, a_s, a_n) of each (c, k) in the order met."""
  h, w = g.shape[1:3]
  sigma, pairint, quad, drop_at = tsc.shift_tables(h, w, sphere_type)
  reach, most = tsc.transpose_bounds(h, w, sphere_type)
  dcol = _bands(np.einsum("nhwo,kco->nhwkc", g, wk), sphere_type)
  bands, lanes = dcol.shape[1:3]
  l = np.arange(lanes)
  dx = np.zeros(dcol.shape[:3] + (wk.shape[1],), np.float64)
  for c in range(bands):
    for k in range(9):
      used = 0
      for j in range(max(c - reach, 0), min(c + reach, bands - 1) + 1):
        b0, b1 = pairint[j, k].astype(np.int64)
        q = quad[j, k]
        a_s = (q[0] if b0 == c else 0.0) + (q[2] if b1 == c else 0.0)
        a_n = (q[1] if b0 == c else 0.0) + (q[3] if b1 == c else 0.0)
        if a_s == 0 and a_n == 0:
          continue
        used += 1
        if found is not None:
          found.setdefault((c, k), []).append((j, a_s, a_n))
        i_s = (l - sigma[j, k]) % lanes
        i_n = (i_s - 1) % lanes
        ws = np.full(lanes, a_s)
        wn = np.full(lanes, a_n)
        if drop:
          ws = np.where(i_s == drop_at[j, k], 0.0, ws)
          wn = np.where(i_n == drop_at[j, k], 0.0, wn)
        if seam:
          wn = np.where(l == 0, 0.0, wn)
        dx[:, c] += (ws[None, :, None] * dcol[:, j, i_s, k]
                     + wn[None, :, None] * dcol[:, j, i_n, k])
      assert used <= most
  return _bands(dx, sphere_type)


def _gather_sample(x, sphere_type):
  h, w = x.shape[1:3]
  idx, wgt = tsc.build_gather_tables(h, w, 3, 3, sphere_type, 1, 1, 1)
  xf = x.reshape(x.shape[0], h * w, -1)
  return sum(wgt[c][None, ..., None] * xf[:, idx[c]] for c in range(4))


# 32x64 is the smallest ERP grid with a dropped sample (row 0, tap 5)
LAYOUTS = [("ERP", 32, 64), ("Cassini", 64, 32)]


@pytest.mark.parametrize("sphere_type,h,w", LAYOUTS)
def test_kernel_sample_keeps_the_edge_rules(sphere_type, h, w):
  """Sampling as the forward kernel does equals the plain gather's
  sampling, and each edge rule is needed for that: without the seam or the
  drop rule the two part."""
  _, _, quad, drop_at = tsc.shift_tables(h, w, sphere_type)
  assert (drop_at >= 0).sum() >= 1
  assert ((quad[..., 1] + quad[..., 3]) > 0).any()
  x = np.random.default_rng(3).normal(size=(1, h, w, 4)).astype(np.float32)
  want = _gather_sample(x, sphere_type)
  np.testing.assert_allclose(_sample_like_the_kernel(x, sphere_type), want,
                             rtol=1e-4, atol=1e-4)
  for rule in ("seam", "drop"):
    wrong = _sample_like_the_kernel(x, sphere_type, **{rule: False})
    assert np.abs(wrong - want).max() > 0.1, rule


@pytest.mark.parametrize("sphere_type,h,w", LAYOUTS)
def test_dx_gather_keeps_the_edge_rules(sphere_type, h, w):
  """The gather of the dx kernel (``bwd_input_tc_kernel``, whose CPU
  model is in ``tests/test_torch_tc_conv.py``) equals the plain scatter
  (``index_add_``), and without the seam or the drop rule the two part."""
  _, wgt, g = _case(h, w, 4, 6, 4)
  wk = wgt.reshape(9, 4, 6)
  want = tsc.sphere_conv_bwd_input(torch.from_numpy(g), torch.from_numpy(wk),
                                   sphere_type=sphere_type).numpy()
  np.testing.assert_allclose(_dx_like_the_kernel(g, wk, sphere_type), want,
                             rtol=1e-4, atol=1e-4)
  for rule in ("seam", "drop"):
    wrong = _dx_like_the_kernel(g, wk, sphere_type, **{rule: False})
    assert np.abs(wrong - want).max() > 0.1, rule


@pytest.mark.parametrize("h,w", [(16, 32), (32, 64), (64, 128), (128, 256)])
def test_erp_transpose_table_lists_the_gathers_entries(h, w):
  """The ERP dx kernel's table holds, for each (input row, tap), exactly
  the output rows the gather above finds, in its order, with their summed
  corner weights, shift and drop column, and their count."""
  found = {}
  _dx_like_the_kernel(np.ones((1, h, w, 1)), np.ones((9, 1, 1)), "ERP",
                      found=found)
  sigma, _, _, drop_at = tsc.shift_tables(h, w, "ERP")
  entries, weights = tsc.transpose_table(h, w, "ERP")
  assert entries.shape == (h, 9, 4, 4) and weights.shape == (h, 9, 4, 2)
  for c in range(h):
    for k in range(9):
      want = found.get((c, k), [])
      assert (entries[c, k, :, 3] == len(want)).all()
      for e, (j, a_s, a_n) in enumerate(want):
        assert tuple(entries[c, k, e, :3]) == (j, sigma[j, k], drop_at[j, k])
        assert tuple(weights[c, k, e]) == (np.float32(a_s), np.float32(a_n))
      assert not weights[c, k, len(want):].any()


@pytest.mark.parametrize("sphere_type,h,w", LAYOUTS)
def test_dw_samples_like_the_kernel(sphere_type, h, w):
  """dw as ``bwd_weight_tc_kernel`` forms it: the forward's samples rebuilt
  from the shift tables, with both edge rules, against g."""
  x, _, g = _case(h, w, 4, 6, 5)
  want = tsc.sphere_conv_bwd_weight(torch.from_numpy(x), torch.from_numpy(g),
                                    sphere_type=sphere_type).numpy()
  got = np.einsum("nkhwc,nhwo->kco", _sample_like_the_kernel(x, sphere_type),
                  g)
  np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_erp_transpose_bounds_fit_the_kernel():
  """Rows, the ERP band, stay within 2 of the output row, and at most four
  output rows of one tap read one input row, at every size from the
  tests' to the full-resolution 1/4 map and beyond: the dx kernel's
  ``reach`` and ``MAXE`` hold for ERP as for Cassini."""
  for h, w in ((16, 32), (32, 64), (64, 128), (128, 256), (256, 512),
               (512, 1024)):
    reach, most = tsc.transpose_bounds(h, w, "ERP")
    assert reach == 2 and 2 <= most <= tsc._MAX_CONTRIB, (h, w, reach, most)


@pytest.mark.parametrize("shape,ok", [
    ((2, 128, 256, 64), True), ((2, 128, 256, 128), True),
    ((2, 64, 128, 128), True), ((2, 32, 64, 128), False),
    ((2, 128, 256, 12), False), ((2, 128, 128, 64), False),
    ((2, 256, 128, 64), False), ((1, 4096, 8192, 8), False)])
def test_erp_train_gate_is_the_jax_gate(monkeypatch, shape, ok):
  """``train_kernel_eligible(..., "ERP")`` is ``_pallas_eligible`` with the
  Pallas mode on and the TPU memory budget left out."""
  monkeypatch.setattr(jsc, "_PALLAS_MODE", "on")
  x = jax.ShapeDtypeStruct(shape, jnp.float32)   # the gate reads the shape
  assert jsc._pallas_eligible(x, 3, 3, "ERP", 1, 1, 1) == ok
  assert tsc.train_kernel_eligible(shape, "ERP") == ok
