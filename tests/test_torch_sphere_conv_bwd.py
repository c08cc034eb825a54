"""The sphere conv's backward in mode_tpu_torch (``sphere_conv_backward``,
K3b's plain version, CPU, f32) against the JAX package's Pallas backward
``sphere_conv_cassini_pallas_bwd`` in interpret mode and against autograd
of the plain forward; and numpy models of the two CUDA kernels' arithmetic
(the dx gather over the forward's shift tables, the dw samples) against
the plain version, with the edge rules that the transpose must keep.

Tolerance against Pallas rtol = atol = 2e-4, the JAX package's own bar
between its Pallas backward and its XLA VJP
(``tests/test_pallas_sphere_conv.py``); against autograd, which sums the
same products in another order, 1e-5 of the largest gradient.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from mode_tpu.ops.pallas import sphere_conv_kernel as jsck
from mode_tpu_torch.ops import sphere_conv as tsc
from tests.test_torch_sphere_conv import _shift_sample

torch.set_num_threads(2)


@pytest.fixture
def interpret_pallas(monkeypatch):
  orig = pl.pallas_call
  monkeypatch.setattr(pl, "pallas_call",
                      functools.partial(orig, interpret=True))


def _case(h, w, cin, cout, seed=0):
  rng = np.random.default_rng(seed)
  x = rng.normal(size=(2, h, w, cin)).astype(np.float32)
  wgt = (rng.normal(size=(3, 3, cin, cout)) * 0.2).astype(np.float32)
  g = rng.normal(size=(2, h, w, cout)).astype(np.float32)
  return x, wgt, g


def _torch_weight(w_hwio):
  return torch.from_numpy(np.ascontiguousarray(
      np.transpose(w_hwio, (3, 2, 0, 1))))


@pytest.mark.parametrize("h,w,cin,cout,bj", [(32, 16, 8, 16, 8),
                                             (64, 32, 16, 8, 4)])
def test_plain_backward_matches_pallas(interpret_pallas, h, w, cin, cout,
                                       bj):
  x, wgt, g = _case(h, w, cin, cout)
  dx, dw = tsc.sphere_conv_backward(torch.from_numpy(x), _torch_weight(wgt),
                                    torch.from_numpy(g))
  jdx, jdw = jsck.sphere_conv_cassini_pallas_bwd(
      jnp.asarray(x), jnp.asarray(wgt), jnp.asarray(g), block_j=bj)
  assert dx.dtype == torch.float32 and dw.dtype == torch.float32
  np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), rtol=2e-4,
                             atol=2e-4)
  # torch layout (Cout, Cin, 3, 3) back to the JAX package's HWIO
  np.testing.assert_allclose(dw.permute(2, 3, 1, 0).numpy(), np.asarray(jdw),
                             rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("h,w,cin,cout", [(32, 16, 8, 16), (64, 32, 16, 8)])
def test_plain_backward_matches_autograd(h, w, cin, cout):
  """The explicit transpose equals autograd of the plain forward; dw comes
  back in the layout of the weight passed."""
  x, wgt, g = (torch.from_numpy(a) for a in _case(h, w, cin, cout, 1))
  wt = _torch_weight(wgt.numpy()).requires_grad_()
  xg = x.clone().requires_grad_()
  want_dx, want_dw = torch.autograd.grad(tsc.sphere_conv(xg, wt), (xg, wt),
                                         g)
  dx, dw = tsc.sphere_conv_backward(x, wt.detach(), g)
  _, dw_packed = tsc.sphere_conv_backward(x, tsc.pack_weight(wt.detach()), g)
  for got, want in ((dx, want_dx), (dw, want_dw),
                    (dw_packed, tsc.pack_weight(want_dw))):
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_bf16_backward_keeps_dx_type_and_dw_in_f32():
  x, wgt, g = _case(32, 16, 8, 16, 2)
  xb = torch.from_numpy(x).bfloat16()
  dx, dw = tsc.sphere_conv_backward(xb, _torch_weight(wgt).bfloat16(),
                                    torch.from_numpy(g).bfloat16())
  assert dx.dtype == torch.bfloat16 and dw.dtype == torch.float32


def _dx_like_the_kernel(g, wk, h, w, seam=True, drop=True, found=None):
  """dx as the gather that ``sphere_conv_bwd.cu:bwd_input_tc_kernel``
  runs: each input pixel (r, c) gathers, for each tap k, from the output
  columns j within ``reach`` of c whose corner c0 or c1 is c (the kernel
  reads them from ``transpose_table``); from output row (r - sigma) mod H
  through the (s, .) corners and (r - 1 - sigma) mod H through the
  successor corners; nothing through a successor corner at r = 0
  (``seam``) or from the output row drop_row (``drop``). ``found``, a dict,
  collects the (j, a_s, a_n) of each (c, k) in the order met."""
  sigma, colint, quad, drop_row = tsc.build_shift_tables(h, w, 3)
  reach, most = tsc.transpose_bounds(h, w)
  dcol = np.einsum("nhwo,kco->nhwkc", g, wk)          # (N, H, W, 9, Cin)
  r = np.arange(h)
  dx = np.zeros(g.shape[:3] + (wk.shape[1],), np.float64)
  for c in range(w):
    for k in range(9):
      used = 0
      for j in range(max(c - reach, 0), min(c + reach, w - 1) + 1):
        c0, c1 = colint[j, k].astype(np.int64)
        q = quad[j, k]
        a_s = (q[0] if c0 == c else 0.0) + (q[2] if c1 == c else 0.0)
        a_n = (q[1] if c0 == c else 0.0) + (q[3] if c1 == c else 0.0)
        if a_s == 0 and a_n == 0:
          continue
        used += 1
        if found is not None:
          found.setdefault((c, k), []).append((j, a_s, a_n))
        i_s = (r - sigma[j, k]) % h
        i_n = (i_s - 1) % h
        ws = np.full(h, a_s)
        wn = np.full(h, a_n)
        if drop:
          ws = np.where(i_s == drop_row[j, k], 0.0, ws)
          wn = np.where(i_n == drop_row[j, k], 0.0, wn)
        if seam:
          wn = np.where(r == 0, 0.0, wn)
        dx[:, :, c] += (ws[None, :, None] * dcol[:, i_s, j, k]
                        + wn[None, :, None] * dcol[:, i_n, j, k])
      assert used <= most
  return dx


def test_transpose_bounds_fit_the_kernel():
  """The dx kernel scans ``reach`` columns to each side and keeps at most
  four samples per (input column, tap): so do the Cassini grids from the
  tests' sizes to the production's and beyond."""
  for h, w in ((32, 16), (64, 32), (256, 128), (512, 256), (1024, 512)):
    reach, most = tsc.transpose_bounds(h, w)
    assert reach == 2 and 2 <= most <= tsc._MAX_CONTRIB, (h, w, reach, most)


@pytest.mark.parametrize("h,w", [(32, 16), (64, 32), (128, 64), (256, 128)])
def test_transpose_table_lists_the_gathers_entries(h, w):
  """The dx kernel's table (``transpose_table``) holds, for each (input
  column, tap), exactly the output columns the gather above finds, in its
  order, with their summed corner weights, shift and drop row, and their
  count; the slots past the count carry no weight."""
  found = {}
  g = np.ones((1, h, w, 1))
  _dx_like_the_kernel(g, np.ones((9, 1, 1)), h, w, found=found)
  sigma, _, _, drop_row = tsc.build_shift_tables(h, w, 3)
  entries, weights = tsc.transpose_table(h, w)
  assert entries.shape == (w, 9, 4, 4) and weights.shape == (w, 9, 4, 2)
  for c in range(w):
    for k in range(9):
      want = found.get((c, k), [])
      assert (entries[c, k, :, 3] == len(want)).all()
      for e, (j, a_s, a_n) in enumerate(want):
        assert tuple(entries[c, k, e, :3]) == (j, sigma[j, k],
                                               drop_row[j, k])
        assert tuple(weights[c, k, e]) == (np.float32(a_s), np.float32(a_n))
      assert not weights[c, k, len(want):].any()


def test_dx_gather_keeps_the_edge_rules():
  """At 64x32 the tables have a drop row (column 0, tap 5) and the
  successor corners reach the seam. The gather of the dx kernel
  (``bwd_input_tc_kernel``, whose CPU model is in
  ``tests/test_torch_tc_conv.py``) equals the plain scatter there, and each
  of the two rules is needed for that: without the seam or the drop rule
  the two part."""
  h, w = 64, 32
  _, _, _, drop_row = tsc.build_shift_tables(h, w, 3)
  assert (drop_row >= 0).sum() >= 1
  x, wgt, g = _case(h, w, 4, 6, 3)
  wk = wgt.reshape(9, 4, 6)
  want = tsc.sphere_conv_bwd_input(torch.from_numpy(g),
                                   torch.from_numpy(wk)).numpy()
  np.testing.assert_allclose(_dx_like_the_kernel(g, wk, h, w), want,
                             rtol=1e-4, atol=1e-4)
  for rule in ("seam", "drop"):
    wrong = _dx_like_the_kernel(g, wk, h, w, **{rule: False})
    assert np.abs(wrong - want).max() > 0.1, rule


def test_dw_samples_like_the_kernel():
  """dw as ``bwd_weight_tc_kernel`` forms it: the forward's samples rebuilt
  from the shift tables (with both edge rules) against g."""
  h, w = 64, 32
  x, wgt, g = _case(h, w, 4, 6, 4)
  col = _shift_sample(x, h, w)                        # (N, 9, H, W, Cin)
  want = tsc.sphere_conv_bwd_weight(torch.from_numpy(x),
                                    torch.from_numpy(g)).numpy()
  np.testing.assert_allclose(np.einsum("nkhwc,nhwo->kco", col, g), want,
                             rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("sphere_type,shape,cout", [
    ("Cassini", (2, 256, 128, 64), 128),    # the layer-4 convs of a step
    ("Cassini", (2, 256, 128, 128), 128),
    ("ERP", (2, 128, 256, 64), 128),
    ("ERP", (2, 128, 256, 128), 128),
    ("Cassini", (1, 80, 40, 72), 40),       # runs of 32, 32 and 16 lanes
    ("ERP", (2, 24, 48, 8), 8),             # fewer stages than 44 splits
])
def test_weight_splits_cover_every_pixel_once(monkeypatch, sphere_type, shape,
                                              cout):
  """The dw kernel's split of its K stages (``_weight_splits`` for an
  H100's 132 SMs; a stage is a run of 32 lanes of one band index of one
  image, the last run of a band shorter where L is no multiple of 32)
  covers every pixel exactly once; at the step's layer-4 shapes 44 splits
  of 9 blocks fill three whole waves of the SMs."""
  monkeypatch.setattr(torch.cuda, "get_device_properties",
                      lambda device: type("P", (), {
                          "multi_processor_count": 132})())
  n, h, w, cin = shape
  nsplit, chunk = tsc._weight_splits(n, h, w, cin, cout, sphere_type, "cuda")
  erp = sphere_type == "ERP"
  band, lanes = (h, w) if erp else (w, h)
  runs = -(-lanes // 32)
  total = n * band * runs
  assert (nsplit - 1) * chunk < total <= nsplit * chunk
  hits = np.zeros(n * h * w, np.int64)
  for z in range(nsplit):                  # block z's range of stages
    for s in range(z * chunk, min(z * chunk + chunk, total)):
      l0, b, img = s % runs * 32, s // runs % band, s // runs // band
      lane = np.arange(l0, min(l0 + 32, lanes))
      np.add.at(hits, img * h * w + (b * w + lane if erp else lane * w + b),
                1)
  assert (hits == 1).all()
  tiles = 9 * -(-cin // (128 if cin > 64 else 64)) * -(-cout // 128)
  if total >= 132:
    assert tiles * nsplit % 132 == 0
  if max(h, w) == 256:
    assert (nsplit, chunk) == (44, 47)


@pytest.mark.parametrize("shape,ok", [
    ((2, 256, 128, 64), True), ((2, 256, 128, 128), True),
    ((2, 128, 64, 128), True), ((2, 64, 32, 128), False),
    ((2, 256, 128, 12), False), ((2, 256, 256, 64), False)])
def test_train_gate_is_the_jax_gate(monkeypatch, shape, ok):
  """``train_kernel_eligible`` is ``ops/sphere_conv.py:_pallas_eligible``
  with the Pallas mode on and the TPU memory budget left out."""
  import importlib
  jsc = importlib.import_module("mode_tpu.ops.sphere_conv")
  monkeypatch.setattr(jsc, "_PALLAS_MODE", "on")
  x = jnp.zeros(shape, jnp.float32)
  assert jsc._pallas_eligible(x, 3, 3, "Cassini", 1, 1, 1) == ok
  assert tsc.train_kernel_eligible(shape) == ok
