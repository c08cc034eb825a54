"""The bridge of mode_tpu_torch (``ops/grid_sample.py``, ``geometry/``,
``pipeline.bridge_all_pairs``) against the JAX package, f32 on the CPU.

- Resampling: the cases of ``tests/test_grid_sample.py``, against torch's
  ``grid_sample`` and the JAX package's, at 1e-5.
- Projections: the sampling maps bit-equal, the outputs within 1e-5.
- Disparity <-> depth: rtol = atol = 1e-5, NaN where the JAX package has
  NaN.
- The z-buffer, in each of its three forms (``set_zbuffer_impl``:
  ``"scatter"``, ``"sort"``, ``"sort2x"``, set on both sides):
  ``_zbuffer_resolve`` on the same radii and targets as the JAX package's
  same form (ties, invalid radii, radii past the sentinel): ``best`` and
  ``winner`` bit-equal; the re-projection from the same depth map bit-equal
  at >= 99.9% of pixels per pair; single and batched calls bit-equal to the
  port's ``"sort"``; batched bit-equal to per-pair.
- The bridge from the same disparities: the confidences it carries (which
  show each target's winner) bit-equal at >= 99.9% of pixels per pair, and
  the depths within 4e-7 of their value (about 3 f32 steps) there. They are
  not bit-equal: the sine law's ``sin`` is glibc's ``sinf`` in the JAX
  package (through XLA on the CPU), which is not correctly rounded, and the
  port's is rounded once from f64; the two part in the last bit at ~1% of
  inputs, and that step carries through the rotations and the radii. The
  counts are printed (``-s``).
"""

import importlib
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mode_tpu import pipeline as jpipe
from mode_tpu.geometry import projection as jproj
from mode_tpu.geometry import reprojection as jrep
from mode_tpu_torch import pipeline as tpipe
from mode_tpu_torch.geometry import projection as tproj
from mode_tpu_torch.geometry import reprojection as trep
from mode_tpu_torch.ops import grid_sample as tgs

# the module (mode_tpu.ops re-exports a function under its name)
jgs = importlib.import_module("mode_tpu.ops.grid_sample")

torch.set_num_threads(2)

SIZES = [(32, 16), (64, 32)]
# share of pixels per pair that must agree (bit-equal or within DEPTH_RTOL)
AGREE = 0.999
DEPTH_RTOL = 4e-7


def _t(a):
  return torch.from_numpy(np.ascontiguousarray(a))


# --- resampling ---------------------------------------------------------------


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
@pytest.mark.parametrize("padding_mode", ["border", "zeros"])
def test_grid_sample_matches_torch_and_jax(rng, mode, padding_mode):
  b, h, w, c = 2, 9, 13, 3
  img = rng.normal(size=(b, h, w, c)).astype(np.float32)
  grid = rng.uniform(-1.4, 1.4, size=(b, 7, 11, 2)).astype(np.float32)
  got = tgs.grid_sample(_t(img), _t(grid), mode=mode,
                        padding_mode=padding_mode).numpy()
  ref = F.grid_sample(_t(img).permute(0, 3, 1, 2), _t(grid), mode=mode,
                      padding_mode=padding_mode, align_corners=True)
  np.testing.assert_allclose(got, ref.permute(0, 2, 3, 1).numpy(),
                             rtol=1e-5, atol=1e-5)
  want = np.asarray(jgs.grid_sample(img, grid, mode=mode,
                                    padding_mode=padding_mode))
  np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_grid_sample_exact_integer_coords(rng):
  b, h, w, c = 1, 6, 8, 2
  img = rng.normal(size=(b, h, w, c)).astype(np.float32)
  ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
  grid = np.stack([xs / (w - 1) * 2 - 1, ys / (h - 1) * 2 - 1],
                  -1)[None].astype(np.float32)
  np.testing.assert_allclose(tgs.grid_sample(_t(img), _t(grid)).numpy(), img,
                             rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("padding_mode", ["border", "zeros"])
def test_sample_points_match_jax(rng, padding_mode):
  img = rng.normal(size=(7, 10, 4)).astype(np.float32)
  y = rng.uniform(-1.5, 7.5, size=(5, 6)).astype(np.float32)
  x = rng.uniform(-1.5, 10.5, size=(5, 6)).astype(np.float32)
  for tfn, jfn in ((tgs.sample_bilinear, jgs.sample_bilinear),
                   (tgs.sample_nearest, jgs.sample_nearest)):
    got = tfn(_t(img), _t(y), _t(x), padding_mode).numpy()
    want = np.asarray(jfn(img, y, x, padding_mode))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# --- projections --------------------------------------------------------------


def test_cassini_to_erp_matches_jax(rng):
  img = rng.normal(size=(2, 16, 8, 3)).astype(np.float32)
  for tm, jm in zip(tproj._cassini_to_erp_pix(16, 8),
                    jproj._cassini_to_erp_pix(16, 8)):
    assert np.array_equal(tm, jm)
  got = tproj.cassini_to_erp(_t(img)).numpy()
  assert got.shape == (2, 8, 16, 3)
  np.testing.assert_allclose(got, np.asarray(jproj.cassini_to_erp(img)),
                             rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("angles", [
    trep.DEEP360_PAIR_TRANSFORMS["13"][1],     # the bridge's "rot" pairs
    trep.DEEP360_PAIR_TRANSFORMS["14"][1],
    (0.3, -0.7, 1.1)])
def test_rotate_cassini_matches_jax(rng, angles):
  img = rng.normal(size=(2, 20, 10, 2)).astype(np.float32)
  for tm, jm in zip(tproj._rotate_cassini_pix(20, 10, *angles),
                    jproj._rotate_cassini_pix(20, 10, *angles)):
    assert np.array_equal(tm, jm)
  got = tproj.rotate_cassini(_t(img), *angles).numpy()
  np.testing.assert_allclose(got, np.asarray(jproj.rotate_cassini(img,
                                                                  *angles)),
                             rtol=1e-5, atol=1e-5)


def test_erp_to_rect_cassini_matches_jax(rng):
  erp = rng.normal(size=(1, 12, 24, 3)).astype(np.float32)
  r = tproj.rodrigues(np.array([0, 0, -np.pi / 2]))
  assert np.array_equal(r, jproj.rodrigues(np.array([0, 0, -np.pi / 2])))
  key = (12, 24, 16, 8, np.ascontiguousarray(r, np.float64).tobytes())
  for tm, jm in zip(tproj._erp_to_rect_pix(*key), jproj._erp_to_rect_pix(*key)):
    assert np.array_equal(tm, jm)
  got = tproj.erp_to_rect_cassini(_t(erp), r, 16, 8).numpy()
  want = np.asarray(jproj.erp_to_rect_cassini(erp, r, 16, 8))
  np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_rotation_helpers_match_jax():
  for args in [(0.3, -0.2, 0.9), (0.5 * math.pi, 0.0, 0.0)]:
    assert np.array_equal(tproj.rotation_matrix(*args),
                          jproj.rotation_matrix(*args))
  for vec in ([0, 0, -np.pi / 4], [0.3, -0.2, 0.9], [0, 0, 0]):
    assert np.array_equal(tproj.rodrigues(np.array(vec)),
                          jproj.rodrigues(np.array(vec)))
  for n, full in ((512, True), (1024, False), (7, True)):
    assert np.array_equal(tproj._axis_angles(n, full),
                          jproj._axis_angles(n, full))


# --- disparity <-> depth ------------------------------------------------------


@pytest.mark.parametrize("baseline", [1.0, math.sqrt(2.0), 0.26])
def test_cassini_disp_to_depth_matches_jax(rng, baseline):
  disp = (rng.uniform(-2, 40, size=(3, 20, 10))
          * rng.integers(0, 2, size=(3, 20, 10))).astype(np.float32)
  got = trep.cassini_disp_to_depth(_t(disp), baseline).numpy()
  want = np.asarray(jrep.cassini_disp_to_depth(disp, baseline))
  np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_depth_to_cassini_disp_matches_jax(rng):
  depth = rng.uniform(-5, 1200, size=(32, 16)).astype(np.float32)
  depth[rng.random(size=depth.shape) < 0.1] = 0.0
  got = trep.depth_to_cassini_disp(_t(depth), 0.26, 1000.0).numpy()
  want = np.asarray(jrep.depth_to_cassini_disp(depth, 0.26, 1000.0))
  assert np.array_equal(np.isnan(got), np.isnan(want))
  assert np.isnan(want).any()
  ok = ~np.isnan(want)
  np.testing.assert_allclose(got[ok], want[ok], rtol=1e-5, atol=1e-5)


# --- the z-buffer -------------------------------------------------------------


FORMS = ["scatter", "sort", "sort2x"]


@pytest.fixture(params=FORMS)
def zbuffer_form(request):
  """Both packages' z-buffer form set to the case's, and "sort" (the
  default of both) restored after: the form is module-wide state."""
  try:
    trep.set_zbuffer_impl(request.param)
    jrep.set_zbuffer_impl(request.param)
    yield request.param
  finally:
    trep.set_zbuffer_impl("sort")
    jrep.set_zbuffer_impl("sort")


def test_zbuffer_default_is_sort_and_an_unknown_form_raises():
  assert trep._ZBUFFER_IMPL == "sort"
  with pytest.raises(ValueError, match="sort3x"):
    trep.set_zbuffer_impl("sort3x")
  assert trep._ZBUFFER_IMPL == "sort"


def test_zbuffer_resolve_is_bit_equal_to_jax(rng, zbuffer_form):
  """The same radii and targets on both sides, in the same form: many
  collisions (targets from a tenth of the cells), forced ties (radii from a
  short list), invalid sources (inf), radii past the sentinel and exactly
  at it."""
  n = 4096
  tgt = rng.integers(0, n // 10, size=n).astype(np.int32)
  r2 = rng.choice(np.float32([0.5, 1.25, 3.0, 7.5]), size=n)
  r2 = np.where(rng.random(n) < 0.5, rng.uniform(0, 50, n), r2)
  r2 = r2.astype(np.float32)
  r2[rng.random(n) < 0.1] = np.inf
  r2[rng.random(n) < 0.05] = 150000.0
  r2[rng.random(n) < 0.02] = trep._SENTINEL
  r2[:3] = 0.0
  jbest, jwin = (np.asarray(a) for a in jrep._zbuffer_resolve(
      jnp.asarray(r2), jnp.asarray(tgt), n))
  best, win = trep._zbuffer_resolve(_t(r2), _t(tgt), n)
  assert best.dtype == torch.float32
  assert np.array_equal(best.numpy().view(np.uint32), jbest.view(np.uint32))
  assert np.array_equal(win.numpy(), jwin)
  assert (jwin < n).sum() > 100 and (jwin == n).sum() > 100
  # a target whose least radius is exactly the sentinel
  assert (jbest == trep._SENTINEL).sum() > 0


def _depth_case(rng, h, w, k=1):
  depth = np.abs(rng.normal(3.0, 4.0, size=(k, h, w))).astype(np.float32)
  depth[rng.random(size=depth.shape) < 0.15] = 0.0
  depth[rng.random(size=depth.shape) < 0.05] = 150000.0
  conf = rng.uniform(0, 1, size=(k, h, w)).astype(np.float32)
  return depth, conf


def _agree(label, got, want, rtol=0.0):
  """Count and print the pixels where ``got`` and ``want`` differ (beyond
  ``rtol`` of ``want``), and hold them to 1 - AGREE of the map."""
  if rtol:
    differ = np.abs(got - want) > rtol * np.abs(want)
  else:
    differ = got.view(np.uint32) != want.view(np.uint32)
  print(f"{label}: {int(differ.sum())} of {differ.size} pixels differ",
        flush=True)
  assert differ.mean() <= 1 - AGREE, (label, int(differ.sum()))


@pytest.mark.parametrize("h,w", SIZES)
@pytest.mark.parametrize("pair", ["23", "24", "34"])
def test_view_transform_matches_jax(rng, h, w, pair):
  depth, conf = _depth_case(rng, h, w)
  args = trep.DEEP360_PAIR_TRANSFORMS[pair][1]
  jv, jc = (np.asarray(a) for a in jrep.depth_view_transform_with_conf(
      depth[0], conf[0], *args))
  v, c = trep.depth_view_transform_with_conf(_t(depth[0]), _t(conf[0]),
                                             *args)
  _agree(f"view transform {pair} {h}x{w} depth", v.numpy(), jv)
  _agree(f"view transform {pair} {h}x{w} conf", c.numpy(), jc)


def test_batched_view_transforms_bit_equal_per_pair(rng):
  params = tuple(trep.DEEP360_PAIR_TRANSFORMS[p][1] for p in ("23", "24",
                                                               "34"))
  depths, confs = _depth_case(rng, 40, 20, 3)
  bd, bc = trep.depth_view_transforms_batched(_t(depths), _t(confs), params)
  for k in range(3):
    v, c = trep.depth_view_transform_with_conf(_t(depths[k]), _t(confs[k]),
                                               *params[k])
    assert torch.equal(bd[k], v) and torch.equal(bc[k], c), k


def _bits_equal(a, b):
  return np.array_equal(a.numpy().view(np.uint32), b.numpy().view(np.uint32))


def test_zbuffer_forms_are_bit_equal_to_sort(rng, zbuffer_form):
  """Single and batched (K = 3, the three "trans" pairs) re-projections in
  the case's form, bit-equal to the port's "sort" on the same maps; and
  the single call against the JAX package's same form."""
  params = tuple(trep.DEEP360_PAIR_TRANSFORMS[p][1] for p in ("23", "24",
                                                               "34"))
  depths, confs = _depth_case(rng, 64, 32, 3)
  bd, bc = trep.depth_view_transforms_batched(_t(depths), _t(confs), params)
  singles = [trep.depth_view_transform_with_conf(_t(depths[k]), _t(confs[k]),
                                                 *params[k])
             for k in range(3)]
  jv, jc = (np.asarray(a) for a in jrep.depth_view_transform_with_conf(
      depths[0], confs[0], *params[0]))
  trep.set_zbuffer_impl("sort")
  sd, sc = trep.depth_view_transforms_batched(_t(depths), _t(confs), params)
  assert _bits_equal(bd, sd) and _bits_equal(bc, sc)
  for k, (v, c) in enumerate(singles):
    assert _bits_equal(v, sd[k]) and _bits_equal(c, sc[k]), k
  _agree(f"view transform ({zbuffer_form}) depth", singles[0][0].numpy(), jv)
  _agree(f"view transform ({zbuffer_form}) conf", singles[0][1].numpy(), jc)


@pytest.mark.parametrize("h,w", SIZES)
def test_bridge_all_pairs_matches_jax(rng, h, w):
  disps = rng.uniform(0, 12, size=(6, h, w)).astype(np.float32)
  disps[rng.random(size=disps.shape) < 0.05] = 0.0
  confs = rng.uniform(0, 1, size=(6, h, w)).astype(np.float32)
  jd, jc = (np.asarray(a) for a in jpipe.bridge_all_pairs(disps, confs))
  d, c = tpipe.bridge_all_pairs(_t(disps), _t(confs))
  assert d.shape == c.shape == (6, h, w)
  for k, pair in enumerate(tpipe.CAM_PAIRS):
    bits = int((d[k].numpy().view(np.uint32) != jd[k].view(np.uint32)).sum())
    print(f"bridge {pair} {h}x{w}: depth not bit-equal at {bits} pixels",
          flush=True)
    _agree(f"bridge {pair} {h}x{w} conf", c[k].numpy(), jc[k])
    _agree(f"bridge {pair} {h}x{w} depth beyond {DEPTH_RTOL}", d[k].numpy(),
           jd[k], DEPTH_RTOL)


@pytest.mark.parametrize("pair", tpipe.CAM_PAIRS)
def test_disp_to_depth_at_cam1_matches_bridge(rng, pair):
  disp = rng.uniform(0, 30, size=(32, 16)).astype(np.float32)
  conf = rng.uniform(0, 1, size=(32, 16)).astype(np.float32)
  d, c = trep.disp_to_depth_at_cam1(_t(disp), _t(conf), pair)
  jd, jc = (np.asarray(a) for a in jrep.disp_to_depth_at_cam1(disp, conf,
                                                              pair))
  np.testing.assert_allclose(d.numpy(), jd, rtol=DEPTH_RTOL, atol=0)
  np.testing.assert_array_equal(c.numpy(), jc)
