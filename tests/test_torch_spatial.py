"""The ``spatial`` axis of mode_tpu_torch (``parallel/mesh.py``,
``parallel/shard_ops.py``, the kernels' halo forms in ``ops/conv3d.py`` and
``ops/conv2d.py``, the regression head's row window in
``ops/regression.py``, the frame in ``pipeline.py``) on the CPU, f32.

1. The collectives as gloo ranks (``parallel/launch.py:run_ranks``; the
   ranks' code is ``tests/torch_spatial_ranks.py``, which imports no JAX):
   ``halo_concat`` and ``gather_rows`` at worlds of 2 and 4, on ``(1, 2)``,
   ``(1, 4)`` and ``(2, 2)`` meshes, against numpy slices with zero planes
   at the mesh's edges; rank r at mesh place ``(r // S, r % S)``.
2. Each plain halo form against the JAX package's ``m_halo`` kernel
   (``mode_tpu/ops/pallas/conv3d_kernel.py``) in interpret mode on the same
   haloed rows, lane-major layouts converted here, and the row window of
   the regression head against the JAX kernel's ``ys``/``mh_win``/``h_out``
   tables, at 1e-5 (both sides sum the same products in other orders).
3. Each plain halo form against the matching rows of the port's unsharded
   plain op, every shard of a 4-way split, at 1e-6.
4. ``ModeDisparity`` in eval with the trained ``tests/data/
   trained_mirror.npz`` (64x32, maxdisp 16) as ``(1, 2)`` and ``(2, 2)``
   gloo ranks, the frame gathered, against the single-device JAX model
   (``tests/test_trained_parity_midres.py``'s bars: 1e-3 px disparity MAE,
   1e-2 max, 1e-3 confidence MAE) and against the port in one process
   (1e-5); 29 collectives a call (28 halo exchanges, K2's gather). The
   ERP model (32x64) on a ``(1, 2)`` mesh against one process.
5. The gates: rows that do not split, a stride-2 conv whose shard would
   not start on an even global row, the fusion net's training forward
   (stage 1 trains under the mesh: ``tests/test_torch_spatial_train.py``)
   and a mesh off the world size all raise, naming what is wrong.
6. The 2-D conv's halo form (K8's ``m_halo``, the fusion net's convs under
   the mesh): the plain form against ``conv2d_band_pallas(..., m_halo=True)``
   in interpret mode at 1e-5 (Cin 12 padded to 16, a residual, ReLU on and
   off), and the plain form and the library form
   (``shard_ops.conv2d_library_sharded``) against the rows of the unsharded
   conv, every shard of a 4-way split, at 1e-6; dilation 2 refused.
7. The frame (``TwoStagePipeline``, 64x32, maxdisp 16, the trained stage 1,
   a seeded fusion net) on a ``(1, 2)`` gloo mesh against the port's
   one-process frame at 1e-5, with ``FRAME_COLLECTIVES`` collectives; the
   fusion net's and the frame's refusals (an H off a multiple of 8 S,
   training, ``Baseline``, a data axis above 1). The fusion net alone on
   ``(1, 2)`` and ``(2, 2)`` meshes is in ``tests/test_torch_fusion.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from mode_tpu.models import disparity as jdisp
from mode_tpu.models import fusion as jfusion
from mode_tpu.ops.pallas import conv2d_kernel as c2k
from mode_tpu.ops.pallas import conv3d_kernel as ck
from mode_tpu.ops.pallas import regression_kernel as rk
from mode_tpu.utils.torch_convert import convert_state_dict
from mode_tpu_torch.models import disparity as tdisp
from mode_tpu_torch.models import fusion as tfusion
from mode_tpu_torch.ops import conv2d as C2
from mode_tpu_torch.ops import conv3d as C
from mode_tpu_torch.ops import regression as R
from mode_tpu_torch.parallel import shard_ops
from mode_tpu_torch.parallel.launch import run_ranks
from mode_tpu_torch.pipeline import TwoStagePipeline
from mode_tpu_torch.utils.convert import load_npz
from tests import torch_spatial_ranks as ranks
from tests.background import started
from tests.port_weights import carry, numpy_variables
from tests.test_torch_fusion import HEAD_SCALE
from tests.trained_mirror import _make_batch, get_trained_state_dict

torch.set_num_threads(2)

TIMEOUT = 300                # seconds a run_ranks call may take
NPZ, MAXDISP, H, W = "tests/data/trained_mirror.npz", 16, 64, 32
PRED_MAE, PRED_MAX, CONF_MAE = 1e-3, 1e-2, 1e-3
ONE_PROCESS = 1e-5
# a call's collectives: 16 stride-1 convs (the 3 heads among them), 6
# stride-2 convs and 6 deconvs exchange halos; K2 gathers its input
COLLECTIVES = 16 + 6 + 6 + 1
# a frame's at stage1_chunk 6: one stage-1 call, the gathers of its
# disparities and confidences, the fusion net's 38 3x3 convs' halo
# exchanges, the fused map's gather
FUSION_COLLECTIVES = 38
FRAME_COLLECTIVES = COLLECTIVES + 2 + FUSION_COLLECTIVES + 1


@pytest.fixture
def interpret_pallas(monkeypatch):
  orig = pl.pallas_call
  monkeypatch.setattr(pl, "pallas_call",
                      functools.partial(orig, interpret=True))


def _haloed(x: np.ndarray, r0: int, r1: int) -> np.ndarray:
  """Rows [r0, r1) of axis 2 of ``x`` with the rows either side, zeros
  past the ends (what ``halo_concat`` gives the rank holding them)."""
  pad = np.pad(x, [(0, 0), (0, 0), (1, 1)] + [(0, 0)] * (x.ndim - 3))
  return np.ascontiguousarray(pad[:, :, r0:r1 + 2])


# --- 1. the collectives -----------------------------------------------------

@pytest.fixture(scope="module")
def halos():
  x = np.random.default_rng(0).normal(size=(1, 2, 8, 3, 4)).astype(
      np.float32)
  return x, {(world, spatial): run_ranks(
      ranks.halo_and_gather, world, (x, 2, spatial), timeout=TIMEOUT,
      device="cpu", threads=1)
             for world, spatial in ((2, 2), (4, 4), (4, 2))}


@pytest.mark.parametrize("world,spatial", [(2, 2), (4, 4), (4, 2)])
def test_halo_concat_and_gather_rows(halos, world, spatial):
  """Rank r sits at ``(r // S, r % S)``, holds rows ``[s n / S, (s + 1) n
  / S)``, gets its neighbours' adjacent planes (zeros at the ends) from
  one all-gather and gathers the whole axis back in order."""
  x, outs = halos
  n = x.shape[2] // spatial
  for r, out in enumerate(outs[(world, spatial)]):
    s = r % spatial
    assert (out["rank"], out["spatial_rank"]) == (r // spatial, s)
    assert out["rows"] == (s * n, (s + 1) * n)
    np.testing.assert_array_equal(out["halo"],
                                  _haloed(x, s * n, (s + 1) * n))
    np.testing.assert_array_equal(out["gathered"], x)
    assert out["collectives"] == 2


# --- 2. the halo forms against the JAX package's m_halo kernels --------------

def _conv_inputs(seed, shape, cin, cout, transpose=False):
  rng = np.random.default_rng(seed)
  x = (rng.normal(size=(*shape, cin)) * 0.3).astype(np.float32)
  wshape = (cin, cout, 3, 3, 3) if transpose else (cout, cin, 3, 3, 3)
  w = (rng.normal(size=wshape) * 0.1).astype(np.float32)
  scale = (rng.normal(size=(cout,)) * 0.2 + 1.0).astype(np.float32)
  bias = (rng.normal(size=(cout,)) * 0.1).astype(np.float32)
  return x, w, scale, bias, rng


def _lane(a):
  """NDHWC -> the JAX kernels' lane-major (B, D, M = H, C, L = W)."""
  return jnp.asarray(np.transpose(a, (0, 1, 2, 4, 3)))


def _ndhwc(a):
  return np.transpose(np.asarray(a), (0, 1, 2, 4, 3))


def _t(a):
  return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("rows,cout,res,relu", [
    ((4, 8), 8, True, False),      # a middle shard of 12 rows, residual
    ((0, 4), 16, False, True),     # the top shard: a zero halo above
    ((8, 12), 1, False, False),    # the bottom shard, the Cout-1 head
])
def test_s1_halo_form_matches_m_halo_pallas(interpret_pallas, rows, cout,
                                            res, relu):
  """``conv3d_s1_bn_act(h_halo=True)`` against ``conv3d_band_pallas(...,
  m_halo=True)`` (K1, ``conv3d_kernel.py:273-335``) on the same rows."""
  x, w, scale, bias, rng = _conv_inputs(0, (1, 2, 12, 128), 8, cout)
  xh = _haloed(x, *rows)
  r = ((rng.normal(size=(1, 2, rows[1] - rows[0], 128, cout)) * 0.3).astype(
      np.float32) if res else None)
  want = ck.conv3d_band_pallas(
      _lane(xh), jnp.asarray(np.transpose(w, (2, 3, 4, 1, 0))),
      jnp.asarray(scale), jnp.asarray(bias),
      None if r is None else _lane(r), relu=relu, m_halo=True)
  got = C.conv3d_s1_bn_act(_t(xh), _t(w), _t(scale), _t(bias), _t(r), relu,
                           h_halo=True)
  assert got.shape == (1, 2, rows[1] - rows[0], 128, cout)
  np.testing.assert_allclose(got.numpy(), _ndhwc(want), rtol=1e-5,
                             atol=1e-5)


@pytest.mark.parametrize("rows", [(4, 8), (0, 4)])
def test_s2_halo_form_matches_m_halo_pallas(interpret_pallas, rows):
  """``conv3d_s2_bn_act(h_halo=True)`` against ``conv3d_band_s2_pallas(
  ..., m_halo=True)`` (K4, ``:484-520``): a shard starting on an even
  global row, its two output rows of the unsharded eight."""
  x, w, scale, bias, _ = _conv_inputs(1, (1, 2, 16, 128), 8, 16)
  xh = _haloed(x, *rows)
  want = ck.conv3d_band_s2_pallas(
      _lane(xh), jnp.asarray(np.transpose(w, (2, 3, 4, 1, 0))),
      jnp.asarray(scale), jnp.asarray(bias), relu=True, m_halo=True)
  got = C.conv3d_s2_bn_act(_t(xh), _t(w), _t(scale), _t(bias), True,
                           h_halo=True)
  assert got.shape == (1, 1, 2, 64, 16)
  np.testing.assert_allclose(got.numpy(), _ndhwc(want), rtol=1e-5,
                             atol=1e-5)


@pytest.mark.parametrize("rows", [(2, 4), (6, 8)])
def test_deconv_halo_form_matches_m_halo_pallas(interpret_pallas, rows):
  """``deconv3d_bn_act(h_halo=True)`` against
  ``conv3d_band_deconv_pallas(..., m_halo=True)`` (K5, ``:681-737``):
  twice the shard's rows, the lower halo row read, the upper one not (the
  bottom shard's lower halo is zeros)."""
  x, w, scale, bias, _ = _conv_inputs(2, (1, 2, 8, 128), 8, 8,
                                      transpose=True)
  xh = _haloed(x, *rows)
  want = ck.conv3d_band_deconv_pallas(
      _lane(xh), jnp.asarray(np.transpose(w, (2, 3, 4, 1, 0))),
      jnp.asarray(scale), jnp.asarray(bias), relu=True, lane_axis=3,
      m_halo=True)
  got = C.deconv3d_bn_act(_t(xh), _t(w), _t(scale), _t(bias), relu=True,
                          h_halo=True)
  assert got.shape == (1, 4, 4, 256, 8)
  np.testing.assert_allclose(got.numpy(), _ndhwc(want), rtol=1e-5,
                             atol=1e-5)


@pytest.mark.parametrize("spatial,s", [(2, 1), (4, 0), (4, 2)])
def test_regression_window_matches_the_pallas_window(interpret_pallas,
                                                     spatial, s):
  """``fused_disparity_regression(row0=, h_out=)`` against the JAX kernel
  given the shard's slice of its own row tables (``ys``, ``mh_win``,
  ``h_out``), as ``mode_tpu/parallel/shard_ops.py:238-263`` gives them."""
  n, d, hq, wq, maxdisp, h, w = 1, 8, 16, 128, 16, 64, 256
  cost = (np.random.default_rng(3).normal(size=(n, d, hq, wq))
          * 2.0).astype(np.float32)
  h_loc = h // spatial
  nt = h_loc // rk.TY
  _, _, ys, mh_win, _ = rk._tables(d, hq, wq, maxdisp, h, w)
  want_pred, want_conf = rk.fused_disparity_regression(
      jnp.asarray(cost), maxdisp, h, w, ys=jnp.asarray(ys[s * nt:][:nt]),
      mh_win=jnp.asarray(mh_win[s * nt:][:nt]), h_out=h_loc)
  pred, conf = R.fused_disparity_regression(torch.from_numpy(cost), maxdisp,
                                            h, w, row0=s * h_loc,
                                            h_out=h_loc)
  assert pred.shape == conf.shape == (n, h_loc, w)
  np.testing.assert_allclose(pred.numpy(), np.asarray(want_pred), rtol=1e-5,
                             atol=1e-5)
  # conf jumps where round(pred) does: a pred within f32 noise of k + 0.5
  # may probe different slices on the two sides
  want_pred = np.asarray(want_pred)
  tie = np.abs(want_pred - np.floor(want_pred) - 0.5) < 1e-4
  np.testing.assert_allclose(conf.numpy()[~tie],
                             np.asarray(want_conf)[~tie], rtol=1e-5,
                             atol=1e-5)


# --- 3. the halo forms against the unsharded plain ops -----------------------

SPLIT = 4


@pytest.mark.parametrize("op", ["s1", "s1_head", "s2", "deconv"])
def test_halo_forms_are_the_rows_of_the_whole_conv(op):
  """Every shard of a 4-way split, haloed as ``halo_concat`` hands it
  over, gives its rows of the conv of the whole volume: at stride 1 the
  shard's own rows, at stride 2 half of them from an even global row, for
  the deconv twice as many."""
  cout = 1 if op == "s1_head" else 8
  deconv = op == "deconv"
  x, w, scale, bias, rng = _conv_inputs(4, (2, 3, 16, 6), 8, cout, deconv)
  res = None
  if op in ("s1", "deconv"):
    rows = 2 * 16 if deconv else 16
    res = (rng.normal(size=(2, 6 if deconv else 3, rows, 12 if deconv else 6,
                            cout)) * 0.3).astype(np.float32)
  fn = {"s1": C.conv3d_s1_bn_act, "s1_head": C.conv3d_s1_bn_act,
        "deconv": C.deconv3d_bn_act}.get(op)
  args = (_t(scale), _t(bias))
  if op == "s2":
    whole = C.conv3d_s2_bn_act(_t(x), _t(w), *args, relu=True)
  else:
    whole = fn(_t(x), _t(w), *args, _t(res), relu=True)
  n = x.shape[2] // SPLIT
  per = {"s2": n // 2, "deconv": 2 * n}.get(op, n)
  for s in range(SPLIT):
    xh = _t(_haloed(x, s * n, (s + 1) * n))
    rows = slice(s * per, (s + 1) * per)
    if op == "s2":
      got = C.conv3d_s2_bn_act(xh, _t(w), *args, relu=True, h_halo=True)
    else:
      r = None if res is None else _t(res[:, :, rows])
      got = fn(xh, _t(w), *args, r, relu=True, h_halo=True)
    torch.testing.assert_close(got, whole[:, :, rows], rtol=1e-6, atol=1e-6)


def test_regression_window_is_the_rows_of_the_whole_head():
  cost = torch.from_numpy((np.random.default_rng(5).normal(
      size=(2, 4, 8, 8)) * 2.0).astype(np.float32))
  whole = R.fused_disparity_regression(cost, 16, 32, 32)
  for row0, h_out in ((0, 8), (8, 16), (24, 8), (5, 3)):
    got = R.fused_disparity_regression(cost, 16, 32, 32, row0=row0,
                                       h_out=h_out)
    for g, want in zip(got, whole):
      torch.testing.assert_close(g, want[:, row0:row0 + h_out], rtol=1e-6,
                                 atol=1e-6)
  with pytest.raises(ValueError, match="not rows of an output of 32"):
    R.fused_disparity_regression(cost, 16, 32, 32, row0=24, h_out=16)


def test_halo_forms_refuse_rows_they_cannot_take():
  w = torch.zeros((8, 8, 3, 3, 3))
  with pytest.raises(ValueError, match="even count"):
    C.conv3d_s2_bn_act(torch.zeros((1, 2, 5, 4, 8)), w, h_halo=True)
  with pytest.raises(ValueError, match="halo planes"):
    C.conv3d_s1_bn_act(torch.zeros((1, 2, 2, 4, 8)), w, h_halo=True)


# --- 4. the sharded model ---------------------------------------------------

@pytest.fixture(scope="module")
def pair():
  """The trained pair, NHWC."""
  rng = np.random.default_rng(5)
  left, right, _ = _make_batch(rng, batch=2, disps=(4, 12), h=H, w=W)
  return (left.permute(0, 2, 3, 1).contiguous().numpy(),
          right.permute(0, 2, 3, 1).contiguous().numpy())


@pytest.fixture(scope="module")
def sharded_started(pair):
  """The port's ranks on the pair, a ``(1, 2)`` and a ``(2, 2)`` mesh, one
  ``run_ranks`` call after the other in a thread of this process, so they
  run while the JAX model compiles."""
  left, right = pair

  def run():
    return {(d, s): run_ranks(ranks.sharded_eval, d * s,
                              (NPZ, MAXDISP, left, right, d, s),
                              timeout=TIMEOUT, device="cpu", threads=1)
            for d, s in ((1, 2), (2, 2))}

  return started(run)


@pytest.fixture(scope="module")
def frame(pair, sharded_started):
  """The trained pair, the single-device JAX model's (pred, conf) and the
  port's in one process."""
  left, right = pair
  jmodel = jdisp.ModeDisparity(maxdisp=MAXDISP, out_conf=True)
  variables = jax.eval_shape(lambda: jmodel.init(
      jax.random.PRNGKey(0), jnp.asarray(left), jnp.asarray(right),
      train=False))
  variables = jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype),
                                     variables)
  variables = convert_state_dict(get_trained_state_dict(), variables)
  jax_out = jax.jit(lambda v, a, b: jmodel.apply(v, a, b, train=False))(
      variables, jnp.asarray(left), jnp.asarray(right))
  port = load_npz(tdisp.ModeDisparity(MAXDISP, out_conf=True, device="cpu"),
                  NPZ)
  with torch.no_grad():
    one = port(torch.from_numpy(left), torch.from_numpy(right))
  return (left, right, [np.asarray(a) for a in jax_out],
          [t.numpy() for t in one])


@pytest.fixture(scope="module")
def sharded(frame, sharded_started):
  return sharded_started.result()


@pytest.mark.parametrize("data,spatial", [(1, 2), (2, 2)])
def test_sharded_eval_matches_the_single_device_jax_model(frame, sharded,
                                                          data, spatial):
  _, _, (j_pred, j_conf), _ = frame
  for r, out in enumerate(sharded[(data, spatial)]):
    assert out["place"] == (r // spatial, r % spatial)
    assert out["pred"].shape == (2 // data, H // spatial, W)
    err = np.abs(out["whole_pred"] - j_pred)
    assert err.mean() <= PRED_MAE and err.max() <= PRED_MAX, (err.mean(),
                                                              err.max())
    assert np.abs(out["whole_conf"] - j_conf).mean() <= CONF_MAE


def test_sharded_erp_eval_matches_one_process():
  """The ERP model (W = 2H) on a (1, 2) mesh: the feature extractor runs
  whole on each rank and only the cost volume's rows are split, so the
  layout does not enter; each rank's rows are its rows of one process's
  call."""
  rng = np.random.default_rng(7)
  left, right, _ = _make_batch(rng, batch=1, disps=(8,), h=W, w=H)
  left = left.permute(0, 2, 3, 1).contiguous().numpy()
  right = right.permute(0, 2, 3, 1).contiguous().numpy()
  port = load_npz(tdisp.ModeDisparity(MAXDISP, "Sphere", "ERP",
                                      out_conf=True, device="cpu"), NPZ)
  with torch.no_grad():
    pred, conf = (t.numpy() for t in port(torch.from_numpy(left),
                                          torch.from_numpy(right)))
  outs = run_ranks(ranks.sharded_eval, 2,
                   (NPZ, MAXDISP, left, right, 1, 2, "ERP"),
                   timeout=TIMEOUT, device="cpu", threads=1)
  for s, out in enumerate(outs):
    rows = slice(s * W // 2, (s + 1) * W // 2)
    np.testing.assert_allclose(out["pred"], pred[:, rows], rtol=0,
                               atol=ONE_PROCESS)
    np.testing.assert_allclose(out["conf"], conf[:, rows], rtol=0,
                               atol=ONE_PROCESS)


@pytest.mark.parametrize("data,spatial", [(1, 2), (2, 2)])
def test_sharded_eval_matches_one_process(frame, sharded, data, spatial):
  """Each rank's rows are its rows of the one-process frame; a call makes
  ``COLLECTIVES`` collectives on every rank."""
  pred, conf = frame[3]
  for r, out in enumerate(sharded[(data, spatial)]):
    b = slice(r // spatial * (2 // data), (r // spatial + 1) * (2 // data))
    rows = slice(r % spatial * (H // spatial),
                 (r % spatial + 1) * (H // spatial))
    np.testing.assert_allclose(out["pred"], pred[b, rows], rtol=0,
                               atol=ONE_PROCESS)
    np.testing.assert_allclose(out["conf"], conf[b, rows], rtol=0,
                               atol=ONE_PROCESS)
    np.testing.assert_allclose(out["whole_pred"], pred, rtol=0,
                               atol=ONE_PROCESS)
    assert out["collectives"] == COLLECTIVES


# --- 5. the gates -----------------------------------------------------------

def test_spatial_mesh_refusals():
  """On a (1, 2) mesh: 5 rows do not split; a stride-2 conv on 3 rows a
  rank (6 in all) would start rank 1 on an odd global row; a 72x36 pair
  gives 9 quarter-resolution rows a rank, so its stride-2 convs refuse;
  the fusion net's training raises (until stage 1 trained under the mesh,
  its training forward was the case); data 2 x spatial 2 is not a world
  of 2."""
  left = np.random.default_rng(6).normal(size=(1, 72, 36, 3)).astype(
      np.float32)
  out = run_ranks(ranks.refusals, 2, (NPZ, MAXDISP, left), timeout=TIMEOUT,
                  device="cpu", threads=1)
  for r in out:
    assert set(r) == {"rows", "stride2", "model_h", "train", "mesh"}
    assert "does not split over the 2 ranks" in r["rows"]
    assert "H % (2 x spatial) == 0: H 6 over 2" in r["stride2"]
    assert "H % (2 x spatial) == 0: H 18 over 2" in r["model_h"]
    assert r["train"].startswith("NotImplementedError: training under a "
                                 "spatial mesh is not ported for the "
                                 "fusion net")
    assert "must hold the world size, 2" in r["mesh"]


def test_chip_smoke_expects_the_spatial_counts():
  """``chip_smoke.py``'s ``sp_gloo_2`` expectations are the counts held
  here: one halo exchange per sharded 3-D conv and K2's gather (the
  collectives the ranks above count), the halo launches per kernel
  summing to them, and the model's three Cout-1 heads."""
  import chip_smoke
  assert chip_smoke.SP_COLLECTIVES == COLLECTIVES
  assert sum(chip_smoke.SP_HALO.values()) == COLLECTIVES
  port = tdisp.ModeDisparity(MAXDISP, device="cpu")
  heads = [m for m in port.modules()
           if getattr(m, "weight", None) is not None
           and m.weight.dim() == 5 and m.weight.shape[0] == 1]
  assert len(heads) == chip_smoke.SP_HEADS == 3


# --- 6. the 2-D conv's halo form --------------------------------------------

def _haloed_2d(x: np.ndarray, r0: int, r1: int) -> np.ndarray:
  """Rows [r0, r1) of axis 1 of an NHWC ``x`` with the rows either side,
  zeros past the ends."""
  pad = np.pad(x, [(0, 0), (1, 1), (0, 0), (0, 0)])
  return np.ascontiguousarray(pad[:, r0:r1 + 2])


def _conv2d_inputs(seed, shape, cin, cout):
  rng = np.random.default_rng(seed)
  x = (rng.normal(size=(*shape, cin)) * 0.3).astype(np.float32)
  w = (rng.normal(size=(cout, cin, 3, 3)) * 0.2).astype(np.float32)
  scale = (rng.normal(size=(cout,)) * 0.2 + 1.0).astype(np.float32)
  bias = (rng.normal(size=(cout,)) * 0.1).astype(np.float32)
  return x, w, scale, bias, rng


@pytest.mark.parametrize("rows,cin,cout,res,relu", [
    ((4, 8), 12, 16, False, True),   # a middle shard, Cin 12 padded to 16
    ((0, 4), 8, 24, True, False),    # the top shard, a residual
    ((8, 12), 16, 8, True, True),    # the bottom shard, residual and ReLU
])
def test_conv2d_halo_form_matches_m_halo_pallas(interpret_pallas, rows, cin,
                                                cout, res, relu):
  """``conv2d_s1_bn_act(h_halo=True)`` against ``conv2d_band_pallas(...,
  m_halo=True)`` (K8, ``conv2d_kernel.py:162-211``) on the same haloed rows
  of a 12-row map, lane-major there; a Cin off 8 padded with zero channels
  on both sides, as the fusion net pads it."""
  x, w, scale, bias, rng = _conv2d_inputs(8, (1, 12, 128), cin, cout)
  pad = -cin % 8
  x = np.pad(x, [(0, 0)] * 3 + [(0, pad)])
  w = np.pad(w, [(0, 0), (0, pad), (0, 0), (0, 0)])
  xh = _haloed_2d(x, *rows)
  r = ((rng.normal(size=(1, rows[1] - rows[0], 128, cout)) * 0.3).astype(
      np.float32) if res else None)
  want = c2k.conv2d_band_pallas(
      jnp.asarray(np.transpose(xh, (0, 1, 3, 2))),
      jnp.asarray(np.transpose(w, (2, 3, 1, 0))), jnp.asarray(scale),
      jnp.asarray(bias),
      None if r is None else jnp.asarray(np.transpose(r, (0, 1, 3, 2))),
      relu=relu, m_halo=True)
  got = C2.conv2d_s1_bn_act(_t(xh), _t(w), _t(scale), _t(bias), _t(r), relu,
                            h_halo=True)
  assert got.shape == (1, rows[1] - rows[0], 128, cout)
  np.testing.assert_allclose(got.numpy(),
                             np.transpose(np.asarray(want), (0, 1, 3, 2)),
                             rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("form", ["kernel", "library"])
def test_conv2d_halo_forms_are_the_rows_of_the_whole_conv(monkeypatch,
                                                          form):
  """Every shard of a 4-way split of a 16-row map, haloed as
  ``halo_concat`` hands it over, gives its rows of the whole map's conv:
  the kernel's plain halo form (with its residual rows) and the library
  form, whose halo exchange is stubbed with the haloed rows."""
  x, w, scale, bias, rng = _conv2d_inputs(9, (2, 16, 6), 8, 16)
  res = (rng.normal(size=(2, 16, 6, 16)) * 0.3).astype(np.float32)
  n = 16 // SPLIT
  if form == "kernel":
    whole = C2.conv2d_s1_bn_act(_t(x), _t(w), _t(scale), _t(bias), _t(res),
                                True)
  else:
    whole = torch.nn.functional.conv2d(
        _t(x).permute(0, 3, 1, 2), _t(w), padding=1).permute(0, 2, 3, 1)
  for s in range(SPLIT):
    xh = _t(_haloed_2d(x, s * n, (s + 1) * n))
    rows = slice(s * n, (s + 1) * n)
    if form == "kernel":
      got = C2.conv2d_s1_bn_act(xh, _t(w), _t(scale), _t(bias),
                                _t(res[:, rows]), True, h_halo=True)
    else:
      monkeypatch.setattr(shard_ops, "halo_concat",
                          lambda local, axis, mesh, xh=xh: xh)
      got = shard_ops.conv2d_library_sharded(_t(x[:, rows]), _t(w),
                                             mesh=None)
    torch.testing.assert_close(got, whole[:, rows], rtol=1e-6, atol=1e-6)


def test_conv2d_halo_form_refuses_what_it_does_not_take():
  w = torch.zeros((8, 8, 3, 3))
  with pytest.raises(ValueError, match="takes dilation 1, got 2"):
    C2.conv2d_s1_bn_act(torch.zeros((1, 6, 4, 8)), w, dilation=2,
                        h_halo=True)
  with pytest.raises(ValueError, match="two halo rows"):
    C2.conv2d_s1_bn_act(torch.zeros((1, 2, 4, 8)), w, h_halo=True)


# --- 7. the frame -----------------------------------------------------------

def _frame_fusion_state():
  """A seeded fusion net at the Deep360 widths for the 64x32 frame, its
  head scaled as ``tests/test_torch_fusion.py`` scales it; numpy state."""
  zeros = [np.zeros((1, H, W, 1), np.float32)] * 6
  views = [np.zeros((1, H, W, 3), np.float32)] * 4
  shapes = jax.eval_shape(lambda: jfusion.ModeFusion(1000.0).init(
      jax.random.PRNGKey(0), zeros, zeros, views, False))
  variables = numpy_variables(shapes, 6, head_scale=HEAD_SCALE["fusion"])
  port = carry(tfusion.ModeFusion(1000.0, device="cpu"), variables)
  return {k: v.numpy() for k, v in port.state_dict().items()}


def test_sharded_frame_matches_one_process():
  """Six textured pairs and four views through ``TwoStagePipeline`` on a
  (1, 2) mesh: every rank returns the whole frame, within 1e-5 of one
  process's, relative for the fused depths (up to 1000 m, where 1e-5 m is
  under one f32 step; the CPU's library convs may sum a haloed shard in
  another order than the whole map), after ``FRAME_COLLECTIVES``
  collectives."""
  rng = np.random.default_rng(12)
  pairs = [_make_batch(rng, batch=1, disps=(d,), h=H, w=W)
           for d in (4, 8, 12, 12, 8, 4)]
  lefts, rights = (np.stack([p[i][0].permute(1, 2, 0).numpy()
                             for p in pairs]) for i in (0, 1))
  rgbs = np.stack([lefts[0], rights[0], lefts[5], rights[5]])
  state = _frame_fusion_state()
  fusion = tfusion.ModeFusion(1000.0, device="cpu")
  fusion.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
  pipe = TwoStagePipeline(
      load_npz(tdisp.ModeDisparity(MAXDISP, out_conf=True, device="cpu"),
               NPZ), fusion, MAXDISP, 1000.0, device="cpu")
  want = [t.numpy() for t in pipe(*(torch.from_numpy(a)
                                    for a in (lefts, rights, rgbs)))]
  assert 1.0 < want[0].std()
  outs = run_ranks(ranks.sharded_frame, 2,
                   (NPZ, MAXDISP, state, lefts, rights, rgbs, 2),
                   timeout=TIMEOUT, device="cpu", threads=1)
  for out in outs:
    for key, ref in zip(("fused", "pred", "conf"), want):
      assert out[key].shape == ref.shape
      np.testing.assert_allclose(out[key], ref, rtol=ONE_PROCESS,
                                 atol=ONE_PROCESS)
    assert out["collectives"] == FRAME_COLLECTIVES


def test_fusion_and_frame_refusals():
  """On a (1, 2) mesh: a 24-row fusion input leaves a rank 12 rows, an odd
  count before its third pool; the fusion net's training forward and
  ``Baseline`` raise; a frame on a (2, 1) mesh names its data axis."""
  out = run_ranks(ranks.fusion_refusals, 2, (24, 128), timeout=TIMEOUT,
                  device="cpu", threads=1)
  for r in out:
    assert set(r) == {"fusion_h", "fusion_train", "baseline", "frame_data"}
    assert "H % (8 x spatial) == 0" in r["fusion_h"]
    assert "H 24 over 2 ranks" in r["fusion_h"]
    assert r["fusion_train"].startswith(
        "NotImplementedError: training under a spatial mesh")
    assert r["baseline"].startswith(
        "NotImplementedError: Baseline under a spatial mesh")
    assert "got a mesh of data 2 x spatial 1" in r["frame_data"]


def test_chip_smoke_expects_the_frame_counts():
  """``chip_smoke.py``'s ``sp_frame_gloo_2`` expectations are the counts
  held here: a frame's collectives, and the fusion net's halo launches
  of the 2-D kernel (its ``FUSION_K8`` convs, held by
  ``tests/test_torch_fusion.py``)."""
  import chip_smoke
  assert chip_smoke.SP_FRAME_COLLECTIVES == FRAME_COLLECTIVES
  assert chip_smoke.SP_FRAME_HALO == {**chip_smoke.SP_HALO,
                                      "conv2d_s1_bn_act": chip_smoke.FUSION_K8}
