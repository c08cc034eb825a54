"""The port's data pipeline, metrics, bicubic resize, colormaps and
checkpoint reading against the JAX package's, on the synthetic trees of
``tests/synth_data.py`` and seeded numpy inputs.

Both sides run the same numpy arithmetic, so items, batches, file lists,
``cubic_matrix`` and the colormaps are held bit-equal; the metrics (torch's
and XLA's sums in other orders) within rtol 1e-6, ``upsample_bicubic``
within atol 1e-6. The native batch decode is held against the per-item
path at the JAX package's own bars (``tests/test_native_io.py``).
"""

import os
import pickle
import random
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from mode_tpu.data import deep360 as jdeep360
from mode_tpu.data import file_lists as jlists
from mode_tpu.data import loader as jloader
from mode_tpu.data import preprocess as jpre
from mode_tpu.data import three_d60 as j3d60
from mode_tpu.ops import resize as jresize
from mode_tpu.utils import checkpoint as jckpt
from mode_tpu.utils import colormap as jcmap
from mode_tpu.utils import metrics as jmetrics
from mode_tpu_torch.data import deep360 as tdeep360
from mode_tpu_torch.data import file_lists as tlists
from mode_tpu_torch.data import loader as tloader
from mode_tpu_torch.data import native_io
from mode_tpu_torch.data import preprocess as tpre
from mode_tpu_torch.data import three_d60 as t3d60
from mode_tpu_torch.ops import resize as tresize
from mode_tpu_torch.utils import checkpoint as tckpt
from mode_tpu_torch.utils import colormap as tcmap
from mode_tpu_torch.utils import metrics as tmetrics
from tests.synth_data import (make_3d60_tree, make_deep360_tree,
                              make_fusion_inputs)

H, W = 64, 32
CA_H, CA_W = 32, 16


@pytest.fixture(scope="module")
def deep360(tmp_path_factory):
  """A clean and a soiled tree (2 frames a subset) and the fusion inputs
  of the clean one."""
  base = tmp_path_factory.mktemp("deep360")
  clean = make_deep360_tree(str(base / "clean"), frames_per_subset=2, h=H,
                            w=W)
  soiled = make_deep360_tree(str(base / "soiled"), frames_per_subset=1,
                             h=H, w=W, soiled=True)
  pred = make_fusion_inputs(str(base / "pred"), clean)
  return {"clean": clean, "soiled": soiled, "pred": pred}


@pytest.fixture(scope="module")
def tree_3d60(tmp_path_factory):
  root = tmp_path_factory.mktemp("d60")
  list_file = make_3d60_tree(root, n_frames=2, with_fusion_inputs=True,
                             ca_shape=(CA_H, CA_W))
  return str(root), list_file


def _assert_items_equal(got: dict, want: dict):
  assert got.keys() == want.keys()
  for key, value in want.items():
    if isinstance(value, np.ndarray):
      assert got[key].dtype == value.dtype, key
      np.testing.assert_array_equal(got[key], value, err_msg=key)
    else:
      assert got[key] == value, key


# ---- file lists

@pytest.mark.parametrize("soiled", [False, True])
def test_disparity_lists_equal(deep360, soiled):
  root = deep360["soiled" if soiled else "clean"]
  for name in ("list_deep360_disparity_train", "list_deep360_disparity_test",
               "list_deep360_disparity_all"):
    got = getattr(tlists, name)(root, soiled)
    assert got == getattr(jlists, name)(root, soiled), name
    assert all(len(x) for x in got), name


def test_fusion_lists_equal(deep360):
  for name in ("list_deep360_fusion_train", "list_deep360_fusion_test"):
    got = getattr(tlists, name)(deep360["pred"], deep360["clean"])
    assert got == getattr(jlists, name)(deep360["pred"], deep360["clean"])


# ---- Deep360 items, batches, loader

@pytest.mark.parametrize("shape", [(H, W), (H // 2, W // 2)])
def test_disparity_items_equal(deep360, shape):
  lists = jlists.list_deep360_disparity_train(deep360["clean"])[:3]
  tds = tdeep360.Deep360DatasetDisparity(*lists, shape=shape)
  jds = jdeep360.Deep360DatasetDisparity(*lists, shape=shape)
  assert len(tds) == len(jds) == 12
  for i in (0, 7):
    _assert_items_equal(tds[i], jds[i])


def test_disparity_crop_items_equal(tmp_path):
  """The crop is 512x256 (training), so a tree a little larger."""
  root = make_deep360_tree(str(tmp_path), frames_per_subset=1, h=520, w=264,
                           subsets=("training", "validation"))
  lists = jlists.list_deep360_disparity_train(root)[:3]
  tds = tdeep360.Deep360DatasetDisparity(*lists, shape=(520, 264), crop=True)
  jds = jdeep360.Deep360DatasetDisparity(*lists, shape=(520, 264), crop=True)
  random.seed(5)
  got = tds[3]
  random.seed(5)
  _assert_items_equal(got, jds[3])


@pytest.mark.parametrize("resize", [False, True])
def test_fusion_items_equal(deep360, resize):
  lists = jlists.list_deep360_fusion_test(deep360["pred"], deep360["clean"])
  tds = tdeep360.Deep360DatasetFusion(*lists, resize=resize)
  jds = jdeep360.Deep360DatasetFusion(*lists, resize=resize)
  assert len(tds) == len(jds) == 2
  for i in range(2):
    _assert_items_equal(tds[i], jds[i])


@pytest.mark.parametrize("batch_size,shuffle", [(5, False), (4, True)])
def test_loader_batches_equal(deep360, batch_size, shuffle):
  """Batches, their order (the last one partial) and their contents."""
  lists = jlists.list_deep360_disparity_train(deep360["clean"])[:3]
  got = list(tloader.DataLoader(
      tdeep360.Deep360DatasetDisparity(*lists, shape=(H, W)), batch_size,
      shuffle=shuffle, num_workers=2, seed=3))
  want = list(jloader.DataLoader(
      jdeep360.Deep360DatasetDisparity(*lists, shape=(H, W)), batch_size,
      shuffle=shuffle, num_workers=2, seed=3))
  assert [len(b["dispNames"]) for b in got] == [
      len(b["dispNames"]) for b in want] == [batch_size] * 2 + [
          12 - 2 * batch_size]
  for g, w in zip(got, want):
    _assert_items_equal(g, w)


def test_fusion_loader_batches_equal(deep360):
  lists = jlists.list_deep360_fusion_train(deep360["pred"],
                                           deep360["clean"])[:4]
  got = list(tloader.DataLoader(tdeep360.Deep360DatasetFusion(*lists), 2))
  want = list(jloader.DataLoader(jdeep360.Deep360DatasetFusion(*lists), 2))
  assert len(got) == len(want) == 1
  _assert_items_equal(got[0], want[0])


def test_native_disparity_batch_matches_items(deep360):
  """``get_batch`` (libmodeio: decode and normalise fused) against the
  per-item PIL path, for every batch size a loader of 6 hands out."""
  assert native_io.available()
  lists = jlists.list_deep360_disparity_test(deep360["clean"])
  ds = tdeep360.Deep360DatasetDisparity(*lists, shape=(H, W))
  for indices in ([4, 0, 11, 1, 7, 2], [9], [3, 10]):
    batch = ds.get_batch(indices, threads=2)
    assert batch is not None, "the native decode did not engage"
    for b, i in enumerate(indices):
      item = ds[i]
      assert batch["dispNames"][b] == item["dispNames"]
      np.testing.assert_allclose(batch["leftImg"][b], item["leftImg"],
                                 rtol=1e-5, atol=1e-6)
      np.testing.assert_allclose(batch["rightImg"][b], item["rightImg"],
                                 rtol=1e-5, atol=1e-6)
      np.testing.assert_array_equal(batch["dispMap"][b], item["dispMap"])
  # a resize or a crop takes the per-item path
  assert tdeep360.Deep360DatasetDisparity(
      *lists, shape=(H // 2, W // 2)).get_batch([0]) is None
  assert tdeep360.Deep360DatasetDisparity(
      *lists, shape=(H, W), crop=True).get_batch([0]) is None


def test_native_fusion_batch_matches_items(deep360):
  lists = jlists.list_deep360_fusion_test(deep360["pred"], deep360["clean"])
  ds = tdeep360.Deep360DatasetFusion(*lists)
  batch = ds.get_batch([1, 0], threads=2)
  assert batch is not None, "the native decode did not engage"
  for b, i in enumerate([1, 0]):
    item = ds[i]
    assert batch["gtNames"][b] == item["gtNames"]
    for key, rtol in (("depths", 0), ("confs", 1e-6), ("rgbs", 1e-5),
                      ("gt", 0)):
      np.testing.assert_allclose(batch[key][b], item[key], rtol=rtol,
                                 atol=1e-6 if rtol else 0, err_msg=key)
  assert tdeep360.Deep360DatasetFusion(*lists, resize=True).get_batch(
      [0]) is None


def test_loader_stops_its_producer_when_the_consumer_stops(deep360):
  lists = jlists.list_deep360_disparity_train(deep360["clean"])[:3]
  ds = tdeep360.Deep360DatasetDisparity(*lists, shape=(H, W))
  before = threading.active_count()
  for bi, _ in enumerate(tloader.DataLoader(ds, 1, num_workers=2,
                                            prefetch=1)):
    if bi == 1:
      break
  assert threading.active_count() == before


def test_loader_raises_a_worker_error():
  class Broken:
    def __len__(self):
      return 3

    def __getitem__(self, i):
      if i == 2:
        raise OSError("unreadable")
      return {"x": np.zeros(2)}

  it = iter(tloader.DataLoader(Broken(), 2, num_workers=2))
  assert next(it)["x"].shape == (2, 2)
  with pytest.raises(OSError, match="unreadable"):
    next(it)


# ---- 3D60

@pytest.mark.parametrize("pair", ["lr", "ud", "ur", "all"])
def test_3d60_disparity_items_equal(tree_3d60, pair):
  root, list_file = tree_3d60
  tds = t3d60.Dataset3D60Disparity(list_file, root, shape=(CA_H, CA_W),
                                   pair=pair)
  jds = j3d60.Dataset3D60Disparity(list_file, root, shape=(CA_H, CA_W),
                                   pair=pair)
  for i in range(2):
    random.seed(i)
    got = tds[i]
    random.seed(i)
    want = jds[i]
    _assert_items_equal({k: v for k, v in got.items() if k != "dispMap"},
                        {k: v for k, v in want.items() if k != "dispMap"})
    np.testing.assert_array_equal(got["dispMap"], want["dispMap"])


@pytest.mark.parametrize("n_views", [2, 3])
def test_3d60_fusion_items_equal(tree_3d60, n_views):
  root, list_file = tree_3d60
  args = (list_file, root, os.path.join(root, "pred"))
  tds = t3d60.Dataset3D60Fusion(*args, shape=(CA_H, CA_W), n_views=n_views)
  jds = j3d60.Dataset3D60Fusion(*args, shape=(CA_H, CA_W), n_views=n_views)
  for i in range(2):
    _assert_items_equal(tds[i], jds[i])


def test_3d60_rectification_and_disparity_equal(rng):
  erp = rng.normal(size=(24, 48, 3)).astype(np.float32)
  r = t3d60.rodrigues(np.array([0, 0, -np.pi / 4]))
  np.testing.assert_array_equal(
      t3d60.erp_to_rect_cassini_np(erp, r, 32, 16),
      j3d60.erp_to_rect_cassini_np(erp, r, 32, 16))
  depth = rng.uniform(-1, 25, size=(32, 16)).astype(np.float32)
  np.testing.assert_array_equal(t3d60.depth_to_disp_np(depth, 0.26, 20.0),
                                j3d60.depth_to_disp_np(depth, 0.26, 20.0))


# ---- preprocessing

def test_preprocess_equal(rng):
  img = rng.integers(0, 256, size=(8, 6, 3), dtype=np.uint8)
  np.testing.assert_array_equal(tpre.rgb_to_tensor(img),
                                jpre.rgb_to_tensor(img))
  depth = rng.uniform(0, 9, size=(8, 6)).astype(np.float64)
  np.testing.assert_array_equal(tpre.depth_to_tensor(depth),
                                jpre.depth_to_tensor(depth))
  x = img.astype(np.float32) / 255
  for fn in ("lighting_augment", "color_jitter"):
    got = getattr(tpre, fn)(x, np.random.default_rng(4))
    want = getattr(jpre, fn)(x, np.random.default_rng(4))
    np.testing.assert_array_equal(got, want, err_msg=fn)


# ---- metrics

def _metric_inputs(seed, disparity):
  rng = np.random.default_rng(seed)
  hi = 40.0 if disparity else 900.0
  gt = rng.uniform(0.5, hi, size=(2, 24, 16)).astype(np.float32)
  pred = (gt * rng.uniform(0.6, 1.5, size=gt.shape)).astype(np.float32)
  gt[rng.random(gt.shape) < 0.05] = 0.0
  pred[rng.random(gt.shape) < 0.03] = 0.0
  mask = rng.random(gt.shape) < 0.8
  return pred, gt, mask


@pytest.mark.parametrize("name", ["mae", "max_ae", "rmse", "absrel", "sqrel",
                                  "silog", "px3", "d1", "delta2",
                                  "threshold_acc", "disparity_metrics",
                                  "depth_metrics"])
def test_metrics_match_jax(name):
  fn_args = {"px3": ("pixel_error_pct", (3,)), "d1": ("d1", (3, 0.05)),
             "delta2": ("delta_acc", (2,)),
             "threshold_acc": ("threshold_acc", (0.1,))}
  fn, extra = fn_args.get(name, (name, ()))
  for seed in range(3):
    pred, gt, mask = _metric_inputs(seed, name.startswith(("d1", "px",
                                                           "disp")))
    got = getattr(tmetrics, fn)(*extra, torch.from_numpy(pred),
                                torch.from_numpy(gt), torch.from_numpy(mask))
    want = getattr(jmetrics, fn)(*extra, jnp.asarray(pred), jnp.asarray(gt),
                                 jnp.asarray(mask))
    if not isinstance(got, dict):
      got, want = {name: got}, {name: want}
    assert got.keys() == want.keys()
    for key in want:
      assert got[key].dtype == torch.float32, key
      np.testing.assert_allclose(float(got[key]), float(want[key]),
                                 rtol=1e-6, err_msg=key)


def test_metrics_of_an_empty_mask_are_finite():
  pred, gt, _ = _metric_inputs(0, True)
  empty = torch.zeros(gt.shape, dtype=torch.bool)
  row = tmetrics.disparity_metrics(torch.from_numpy(pred),
                                   torch.from_numpy(gt), empty)
  assert all(float(v) == 0.0 for v in row.values())


# ---- bicubic resize

@pytest.mark.parametrize("n_out,n_in,align", [(64, 32, True), (7, 5, True),
                                              (5, 9, True), (3, 1, True),
                                              (12, 6, False)])
def test_cubic_matrix_bit_equal(n_out, n_in, align):
  got = tresize.cubic_matrix(n_out, n_in, align)
  assert got.dtype == np.float32
  np.testing.assert_array_equal(got, jresize.cubic_matrix(n_out, n_in, align))


def test_upsample_bicubic_matches_jax_and_torch(rng):
  """Against the JAX resize at atol 1e-6 and torch's own bicubic (its
  weights computed in f32) at 1e-5, on unit-scale maps."""
  x = rng.normal(size=(2, 16, 8, 1)).astype(np.float32)
  got = tresize.upsample_bicubic(torch.from_numpy(x), 32, 16)
  want = np.asarray(jresize.upsample_bicubic(jnp.asarray(x), 32, 16))
  np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
  ref = torch.nn.functional.interpolate(
      torch.from_numpy(x).permute(0, 3, 1, 2), size=(32, 16), mode="bicubic",
      align_corners=True).permute(0, 2, 3, 1)
  np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=1e-5)


# ---- colormaps and PNGs

def test_colormap_arrays_bit_equal(rng):
  gray = np.arange(256, dtype=np.uint8).reshape(16, 16)
  np.testing.assert_array_equal(tcmap.jet_colormap(gray),
                                jcmap.jet_colormap(gray))
  for img in (rng.uniform(-3, 50, size=(9, 7)).astype(np.float32),
              np.full((4, 4), 2.5, np.float32)):
    np.testing.assert_array_equal(tcmap.normalize_to_u8(img),
                                  jcmap.normalize_to_u8(img))


def test_png_writers_pixel_equal(tmp_path, rng):
  value = rng.uniform(0, 40, size=(12, 10)).astype(np.float32)
  mask = rng.random(value.shape) < 0.7
  conf = rng.uniform(-0.2, 1.2, size=(12, 10)).astype(np.float32)
  for side, cmap in (("t", tcmap), ("j", jcmap)):
    cmap.save_colormapped(str(tmp_path / f"{side}_c.png"), value, mask)
    cmap.save_colormapped(str(tmp_path / f"{side}_n.png"), value,
                          log_scale=False)
    cmap.save_gray_png(str(tmp_path / f"{side}_g.png"), conf)
  for name in ("c", "n", "g"):
    got = np.asarray(Image.open(tmp_path / f"t_{name}.png"))
    want = np.asarray(Image.open(tmp_path / f"j_{name}.png"))
    np.testing.assert_array_equal(got, want, err_msg=name)


# ---- checkpoints

def test_torch_checkpoint_loads_weights_and_refuses_other_pickles(tmp_path):
  state = {"a.weight": torch.arange(6.0).reshape(2, 3)}
  torch.save({"epoch": 4, "state_dict": state, "train_loss": 0.5},
             tmp_path / "ok.tar")
  obj = tckpt.load_torch_checkpoint(str(tmp_path / "ok.tar"))
  assert obj["epoch"] == 4 and obj["train_loss"] == 0.5
  torch.testing.assert_close(obj["state_dict"]["a.weight"], state["a.weight"])
  torch.save({"epoch": 1, "state_dict": state, "extra": threading.Event},
             tmp_path / "bad.tar")
  with pytest.raises(pickle.UnpicklingError):
    tckpt.load_torch_checkpoint(str(tmp_path / "bad.tar"))


def test_latest_epoch_dir_matches_jax(tmp_path):
  for name in ("ckpt_3", "ckpt_12", "ckpt_x", "other_40", "ckpt_7"):
    (tmp_path / name).mkdir()
  assert tckpt.latest_epoch_dir(str(tmp_path), "ckpt_") == \
      jckpt.latest_epoch_dir(str(tmp_path), "ckpt_") == str(
          tmp_path / "ckpt_12")
  assert tckpt.latest_epoch_dir(str(tmp_path / "none"), "ckpt_") is None
