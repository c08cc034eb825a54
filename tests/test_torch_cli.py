"""The port's serving CLIs (``mode_tpu_torch/cli``) against the JAX
package's, both on the CPU, on one synthetic Deep360 tree at 64x32, maxdisp
16 (``tests/synth_data.py``: one frame a subset, so 18 pairs, 6 of them in
``testing``), with the same ``.tar`` weights on both sides: stage 1 the
trained ``tests/data/trained_mirror.npz`` wrapped as the reference's
training checkpoint, the fusion nets seeded (``tests/port_weights.py``)
with their 1x1 heads scaled by ``tests/test_torch_fusion.py:HEAD_SCALE``.
The JAX package loads the ``.tar`` through its own
``load_model_checkpoint``; each JAX CLI runs once, in a module fixture,
beside the port's CLIs (three threads).

Bars:
- ``test_disparity`` at batch 6 on both sides: each metric within 1e-4
  of JAX's, a thresholded percentage within one pixel's share; the
  ``_pred.npz`` dumps within 1e-3 px MAE and 1e-2 px max
  (``tests/test_trained_parity_midres.py``); the port also at batch 4 (a
  batch of 4, then a partial one of 2), its dumps at the same bars and
  its MAE the MAE of its own dumps;
- ``save_output_disparity_stage`` (batch 6): the same file tree; the conf
  PNGs within one 8-bit level; the depths within ``DEPTH_RTOL`` at 99.9%
  of each map's pixels (the stage-1 MAE bar, 1e-3 px, over a disparity
  of 1 px: the two stage 1s part by ~1e-5 px, so the bridge's own bar of
  4e-7 cannot hold here); and the port's files against the JAX bridge
  (``geometry.reprojection.disp_to_depth_at_cam1``) applied to the port's
  own stage-1 output, at the bridge's bars (``tests/test_torch_geometry.py``:
  depths within 4e-7 relative at >= 99.9% of the pixels, conf PNGs equal);
- ``test_fusion``, ``ModeFusion`` and ``Baseline``: the ``_pred.npy``
  dumps at ``tests/test_torch_fusion.py``'s bars (rtol 1e-4, atol 1e-2
  m), the metrics the same way (a percentage within one pixel's share);
- ``predict``: ``--stage all``'s ``output_depth.npz`` within the frame's
  fused MAE of ``tests/test_torch_pipeline.py`` (1e-2 m); ``--stage
  disp``'s conf PNG within one level, its disparity PNG within one gray
  level through the JET ramp (4 levels a channel).

Also: a checkpoint saved by the JAX package (orbax), converted by
``scripts/jax_checkpoint_to_torch.py``, serves in the port; an orbax
directory given to a port CLI raises, naming the converter; and without a
card each CLI raises unless given ``--device cpu``.
"""

import functools
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from mode_tpu.cli import predict as jpredict
from mode_tpu.cli import save_output_disparity_stage as jsave
from mode_tpu.cli import test_disparity as jtest_disp
from mode_tpu.cli import test_fusion as jtest_fusion
from mode_tpu.models import fusion as jfusion
from mode_tpu.models.disparity import ModeDisparity as JModeDisparity
from mode_tpu.utils.checkpoint import save_checkpoint
from mode_tpu.utils.torch_convert import convert_state_dict
from mode_tpu_torch.cli import common
from mode_tpu_torch.cli import predict as tpredict
from mode_tpu_torch.cli import save_output_disparity_stage as tsave
from mode_tpu_torch.cli import test_disparity as ttest_disp
from mode_tpu_torch.cli import test_fusion as ttest_fusion
from mode_tpu_torch.utils.convert import params_from_jax
from scripts import jax_checkpoint_to_torch
from tests.background import in_threads
from tests.port_weights import numpy_variables
from tests.synth_data import make_deep360_tree, make_fusion_inputs
from tests.test_torch_fusion import HEAD_SCALE
from tests.trained_mirror import get_trained_state_dict

torch.set_num_threads(2)

H, W, MAXDISP = 64, 32, 16
PRED_MAE, PRED_MAX = 1e-3, 1e-2
METRIC_ATOL = 1e-4
FUSION_RTOL, FUSION_ATOL = 1e-4, 1e-2
FUSED_MAE = 1e-2
# a depth's relative error from a disparity error e at disparity d is about
# e / d: the stage-1 MAE bar over a disparity of 1 px
DEPTH_RTOL = PRED_MAE / 1.0
# the bridge's own bars, from one disparity map (tests/test_torch_geometry.py)
BRIDGE_RTOL, BRIDGE_AGREE = 4e-7, 0.999
PCT = ("Px1 (%)", "Px3 (%)", "Px5 (%)", "D1 (%)", "δ1 (%)", "δ2 (%)",
       "δ3 (%)")
CLIS = {"predict": (jpredict, tpredict),
        "test_disparity": (jtest_disp, ttest_disp),
        "save_output_disparity_stage": (jsave, tsave),
        "test_fusion": (jtest_fusion, ttest_fusion)}


def _fusion_state(model: str) -> dict:
  zeros = [np.zeros((1, H, W, 1), np.float32)] * 6
  if model == "ModeFusion":
    views = [np.zeros((1, H, W, 3), np.float32)] * 4
    shapes = jax.eval_shape(lambda: jfusion.ModeFusion(1000.0).init(
        jax.random.PRNGKey(0), zeros, zeros, views, False))
    variables = numpy_variables(shapes, 6, head_scale=HEAD_SCALE["fusion"])
  else:
    shapes = jax.eval_shape(lambda: jfusion.Baseline(1000.0).init(
        jax.random.PRNGKey(0), zeros, False))
    variables = numpy_variables(shapes, 4,
                                head_scale=HEAD_SCALE["baseline"])
  return params_from_jax(jax.tree_util.tree_map(np.asarray, variables))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
  base = tmp_path_factory.mktemp("cli")
  data = make_deep360_tree(str(base / "data"), frames_per_subset=1, h=H, w=W)
  fusion_in = make_fusion_inputs(str(base / "fusion_in"), data)
  tars = {"disp": str(base / "disp.tar")}
  torch.save({"epoch": 7, "state_dict": get_trained_state_dict()},
             tars["disp"])
  for model in ("ModeFusion", "Baseline"):
    tars[model] = str(base / f"{model}.tar")
    torch.save({"epoch": 0, "state_dict": _fusion_state(model)},
               tars[model])
  # predict --stage all's inputs: <prefix>_<pair>_<l|r>.png
  rgb = os.path.join(data, "ep1_500frames", "testing", "rgb")
  frame = str(base / "frame")
  os.makedirs(frame)
  for name in sorted(os.listdir(rgb)):
    pair, side = name.split("_")[1], name.split("_")[-1].split(".")[0]
    shutil.copy(os.path.join(rgb, name),
                os.path.join(frame, f"ca_{pair}_{side}.png"))
  return {"base": str(base), "data": data, "fusion_in": fusion_in,
          "tars": tars, "frame": frame,
          "pair": [os.path.join(frame, f"ca_12_{s}.png") for s in "lr"]}


def _invocations(cli, setup, side: str, extra=()) -> list:
  """Every CLI once, writing under ``<base>/<side>``: ``(key, main,
  argv)``, ``key`` naming the dicts that ``test_disparity`` and
  ``test_fusion`` return (None for the others). No run reads another's
  output. The fusion runs come right after ``test_disparity``: run in
  another thread, they need none of the stage-1 model's eager ops that
  ``test_disparity`` compiles first."""
  out = os.path.join(setup["base"], side)
  shape = ["--height", str(H), "--width", str(W), "--max_disp",
           str(MAXDISP)]
  tars = setup["tars"]
  runs = [("disp", cli["test_disparity"].main, [
      "--dataset_root", setup["data"], "--checkpoint_disp", tars["disp"],
      "--batch_size", "6", "--save_output_path", f"{out}/disp",
      "--save_ori", *shape, *extra])]
  if side == "port":
    runs.append(("disp4", cli["test_disparity"].main, [
        "--dataset_root", setup["data"], "--checkpoint_disp", tars["disp"],
        "--batch_size", "4", "--save_output_path", f"{out}/disp4",
        "--save_ori", *shape, *extra]))
  for model in ("ModeFusion", "Baseline"):
    runs.append((model, cli["test_fusion"].main, [
        "--datapath-input", setup["fusion_in"], "--datapath-dataset",
        setup["data"], "--loadmodel", tars[model], "--model", model,
        "--outpath", f"{out}/fusion", *extra]))
  runs.append((None, cli["save_output_disparity_stage"].main, [
      "--datapath", setup["data"], "--outpath", f"{out}/bridge",
      "--checkpoint_disp", tars["disp"], *shape, *extra]))
  pshape = ["--heightC", str(H), "--widthC", str(W), "--max_disp",
            str(MAXDISP), "--checkpoint_disp", tars["disp"]]
  runs.append((None, cli["predict"].main, [
      "--stage", "disp", "--left_name", setup["pair"][0], "--right_name",
      setup["pair"][1], "--save_root", f"{out}/predict_disp", *pshape,
      *extra]))
  runs.append((None, cli["predict"].main, [
      "--stage", "all", "--data_root", setup["frame"], "--checkpoint_fusion",
      tars["ModeFusion"], "--save_root", f"{out}/predict_all", *pshape,
      *extra]))
  return runs


def _run_in_turn(runs) -> dict:
  return {key: got for key, got in ((key, main(argv))
                                    for key, main, argv in runs)
          if key is not None}


@pytest.fixture(scope="module")
def runs(setup):
  """Both packages' CLIs, in three threads of this process: the JAX
  ``test_disparity``, the other JAX CLIs in turn, the port's CLIs in turn
  (XLA compiles and PyTorch's CPU kernels run at once; tracing and the
  host's Python take turns)."""
  jax_runs = _invocations({k: v[0] for k, v in CLIS.items()}, setup, "jax")
  port_runs = _invocations({k: v[1] for k, v in CLIS.items()}, setup,
                           "port", ("--device", "cpu"))
  done = in_threads({part: functools.partial(_run_in_turn, runs)
                     for part, runs in (("jax_first", jax_runs[:1]),
                                        ("jax_rest", jax_runs[1:]),
                                        ("port", port_runs))})
  return {"jax": {**done["jax_first"], **done["jax_rest"]},
          "port": done["port"]}


def _files(root: str) -> list[str]:
  return sorted(os.path.relpath(os.path.join(d, f), root)
                for d, _, fs in os.walk(root) for f in fs)


def _side(setup, side, *parts):
  return os.path.join(setup["base"], side, *parts)


def _png(path) -> np.ndarray:
  return np.asarray(Image.open(path)).astype(np.int64)


def _min_masked(data: str, batch: int) -> int:
  """The fewest ground-truth pixels a test_disparity batch holds."""
  masks = [m for _, _, m in _gt_masks(data)]
  return min(int(sum(m.sum() for m in masks[i:i + batch]))
             for i in range(0, len(masks), batch))


def _gt_masks(data: str) -> list:
  """(name of the dump, ground truth, mask) of each test pair, in order."""
  _, _, disps = ttest_disp.list_deep360_disparity_test(data)
  out = []
  for path in disps:
    gt = np.load(path)["arr_0"]
    out.append((ttest_disp._out_name(path, "Deep360") + "_pred.npz", gt,
                (gt > 0) & np.isfinite(gt) & (gt <= MAXDISP)))
  return out


def _assert_metrics(got: dict, want: dict, abs_bar, pct_bar):
  assert list(got) == list(want)
  for k in want:
    assert np.isfinite(got[k]), k
    bar = pct_bar if k in PCT else abs_bar(want[k])
    assert abs(got[k] - want[k]) <= bar, (k, got[k], want[k], bar)


def _assert_dumps_match_jax(setup, out: str):
  files = _files(_side(setup, "jax", "disp"))
  assert files == _files(out)
  assert len([f for f in files if f.endswith("_pred.npz")]) == 6
  for name in files:
    if name.endswith(".npz"):
      got = np.load(os.path.join(out, name))["arr_0"]
      want = np.load(_side(setup, "jax", "disp", name))["arr_0"]
      err = np.abs(got - want)
      assert err.mean() <= PRED_MAE and err.max() <= PRED_MAX, name


def test_test_disparity_matches_jax(setup, runs):
  _assert_metrics(runs["port"]["disp"], runs["jax"]["disp"],
                  lambda _: METRIC_ATOL,
                  100.0 / _min_masked(setup["data"], 6))
  _assert_dumps_match_jax(setup, _side(setup, "port", "disp"))


def test_test_disparity_partial_batch_matches_jax(setup, runs):
  _assert_dumps_match_jax(setup, _side(setup, "port", "disp4"))


@pytest.mark.parametrize("batch", [6, 4])
def test_test_disparity_mae_is_its_dumps_mae(setup, runs, batch):
  """The returned MAE is the mean over the batches of the masked MAE of
  the ``_pred.npz`` dumps (zero off the mask)."""
  out = _side(setup, "port", "disp" if batch == 6 else "disp4")
  items = _gt_masks(setup["data"])
  maes = []
  for i in range(0, len(items), batch):
    err, n = 0.0, 0
    for name, gt, mask in items[i:i + batch]:
      pred = np.load(os.path.join(out, name))["arr_0"]
      err += float(np.abs(pred - np.nan_to_num(gt))[mask].sum())
      n += int(mask.sum())
    maes.append(err / n)
  got = runs["port"]["disp" if batch == 6 else "disp4"]["MAE"]
  assert np.isfinite(got)
  np.testing.assert_allclose(got, np.mean(maes), rtol=1e-5)


def test_save_output_disparity_stage_matches_jax(setup, runs):
  root_j = _side(setup, "jax", "bridge")
  root_t = _side(setup, "port", "bridge")
  files = _files(root_j)
  assert files == _files(root_t)
  assert len(files) == 2 * 6 * 3          # depth + conf, 6 pairs, 3 subsets
  worst = 0.0
  for name in files:
    if name.endswith(".npz"):
      got = np.load(os.path.join(root_t, name))["arr_0"]
      want = np.load(os.path.join(root_j, name))["arr_0"]
      assert got.shape == want.shape == (H, W) and got.dtype == np.float32
      assert np.isfinite(got).all() and 0 <= got.min() and got.max() <= 1000
      rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-6)
      worst = max(worst, float(np.quantile(rel, BRIDGE_AGREE)))
    else:
      diff = np.abs(_png(os.path.join(root_t, name))
                    - _png(os.path.join(root_j, name)))
      assert diff.max() <= 1, name
  print(f"bridge CLI: the depths' relative error at the "
        f"{BRIDGE_AGREE:.1%} quantile {worst:.3g} (bar {DEPTH_RTOL})")
  assert worst <= DEPTH_RTOL


def test_save_output_bridge_is_the_jax_bridge(setup, runs):
  """The port's files against the JAX bridge of the port's own stage 1,
  batch by batch as the CLI runs it."""
  from mode_tpu.geometry.reprojection import disp_to_depth_at_cam1
  from mode_tpu.utils.colormap import save_gray_png
  from mode_tpu_torch.data.deep360 import Deep360DatasetDisparity
  from mode_tpu_torch.data.loader import DataLoader
  from mode_tpu_torch.models.disparity import ModeDisparity
  lists = tsave.list_deep360_disparity_all(setup["data"])
  model = ModeDisparity(MAXDISP, out_conf=True, device="cpu")
  common.load_model_checkpoint(setup["tars"]["disp"], model)
  root = _side(setup, "port", "bridge")
  for batch in DataLoader(Deep360DatasetDisparity(*lists, shape=(H, W)), 6):
    pred, conf = model(torch.from_numpy(batch["leftImg"]),
                       torch.from_numpy(batch["rightImg"]))
    for i, name in enumerate(batch["dispNames"]):
      depth, c = disp_to_depth_at_cam1(jnp.asarray(pred[i].numpy()),
                                       jnp.asarray(conf[i].numpy()),
                                       name[-11:-9])
      depth_out, conf_out = tsave.output_paths(
          name, setup["data"], root, "disp_pred2depth", "conf_map")
      got = np.load(depth_out)["arr_0"]
      want = np.asarray(depth)
      differ = np.abs(got - want) > BRIDGE_RTOL * np.abs(want)
      assert differ.mean() <= 1 - BRIDGE_AGREE, (name, differ.mean())
      save_gray_png(str(setup["base"]) + "/jax_conf.png", np.asarray(c))
      np.testing.assert_array_equal(_png(conf_out),
                                    _png(setup["base"] + "/jax_conf.png"))


@pytest.mark.parametrize("model", ["ModeFusion", "Baseline"])
def test_test_fusion_matches_jax(setup, runs, model):
  _assert_metrics(runs["port"][model], runs["jax"][model],
                  lambda v: FUSION_ATOL + FUSION_RTOL * abs(v),
                  100.0 / (H * W))
  sub = ("fusion", "Deep360", model)
  files = _files(_side(setup, "jax", *sub))
  assert files == _files(_side(setup, "port", *sub))
  assert len(files) == 3                     # gt PNG, pred npy, pred PNG
  for name in files:
    if name.endswith(".npy"):
      got = np.load(_side(setup, "port", *sub, name))
      want = np.load(_side(setup, "jax", *sub, name))
      assert got.shape == want.shape == (W, H)      # ERP
      assert 1.0 < want.std()
      np.testing.assert_allclose(got, want, rtol=FUSION_RTOL,
                                 atol=FUSION_ATOL)


def test_predict_matches_jax(setup, runs):
  got = np.load(_side(setup, "port", "predict_all",
                      "output_depth.npz"))["arr_0"]
  want = np.load(_side(setup, "jax", "predict_all",
                       "output_depth.npz"))["arr_0"]
  assert got.shape == want.shape == (H, W) and np.isfinite(got).all()
  assert float(np.abs(got - want).mean()) <= FUSED_MAE
  assert 1.0 < want.std()
  for name, bar in (("output_conf.png", 1), ("output_disp.png", 4)):
    diff = np.abs(_png(_side(setup, "port", "predict_disp", name))
                  - _png(_side(setup, "jax", "predict_disp", name)))
    assert diff.max() <= bar, name
  for sub in ("predict_disp", "predict_all"):
    assert _files(_side(setup, "jax", sub)) == _files(_side(setup, "port",
                                                            sub))


def test_jax_checkpoint_converts_and_serves(setup, runs, tmp_path):
  """A stage-1 checkpoint saved by the JAX package, converted to a .tar,
  serves in the port as the JAX CLI served the same weights."""
  dummy = jnp.zeros((1, H, W, 3))
  shapes = jax.eval_shape(lambda: JModeDisparity(maxdisp=MAXDISP).init(
      jax.random.PRNGKey(0), dummy, dummy, train=False))
  state = get_trained_state_dict()
  variables = convert_state_dict(state, jax.tree_util.tree_map(
      lambda s: np.zeros(s.shape, s.dtype), shapes))
  ckpt = str(tmp_path / "ckpt_disp_ModeDisparity_Deep360_3")
  save_checkpoint(ckpt, {"epoch": 3, "params": variables["params"],
                         "batch_stats": variables["batch_stats"],
                         "train_loss": 0.25})
  tar = str(tmp_path / "converted.tar")
  jax_checkpoint_to_torch.main([ckpt, tar])
  obj = torch.load(tar, weights_only=True)
  assert obj["epoch"] == 3 and obj["train_loss"] == 0.25
  assert sorted(obj["state_dict"]) == sorted(state)
  for key, value in state.items():
    if not key.endswith("num_batches_tracked"):
      torch.testing.assert_close(obj["state_dict"][key], value, rtol=0,
                                 atol=0)
  out = str(tmp_path / "disp")
  metrics = ttest_disp.main(
      ["--dataset_root", setup["data"], "--checkpoint_disp", tar,
       "--batch_size", "6", "--save_output_path", out, "--save_ori",
       "--height", str(H), "--width", str(W), "--max_disp", str(MAXDISP),
       "--device", "cpu"])
  _assert_metrics(metrics, runs["jax"]["disp"], lambda _: METRIC_ATOL,
                  100.0 / _min_masked(setup["data"], 6))
  _assert_dumps_match_jax(setup, out)


def _argv(name: str, ckpt: str, setup) -> list[str]:
  return {"predict": ["--checkpoint_disp", ckpt],
          "test_disparity": ["--checkpoint_disp", ckpt, "--dataset_root",
                             setup["data"]],
          "save_output_disparity_stage": ["--checkpoint_disp", ckpt,
                                          "--datapath", setup["data"],
                                          "--outpath", setup["base"]
                                          + "/unused"],
          "test_fusion": ["--loadmodel", ckpt, "--datapath-input",
                          setup["fusion_in"], "--datapath-dataset",
                          setup["data"], "--outpath",
                          setup["base"] + "/unused"]}[name]


@pytest.mark.parametrize("name", sorted(CLIS))
def test_orbax_directory_names_the_converter(setup, tmp_path, name):
  with pytest.raises(ValueError, match=common.CONVERTER):
    CLIS[name][1].main(_argv(name, str(tmp_path), setup)
                       + ["--device", "cpu"])


@pytest.mark.parametrize("name", sorted(CLIS))
def test_cli_needs_a_card_or_cpu(setup, monkeypatch, name):
  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  with pytest.raises(RuntimeError, match="no CUDA device"):
    CLIS[name][1].main(_argv(name, setup["tars"]["disp"], setup))
