"""The port's training CLIs (``mode_tpu_torch/cli/train_disparity.py``,
``train_fusion.py``) against the JAX package's, both on the CPU, on one
synthetic Deep360 tree at 64x32, maxdisp 16 (``tests/synth_data.py``: two
frames a subset, so 12 training pairs and 2 fusion frames), from the same
``.tar`` weights on both sides: stage 1 the trained
``tests/data/trained_mirror.npz`` wrapped as the reference's training
checkpoint, the fusion nets seeded with their heads scaled
(``tests/test_torch_cli.py:_fusion_state``). Each JAX CLI runs once, in f32,
with ``--dp 1 --sp 1``, in a module fixture; its orbax checkpoints are read
through ``mode_tpu.utils.checkpoint.load_checkpoint`` and
``utils/convert.py:params_from_jax``, its event files (and the port's)
through ``utils/tb_writer.py:read_scalars``.

Bars:
- each logged loss within 1e-4 relative (one step of
  ``tests/test_torch_train_step.py`` holds the loss at 1e-5; a second step
  starts from weights that Adam moved by about +-lr, see below); EPE and the
  fusion metrics within 1e-4 relative; a thresholded percentage (D1, the
  deltas) within one pixel's share of the masked pixels, as
  ``tests/test_torch_cli.py`` holds them;
- the saved BN statistics within 1e-5 relative of their norm (the train
  step test's 1e-5); the saved parameters: Adam's first step maps every
  gradient g to lr g / (|g| + eps), so an element whose gradient is near
  eps or is noise (its sign differs between two f32 steps whose sums run
  in other orders) may move by up to 2 lr more on one side. So each
  element's update is held within 2 lr of JAX's and, on all but
  ``FLIP_SHARE`` = 1% of the model's elements, within 1e-6 (the train step
  test's Adam bar) for stage 1 (trained weights; on the CPU 0.02% of the
  elements part by more after one step, 0.13% after two, by at most
  5.3e-5 and 1.3e-4 against lr 1e-3) and within lr / 2 for the seeded
  fusion nets, whose f32 gradients are chaotic (``tests/test_torch_fusion_
  train.py``): there a few tenths of a percent of the elements part by
  more, a sign flipped. An element left where it was reads about lr off
  (Adam's first update is just under lr), so besides, all but
  ``FLIP_SHARE`` of the fusion nets' elements must have moved by lr / 2 or
  more;
- the loader hands both CLIs the same batches, bit-equal;
- ``--resume`` starts at the checkpoint's epoch + 1 in both packages, and
  the resumed step's loss agrees at the loss bar;
- ``--loadSHGonly``: the non-feature-extractor tensors bit-equal to JAX's
  ``convert_shg_only`` of the same ``.tar``, the feature extractor left as
  it was.
"""

import collections
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from mode_tpu import training as jtraining
from mode_tpu.cli import train_disparity as jtrain_disp
from mode_tpu.cli import train_fusion as jtrain_fusion
from mode_tpu.data.deep360 import Deep360DatasetDisparity as JDisparitySet
from mode_tpu.data.file_lists import list_deep360_disparity_train
from mode_tpu.data.loader import DataLoader as JLoader
from mode_tpu.models import disparity as jdisp
from mode_tpu.models import fusion as jfusion
from mode_tpu.ops.pallas import conv2d_kernel as c2k
from mode_tpu.ops.pallas import conv3d_kernel as c3k
from mode_tpu.utils.checkpoint import load_checkpoint
from mode_tpu.utils.torch_convert import convert_shg_only
from mode_tpu_torch.cli import common
from mode_tpu_torch.cli import train_disparity as ttrain_disp
from mode_tpu_torch.cli import train_fusion as ttrain_fusion
from mode_tpu_torch.data.deep360 import Deep360DatasetDisparity
from mode_tpu_torch.data.loader import DataLoader
from mode_tpu_torch.models import fusion as tfusion
from mode_tpu_torch.models.disparity import ModeDisparity
from mode_tpu_torch.ops import conv2d as conv2d_ops
from mode_tpu_torch.parallel.launch import run_ranks
from mode_tpu_torch.utils.convert import params_from_jax
from mode_tpu_torch.utils.tb_writer import read_scalars
from tests import torch_parallel_ranks as ranks
from tests.synth_data import (make_3d60_tree, make_deep360_tree,
                              make_fusion_inputs)
from tests.test_torch_cli import _fusion_state
from tests.trained_mirror import get_trained_state_dict

torch.set_num_threads(2)

H, W, MAXDISP, BATCH, SEED = 64, 32, 16, 2, 123
LOSS_RTOL, METRIC_RTOL, STATS_RTOL = 1e-4, 1e-4, 1e-5
ADAM_ATOL, FLIP_SHARE = 1e-6, 1e-2
FUSION_LR = 1e-4           # the fusion CLI's default --lr
SHAPE = ["--height", str(H), "--width", str(W), "--max_disp", str(MAXDISP)]
STAGE1 = ["--start_decay", "1", "--steps_per_epoch", "1", "--batch_size",
          str(BATCH), "--seed", str(SEED), *SHAPE]
FUSION = ["--epochs", "1", "--steps_per_epoch", "1", "--batch-size",
          str(BATCH)]
FUSION_RUNS = {"float": ("ModeFusion", []),
               "packed": ("ModeFusion", ["--packed_dir"]),
               "baseline": ("Baseline", [])}
PCT = ("total disp validation d1", "δ1", "δ2", "δ3")


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
  base = str(tmp_path_factory.mktemp("train_cli"))
  data = make_deep360_tree(f"{base}/data", frames_per_subset=2, h=H, w=W)
  fusion_in = make_fusion_inputs(f"{base}/fusion_in", data)
  tars = {"disp": f"{base}/disp.tar"}
  torch.save({"epoch": 7, "state_dict": get_trained_state_dict()},
             tars["disp"])
  for model in ("ModeFusion", "Baseline"):
    tars[model] = f"{base}/{model}.tar"
    torch.save({"epoch": 0, "state_dict": _fusion_state(model)},
               tars[model])
  return {"base": base, "data": data, "fusion_in": fusion_in, "tars": tars}


def _root(setup, side, *parts):
  return os.path.join(setup["base"], side, *parts)


def _scalars(log_dir) -> dict:
  (path,) = glob.glob(os.path.join(log_dir, "events.out.tfevents.*"))
  out = {}
  for tag, step, value in read_scalars(path):
    out.setdefault(tag, {})[step] = value
  return out


def _memo_step(make):
  """``make`` that hands the same jitted step to every run with the same
  model and compute dtype: a resumed run reuses the first run's compiled
  step instead of compiling an identical one."""
  built = {}

  def memo(model, optimizer, mesh, compute_dtype=None, **kw):
    key = (model, compute_dtype, tuple(sorted(kw.items())))
    if key not in built:
      built[key] = make(model, optimizer, mesh, compute_dtype=compute_dtype,
                        **kw)
    return built[key]

  return memo


@pytest.fixture(scope="module")
def stage1(setup):
  """Both stage-1 CLIs: two epochs from the trained .tar (one step each,
  lr 1e-3 then 1e-4), then ``--resume`` from the epoch-2 checkpoint to
  epoch 3."""
  runs = {}
  mp = pytest.MonkeyPatch()
  mp.setattr(jtraining, "make_disparity_train_step",
             _memo_step(jtraining.make_disparity_train_step))
  try:
    for side, main, extra, suffix in (
        ("jax", jtrain_disp.main, ["--dp", "1", "--sp", "1"], ""),
        ("port", ttrain_disp.main, ["--device", "cpu"], ".tar")):
      ckpts = _root(setup, side, "stage1")
      common_args = ["--dataset_root", setup["data"], "--save_checkpoint_path",
                     ckpts, *STAGE1, *extra]
      first = main(["--checkpoint_disp", setup["tars"]["disp"], "--epochs",
                    "2", *common_args])
      root = os.path.join(ckpts, "ModeDisparity", "Deep360")
      logs = _scalars(os.path.join(root, "logs"))
      os.rename(os.path.join(root, "logs"), os.path.join(root, "logs_first"))
      resumed = main(["--checkpoint_disp", os.path.join(
          root, f"ckpt_disp_ModeDisparity_Deep360_2{suffix}"), "--resume",
                      "--epochs", "3", *common_args])
      runs[side] = {"root": root, "logs": logs, "out": first,
                    "resumed_logs": _scalars(os.path.join(root, "logs")),
                    "resumed": resumed}
  finally:
    mp.undo()
  return runs


def _jax_state(path) -> dict:
  payload = load_checkpoint(path)
  return params_from_jax({"params": payload["params"],
                          "batch_stats": payload["batch_stats"]})


def _assert_close_rel(got, want, rtol, what):
  assert np.isfinite(got), what
  assert abs(got - want) <= rtol * abs(want), (what, got, want)


def _masked_pixels(setup) -> int:
  """The fewest ground-truth pixels in (0, maxdisp] of a validation batch
  of the stage-1 runs (their first)."""
  *_, vd = list_deep360_disparity_train(setup["data"])
  n = 0
  for path in vd[:BATCH]:
    gt = np.load(path)["arr_0"]
    n += int(((gt > 0) & np.isfinite(gt) & (gt <= MAXDISP)).sum())
  return n


def test_stage1_logs_match_jax(setup, stage1):
  got, want = stage1["port"]["logs"], stage1["jax"]["logs"]
  assert set(got) == set(want) == {
      "loss disp", "total disp train loss", "total disp validation loss",
      "total disp validation d1"}
  pixel = 100.0 / _masked_pixels(setup) / BATCH
  for tag in want:
    assert sorted(got[tag]) == sorted(want[tag]) == [1, 2], tag
    for step, value in want[tag].items():
      if tag in PCT:
        assert abs(got[tag][step] - value) <= pixel, (tag, step)
      else:
        _assert_close_rel(got[tag][step], value,
                          LOSS_RTOL if "loss" in tag else METRIC_RTOL,
                          (tag, step))
  assert stage1["port"]["out"]["losses"] == pytest.approx(
      [got["loss disp"][1], got["loss disp"][2]], rel=1e-7)


def _assert_state_matches(got: dict, want: dict, before: dict, lr: float,
                          atol: float):
  """The BN statistics at ``STATS_RTOL``; the parameters' updates from
  ``before`` elementwise within ``atol`` of JAX's on all but
  ``FLIP_SHARE`` of the model's elements, and within ``2 lr`` on those.
  Returns that share."""
  assert set(got) == set(want)
  off = total = 0
  for key, ref in want.items():
    value = got[key]
    assert value.shape == ref.shape, key
    if key.endswith(("running_mean", "running_var")):
      err = float(torch.linalg.vector_norm(value - ref))
      assert err <= STATS_RTOL * float(torch.linalg.vector_norm(ref)), key
    elif key.endswith(("weight", "bias")):
      diff = ((value - before[key]) - (ref - before[key])).abs()
      off += int((diff > atol).sum())
      total += diff.numel()
      assert float(diff.max()) <= 2 * lr + ADAM_ATOL, key
  assert off <= FLIP_SHARE * total, (off, total)
  return off / total


@pytest.mark.parametrize("epoch", [1, 2])
def test_stage1_checkpoints_match_jax(setup, stage1, epoch):
  root_j, root_t = stage1["jax"]["root"], stage1["port"]["root"]
  name = f"ckpt_disp_ModeDisparity_Deep360_{epoch}"
  want = _jax_state(os.path.join(root_j, name))
  obj = torch.load(os.path.join(root_t, name + ".tar"), weights_only=True)
  assert sorted(obj) == ["epoch", "state_dict", "train_loss"]
  assert obj["epoch"] == epoch
  assert obj["train_loss"] == stage1["port"]["out"]["train_loss"][epoch]
  before = get_trained_state_dict() if epoch == 1 else torch.load(
      os.path.join(root_t, f"ckpt_disp_ModeDisparity_Deep360_{epoch - 1}"
                   ".tar"), weights_only=True)["state_dict"]
  before = {k: torch.as_tensor(v) for k, v in before.items()}
  got = {k: v for k, v in obj["state_dict"].items()
         if not k.endswith("num_batches_tracked")}
  want = {k: v for k, v in want.items()
          if not k.endswith("num_batches_tracked")}
  share = _assert_state_matches(got, want, before, 1e-3, ADAM_ATOL)
  print(f"epoch {epoch}: the share of the parameters whose update parts "
        f"from JAX's by more than {ADAM_ATOL}: {share:.3g}")
  # the checkpoint serves: it loads strictly into a fresh model
  ModeDisparity(MAXDISP, device="cpu").load_state_dict(obj["state_dict"],
                                                       strict=True)


def test_stage1_resume_starts_after_the_checkpoint(setup, stage1):
  for side, suffix in (("jax", ""), ("port", ".tar")):
    root = stage1[side]["root"]
    assert os.path.exists(os.path.join(
        root, f"ckpt_disp_ModeDisparity_Deep360_3{suffix}")), side
    logs = stage1[side]["resumed_logs"]
    assert sorted(logs["total disp train loss"]) == [3], side
    assert sorted(logs["loss disp"]) == [1], side
  _assert_close_rel(stage1["port"]["resumed_logs"]["loss disp"][1],
                    stage1["jax"]["resumed_logs"]["loss disp"][1], LOSS_RTOL,
                    "resumed loss")
  assert list(stage1["port"]["resumed"]["train_loss"]) == [3]


def test_stage1_validation_colormaps(stage1):
  for epoch in (1, 2, 3):
    for side in ("jax", "port"):
      assert os.path.exists(os.path.join(stage1[side]["root"], "outputs",
                                         f"{epoch:03d}_val.png")), side


def test_loader_gives_both_clis_the_same_batches(setup):
  lists = list_deep360_disparity_train(setup["data"])[:3]
  sets = (JDisparitySet(*lists, shape=(H, W)),
          Deep360DatasetDisparity(*lists, shape=(H, W)))
  loaders = (JLoader(sets[0], batch_size=BATCH, num_workers=4, shuffle=True,
                     seed=SEED),
             DataLoader(sets[1], batch_size=BATCH, num_workers=4,
                        shuffle=True, seed=SEED))
  orders = []
  for epoch in (1, 2):
    for loader in loaders:
      loader.set_epoch(epoch)
    batches = [list(loader) for loader in loaders]
    assert len(batches[0]) == len(batches[1]) == 6
    for a, b in zip(*batches):
      assert a["dispNames"] == b["dispNames"]
      for k in ("leftImg", "rightImg", "dispMap"):
        np.testing.assert_array_equal(a[k], b[k])
    orders.append(batches[1][0]["dispNames"])
  assert orders[0] != orders[1]         # each epoch its own shuffle


@pytest.fixture(scope="module")
def fusion(setup):
  runs = {}
  for label, (model, extra) in FUSION_RUNS.items():
    runs[label] = {}
    for side, main, flags in (("jax", jtrain_fusion.main, ["--dp", "1"]),
                              ("port", ttrain_fusion.main,
                               ["--device", "cpu"])):
      out = _root(setup, side, "fusion", label)
      args = ["--packed_dir", _root(setup, side, "packs")] if extra else []
      returned = main(["--datapath-input", setup["fusion_in"],
                       "--datapath-dataset", setup["data"], "--model", model,
                       "--loadmodel", setup["tars"][model], "--savemodel",
                       out, *FUSION, *args, *flags])
      root = os.path.join(out, model, "Deep360")
      runs[label][side] = {"root": root, "out": returned,
                           "logs": _scalars(os.path.join(root, "log"))}
  return runs


@pytest.mark.parametrize("label", sorted(FUSION_RUNS))
def test_fusion_matches_jax(setup, fusion, label):
  run = fusion[label]
  got, want = run["port"]["logs"], run["jax"]["logs"]
  assert set(got) == set(want) == {"Training Loss", "MAE", "RMSE", "AbsRel",
                                   "SqRel", "SILog", "δ1"}
  pixel = 100.0 / (H * W)
  for tag, steps in want.items():
    assert sorted(got[tag]) == sorted(steps) == [0], tag
    if tag in PCT:
      assert abs(got[tag][0] - steps[0]) <= pixel, tag
    else:
      _assert_close_rel(got[tag][0], steps[0],
                        LOSS_RTOL if "Loss" in tag else METRIC_RTOL, tag)
  # the 8-metric table's last two, which the CLIs print but do not log
  assert len(run["port"]["out"]["val"][0]) == 8
  model = FUSION_RUNS[label][0]
  want_state = _jax_state(os.path.join(run["jax"]["root"],
                                       "ckpt_fusion_epoch0"))
  obj = torch.load(os.path.join(run["port"]["root"], "ckpt_fusion_epoch0.tar"),
                   weights_only=True)
  assert obj["epoch"] == 0
  before = {k: torch.as_tensor(v) for k, v in _fusion_state(model).items()}
  keep = [k for k in want_state if not k.endswith("num_batches_tracked")]
  got = {k: obj["state_dict"][k] for k in keep}
  share = _assert_state_matches(got, {k: want_state[k] for k in keep}, before,
                                FUSION_LR, FUSION_LR / 2)
  params = [k for k in keep if k.endswith(("weight", "bias"))]
  moved = sum(int(((got[k] - before[k]).abs() >= FUSION_LR / 2).sum())
              for k in params) / sum(got[k].numel() for k in params)
  print(f"{label}: the share of the parameters whose update parts from "
        f"JAX's by more than lr / 2: {share:.3g}; the share that moved by "
        f"lr / 2 or more: {moved:.4g}")
  assert moved >= 1 - FLIP_SHARE, moved


def test_fusion_packs_are_the_jax_packs(setup, fusion):
  got = sorted(glob.glob(_root(setup, "port", "packs", "train", "*.mfp")))
  want = sorted(glob.glob(_root(setup, "jax", "packs", "train", "*.mfp")))
  assert len(got) == len(want) == 2
  for a, b in zip(got, want):
    with open(a, "rb") as fa, open(b, "rb") as fb:
      assert fa.read() == fb.read()


# ---- SHG-only loading
def _jax_disparity_variables():
  model = jdisp.ModeDisparity(maxdisp=MAXDISP)
  x = jax.numpy.zeros((1, H, W, 3))
  shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), x, x,
                                             train=False))
  rng = np.random.default_rng(4)
  return jax.tree_util.tree_map(
      lambda s: rng.normal(size=s.shape).astype(np.float32), shapes)


def _is_fe(key: str) -> bool:
  return "feature_extraction" in key or "forfilter1" in key


def test_shg_only_loads_what_jax_loads(setup):
  variables = _jax_disparity_variables()
  obj = torch.load(setup["tars"]["disp"], weights_only=True)
  want = params_from_jax(jax.tree_util.tree_map(
      np.asarray, convert_shg_only(obj, variables)))
  fresh = params_from_jax(variables)
  model = ModeDisparity(MAXDISP, device="cpu")
  model.load_state_dict(fresh, strict=True)
  assert common.load_model_checkpoint(setup["tars"]["disp"], model,
                                      shg_only=True) == 7
  got = model.state_dict()
  n_fe = 0
  for key, value in got.items():
    if key.endswith("num_batches_tracked"):
      continue
    if _is_fe(key):
      n_fe += 1
      assert torch.equal(value, fresh[key]), key      # its own weights
    else:
      assert torch.equal(value, want[key]), key
      assert torch.equal(value, torch.as_tensor(obj["state_dict"][key])), key
  assert n_fe > 50


def test_shg_only_refuses_a_file_missing_a_stack_key(setup, tmp_path):
  state = dict(get_trained_state_dict())
  del state["dres0.0.0.weight"]
  path = str(tmp_path / "short.tar")
  torch.save({"epoch": 1, "state_dict": state}, path)
  with pytest.raises(KeyError, match="outside the feature extractor"):
    common.load_model_checkpoint(path, ModeDisparity(MAXDISP, device="cpu"),
                                 shg_only=True)


def test_train_disparity_load_shg_only(setup, tmp_path):
  """The CLI with ``--loadSHGonly``: after one step at lr 1e-3 the feature
  extractor lies within one Adam step of the model's own fresh weights,
  the rest within one step of the checkpoint's."""
  ttrain_disp.main(["--dataset_root", setup["data"], "--checkpoint_disp",
                    setup["tars"]["disp"], "--loadSHGonly", "--epochs", "1",
                    "--save_checkpoint_path", str(tmp_path), *STAGE1,
                    "--device", "cpu"])
  saved = torch.load(str(tmp_path / "ModeDisparity" / "Deep360" /
                         "ckpt_disp_ModeDisparity_Deep360_1.tar"),
                     weights_only=True)["state_dict"]
  fresh = ModeDisparity(MAXDISP, device="cpu",
                        generator=torch.Generator().manual_seed(SEED))
  trained = get_trained_state_dict()
  for key, param in fresh.named_parameters():
    ref = param.detach() if _is_fe(key) else torch.as_tensor(trained[key])
    assert float((saved[key] - ref).abs().max()) <= 1e-3 * (1 + 1e-4), key


# ---- 3D60, refusals
def test_train_disparity_3d60(tmp_path):
  root = tmp_path / "d60"
  list_file = make_3d60_tree(root, n_frames=2)
  out = ttrain_disp.main(["--dataset", "3D60", "--dataset_root", str(root),
                          "--filenames_train", list_file, "--filenames_val",
                          list_file, "--epochs", "1", "--save_checkpoint_path",
                          str(tmp_path / "ck"), *STAGE1, "--device", "cpu"])
  assert len(out["losses"]) == 1 and np.isfinite(out["losses"][0])
  assert all(np.isfinite(out["val"][1]))
  obj = torch.load(str(tmp_path / "ck" / "ModeDisparity" / "3D60" /
                       "ckpt_disp_ModeDisparity_3D60_1.tar"),
                   weights_only=True)
  assert obj["epoch"] == 1 and np.isfinite(obj["train_loss"])


def _argv(name, setup, tmp):
  if name == "train_disparity":
    return ["--dataset_root", setup["data"], "--save_checkpoint_path", tmp,
            *STAGE1]
  return ["--datapath-input", setup["fusion_in"], "--datapath-dataset",
          setup["data"], "--savemodel", tmp, *FUSION]


TRAINERS = {"train_disparity": ttrain_disp, "train_fusion": ttrain_fusion}


@pytest.mark.parametrize("name,flag", [
    ("train_disparity", ["--dp", "2"]), ("train_disparity", ["--sp", "2"]),
    ("train_disparity", ["--dp", "8"]), ("train_fusion", ["--dp", "2"]),
    ("train_fusion", ["--dp", "8"])])
def test_more_than_one_card_is_refused(setup, tmp_path, name, flag):
  """In one process (a world of one), ``--dp`` other than 1 is not the
  world size and ``--sp`` above 1 does not divide it: both refused, by the
  mesh, before anything is written. (Until the data axis was ported, both
  were refused as training on more than one card; until stage 1 trained
  under the spatial axis, ``--sp`` was refused as the unported axis.)"""
  match = ("the spatial axis must divide the world size, 1"
           if flag[0] == "--sp"
           else "the data axis must be the world size, 1")
  with pytest.raises(ValueError, match=match):
    TRAINERS[name].main(_argv(name, setup, str(tmp_path)) + flag
                        + ["--device", "cpu"])
  assert not os.listdir(tmp_path)


# the two-rank runs: (trainer, its mesh flags, its save directory)
RANK_RUNS = {"train_disparity": ("train_disparity", ["--dp", "2"],
                                 "stage1"),
             "train_disparity_sp": ("train_disparity", ["--sp", "2"],
                                    "stage1_sp"),
             "train_fusion": ("train_fusion", ["--dp", "2"], "fusion")}


@pytest.fixture(scope="module")
def two_ranks(setup):
  """Each trainer as two gloo ranks with ``--dp 2`` (the global batch of
  2 split one example a rank): stage 1 for one epoch from the trained
  .tar, ``ModeFusion`` from float inputs; and stage 1 with ``--sp 2``
  (both ranks on the whole batch, each on its half of the cost volume's
  H)."""
  runs = {}
  for label, (name, mesh, save) in RANK_RUNS.items():
    if name == "train_disparity":
      argv = ["--dataset_root", setup["data"], "--checkpoint_disp",
              setup["tars"]["disp"], "--epochs", "1",
              "--save_checkpoint_path", _root(setup, "ranks", save), *STAGE1]
    else:
      argv = ["--datapath-input", setup["fusion_in"], "--datapath-dataset",
              setup["data"], "--model", "ModeFusion", "--loadmodel",
              setup["tars"]["ModeFusion"], "--savemodel",
              _root(setup, "ranks", save), *FUSION]
    runs[label] = run_ranks(ranks.trainer, 2, (
        name, argv + ["--device", "cpu", *mesh]), timeout=300,
                            device="cpu", threads=2)
  return runs


@pytest.mark.parametrize("name", sorted(RANK_RUNS))
def test_two_ranks_train_as_the_jax_cli(setup, stage1, fusion, two_ranks,
                                        name):
  """Two ranks save what the JAX CLI saves after the epoch (its run on
  one device: the mesh steps' numbers are held to the port's two-rank
  steps in ``tests/test_torch_parallel.py`` and
  ``tests/test_torch_spatial_train.py``), within this file's bars; every
  rank returns the same losses; rank 0 alone wrote files."""
  out = two_ranks[name]
  assert out[0]["losses"] == out[1]["losses"]
  assert out[0]["written"] and not out[1]["written"], out[1]["written"]
  if RANK_RUNS[name][0] == "train_disparity":
    root = _root(setup, "ranks", RANK_RUNS[name][2], "ModeDisparity",
                 "Deep360")
    want = _jax_state(os.path.join(stage1["jax"]["root"],
                                   "ckpt_disp_ModeDisparity_Deep360_1"))
    obj = torch.load(os.path.join(root, "ckpt_disp_ModeDisparity_Deep360_1"
                                  ".tar"), weights_only=True)
    before = {k: torch.as_tensor(v) for k, v in
              get_trained_state_dict().items()}
    lr, atol = 1e-3, ADAM_ATOL
    assert sorted(os.listdir(root)) == ["ckpt_disp_ModeDisparity_Deep360_1"
                                        ".tar", "logs", "outputs"]
    assert len(os.listdir(os.path.join(root, "logs"))) == 1
    _assert_close_rel(out[0]["losses"][0],
                      stage1["jax"]["logs"]["loss disp"][1], LOSS_RTOL,
                      "loss")
  else:
    root = _root(setup, "ranks", "fusion", "ModeFusion", "Deep360")
    want = _jax_state(os.path.join(fusion["float"]["jax"]["root"],
                                   "ckpt_fusion_epoch0"))
    obj = torch.load(os.path.join(root, "ckpt_fusion_epoch0.tar"),
                     weights_only=True)
    before = {k: torch.as_tensor(v)
              for k, v in _fusion_state("ModeFusion").items()}
    lr, atol = FUSION_LR, FUSION_LR / 2
    assert sorted(os.listdir(root)) == ["ckpt_fusion_epoch0.tar", "log"]
    _assert_close_rel(out[0]["losses"][0],
                      fusion["float"]["jax"]["logs"]["Training Loss"][0],
                      LOSS_RTOL, "loss")
  keep = [k for k in want if not k.endswith("num_batches_tracked")]
  _assert_state_matches({k: obj["state_dict"][k] for k in keep},
                        {k: want[k] for k in keep}, before, lr, atol)


@pytest.mark.parametrize("name", sorted(TRAINERS))
def test_trainer_needs_a_card_or_cpu(setup, tmp_path, monkeypatch, name):
  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  with pytest.raises(RuntimeError, match="no CUDA device"):
    TRAINERS[name].main(_argv(name, setup, str(tmp_path)))


# ---- the Baseline's training convs on the kernel, at chip_smoke.py's shape
def test_baseline_training_routes_as_the_jax_package(monkeypatch):
  """The Baseline's training forward at the training CLIs' batch 4 and
  1024x512, traced on both sides with counting stubs and no kernel run (as
  ``tests/test_torch_fusion_train.py`` traces ModeFusion's). The port's
  gate is the JAX package's batch-packed training gate with its TPU memory
  budget left out (``ops/conv2d.py:train_kernel_eligible``), as all the
  port's gates leave it out: traced so (``_pick_mb_bpack`` admitting every
  block height), the JAX gate takes every stride-1 3x3 conv but the
  6-channel input conv, and so does the port,
  ``chip_smoke.BASELINE_TRAIN_K9`` a forward. With the budget the JAX
  package leaves one more to XLA, the conv with 256 input channels."""
  batch, (h, w) = chip_smoke.TRAIN_CLI_BATCH, chip_smoke.GEOMETRY["Cassini"]
  monkeypatch.setattr(c3k, "_CONV3D_MODE", "on")
  jax_calls, port_calls = [], []

  def jax_stub(x, k, g, dil):
    jax_calls.append(tuple(x.shape))
    return jnp.zeros((*x.shape[:3], k.shape[-1]), x.dtype)

  def port_stub(x, weight, dilation=1, *, plain=False):
    port_calls.append(tuple(x.shape))
    return torch.empty((*x.shape[:3], weight.shape[0]), dtype=x.dtype,
                       device=x.device)

  monkeypatch.setattr(c2k, "conv2d_3x3_fast_train", jax_stub)
  monkeypatch.setattr(conv2d_ops, "conv2d_train", port_stub)
  model = jfusion.Baseline(1000.0)
  depths = [jnp.zeros((batch, h, w, 1))] * 6
  variables = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0),
                                                depths, False))

  def trace_jax():
    jax_calls.clear()
    jax.eval_shape(lambda v: model.apply(v, depths, True,
                                         mutable=["batch_stats"]), variables)
    return list(jax_calls)

  budgeted = trace_jax()
  monkeypatch.setattr(c2k, "_pick_mb_bpack", lambda *a, **k: 1)
  unbudgeted = trace_jax()
  port = tfusion.Baseline(1000.0, device="cpu").to("meta")
  port.device = torch.device("meta")
  port.train()([torch.empty((batch, h, w, 1), device="meta")] * 6)
  assert port_calls == unbudgeted
  assert len(port_calls) == chip_smoke.BASELINE_TRAIN_K9 == 17
  left = collections.Counter(unbudgeted) - collections.Counter(budgeted)
  assert left == {(batch, h, w, 256): 1}
  assert len(budgeted) == len(unbudgeted) - 1
