"""The training CLIs' loading, data and refusals, on
``tests/test_torch_train_cli.py``'s tree and ``.tar`` weights:

- the loader hands both packages' CLIs the same batches, bit-equal, each
  epoch its own shuffle;
- ``--loadSHGonly``: the non-feature-extractor tensors bit-equal to JAX's
  ``convert_shg_only`` of the same ``.tar``, the feature extractor left as
  it was; a file missing a stack key refused; the CLI after one step with
  it;
- ``train_disparity`` on a 3D60 tree;
- in one process, ``--dp`` other than the world size and ``--sp`` that
  does not divide it refused, and without a card each trainer raises
  unless given ``--device cpu``;
- the Baseline's training convs on the kernel, traced on both sides at
  ``chip_smoke.py``'s shape.
"""

import collections
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from mode_tpu.data.deep360 import Deep360DatasetDisparity as JDisparitySet
from mode_tpu.data.file_lists import list_deep360_disparity_train
from mode_tpu.data.loader import DataLoader as JLoader
from mode_tpu.models import disparity as jdisp
from mode_tpu.models import fusion as jfusion
from mode_tpu.ops.pallas import conv2d_kernel as c2k
from mode_tpu.ops.pallas import conv3d_kernel as c3k
from mode_tpu.utils.torch_convert import convert_shg_only
from mode_tpu_torch.cli import common
from mode_tpu_torch.cli import train_disparity as ttrain_disp
from mode_tpu_torch.cli import train_fusion as ttrain_fusion
from mode_tpu_torch.data.deep360 import Deep360DatasetDisparity
from mode_tpu_torch.data.loader import DataLoader
from mode_tpu_torch.models import fusion as tfusion
from mode_tpu_torch.models.disparity import ModeDisparity
from mode_tpu_torch.ops import conv2d as conv2d_ops
from mode_tpu_torch.utils.convert import params_from_jax
from tests.synth_data import make_3d60_tree
from tests.test_torch_train_cli import (BATCH, FUSION, H, MAXDISP, SEED,
                                        STAGE1, W, setup)
from tests.trained_mirror import get_trained_state_dict

torch.set_num_threads(2)


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
