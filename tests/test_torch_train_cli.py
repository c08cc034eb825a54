"""The port's stage-1 training CLI (``mode_tpu_torch/cli/train_disparity.py``)
against the JAX package's, both on the CPU, on one synthetic Deep360 tree
at 64x32, maxdisp 16 (``tests/synth_data.py``: two frames a subset, so 12
training pairs and 2 fusion frames), from the same ``.tar`` weights on both
sides: stage 1 the trained ``tests/data/trained_mirror.npz`` wrapped as the
reference's training checkpoint, the fusion nets seeded with their heads
scaled (``tests/test_torch_cli.py:_fusion_state``). Each JAX CLI runs once,
in f32, with ``--dp 1 --sp 1``, in a module fixture; its orbax checkpoints
are read through ``mode_tpu.utils.checkpoint.load_checkpoint`` and
``utils/convert.py:params_from_jax``, its event files (and the port's)
through ``utils/tb_writer.py:read_scalars``. The port's trainer also runs
as two gloo ranks (``--dp 2``, ``--sp 2``), started before the JAX CLI so
that the two overlap. ``tests/test_torch_train_cli_fusion.py`` holds
``train_fusion`` the same way, with this file's fixtures and bars, and
``tests/test_torch_train_cli_args.py`` the trainers' loading, data and
refusals.

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
- ``--resume`` starts at the checkpoint's epoch + 1 in both packages, and
  the resumed step's loss agrees at the loss bar.

The JAX CLIs' runs share what is the same between them: the resumed run
reuses the first run's jitted train step, eval function and initial state
(``_memo_step``, ``_MemoJax``, ``_memo_init``), which are the same function
of the same model and shapes.
"""

import glob
import os

import jax
import numpy as np
import pytest
import torch

from mode_tpu import training as jtraining
from mode_tpu.cli import train_disparity as jtrain_disp
from mode_tpu.data.file_lists import list_deep360_disparity_train
from mode_tpu.utils.checkpoint import load_checkpoint
from mode_tpu_torch.cli import train_disparity as ttrain_disp
from mode_tpu_torch.models.disparity import ModeDisparity
from mode_tpu_torch.parallel.launch import run_ranks
from mode_tpu_torch.utils.convert import params_from_jax
from mode_tpu_torch.utils.tb_writer import read_scalars
from tests import torch_parallel_ranks as ranks
from tests.background import started
from tests.synth_data import make_deep360_tree, make_fusion_inputs
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
  model and arguments: a resumed run reuses the first run's compiled step
  instead of compiling an identical one."""
  built = {}

  def memo(model, optimizer, *args, **kw):
    key = (model, args, tuple(sorted(kw.items())))
    if key not in built:
      built[key] = make(model, optimizer, *args, **kw)
    return built[key]

  return memo


class _MemoJax:
  """``jax`` as a JAX CLI module sees it, its ``jit`` memoised on the
  function's code and the values it closes over (the model): a resumed run
  reuses the first run's jitted eval function for the same model instead
  of compiling an identical one. A function that closes over anything
  unhashable is jitted as it comes."""

  def __init__(self):
    self._built = {}

  def __getattr__(self, name):
    return getattr(jax, name)

  def jit(self, fn, **kw):
    try:
      key = (fn.__code__, tuple(c.cell_contents for c in fn.__closure__ or
                                ()), tuple(sorted(kw.items())))
      hash(key)
    except TypeError:
      return jax.jit(fn, **kw)
    if key not in self._built:
      self._built[key] = jax.jit(fn, **kw)
    return self._built[key]


def _memo_init(init):
  """``training.init_state`` that hands every run with the same model,
  seed and input shapes a copy of the same initial state (a pure function
  of them; the runs load their checkpoints over it). A copy: the train
  steps donate the state they are given."""
  built = {}

  def memo(model, optimizer, rng, *args, **kw):
    key = (model, np.asarray(rng).tobytes(), tuple(
        tuple(np.shape(a)) for a in jax.tree_util.tree_leaves(args)),
           tuple(sorted(kw.items())))
    if key not in built:
      built[key] = init(model, optimizer, rng, *args, **kw)
    return jax.tree_util.tree_map(
        lambda a: a.copy() if hasattr(a, "copy") else a, built[key])

  return memo


def memo_jax_cli(mp, module, make_step: str):
  """Patch ``module`` (a JAX CLI) and ``jtraining`` for the JAX runs of one
  fixture: the train-step builder ``make_step``, ``init_state`` and the
  CLI's ``jax.jit`` memoised across its runs."""
  mp.setattr(jtraining, make_step,
             _memo_step(getattr(jtraining, make_step)))
  mp.setattr(jtraining, "init_state", _memo_init(jtraining.init_state))
  mp.setattr(module, "jax", _MemoJax())


@pytest.fixture(scope="module")
def stage1(setup, two_ranks_started):
  """Both stage-1 CLIs: two epochs from the trained .tar (one step each,
  lr 1e-3 then 1e-4), then ``--resume`` from the epoch-2 checkpoint to
  epoch 3. (The two-rank runs, started first, run meanwhile.)"""
  runs = {}
  mp = pytest.MonkeyPatch()
  memo_jax_cli(mp, jtrain_disp, "make_disparity_train_step")
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


# the two-rank runs: (trainer, its mesh flags, its save directory)
RANK_RUNS = {"train_disparity": ("train_disparity", ["--dp", "2"],
                                 "stage1"),
             "train_disparity_sp": ("train_disparity", ["--sp", "2"],
                                    "stage1_sp"),
             "train_fusion": ("train_fusion", ["--dp", "2"], "fusion")}


def start_ranks(setup, labels):
  """Each trainer of ``labels`` as two gloo ranks with its mesh flags, one
  ``run_ranks`` call after another in a thread of this process: stage 1
  for one epoch from the trained .tar with ``--dp 2`` (the global batch
  of 2 split one example a rank) or ``--sp 2`` (both ranks on the whole
  batch, each on its half of the cost volume's H), ``ModeFusion`` from
  float inputs with ``--dp 2``. Returns the future of ``{label: the
  ranks' returns}``."""

  def run():
    runs = {}
    for label in labels:
      name, mesh, save = RANK_RUNS[label]
      if name == "train_disparity":
        argv = ["--dataset_root", setup["data"], "--checkpoint_disp",
                setup["tars"]["disp"], "--epochs", "1",
                "--save_checkpoint_path", _root(setup, "ranks", save),
                *STAGE1]
      else:
        argv = ["--datapath-input", setup["fusion_in"],
                "--datapath-dataset", setup["data"], "--model",
                "ModeFusion", "--loadmodel", setup["tars"]["ModeFusion"],
                "--savemodel", _root(setup, "ranks", save), *FUSION]
      runs[label] = run_ranks(ranks.trainer, 2, (
          name, argv + ["--device", "cpu", *mesh]), timeout=300,
                              device="cpu", threads=2)
    return runs

  return started(run)


STAGE1_RANKS = ("train_disparity", "train_disparity_sp")


@pytest.fixture(scope="module")
def two_ranks_started(setup):
  return start_ranks(setup, STAGE1_RANKS)


@pytest.fixture(scope="module")
def two_ranks(two_ranks_started):
  return two_ranks_started.result()


def assert_two_ranks_match(setup, out, name, jax_root, jax_loss):
  """Two ranks save what the JAX CLI saves after the epoch (its run on
  one device, under ``jax_root``, its logged loss ``jax_loss``: the mesh
  steps' numbers are held to the port's two-rank steps in
  ``tests/test_torch_parallel.py`` and
  ``tests/test_torch_spatial_train.py``), within this file's bars; every
  rank returns the same losses; rank 0 alone wrote files."""
  assert out[0]["losses"] == out[1]["losses"]
  assert out[0]["written"] and not out[1]["written"], out[1]["written"]
  if RANK_RUNS[name][0] == "train_disparity":
    root = _root(setup, "ranks", RANK_RUNS[name][2], "ModeDisparity",
                 "Deep360")
    want = _jax_state(os.path.join(jax_root,
                                   "ckpt_disp_ModeDisparity_Deep360_1"))
    obj = torch.load(os.path.join(root, "ckpt_disp_ModeDisparity_Deep360_1"
                                  ".tar"), weights_only=True)
    before = {k: torch.as_tensor(v) for k, v in
              get_trained_state_dict().items()}
    lr, atol = 1e-3, ADAM_ATOL
    assert sorted(os.listdir(root)) == ["ckpt_disp_ModeDisparity_Deep360_1"
                                        ".tar", "logs", "outputs"]
    assert len(os.listdir(os.path.join(root, "logs"))) == 1
  else:
    root = _root(setup, "ranks", "fusion", "ModeFusion", "Deep360")
    want = _jax_state(os.path.join(jax_root, "ckpt_fusion_epoch0"))
    obj = torch.load(os.path.join(root, "ckpt_fusion_epoch0.tar"),
                     weights_only=True)
    before = {k: torch.as_tensor(v)
              for k, v in _fusion_state("ModeFusion").items()}
    lr, atol = FUSION_LR, FUSION_LR / 2
    assert sorted(os.listdir(root)) == ["ckpt_fusion_epoch0.tar", "log"]
  _assert_close_rel(out[0]["losses"][0], jax_loss, LOSS_RTOL, "loss")
  keep = [k for k in want if not k.endswith("num_batches_tracked")]
  _assert_state_matches({k: obj["state_dict"][k] for k in keep},
                        {k: want[k] for k in keep}, before, lr, atol)


@pytest.mark.parametrize("name", STAGE1_RANKS)
def test_two_ranks_train_as_the_jax_cli(setup, stage1, two_ranks, name):
  assert_two_ranks_match(setup, two_ranks[name], name, stage1["jax"]["root"],
                         stage1["jax"]["logs"]["loss disp"][1])
