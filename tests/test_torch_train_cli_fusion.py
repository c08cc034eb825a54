"""The port's fusion training CLI (``mode_tpu_torch/cli/train_fusion.py``)
against the JAX package's, both on the CPU, on
``tests/test_torch_train_cli.py``'s tree and ``.tar`` weights, at its bars:
one epoch of one step of ``ModeFusion`` from float inputs and from packed
frames (the packs byte-equal to the JAX package's) and of ``Baseline``;
and ``ModeFusion`` as two gloo ranks with ``--dp 2``, started before the
JAX CLI so that the two overlap. The JAX runs share their initial state
and their jitted eval function where the model is the same
(``memo_jax_cli``).
"""

import glob
import os

import pytest
import torch

from mode_tpu.cli import train_fusion as jtrain_fusion
from mode_tpu_torch.cli import train_fusion as ttrain_fusion
from tests.test_torch_cli import _fusion_state
from tests.test_torch_train_cli import (FUSION, FUSION_LR, FLIP_SHARE, H,
                                        LOSS_RTOL, METRIC_RTOL, PCT, W,
                                        _assert_close_rel,
                                        _assert_state_matches, _jax_state,
                                        _root, _scalars,
                                        assert_two_ranks_match, memo_jax_cli,
                                        setup, start_ranks)

torch.set_num_threads(2)

FUSION_RUNS = {"float": ("ModeFusion", []),
               "packed": ("ModeFusion", ["--packed_dir"]),
               "baseline": ("Baseline", [])}


@pytest.fixture(scope="module")
def two_ranks_started(setup):
  return start_ranks(setup, ("train_fusion",))


@pytest.fixture(scope="module")
def two_ranks(two_ranks_started):
  return two_ranks_started.result()


@pytest.fixture(scope="module")
def fusion(setup, two_ranks_started):
  """Both fusion CLIs, one epoch of one step each, for every run of
  ``FUSION_RUNS``. (The two-rank run, started first, runs meanwhile.)"""
  runs = {}
  mp = pytest.MonkeyPatch()
  memo_jax_cli(mp, jtrain_fusion, "make_fusion_train_step")
  try:
    _run_fusion(setup, runs)
  finally:
    mp.undo()
  return runs


def _run_fusion(setup, runs):
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


@pytest.mark.parametrize("name", ["train_fusion"])
def test_two_ranks_train_as_the_jax_cli(setup, fusion, two_ranks, name):
  assert_two_ranks_match(setup, two_ranks[name], name,
                         fusion["float"]["jax"]["root"],
                         fusion["float"]["jax"]["logs"]["Training Loss"][0])
