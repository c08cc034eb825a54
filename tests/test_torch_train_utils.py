"""The modules the port's trainers import, against the JAX package's, on
the CPU: the packed fusion frames (``data/fusion_pack.py``), the uint8
items of ``Deep360DatasetDisparity(device_normalize=True)``, the
TensorBoard writer, the profiler's trace, the init menu
(``models/initialize.py``) and checkpoint saving.

Bars:
- ``.mfp`` packs, uint8 items and native batches: bit-equal (both sides
  run the same numpy and the same native library); a pack written by one
  package reads in the other; a native batch's images against the item
  path's, uint8 exactly, normalised at ``tests/test_native_io.py``'s bars;
- event files: byte-equal, with ``time.time`` fixed on both sides;
- the init menu: the same set of tensors re-initialised as the JAX menu's
  (``tests/test_torch_init_menus.py``), BN weights 1 and biases 0
  exactly; on each drawn tensor of 2000 values or
  more, its std within 10% of its formula, its std and mean |w| within 10%
  of torch's own initialiser's on the same shape, and a uniform draw's
  largest |w| inside its bound and within 15% of it
  (``tests/test_initialize.py``'s bars; the largest value of a normal draw
  of a few thousand values is too noisy to hold); ``default`` is the
  identity;
- a saved ``.tar`` loads with ``weights_only=True`` and ``strict=True`` to
  the same tensors.
"""

import json
import math
import os
import time

import numpy as np
import pytest
import torch

from mode_tpu.data import deep360 as jdeep360
from mode_tpu.data import fusion_pack as jpack
from mode_tpu.data.file_lists import list_deep360_fusion_train
from mode_tpu.utils import tb_writer as jtb
from mode_tpu_torch.cli import common
from mode_tpu_torch.data import deep360 as tdeep360
from mode_tpu_torch.data import fusion_pack as tpack
from mode_tpu_torch.data import native_io
from mode_tpu_torch.data.file_lists import list_deep360_disparity_train
from mode_tpu_torch.models.disparity import ModeDisparity
from mode_tpu_torch.models.fusion import ModeFusion
from mode_tpu_torch.models.initialize import INIT_TYPES, init_model_params
from mode_tpu_torch.utils import profiling
from mode_tpu_torch.utils import tb_writer as ttb
from mode_tpu_torch.utils.checkpoint import save_checkpoint
from tests.synth_data import make_deep360_tree, make_fusion_inputs

torch.set_num_threads(2)

H, W, MAXDISP = 64, 32, 16
STD_RTOL, MAX_RTOL, MIN_SIZE = 0.1, 0.15, 2000
GAIN = math.sqrt(2.0 / (1.0 + 0.01**2))


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
  base = tmp_path_factory.mktemp("train_utils")
  data = make_deep360_tree(str(base / "data"), frames_per_subset=2, h=H,
                           w=W, subsets=("training", "validation"))
  pred = make_fusion_inputs(str(base / "pred"), data)
  return {"base": base, "data": data,
          "fusion": list_deep360_fusion_train(pred, data)}


# ---- fusion_pack
def _pack_bytes(paths) -> list[bytes]:
  out = []
  for p in paths:
    with open(p, "rb") as f:
      out.append(f.read())
  return out


@pytest.mark.parametrize("native", [True, False])
def test_packs_byte_equal_to_jax(tree, monkeypatch, native):
  td, tc, tr, tg, *_ = tree["fusion"]
  base = tree["base"] / f"packs_{native}"
  want = jpack.pack_dataset(td, tc, tr, tg, str(base / "jax"))
  if not native:
    monkeypatch.setattr(native_io, "available", lambda: False)
  else:
    assert native_io.available()
  got = tpack.pack_dataset(td, tc, tr, tg, str(base / "port"))
  assert [os.path.basename(p) for p in got] == [os.path.basename(p)
                                                for p in want]
  assert len(got) == 2
  h, w = H, W
  for g, b in zip(_pack_bytes(got), _pack_bytes(want)):
    assert len(g) == 28 + h * w * (6 * 2 + 6 + 4 * 3 + 4)
    assert g == b
  # each package reads the other's packs
  for path_t, path_j in zip(got, want):
    for a, b in zip(tpack.read_pack(path_j), jpack.read_pack(path_t)):
      np.testing.assert_array_equal(a, b)


def test_packed_dataset_items_equal(tree):
  td, tc, tr, tg, *_ = tree["fusion"]
  paths = tpack.pack_dataset(td, tc, tr, tg, str(tree["base"] / "items"))
  got = tpack.PackedFusionDataset(paths, gt_names=tg)
  want = jpack.PackedFusionDataset(paths, gt_names=tg)
  assert got.raw_inputs and len(got) == len(want) == 2
  for i in range(len(got)):
    a, b = got[i], want[i]
    assert a.keys() == b.keys() and a["gtNames"] == b["gtNames"]
    for k in ("depths", "confs", "rgbs", "gt"):
      assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
      np.testing.assert_array_equal(a[k], b[k])


def test_write_pack_refuses_a_bad_file(tmp_path):
  path = str(tmp_path / "bad.mfp")
  with open(path, "wb") as f:
    f.write(b"NOPE" + bytes(24))
  with pytest.raises(IOError, match="not a fusion pack"):
    tpack.read_pack(path)


# ---- device_normalize
def _disparity_sets(data, device_normalize):
  tl, tr, td, *_ = list_deep360_disparity_train(data)
  return (jdeep360.Deep360DatasetDisparity(
      tl, tr, td, shape=(H, W), device_normalize=device_normalize),
          tdeep360.Deep360DatasetDisparity(
              tl, tr, td, shape=(H, W), device_normalize=device_normalize))


def test_device_normalize_items_equal(tree):
  jds, tds = _disparity_sets(tree["data"], True)
  for i in (0, 5, len(tds) - 1):
    a, b = tds[i], jds[i]
    assert a.keys() == b.keys()
    assert a["leftImg"].dtype == np.uint8 and a["leftImg"].shape == (H, W, 3)
    for k in ("leftImg", "rightImg", "dispMap"):
      assert a[k].dtype == b[k].dtype
      np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("device_normalize", [True, False])
def test_native_batches_equal(tree, device_normalize):
  jds, tds = _disparity_sets(tree["data"], device_normalize)
  idx = [3, 0, 7, 2]
  a, b = tds.get_batch(idx, 2), jds.get_batch(idx, 2)
  assert a is not None and b is not None, "the native decode did not engage"
  want_dtype = np.uint8 if device_normalize else np.float32
  assert a["leftImg"].dtype == want_dtype
  for k in ("leftImg", "rightImg", "dispMap"):
    np.testing.assert_array_equal(a[k], b[k])
  # each image of the batch is the item path's: exactly in uint8; the
  # normalising decode at tests/test_native_io.py's bars
  for j, i in enumerate(idx):
    np.testing.assert_allclose(a["leftImg"][j], tds[i]["leftImg"],
                               rtol=0 if device_normalize else 1e-5,
                               atol=0 if device_normalize else 1e-6)


# ---- tb_writer
def test_event_files_byte_equal(tmp_path, monkeypatch):
  monkeypatch.setattr(time, "time", lambda: 1760000000.25)
  files = []
  for mod, side in ((jtb, "jax"), (ttb, "port")):
    writer = mod.SummaryWriter(str(tmp_path / side), purge_step=4)
    for step, (tag, value) in enumerate([("loss disp", 0.125),
                                         ("δ1 (%)".split(" ")[0], 97.5),
                                         ("Training Loss", -3e-5)]):
      writer.add_scalar(tag, value, step + 4)
    writer.close()
    (name,) = os.listdir(tmp_path / side)
    files.append((name, (tmp_path / side / name).read_bytes()))
  assert files[0] == files[1]
  assert ttb.read_scalars(str(tmp_path / "port" / files[1][0])) == [
      ("loss disp", 4, 0.125), ("δ1", 5, 97.5),
      ("Training Loss", 6, float(np.float32(-3e-5)))]


def test_read_scalars_refuses_a_corrupt_file(tmp_path):
  writer = ttb.SummaryWriter(str(tmp_path))
  writer.add_scalar("a", 1.0, 1)
  writer.close()
  (name,) = os.listdir(tmp_path)
  path = tmp_path / name
  buf = bytearray(path.read_bytes())
  buf[-6] ^= 1
  path.write_bytes(bytes(buf))
  with pytest.raises(IOError, match="corrupt"):
    ttb.read_scalars(str(path))


# ---- profiling
def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
  with profiling.trace(str(tmp_path / "trace")) as prof:
    with profiling.span("the step"):
      torch.ones(64, 64) @ torch.ones(64, 64)
  assert prof is not None
  spans, name = sorted(os.listdir(tmp_path / "trace"))
  assert name.startswith("trace.") and name.endswith(".json")
  assert spans == "spans." + name[len("trace."):]
  events = json.loads((tmp_path / "trace" / name).read_text())["traceEvents"]
  names = {e.get("name") for e in events}
  assert "the step" in names and "aten::mm" in names
  summary = json.loads((tmp_path / "trace" / spans).read_text())["summary"]
  assert summary["spans"]["the step"]["count"] == 1
  with profiling.trace(None) as prof:
    pass
  assert prof is None


# ---- the init menu
def _port_model(kind):
  if kind == "disparity":
    return ModeDisparity(MAXDISP, device="cpu")
  return ModeFusion(1000.0, device="cpu")


_FORMULAS = {
    "kaiming_normal": lambda fi, fo: GAIN / math.sqrt(fi),
    "kaiming_uniform": lambda fi, fo: GAIN / math.sqrt(fi),
    "xavier_normal": lambda fi, fo: math.sqrt(2.0 / (fi + fo)),
    "xavier_uniform": lambda fi, fo: math.sqrt(2.0 / (fi + fo)),
    "normal": lambda fi, fo: 1.0,
}
_TORCH = {
    "kaiming_normal": lambda w: torch.nn.init.kaiming_normal_(
        w, mode="fan_in", nonlinearity="leaky_relu"),
    "kaiming_uniform": lambda w: torch.nn.init.kaiming_uniform_(
        w, mode="fan_in", nonlinearity="leaky_relu"),
    "xavier_normal": torch.nn.init.xavier_normal_,
    "xavier_uniform": torch.nn.init.xavier_uniform_,
    "normal": torch.nn.init.normal_,
}


@pytest.mark.parametrize("kind", ["disparity", "fusion"])
@pytest.mark.parametrize("init_type", [t for t in INIT_TYPES
                                       if t != "default"])
def test_init_statistics(kind, init_type):
  model = init_model_params(_port_model(kind), init_type,
                            torch.Generator().manual_seed(2))
  held = 0
  for n, p in model.named_parameters():
    if p.ndim <= 2 or p.numel() < MIN_SIZE:
      continue
    # a (O, I, *K) weight, a transpose conv's (I, O, *K): torch's fans
    fan_in, fan_out = torch.nn.init._calculate_fan_in_and_fan_out(p)
    std = _FORMULAS[init_type](fan_in, fan_out)
    np.testing.assert_allclose(float(p.detach().std()), std, rtol=STD_RTOL,
                               err_msg=n)
    torch.manual_seed(held)
    ref = _TORCH[init_type](torch.empty(p.shape))
    p = p.detach()
    for stat in (torch.std, lambda t: t.abs().mean()):
      np.testing.assert_allclose(float(stat(p)), float(stat(ref)),
                                 rtol=STD_RTOL, err_msg=n)
    if init_type.endswith("uniform"):     # inside its bound, and near it
      bound = math.sqrt(3.0) * std
      assert float(p.abs().max()) <= bound * (1 + 1e-6), n
      np.testing.assert_allclose(float(p.abs().max()), bound, rtol=MAX_RTOL,
                                 err_msg=n)
    held += 1
  assert held >= 10


def test_init_default_is_the_identity():
  model = _port_model("fusion")
  before = {k: v.clone() for k, v in model.state_dict().items()}
  assert init_model_params(model, "default", torch.Generator()) is model
  assert init_model_params(model, None, torch.Generator()) is model
  for k, v in model.state_dict().items():
    assert torch.equal(v, before[k]), k
  with pytest.raises(ValueError, match="unknown init type"):
    init_model_params(model, "orthogonal", torch.Generator())


def test_init_draws_are_seeded():
  a = init_model_params(_port_model("fusion"), "xavier_uniform",
                        torch.Generator().manual_seed(5))
  b = init_model_params(_port_model("fusion"), "xavier_uniform",
                        torch.Generator().manual_seed(5))
  for (n, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
    assert torch.equal(p, q), n


# ---- checkpoint saving
def test_saved_tar_round_trips(tmp_path):
  model = _port_model("disparity")
  init_model_params(model, "xavier_normal", torch.Generator().manual_seed(3))
  for b in model.buffers():
    b.add_(1)
  path = str(tmp_path / "ckpt_disp_ModeDisparity_Deep360_4.tar")
  save_checkpoint(path, {"epoch": 4, "state_dict": model.state_dict(),
                         "train_loss": 0.75})
  assert os.listdir(tmp_path) == [os.path.basename(path)]
  obj = torch.load(path, map_location="cpu", weights_only=True)
  assert sorted(obj) == ["epoch", "state_dict", "train_loss"]
  assert obj["epoch"] == 4 and obj["train_loss"] == 0.75
  fresh = _port_model("disparity")
  fresh.load_state_dict(obj["state_dict"], strict=True)
  other = _port_model("disparity")
  assert common.load_model_checkpoint(path, other) == 4
  for k, v in model.state_dict().items():
    assert torch.equal(other.state_dict()[k], v), k
    assert torch.equal(fresh.state_dict()[k], v), k
