"""The port stands alone: importing every module of mode_tpu_torch (and
chip_smoke.py) loads no JAX, Flax or mode_tpu module, and its entry points
do not quietly run on the CPU."""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "mode_tpu")

_IMPORT_ALL = """
import pkgutil, sys
before = set(sys.modules)
import mode_tpu_torch
for info in pkgutil.walk_packages(mode_tpu_torch.__path__, "mode_tpu_torch."):
  __import__(info.name)
import chip_smoke
added = set(sys.modules) - before
bad = sorted(m for m in added
             if m.split(".")[0] in {forbidden} and m.split(".")[0] != "mode_tpu_torch")
print(len([m for m in added if m.startswith("mode_tpu_torch.")]))
assert not bad, bad
"""


def _forbidden(name: str) -> bool:
  return name.split(".")[0] in FORBIDDEN


def test_import_loads_no_jax_or_mode_tpu():
  code = _IMPORT_ALL.format(forbidden=set(FORBIDDEN))
  out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
  assert out.returncode == 0, out.stderr
  assert int(out.stdout.strip()) >= 10       # every module was imported


@pytest.mark.parametrize("path", sorted(
    [str(p.relative_to(ROOT)) for p in (ROOT / "mode_tpu_torch").rglob("*.py")]
    + ["chip_smoke.py"]))
def test_source_names_no_jax_or_mode_tpu(path):
  tree = ast.parse((ROOT / path).read_text())
  for node in ast.walk(tree):
    if isinstance(node, ast.Import):
      names = [a.name for a in node.names]
    elif isinstance(node, ast.ImportFrom):
      names = [node.module or ""]
    else:
      continue
    assert not any(_forbidden(n) for n in names), (path, names)


def test_entry_point_needs_a_card_or_an_explicit_cpu(monkeypatch):
  from mode_tpu_torch.device import resolve_device
  from mode_tpu_torch.models.disparity import ModeDisparity
  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  with pytest.raises(RuntimeError, match="no CUDA device"):
    ModeDisparity()                       # the default: conv="Sphere"
  with pytest.raises(RuntimeError, match="no CUDA device"):
    ModeDisparity(32, "Regular", out_conf=True)
  with pytest.raises(RuntimeError):
    resolve_device("cuda")
  assert resolve_device("cpu") == torch.device("cpu")


def test_sphere_feature_extractor_is_the_next_slice():
  """Both sphere feature extractors are ported, Cassini (the default) and
  ERP, with the same parameters; an unknown layout raises. Without a card
  the ERP model, like the others, builds only on an explicit CPU."""
  from mode_tpu_torch.models.disparity import (ModeDisparity,
                                               SphereFeatureExtraction)
  model = ModeDisparity(32, device="cpu")
  assert isinstance(model.feature_extraction, SphereFeatureExtraction)
  erp = ModeDisparity(32, "Sphere", "ERP", device="cpu")
  assert isinstance(erp.feature_extraction, SphereFeatureExtraction)
  assert {k: v.shape for k, v in erp.state_dict().items()} == {
      k: v.shape for k, v in model.state_dict().items()}
  with pytest.raises(ValueError, match="unknown sphere_type"):
    ModeDisparity(32, "Sphere", "Fisheye", device="cpu")
  if not torch.cuda.is_available():
    with pytest.raises(RuntimeError, match="no CUDA device"):
      ModeDisparity(32, "Sphere", "ERP")


def test_frame_entry_points_need_a_card_or_an_explicit_cpu(monkeypatch):
  """The fusion nets and the whole-frame pipeline, like stage 1, build on
  the card by default and only on an explicit CPU without one."""
  from mode_tpu_torch.models.disparity import ModeDisparity
  from mode_tpu_torch.models.fusion import Baseline, ModeFusion
  from mode_tpu_torch.pipeline import TwoStagePipeline
  disp = ModeDisparity(16, out_conf=True, device="cpu")
  fusion = ModeFusion(device="cpu")
  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  for build in (ModeFusion, Baseline,
                lambda: TwoStagePipeline(disp, fusion, maxdisp=16)):
    with pytest.raises(RuntimeError, match="no CUDA device"):
      build()
  assert TwoStagePipeline(disp, fusion, maxdisp=16,
                          device="cpu").device == torch.device("cpu")
