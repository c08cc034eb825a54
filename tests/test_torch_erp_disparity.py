"""The ERP configuration of the conv="Sphere" stage-1 model in mode_tpu_torch
(``ModeDisparity(..., "Sphere", "ERP")``: its sphere blocks, feature
extractor and the whole model) against the JAX package, f32 on the CPU, and
the dispatch of its convs to the port's kernels.

Blocks and feature extractors run at shared random numpy weights carried
into the port by ``params_from_jax``. The whole model runs with the repo's
trained reference weights (``tests/data/trained_mirror*.npz``; the ERP model
has the Cassini model's parameters, so the same file loads with
``strict=True``) on ERP pairs, the JAX side through its own converter. The
JAX model runs its XLA path on the CPU, the plain reference of its kernels.
Bars as in ``tests/test_torch_sphere_disparity.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mode_tpu.models import blocks as jblocks
from mode_tpu.models import disparity as jdisp
from mode_tpu.ops.pallas import conv2d_kernel as c2k
from mode_tpu.utils.torch_convert import convert_state_dict
from mode_tpu_torch.models import blocks as tblocks
from mode_tpu_torch.models import disparity as tdisp
from tests.port_weights import carry
from tests.background import in_threads
from tests.test_torch_sphere_disparity import (MID, SMALL,
                                               _assert_port_matches,
                                               _count_calls, _flax_case,
                                               _nchw, _trained_case,
                                               jax_slice_of)

torch.set_num_threads(2)

# the trained cases at the ERP geometry: W = 2H, the Cassini pixel counts
SMALL_ERP = (*SMALL[:2], SMALL[3], SMALL[2], SMALL[4])       # 32x64/16
MID_ERP = (*MID[:2], MID[3], MID[2], MID[4])                 # 256x512/48


@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("cin,cout,downsample", [(8, 16, True),
                                                 (16, 16, False)])
def test_erp_sphere_basic_block_matches_flax(cin, cout, downsample, batch):
  x = np.random.default_rng(2).normal(size=(batch, 16, 32, cin)).astype(
      np.float32)
  block = jblocks.SphereBasicBlock(cout, has_downsample=downsample,
                                   sphere_type="ERP")
  variables, want = _flax_case(block, x, 3, False)
  port = carry(tblocks.SphereBasicBlock(cin, cout, downsample, "ERP"),
               variables)
  with torch.no_grad():
    got = port(_nchw(x)).permute(0, 2, 3, 1)
  np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("batch", [1, 2])
def test_erp_feature_extraction_matches_flax(batch):
  """Random weights grow the activations through 23 residual blocks, so
  the bar is relative to the output's largest value."""
  x = (np.random.default_rng(4).normal(size=(batch, 32, 64, 3))
       * 0.5).astype(np.float32)
  variables, want = _flax_case(jdisp.SphereFeatureExtraction("ERP"), x, 5,
                               False)
  port = carry(tdisp.SphereFeatureExtraction("ERP"), variables)
  with torch.no_grad():
    got = port(torch.from_numpy(x))
  assert got.shape == want.shape == (batch, 8, 16, 32)
  scale = float(np.abs(want).max())
  np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                             atol=1e-5 * scale)


@pytest.fixture(scope="module")
def erp_slices():
  """The JAX ERP model at 32x64 and at 256x512, each built and run in a
  thread of its own (tracing takes turns, XLA compiles the two at once)."""
  cases = {"small": (SMALL_ERP, 1, (4,), "ERP"),
           "mid": (MID_ERP, 1, (20,), "ERP")}
  return in_threads({k: functools.partial(jax_slice_of, case)
                     for k, case in cases.items()})


def test_erp_slice_matches_jax_at_32x64(erp_slices):
  _assert_port_matches(*erp_slices["small"])


def test_erp_slice_matches_jax_at_256x512(erp_slices):
  """The mid-resolution operating point: the sphere convs at 64x128, where
  the lane axis reaches 128 and the tables have dropped samples."""
  _assert_port_matches(*erp_slices["mid"])


def test_erp_weights_are_the_cassini_weights():
  """The ERP model's parameter tree is the Cassini model's: the reference
  checkpoint loads into it with strict keys, the JAX package's converter
  maps its state_dict to the JAX ERP model's variables, and
  ``params_from_jax`` maps them back."""
  jmodel, variables, port, _, _ = _trained_case(SMALL_ERP, 1, (4,), "ERP")
  cassini = _trained_case(SMALL, 1, (4,))[1]
  assert (jax.tree_util.tree_structure(variables)
          == jax.tree_util.tree_structure(cassini))
  zeros = jax.tree_util.tree_map(jnp.zeros_like, variables)
  back = convert_state_dict(port.state_dict(), zeros)
  want = dict(jax.tree_util.tree_leaves_with_path(variables))
  for path, leaf in jax.tree_util.tree_leaves_with_path(back):
    np.testing.assert_array_equal(np.asarray(leaf), np.asarray(want[path]))
  fresh = carry(tdisp.ModeDisparity(16, "Sphere", "ERP", out_conf=True,
                                    device="cpu"), variables)
  for key, value in port.state_dict().items():
    if not key.endswith("num_batches_tracked"):
      torch.testing.assert_close(fresh.state_dict()[key], value, rtol=0,
                                 atol=0)


@pytest.mark.parametrize("batch,want", [
    (1, {"conv2d": 2, "sphere": 16}), (2, {"conv2d": 32, "sphere": 16})])
def test_erp_feature_extractor_dispatches_as_the_jax_package(monkeypatch,
                                                             batch, want):
  """The ERP feature extractor routes its convs as the Cassini one does:
  the stem's two stride-1 convs on the 2-D kernel at batch 1, every
  stride-1 3x3 conv at batch >= 2, the 16 sphere convs on the ERP sphere
  op at every batch."""
  calls = _count_calls(monkeypatch)
  seen = []
  sphere_conv_bn_act = tblocks.sphere_conv_bn_act

  def layout(*args, **kwargs):
    seen.append(kwargs["sphere_type"])
    return sphere_conv_bn_act(*args, **kwargs)

  monkeypatch.setattr(tblocks, "sphere_conv_bn_act", layout)
  fe = tdisp.SphereFeatureExtraction("ERP").eval()
  with torch.no_grad():
    fe(torch.zeros(batch, 32, 64, 3))
  assert calls == want
  assert seen == ["ERP"] * 16


@pytest.mark.parametrize("batch", [1, 2, 6])
def test_erp_2d_routing_is_the_jax_gate_at_full_width(batch):
  """At the ERP model's full 512x1024 input the JAX package runs the stem's
  two stride-1 convs on its 2-D band kernel at every batch (the input's W
  is a multiple of 256) and layers 1-3 and ``lastconv.2`` batch-packed
  where ``pick_bpack_g`` packs both lane widths, W/2 = 512 and W/4 = 256
  (``mode_tpu/models/disparity.py:53-61``). The port's feature extractor
  fuses the stem at every batch and the rest at batch > 1: the same
  convs."""
  w = 1024
  assert w % 256 == 0                                 # the lane stem
  lane_fe = (c2k.pick_bpack_g(batch, w // 2) is not None
             and c2k.pick_bpack_g(batch, w // 4) is not None)
  assert lane_fe == (batch > 1)
