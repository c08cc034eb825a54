"""The conv="Sphere" slice of mode_tpu_torch (blocks, feature extractor and
the whole stage-1 model) against the JAX package, f32 on the CPU, and the
dispatch of the feature extractors' convs to the port's kernels.

Blocks and feature extractors run at shared random numpy weights (BN
statistics included, so the folded affine is exercised), carried into the
port by ``params_from_jax``. The whole model runs with the repo's trained
reference weights (``tests/data/trained_mirror*.npz``), loaded into the port
straight from their torch keys with ``strict=True``; the JAX side gets the
same weights through its own converter. The JAX model runs its XLA path on
the CPU, the plain reference of its kernels.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mode_tpu.models import blocks as jblocks
from mode_tpu.models import disparity as jdisp
from mode_tpu.ops.pallas import conv3d_kernel as ck
from mode_tpu.utils.torch_convert import convert_state_dict
from mode_tpu_torch.models import blocks as tblocks
from mode_tpu_torch.models import disparity as tdisp
from mode_tpu_torch.ops import conv2d as conv2d_ops
from mode_tpu_torch.utils.convert import load_npz
from tests.background import in_threads
from tests.port_weights import carry, numpy_variables
from tests.trained_mirror import (MID_H, MID_MAXDISP, MID_W, _make_batch,
                                  get_trained_state_dict,
                                  get_trained_state_dict_mid)

torch.set_num_threads(2)

SMALL = ("tests/data/trained_mirror.npz", get_trained_state_dict, 64, 32, 16)
MID = ("tests/data/trained_mirror_mid.npz", get_trained_state_dict_mid, MID_H,
       MID_W, MID_MAXDISP)
# tests/test_trained_parity_midres.py:60-64
PRED_MAE, PRED_MAX, CONF_MAE = 1e-3, 1e-2, 1e-3


def _flax_case(module, x, seed, *args):
  shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0),
                                              jnp.asarray(x), *args))
  variables = numpy_variables(shapes, seed)
  return variables, np.asarray(module.apply(variables, jnp.asarray(x), *args))


def _nchw(x):
  return torch.from_numpy(x).permute(0, 3, 1, 2)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("cin,cout,stride,dilation,downsample", [
    (8, 16, 1, 1, True),     # layer1.0: a wider block with a 1x1 shortcut
    (16, 16, 2, 1, True),    # layer2.0: strided
    (16, 16, 1, 2, False),   # layer3: dilation 2, identity shortcut
])
def test_regular_basic_block_matches_flax(cin, cout, stride, dilation,
                                          downsample, fused):
  x = np.random.default_rng(0).normal(size=(2, 12, 20, cin)).astype(
      np.float32)
  block = jblocks.RegularBasicBlock(cout, stride=stride, pad=1,
                                    dilation=dilation,
                                    has_downsample=downsample)
  variables, want = _flax_case(block, x, 1, False)
  port = carry(tblocks.RegularBasicBlock(cin, cout, stride, 1, dilation,
                                         has_downsample=downsample),
               variables)
  with torch.no_grad():
    got = port(_nchw(x), fused=fused).permute(0, 2, 3, 1)
  np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("cin,cout,downsample", [(8, 16, True),
                                                 (16, 16, False)])
def test_sphere_basic_block_matches_flax(cin, cout, downsample):
  x = np.random.default_rng(2).normal(size=(2, 32, 16, cin)).astype(
      np.float32)
  block = jblocks.SphereBasicBlock(cout, has_downsample=downsample)
  variables, want = _flax_case(block, x, 3, False)
  port = carry(tblocks.SphereBasicBlock(cin, cout, downsample), variables)
  with torch.no_grad():
    got = port(_nchw(x)).permute(0, 2, 3, 1)
  np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("batch", [1, 2])
def test_sphere_feature_extraction_matches_flax(batch):
  """Random weights grow the activations through 23 residual blocks, so
  the bar is relative to the output's largest value."""
  x = (np.random.default_rng(4).normal(size=(batch, 64, 32, 3))
       * 0.5).astype(np.float32)
  variables, want = _flax_case(jdisp.SphereFeatureExtraction(), x, 5, False)
  port = carry(tdisp.SphereFeatureExtraction(), variables)
  with torch.no_grad():
    got = port(torch.from_numpy(x))
  assert got.shape == want.shape == (batch, 16, 8, 32)
  scale = float(np.abs(want).max())
  np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                             atol=1e-5 * scale)


def _count_calls(monkeypatch):
  """Count the calls of the 2-D and sphere conv ops the blocks make."""
  calls = {"conv2d": 0, "sphere": 0}

  def counted(name, fn):
    def wrapper(*args, **kwargs):
      calls[name] += 1
      return fn(*args, **kwargs)
    return wrapper

  monkeypatch.setattr(conv2d_ops, "conv2d_s1_bn_act", counted(
      "conv2d", conv2d_ops.conv2d_s1_bn_act))
  monkeypatch.setattr(tblocks, "sphere_conv_bn_act", counted(
      "sphere", tblocks.sphere_conv_bn_act))
  return calls


@pytest.mark.parametrize("conv,batch,shape,want", [
    ("Sphere", 1, (64, 32), {"conv2d": 2, "sphere": 16}),
    ("Sphere", 2, (64, 32), {"conv2d": 32, "sphere": 16}),
    ("Regular", 1, (256, 256), {"conv2d": 0, "sphere": 0}),
    ("Regular", 2, (256, 256), {"conv2d": 52, "sphere": 0}),
])
def test_feature_extractors_dispatch_as_the_jax_package(monkeypatch, conv,
                                                         batch, shape, want):
  """The fused 2-D conv takes exactly the convs that reach K8/K9 in the JAX
  package at the same batch: the Sphere stem's two stride-1 convs at batch
  1; every stride-1 3x3 conv of either feature extractor at batch >= 2 (32
  per Sphere call: stem 2, layer1 6, layer2 15, layer3 8, lastconv.2 1;
  52 per Regular call). The 16 sphere convs of layer 4 run the sphere op at
  every batch."""
  calls = _count_calls(monkeypatch)
  fe = (tdisp.SphereFeatureExtraction() if conv == "Sphere"
        else tdisp.PSMNetFeatureExtraction()).eval()
  with torch.no_grad():
    fe(torch.zeros(batch, *shape, 3))
  assert calls == want


@functools.lru_cache(maxsize=None)
def _trained_case(case, batch, disps, sphere_type="Cassini"):
  """The JAX model and its variables, the port's model and the pair (NHWC
  numpy) at ``case``; memoised, as tests read but never change them."""
  npz, state_dict, h, w, maxdisp = case
  rng = np.random.default_rng(5)
  left, right, _ = _make_batch(rng, batch=batch, disps=disps, h=h, w=w)
  left = left.permute(0, 2, 3, 1).contiguous().numpy()
  right = right.permute(0, 2, 3, 1).contiguous().numpy()
  jmodel = jdisp.ModeDisparity(maxdisp=maxdisp, sphere_type=sphere_type,
                               out_conf=True)
  variables = jax.eval_shape(lambda: jmodel.init(
      jax.random.PRNGKey(0), jnp.asarray(left), jnp.asarray(right),
      train=False))
  variables = jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype),
                                     variables)
  variables = convert_state_dict(state_dict(), variables)
  port = load_npz(tdisp.ModeDisparity(maxdisp, "Sphere", sphere_type,
                                      out_conf=True, device="cpu"), npz)
  return jmodel, variables, port, left, right


def _jax_slice(jmodel, variables, port, left, right):
  """The JAX model's outputs on the pair, and what the port needs."""
  j_pred, j_conf = jax.jit(lambda v, a, b: jmodel.apply(
      v, a, b, train=False))(variables, jnp.asarray(left), jnp.asarray(right))
  return port, left, right, np.asarray(j_pred), np.asarray(j_conf)


def _assert_slice_matches(jmodel, variables, port, left, right):
  _assert_port_matches(*_jax_slice(jmodel, variables, port, left, right))


def _assert_port_matches(port, left, right, j_pred, j_conf):
  pred, conf = port(torch.from_numpy(left), torch.from_numpy(right))
  assert pred.shape == conf.shape == left.shape[:3]
  err = np.abs(pred.numpy() - np.asarray(j_pred))
  assert err.mean() <= PRED_MAE and err.max() <= PRED_MAX, (err.mean(),
                                                            err.max())
  conf_mae = np.abs(conf.numpy() - np.asarray(j_conf)).mean()
  assert conf_mae <= CONF_MAE, conf_mae


@pytest.fixture(scope="module")
def slices():
  """The JAX model at 64x32 (batch 2) and at the mid-resolution operating
  point (batch 1 and 2), each built and run in a thread of its own
  (tracing takes turns, XLA compiles them at once)."""
  cases = {"small": (SMALL, 2, (4, 12)), 1: (MID, 1, (20, 36)),
           2: (MID, 2, (20, 36))}
  return in_threads({k: functools.partial(jax_slice_of, case)
                     for k, case in cases.items()})


def jax_slice_of(case):
  return _jax_slice(*_trained_case(*case))


def test_sphere_slice_matches_jax_at_64x32(slices):
  _assert_port_matches(*slices["small"])


@pytest.mark.parametrize("batch", [1, 2])
def test_sphere_slice_matches_jax_at_512x256(slices, batch):
  """The trained mid-resolution operating point, where the sphere conv
  runs at 128x64 with the production tables' structure."""
  _assert_port_matches(*slices[batch])


def test_state_dict_round_trips_to_jax_variables():
  """The port's Sphere keys are the reference torch keys: the JAX package's
  converter maps the port's state_dict to the same variables as the
  reference checkpoint, and ``params_from_jax`` maps them back."""
  jmodel, variables, port, _, _ = _trained_case(SMALL, 1, (4,))
  zeros = jax.tree_util.tree_map(jnp.zeros_like, variables)
  back = convert_state_dict(port.state_dict(), zeros)
  want = dict(jax.tree_util.tree_leaves_with_path(variables))
  flat = jax.tree_util.tree_leaves_with_path(back)
  assert len(flat) == len(want)
  for path, leaf in flat:
    np.testing.assert_array_equal(np.asarray(leaf), np.asarray(want[path]))
  fresh = carry(tdisp.ModeDisparity(16, out_conf=True, device="cpu"),
                variables)
  for key, value in port.state_dict().items():
    if not key.endswith("num_batches_tracked"):    # not carried by JAX
      torch.testing.assert_close(fresh.state_dict()[key], value, rtol=0,
                                 atol=0)


def test_regular_slice_matches_jax_at_batch_two():
  """The Regular model at batch 2, where its stride-1 3x3 convs take the
  fused 2-D conv, against the JAX model (random weights, as
  tests/test_torch_disparity.py's batch-1 slice test builds them)."""
  h, w, maxdisp = 256, 512, 32
  rng = np.random.default_rng(6)
  left = (rng.normal(size=(2, h, w, 3)) * 0.5).astype(np.float32)
  right = np.roll(left, 3, axis=2)
  jmodel = jdisp.ModeDisparity(maxdisp=maxdisp, conv="Regular",
                               out_conf=True)
  shapes = jax.eval_shape(lambda: jmodel.init(
      jax.random.PRNGKey(0), jnp.asarray(left), jnp.asarray(right),
      train=False))
  variables = numpy_variables(shapes, 7, head_scale=1e-6)
  port = carry(tdisp.ModeDisparity(maxdisp, "Regular", out_conf=True,
                                   device="cpu"), variables)
  ck.set_conv3d_pallas("off")
  try:
    _assert_slice_matches(jmodel, variables, port, left, right)
  finally:
    ck.set_conv3d_pallas("auto")
