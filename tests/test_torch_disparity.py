"""mode_tpu_torch.models (blocks, hourglass, the stage-1 slice) against the
JAX package at shared weights, f32 on the CPU.

The JAX side's variables take their structure from ``jax.eval_shape`` of
``init`` and their values from a numpy seed, BatchNorm statistics included
(so the folded affine is exercised); ``params_from_jax`` carries them into
the port, which loads them with ``load_state_dict(strict=True)``.
"""

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
from mode_tpu_torch.utils.convert import unwrap_checkpoint
from tests.port_weights import carry, numpy_variables

torch.set_num_threads(2)


@pytest.mark.parametrize("cin,cout,stride,dilation", [
    (8, 16, 1, 2),       # layer4-style dilated block with a 1x1 shortcut
    (16, 16, 2, 1),      # layer2.0-style strided block
])
def test_basic_block_no_relu_matches_flax(cin, cout, stride, dilation):
  x = np.random.default_rng(0).normal(size=(1, 12, 20, cin)).astype(
      np.float32)
  block = jblocks.BasicBlockNoRelu(cout, stride=stride, pad=1,
                                   dilation=dilation, has_downsample=True)
  shapes = jax.eval_shape(lambda: block.init(jax.random.PRNGKey(0),
                                             jnp.asarray(x), False))
  variables = numpy_variables(shapes, 1)
  want = block.apply(variables, jnp.asarray(x), False)
  port = carry(tblocks.BasicBlockNoRelu(cin, cout, stride, 1, dilation,
                                        has_downsample=True), variables)
  with torch.no_grad():
    got = port(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
  np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                             atol=1e-5)


@pytest.mark.parametrize("with_skips", [False, True])
def test_hourglass_matches_flax(with_skips):
  rng = np.random.default_rng(2)
  x = rng.normal(size=(1, 8, 16, 24, 8)).astype(np.float32)
  skip = (None if not with_skips
          else rng.normal(size=(1, 4, 8, 12, 16)).astype(np.float32))
  hg = jdisp.Hourglass(8)
  jskip = None if skip is None else jnp.asarray(skip)
  shapes = jax.eval_shape(lambda: hg.init(jax.random.PRNGKey(0),
                                          jnp.asarray(x), jskip, jskip,
                                          False))
  variables = numpy_variables(shapes, 3)
  want = hg.apply(variables, jnp.asarray(x), jskip, jskip, False)
  port = carry(tdisp.Hourglass(8), variables)
  tskip = None if skip is None else torch.from_numpy(skip)
  with torch.no_grad():
    got = port(torch.from_numpy(x), tskip, tskip)
  for g, w in zip(got, want):
    np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("layer", ["conv", "deconv"])
def test_layer_operands_follow_weight_changes(layer):
  """A 3-D layer keeps its packed weight and folded BN between calls and
  remakes them after an in-place edit or a ``load_state_dict``."""
  torch.manual_seed(0)
  mod = (tblocks.ConvBn3d(4, 6) if layer == "conv"
         else tblocks.DeconvBn3d(4, 6)).eval()
  tblocks.init_weights(mod, torch.Generator().manual_seed(1))
  x = torch.randn(1, 2, 3, 4, 4)

  def fresh():
    """The same layer built anew from the current state_dict."""
    twin = (tblocks.ConvBn3d(4, 6) if layer == "conv"
            else tblocks.DeconvBn3d(4, 6)).eval()
    twin.load_state_dict(mod.state_dict())
    return twin(x, relu=True)

  first = mod(x, relu=True)
  kept = mod._operands._value[0]
  mod(x, relu=True)
  assert mod._operands._value[0] is kept           # not made again
  with torch.no_grad():
    mod[1].running_var.mul_(4.0)
    mod[0].weight.neg_()
  torch.testing.assert_close(mod(x, relu=True), fresh(), rtol=0, atol=0)
  state = {k: v * 0.5 for k, v in mod.state_dict().items()}
  mod.load_state_dict(state)
  got = mod(x, relu=True)
  torch.testing.assert_close(got, fresh(), rtol=0, atol=0)
  assert not torch.equal(got, first)


@pytest.fixture(scope="module")
def slice_pair():
  """The slice at a CPU size: maxdisp 32, (1, 256, 512, 3) images."""
  h, w, maxdisp = 256, 512, 32
  rng = np.random.default_rng(4)
  left = (rng.normal(size=(1, h, w, 3)) * 0.5).astype(np.float32)
  right = np.roll(left, 3, axis=2)
  jmodel = jdisp.ModeDisparity(maxdisp=maxdisp, conv="Regular",
                               out_conf=True)
  shapes = jax.eval_shape(lambda: jmodel.init(
      jax.random.PRNGKey(0), jnp.asarray(left), jnp.asarray(right),
      train=False))
  # with random weights the 25 residual blocks of the feature extractor grow
  # the activations to ~1e7 (nothing calibrates the BN statistics); the
  # heads are scaled down so the logits spread over a few units and the
  # softmax stays soft, as a trained net's does
  variables = numpy_variables(shapes, 5, head_scale=1e-6)
  port = tdisp.ModeDisparity(maxdisp, "Regular", out_conf=True, device="cpu")
  carry(port, variables)
  return jmodel, variables, port, left, right


def test_slice_matches_jax_model(slice_pair):
  """Pred MAE <= 1e-3 px, max <= 1e-2 px, conf MAE <= 1e-3: the bars of
  tests/test_trained_parity_midres.py. The JAX side runs its XLA path
  (Pallas off), the plain reference of its kernels."""
  jmodel, variables, port, left, right = slice_pair
  ck.set_conv3d_pallas("off")
  try:
    j_pred, j_conf = jax.jit(lambda v, a, b: jmodel.apply(
        v, a, b, train=False))(variables, jnp.asarray(left),
                               jnp.asarray(right))
  finally:
    ck.set_conv3d_pallas("auto")
  pred, conf = port(torch.from_numpy(left), torch.from_numpy(right))
  assert pred.shape == conf.shape == (1, 256, 512)
  err = np.abs(pred.numpy() - np.asarray(j_pred))
  assert err.mean() <= 1e-3 and err.max() <= 1e-2, (err.mean(), err.max())
  conf_mae = np.abs(conf.numpy() - np.asarray(j_conf)).mean()
  assert conf_mae <= 1e-3, conf_mae
  # the operating point is not degenerate: disparities spread, the softmax
  # is not one-hot
  assert float(pred.std()) > 0.5 and float(conf.mean()) < 0.9


def test_state_dict_round_trips_to_jax_variables(slice_pair):
  """The port's keys are the reference torch keys: the JAX package's own
  torch converter maps the port's state_dict back to the same variables."""
  _, variables, port, _, _ = slice_pair
  back = convert_state_dict(port.state_dict(), variables)
  flat_back = jax.tree_util.tree_leaves_with_path(back)
  flat_want = dict(jax.tree_util.tree_leaves_with_path(variables))
  assert len(flat_back) == len(flat_want)
  for path, leaf in flat_back:
    np.testing.assert_array_equal(np.asarray(leaf),
                                  np.asarray(flat_want[path]))


@pytest.mark.parametrize("wrapped", [False, True])
def test_reference_checkpoint_loads(slice_pair, wrapped):
  """A reference ``.tar`` state_dict, saved from ``nn.DataParallel``
  (``module.`` prefixes), bare or inside the training wrapper, loads
  strictly into the port."""
  _, _, port, _, _ = slice_pair
  state = {"module." + k: v for k, v in port.state_dict().items()}
  ckpt = {"epoch": 3, "state_dict": state} if wrapped else state
  fresh = tdisp.ModeDisparity(32, "Regular", out_conf=True, device="cpu")
  fresh.load_state_dict(unwrap_checkpoint(ckpt), strict=True)
  for key, value in port.state_dict().items():
    torch.testing.assert_close(fresh.state_dict()[key], value, rtol=0,
                               atol=0)
