"""The whole frame of mode_tpu_torch (``pipeline.TwoStagePipeline``) against
the JAX package's, f32 on the CPU, and the pieces it adds: the conv-weight
cast, the normalisation's device constants and the FLOP counts.

The frame: 64x32 Cassini, maxdisp 16, stage 1 with the trained reference
weights (``tests/data/trained_mirror.npz``), the fusion net with seeded
weights (its head scaled as in ``tests/test_torch_fusion.py``), six
textured pairs each with its own disparity, the four views of pairs 12 and
34; uint8 inputs (normalised on the device) and float ones. The JAX frame
is built once per module for each. Bars: the disparities and confidences
at the stage-1 bars of ``tests/test_trained_parity_midres.py``, the fused
depth's MAE <= 1e-2 m; the bridge's pixels that differ beyond a few f32
steps (``tests/test_torch_geometry.py``) are counted and printed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mode_tpu import pipeline as jpipe
from mode_tpu.models import fusion as jfusion
from mode_tpu.utils import flops as jflops
from mode_tpu.utils.torch_convert import convert_state_dict
from mode_tpu_torch import pipeline as tpipe
from mode_tpu_torch import training as ttraining
from mode_tpu_torch.models import blocks as tblocks
from mode_tpu_torch.models import disparity as tdisp
from mode_tpu_torch.models import fusion as tfusion
from mode_tpu_torch.utils import flops as tflops
from mode_tpu_torch.utils.convert import load_npz
from tests.port_weights import carry, numpy_variables
from tests.test_torch_fusion import HEAD_SCALE
from tests.trained_mirror import _make_batch, get_trained_state_dict

torch.set_num_threads(2)

H, W, MAXDISP = 64, 32, 16
NPZ = "tests/data/trained_mirror.npz"
DISPS = (4, 8, 12, 12, 8, 4)
PRED_MAE, PRED_MAX, CONF_MAE = 1e-3, 1e-2, 1e-3
FUSED_MAE = 1e-2


def _frame(seed=11):
  """Six textured pairs, the right view the left rolled by the pair's
  disparity, NHWC f32, and the same as uint8 whose ImageNet normalisation
  is the texture up to the 8-bit step."""
  rng = np.random.default_rng(seed)
  lefts, rights = [], []
  for d in DISPS:
    left, right, _ = _make_batch(rng, 1, disps=(d,), h=H, w=W)
    lefts.append(left[0].permute(1, 2, 0).numpy())
    rights.append(right[0].permute(1, 2, 0).numpy())
  lefts, rights = np.stack(lefts), np.stack(rights)
  mean = np.float32(ttraining.IMAGENET_MEAN)
  std = np.float32(ttraining.IMAGENET_STD)

  def u8(x):
    return np.clip(np.round((x * std + mean) * 255), 0, 255).astype(np.uint8)

  return {False: (lefts, rights), True: (u8(lefts), u8(rights))}


def _views(lefts, rights):
  return np.stack([lefts[0], rights[0], lefts[5], rights[5]])


def _fusion_variables():
  zeros = [np.zeros((1, H, W, 1), np.float32)] * 6
  views = [np.zeros((1, H, W, 3), np.float32)] * 4
  shapes = jax.eval_shape(lambda: jfusion.ModeFusion(1000.0).init(
      jax.random.PRNGKey(0), zeros, zeros, views, False))
  return numpy_variables(shapes, 6, head_scale=HEAD_SCALE["fusion"])


@pytest.fixture(scope="module")
def frame():
  """The inputs, the fusion weights and the JAX frame's outputs, uint8 and
  float."""
  inputs = _frame()
  fusion_vars = _fusion_variables()
  dummy = jnp.zeros((1, H, W, 3))
  from mode_tpu.models.disparity import ModeDisparity
  shapes = jax.eval_shape(lambda: ModeDisparity(
      maxdisp=MAXDISP, out_conf=True).init(jax.random.PRNGKey(0), dummy,
                                            dummy, train=False))
  disp_vars = convert_state_dict(
      get_trained_state_dict(),
      jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype), shapes))
  want = {}
  for u8, (lefts, rights) in inputs.items():
    pipe = jpipe.TwoStagePipeline(disp_vars, fusion_vars, MAXDISP, 1000.0,
                                  uint8_inputs=u8)
    want[u8] = tuple(np.asarray(a) for a in pipe(lefts, rights,
                                                 _views(lefts, rights)))
  return inputs, fusion_vars, want


def _port(fusion_vars, **kw):
  disp = load_npz(tdisp.ModeDisparity(MAXDISP, out_conf=True, device="cpu"),
                  NPZ)
  fusion = carry(tfusion.ModeFusion(1000.0, device="cpu"), fusion_vars)
  return tpipe.TwoStagePipeline(disp, fusion, MAXDISP, 1000.0, device="cpu",
                                **kw)


@pytest.mark.parametrize("u8", [True, False])
def test_frame_matches_jax(frame, u8):
  inputs, fusion_vars, want = frame
  lefts, rights = inputs[u8]
  pipe = _port(fusion_vars, uint8_inputs=u8)
  fused, disp, conf = pipe(torch.from_numpy(lefts), torch.from_numpy(rights),
                           torch.from_numpy(_views(lefts, rights)))
  j_fused, j_disp, j_conf = want[u8]
  assert fused.shape == (H, W) and disp.shape == conf.shape == (6, H, W)
  assert fused.dtype == disp.dtype == conf.dtype == torch.float32
  err = np.abs(disp.numpy() - j_disp)
  assert err.mean() <= PRED_MAE and err.max() <= PRED_MAX, (err.mean(),
                                                            err.max())
  assert np.abs(conf.numpy() - j_conf).mean() <= CONF_MAE
  depths, _ = tpipe.bridge_all_pairs(disp, conf)
  j_depths, _ = jpipe.bridge_all_pairs(j_disp, j_conf)
  differ = np.abs(depths.numpy() - np.asarray(j_depths)) > 4e-7 * np.abs(
      np.asarray(j_depths))
  print(f"frame (uint8 {u8}): bridged depths differ beyond 4e-7 at "
        f"{differ.sum(axis=(1, 2)).tolist()} pixels per pair", flush=True)
  fused_mae = float(np.abs(fused.numpy() - j_fused).mean())
  assert fused_mae <= FUSED_MAE, fused_mae
  assert 1.0 < j_fused.std()


def test_stage1_chunks_agree(frame):
  inputs, fusion_vars, _ = frame
  lefts, rights = (torch.from_numpy(a) for a in inputs[True])
  rgbs = torch.from_numpy(_views(*inputs[True]))
  six = _port(fusion_vars, uint8_inputs=True)(lefts, rights, rgbs)
  three = _port(fusion_vars, uint8_inputs=True, stage1_chunk=3)(lefts,
                                                                rights, rgbs)
  for a, b in zip(six, three):
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_pipeline_takes_reference_state_dicts(frame):
  """State dicts in the reference's layout build the same frame."""
  inputs, fusion_vars, _ = frame
  port = _port(fusion_vars)
  lefts, rights = (torch.from_numpy(a) for a in inputs[False])
  rgbs = torch.from_numpy(_views(*inputs[False]))
  fusion_state = dict(port.fusion.state_dict())
  fusion_state["feature_extraction.depth_layer1.0.downsample.0.weight"] = (
      torch.zeros(32, 12, 1, 1))
  pipe = tpipe.TwoStagePipeline(port.disp.state_dict(), fusion_state, MAXDISP,
                                1000.0, device="cpu")
  for a, b in zip(pipe(lefts, rights, rgbs), port(lefts, rights, rgbs)):
    assert torch.equal(a, b)
  with pytest.raises(ValueError, match="stage1_chunk"):
    _port(fusion_vars, stage1_chunk=4)


# --- the conv-weight cast and the normalisation -------------------------------


def test_cast_conv_params_casts_conv_weights_only():
  """A cast copy, as the JAX package's ``cast_conv_params`` returns a new
  tree: conv weights bf16, biases and BN f32; the module passed in keeps
  its f32 weights."""
  model = tdisp.ModeDisparity(MAXDISP, out_conf=True, device="cpu")
  fusion = tfusion.ModeFusion(1000.0, (8, 16, 32, 64), device="cpu")
  layer = model.feature_extraction.layer4[0].conv2
  before = tblocks._fused_operands(layer, tblocks.conv2d_ops.pack_weight_tc)
  cast = {}
  for key, m in (("disp", model), ("fusion", fusion)):
    cast[key] = ttraining.cast_conv_params(m, torch.bfloat16)
    assert cast[key] is not m
    for (name, p), (_, q) in zip(cast[key].named_parameters(),
                                 m.named_parameters()):
      conv = p.dim() >= 4        # every conv-like weight, the 1x1 head's
      assert p.dtype == (torch.bfloat16 if conv else torch.float32), name
      assert q.dtype == torch.float32, name
      assert torch.equal(p.float(), q.detach().to(p.dtype).float()), name
  assert cast["fusion"].feature_extraction.depth_layer7[2].bias.dtype == (
      torch.float32)
  # the copy's kernel-layout weights follow the cast; the original's stay
  after = tblocks._fused_operands(cast["disp"].feature_extraction.layer4[0]
                                  .conv2, tblocks.conv2d_ops.pack_weight_tc)
  again = tblocks._fused_operands(layer, tblocks.conv2d_ops.pack_weight_tc)
  assert before[0].parts.dtype == again[0].parts.dtype == torch.float32
  assert after[0].parts.dtype == torch.bfloat16
  assert after[0].parts.shape[0] == 1 and before[0].parts.shape[0] == 2


# --- the modules the pipeline holds (fault F4) --------------------------------


def _bn_buffers(module):
  return {k: v.clone() for k, v in module.state_dict().items()
          if k.endswith(("running_mean", "running_var",
                         "num_batches_tracked"))}


def test_pipeline_runs_train_mode_modules_in_eval():
  """Stage 1 and the fusion net handed over in train mode (as a training
  step leaves them) give the frame of eval-mode modules, bit for bit; the
  caller's modules keep their mode and their BN statistics."""
  lefts, rights = (torch.from_numpy(a) for a in _frame()[True])
  rgbs = torch.stack([lefts[0], rights[0], lefts[5], rights[5]])
  fusion_vars = _fusion_variables()
  eval_pipe = _port(fusion_vars, uint8_inputs=True)
  want = eval_pipe(lefts, rights, rgbs)
  disp = load_npz(tdisp.ModeDisparity(MAXDISP, out_conf=True, device="cpu"),
                  NPZ).train()
  fusion = carry(tfusion.ModeFusion(1000.0, device="cpu"),
                 fusion_vars).train()
  buffers = {"disp": _bn_buffers(disp), "fusion": _bn_buffers(fusion)}
  pipe = tpipe.TwoStagePipeline(disp, fusion, MAXDISP, 1000.0,
                                uint8_inputs=True, device="cpu")
  got = pipe(lefts, rights, rgbs)
  for a, b in zip(got, want):
    assert torch.equal(a, b)
  assert disp.training and fusion.training
  assert not pipe.disp.training and not pipe.fusion.training
  for key, m in (("disp", disp), ("fusion", fusion)):
    for name, v in _bn_buffers(m).items():
      assert torch.equal(v, buffers[key][name]), name


def test_bf16_pipeline_leaves_the_callers_modules_f32():
  disp = load_npz(tdisp.ModeDisparity(MAXDISP, out_conf=True, device="cpu"),
                  NPZ)
  fusion = tfusion.ModeFusion(1000.0, (8, 16, 32, 64), device="cpu")
  pipe = tpipe.TwoStagePipeline(disp, fusion, MAXDISP, 1000.0,
                                dtype=torch.bfloat16, device="cpu")
  for m in (disp, fusion):
    assert {p.dtype for p in m.parameters()} == {torch.float32}
  for m in (pipe.disp, pipe.fusion):
    assert torch.bfloat16 in {p.dtype for p in m.parameters()}


def test_normalize_keeps_its_output_and_uploads_once():
  x = torch.from_numpy(np.random.default_rng(1).integers(
      0, 256, (2, 4, 5, 3), np.uint8))
  got = ttraining.normalize_rgb_on_device(x)
  # the JAX package's compiled arithmetic: x * f32(1/255) - mean as one
  # fused multiply-add, then times f32(1/std)
  mean = np.float32(ttraining.IMAGENET_MEAN).astype(np.float64)
  inv_std = np.float32(1) / np.float32(ttraining.IMAGENET_STD)
  want = (x.numpy() * np.float64(np.float32(1 / 255)) - mean).astype(
      np.float32) * inv_std
  np.testing.assert_array_equal(got.numpy(), want)
  assert torch.equal(ttraining.normalize_rgb_on_device(x, torch.bfloat16),
                     got.to(torch.bfloat16))
  dev = torch.device("cpu")
  assert all(a is b for a, b in zip(ttraining.imagenet_stats(dev),
                                    ttraining.imagenet_stats(dev)))


# --- FLOP counts ---------------------------------------------------------------


def test_flops_equal_the_jax_package_counts():
  """The copy of ``utils/flops.py`` at the shapes of ``tests/test_flops.py``
  and at the production frame."""
  for args in [(1, 64, 32, 16), (1, 1024, 512, 192), (2, 1024, 512, 192)]:
    assert tflops.disparity_flops(*args) == jflops.disparity_flops(*args)
  for args in [(1, 64, 128), (1, 1024, 512)]:
    assert tflops.fusion_flops(*args) == jflops.fusion_flops(*args)
  assert tflops.fusion_flops(1, 64, 128, (8, 16, 32, 64)) == (
      jflops.fusion_flops(1, 64, 128, (8, 16, 32, 64)))
  assert tflops.pipeline_flops() == jflops.pipeline_flops()
  assert 9.0e12 < tflops.pipeline_flops() < 10.5e12
