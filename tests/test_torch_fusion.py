"""Stage 2 of mode_tpu_torch (``models/fusion.py`` and its blocks) against the
JAX package, f32 on the CPU, and which of its convs take the port's 2-D
kernel.

The two sides share seeded numpy weights (JAX init shapes ->
``tests/port_weights.py:numpy_variables`` -> ``params_from_jax`` ->
``load_state_dict(strict=True)``), BN statistics randomised. Bars: rtol
1e-4, atol 1e-2 m (the depth range is 1000 m). The 1x1 head is scaled by
``HEAD_SCALE`` so its logits have a std of about 1 (the features of the
seeded nets on depths of up to 900 m give logits of std ~400-530): at a
logit std of ~20, most pixels sit in the sigmoid's flat tails, and where
they leave them a 1e-7 input jitter moves the JAX package's own output by
0.02-0.18 m, at or past the bar.

- the NHWC forward at 32x16, batch 2, channels (8, 16, 32, 64), and the
  lane-major forward at 16x128, batch 1, where the JAX package runs its
  2-D band kernel (``_CONV3D_MODE="on"``, Pallas in interpret mode): in
  ``tests/test_torch_fusion_forward.py``, with this file's helpers;
- ``Baseline`` on the NHWC forward;
- the eval forward keeps no graph (the training forward is held in
  ``tests/test_torch_fusion_train.py``).

The routing: the JAX fusion net traced under ``jax.eval_shape`` with
counting stubs for its Pallas 2-D kernels, against the port's calls of
``ops/conv2d.py:conv2d_s1_bn_act``, at 16x128 and at the frame's 1024x512,
where ``chip_smoke.py`` expects the count; and under a ``(1, 2)`` mesh at
1024x512, the JAX net's ``conv2d_band_sharded`` calls against the port's
halo-form calls (``parallel/shard_ops.py``), shapes only.

The spatial axis: ``ModeFusion`` in eval on ``(1, 2)`` and ``(2, 2)`` gloo
meshes (``tests/torch_spatial_ranks.py``) at 32x128, batch 2, the fused
batch gathered from every rank, against the single-device JAX net at the
bars above and against the port in one process at 1e-5 (relative: the
depths reach 1000 m), with 38 halo exchanges a forward on every rank.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import chip_smoke
from mode_tpu.models import fusion as jfusion
from mode_tpu.ops.pallas import conv2d_kernel as c2k
from mode_tpu.ops.pallas import conv3d_kernel as c3k
from mode_tpu.parallel import mesh as jmesh
from mode_tpu.parallel import shard_ops as jshard
from mode_tpu_torch.models import blocks as tblocks
from mode_tpu_torch.models import fusion as tfusion
from mode_tpu_torch.ops import conv2d as conv2d_ops
from mode_tpu_torch.parallel import mesh as pmesh
from mode_tpu_torch.parallel import shard_ops
from mode_tpu_torch.parallel.launch import run_ranks
from mode_tpu_torch.utils.convert import load_reference_state_dict
from tests import torch_spatial_ranks as ranks
from tests.port_weights import carry, numpy_variables
from tests.torch_mirror import ModeFusionT

torch.set_num_threads(2)

SMALL = (8, 16, 32, 64)
HEAD_SCALE = {"fusion": 1 / 400, "baseline": 1 / 530}
RTOL, ATOL = 1e-4, 1e-2


@pytest.fixture
def interpret_pallas(monkeypatch):
  orig = pl.pallas_call
  monkeypatch.setattr(pl, "pallas_call",
                      functools.partial(orig, interpret=True))


def _maps(seed, b, h, w, k, lo, hi, ch):
  rng = np.random.default_rng(seed)
  return [rng.uniform(lo, hi, (b, h, w, ch)).astype(np.float32)
          for _ in range(k)]


def _frame_inputs(b, h, w, seed=5):
  depths = _maps(seed, b, h, w, 6, 0.0, 900.0, 1)
  confs = _maps(seed + 1, b, h, w, 6, 0.0, 1.0, 1)
  rgbs = [x * 4 - 2 for x in _maps(seed + 2, b, h, w, 4, 0.0, 1.0, 3)]
  return depths, confs, rgbs


def _torch(arrays):
  return [torch.from_numpy(a) for a in arrays]


def _fusion_case(b, h, w, channels=SMALL, seed=3):
  inputs = _frame_inputs(b, h, w)
  jmodel = jfusion.ModeFusion(1000.0, channels)
  shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), *inputs,
                                              False))
  variables = numpy_variables(shapes, seed,
                              head_scale=HEAD_SCALE["fusion"])
  want = np.asarray(jmodel.apply(variables, *inputs, False))
  port = carry(tfusion.ModeFusion(1000.0, channels, device="cpu"), variables)
  got = port(*(_torch(x) for x in inputs)).numpy()
  return got, want


def _assert_close(got, want):
  assert got.shape == want.shape
  # the outputs spread over the depth range, so the bar sees the net
  assert 100.0 < want.std() and 0.05 < (want < 500).mean() < 0.95
  np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_baseline_matches_jax():
  depths = _maps(7, 2, 32, 16, 6, 0.0, 900.0, 1)
  jmodel = jfusion.Baseline(1000.0)
  shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), depths,
                                              False))
  variables = numpy_variables(shapes, 4, head_scale=HEAD_SCALE["baseline"])
  want = np.asarray(jmodel.apply(variables, depths, False))
  port = carry(tfusion.Baseline(1000.0, device="cpu"), variables)
  _assert_close(port(_torch(depths)).numpy(), want)


def test_reference_state_dict_loads_without_its_dead_branches():
  """The reference's fusion ``state_dict`` (the torch mirror's keys) loads
  into the port once the keys of the ``downsample`` branches its blocks
  build and never run are dropped; every other tensor lands as it was."""
  torch.manual_seed(0)
  ref = ModeFusionT(1000.0, list(SMALL), {"depth": 12, "rgb": 12})
  state = ref.state_dict()
  port = tfusion.ModeFusion(1000.0, SMALL, device="cpu")
  dropped = load_reference_state_dict(port, state)
  assert dropped and all(".downsample." in k for k in dropped)
  assert set(dropped) == set(state) - set(port.state_dict())
  for k, v in port.state_dict().items():
    assert torch.equal(v, state[k]), k
  with pytest.raises(KeyError, match="map to nothing"):
    load_reference_state_dict(port, {**state, "feature_extraction.extra": v})


def test_fusion_forward_is_eval_only():
  """The eval forward is inference only: it keeps no graph and leaves the
  BN statistics as they are, even when the caller has autograd on. Only
  after ``train()`` (``tests/test_torch_fusion_train.py``) does the forward
  build a graph and update them."""
  port = tfusion.ModeFusion(1000.0, SMALL, device="cpu")
  bn = port.feature_extraction.depth_layer1[0].conv1[0][1]
  before = bn.running_mean.clone()
  with torch.enable_grad():
    out = port(*(_torch(x) for x in _frame_inputs(2, 16, 8)))
  assert out.grad_fn is None and not out.requires_grad
  assert torch.equal(bn.running_mean, before)
  assert int(bn.num_batches_tracked) == 0
  port.train()
  out = port(*(_torch(x) for x in _frame_inputs(2, 16, 8)))
  assert out.grad_fn is not None and int(bn.num_batches_tracked) == 1


# --- which convs take the 2-D kernel -------------------------------------------


def _count_jax(monkeypatch, h, w, channels, batch=1):
  """The JAX fusion net's eval forward traced with its Pallas policy on:
  calls of its per-image and batch-packed 2-D kernels. The stubs return
  zeros of the output's shape, so no kernel is traced."""
  monkeypatch.setattr(c3k, "_CONV3D_MODE", "on")
  calls = {"K8": 0, "K9": 0}

  def stub(name, shape_fn):
    def fn(x, weight, *args, **kwargs):
      calls[name] += 1
      return jnp.zeros(shape_fn(x, weight), x.dtype)
    return fn

  monkeypatch.setattr(c2k, "conv2d_band_pallas", stub(
      "K8", lambda x, k: (x.shape[0], x.shape[1], k.shape[-1], x.shape[3])))
  monkeypatch.setattr(c2k, "conv2d_band_bpack", stub(
      "K9", lambda x, k: (x.shape[0], x.shape[1], k.shape[-1], x.shape[3])))
  monkeypatch.setattr(c2k, "conv2d_3x3_fast_train", stub(
      "K9", lambda x, k: (*x.shape[:3], k.shape[-1])))
  model = jfusion.ModeFusion(1000.0, channels)
  zeros = [jnp.zeros((batch, h, w, 1))] * 6
  views = [jnp.zeros((batch, h, w, 3))] * 4
  variables = jax.eval_shape(lambda: model.init(
      jax.random.PRNGKey(0), zeros, zeros, views, False))
  calls.update(K8=0, K9=0)
  jax.eval_shape(lambda v: model.apply(v, zeros, zeros, views, False),
                 variables)
  return calls


def _count_port(monkeypatch, h, w, channels, batch=1):
  """Calls of the port's 2-D kernel wrapper in the fusion net's forward;
  the stub returns zeros of the output's shape."""
  calls = []

  def stub(x, weight, *args, **kwargs):
    calls.append(tuple(x.shape))
    return torch.zeros((*x.shape[:3], weight.cout))

  monkeypatch.setattr(conv2d_ops, "conv2d_s1_bn_act", stub)
  model = tfusion.ModeFusion(1000.0, channels, device="cpu")
  zeros = [torch.zeros((batch, h, w, 1))] * 6
  views = [torch.zeros((batch, h, w, 3))] * 4
  model(zeros, zeros, views)
  return calls


def test_routing_at_16x128(monkeypatch):
  """The lane-major forward at 16x128: the 16 convs of the full-resolution
  level (depth_layer1, rgb_layer1, fusion_layer1, depth_layer7) take the
  kernel; the coarser levels' W is under 128."""
  assert _count_jax(monkeypatch, 16, 128, SMALL) == {"K8": 16, "K9": 0}
  assert len(_count_port(monkeypatch, 16, 128, SMALL)) == 16


def test_routing_at_the_frame_shape(monkeypatch):
  """At 1024x512 every fusion conv but depth_layer4's two (W = 64) takes the
  kernel: 16 at W = 512, 10 at 256, 10 at 128, 36 in all, the count
  ``chip_smoke.py``'s frame path expects. The two 12-channel convs are
  among them, their input padded to 16 channels."""
  jax_calls = _count_jax(monkeypatch, 1024, 512, (32, 64, 128, 256))
  port_calls = _count_port(monkeypatch, 1024, 512, (32, 64, 128, 256))
  assert jax_calls == {"K8": chip_smoke.FUSION_K8, "K9": 0}
  assert len(port_calls) == chip_smoke.FUSION_K8 == 36
  assert [s[2] for s in port_calls].count(512) == 16
  assert [s for s in port_calls if s[3] == 16] == [(1, 1024, 512, 16)] * 2
  frame = chip_smoke.FRAME_JAX["conv2d_s1_bn_act"]
  assert frame[1] == chip_smoke.FUSION_K8 + 64


def test_nhwc_forward_routes_as_the_jax_package(monkeypatch):
  """Off the lane-major forward (W under 128) the JAX package's fusion
  convs take its batch-packed kernel where ``train_bpack2d_g`` says so: at
  batch 2 with H a multiple of 128 every conv whose Cin is a multiple of 8;
  the port routes the same convs."""
  jax_calls = _count_jax(monkeypatch, 128, 64, SMALL, batch=2)
  port_calls = _count_port(monkeypatch, 128, 64, SMALL, batch=2)
  assert jax_calls["K8"] == 0 and jax_calls["K9"] == len(port_calls) > 0


def test_fusion_conv_pads_cin_to_a_multiple_of_8():
  """A 12-channel conv through the kernel path pads input and weight with
  zero channels; its plain version equals the unpadded conv."""
  gen = torch.Generator().manual_seed(0)
  layer = tblocks.FusionConvBn(12, 16)
  tblocks.init_weights(layer, gen)
  layer.eval()
  x = torch.randn((1, 8, 128, 12), generator=gen)
  with torch.no_grad():
    a = layer(x, kernel=True)
    b = layer(x, kernel=False)
  packed = layer._packed.get((layer[0].weight,), None)
  assert packed.weight.shape == (16, 16, 3, 3)
  torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


# --- the spatial axis ---------------------------------------------------------

SPATIAL = 2
FRAME_HALO_CONVS = 38       # every 3x3 conv of the net exchanges its halo


def _count_jax_mesh(monkeypatch, h, w, channels, spatial):
  """The JAX fusion net's eval forward traced under a ``(1, spatial)`` mesh
  of the CPU's virtual devices with its Pallas policy on: the shard-local
  shapes (lane-major ``(B, M / S, C, L)``) of its ``conv2d_band_sharded``
  calls, and its unsharded 2-D kernels' calls (none)."""
  monkeypatch.setattr(c3k, "_CONV3D_MODE", "on")
  sharded, bare = [], []

  def stub(x, weight, scale, bias, residual, relu, mesh):
    sharded.append((x.shape[0], x.shape[1] // spatial, *x.shape[2:]))
    return jnp.zeros((x.shape[0], x.shape[1], weight.shape[-1], x.shape[3]),
                     x.dtype)

  def bare_stub(x, weight, *args, **kwargs):
    bare.append(x.shape)
    return jnp.zeros((x.shape[0], x.shape[1], weight.shape[-1], x.shape[3]),
                     x.dtype)

  monkeypatch.setattr(jshard, "conv2d_band_sharded", stub)
  monkeypatch.setattr(c2k, "conv2d_band_pallas", bare_stub)
  model = jfusion.ModeFusion(1000.0, channels)
  zeros = [jnp.zeros((1, h, w, 1))] * 6
  views = [jnp.zeros((1, h, w, 3))] * 4
  variables = jax.eval_shape(lambda: model.init(
      jax.random.PRNGKey(0), zeros, zeros, views, False))
  sharded.clear()
  bare.clear()
  with jmesh.activate(jmesh.make_mesh(data=1, spatial=spatial)):
    jax.eval_shape(lambda v: model.apply(v, zeros, zeros, views, False),
                   variables)
  return sharded, bare


def _count_port_mesh(monkeypatch, h, w, channels, spatial):
  """The port's eval forward under a ``(1, spatial)`` mesh (rank 0; the
  halo exchanges stubbed, so no process group): the NHWC shapes of a
  rank's rows reaching the kernel's halo form and the library form."""
  kernel, library = [], []

  def kernel_stub(x, weight, scale, bias, residual, relu, *, mesh, plain):
    kernel.append(tuple(x.shape))
    return torch.zeros((*x.shape[:3], weight.cout))

  def library_stub(x, weight, *, mesh):
    library.append(tuple(x.shape))
    return torch.zeros((*x.shape[:3], weight.shape[0]))

  monkeypatch.setattr(shard_ops, "conv2d_s1_sharded", kernel_stub)
  monkeypatch.setattr(shard_ops, "conv2d_library_sharded", library_stub)
  model = tfusion.ModeFusion(1000.0, channels, device="cpu")
  zeros = [torch.zeros((1, h, w, 1))] * 6
  views = [torch.zeros((1, h, w, 3))] * 4
  mesh = pmesh.Mesh(data=1, rank=0, device=torch.device("cpu"),
                    spatial=spatial)
  with pmesh.activate(mesh):
    out = model(zeros, zeros, views)
  assert out.shape == (1, h // spatial, w, 1)
  return kernel, library


def test_routing_under_a_spatial_mesh(monkeypatch):
  """At 1024x512 on a (1, 2) mesh the JAX net sends 36 convs to
  ``conv2d_band_sharded`` (every lane-major conv but depth_layer4's two,
  W = 64) and none to the bare kernel; the port sends the same 36, at the
  same shard-local shapes, to the kernel's halo form and depth_layer4's
  two to the library form: ``chip_smoke.FUSION_K8`` halo launches a
  frame."""
  channels = (32, 64, 128, 256)
  jax_calls, bare = _count_jax_mesh(monkeypatch, 1024, 512, channels,
                                    SPATIAL)
  kernel, library = _count_port_mesh(monkeypatch, 1024, 512, channels,
                                     SPATIAL)
  assert not bare
  assert len(jax_calls) == len(kernel) == chip_smoke.FUSION_K8 == 36
  # lane-major (B, M, C, L) against NHWC (B, H, W, C); C padded to 8 both
  assert [(b, m, l, c) for b, m, c, l in jax_calls] == kernel
  assert library == [(1, 64, 64, 128), (1, 64, 64, 256)]
  assert len(kernel) + len(library) == FRAME_HALO_CONVS


@pytest.fixture(scope="module")
def spatial_case():
  """A lane-eligible 32x128 batch of 2, seeded weights at the small widths,
  the single-device JAX net's output, the port's in one process, and the
  port's weights as numpy."""
  channels, (b, h, w) = SMALL, (2, 32, 128)
  inputs = _frame_inputs(b, h, w)
  jmodel = jfusion.ModeFusion(1000.0, channels)
  shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), *inputs,
                                              False))
  variables = numpy_variables(shapes, 3, head_scale=HEAD_SCALE["fusion"])
  want = np.asarray(jmodel.apply(variables, *inputs, False))
  port = carry(tfusion.ModeFusion(1000.0, channels, device="cpu"), variables)
  one = port(*(_torch(x) for x in inputs)).numpy()
  state = {k: v.numpy() for k, v in port.state_dict().items()}
  return inputs, want, one, state


@pytest.mark.parametrize("data,spatial", [(1, 2), (2, 2)])
def test_sharded_fusion_matches_jax_and_one_process(spatial_case, data,
                                                    spatial):
  """Each rank holds its ``(B / D, H / S, W, 1)`` rows of the one-process
  output; the fused batch gathered from every rank holds the single-device
  JAX net at the bars above."""
  inputs, want, one, state = spatial_case
  outs = run_ranks(ranks.sharded_fusion, data * spatial,
                   (state, SMALL, *inputs, data, spatial), timeout=300,
                   device="cpu", threads=1)
  b, h = want.shape[0] // data, want.shape[1] // spatial
  for r, out in enumerate(outs):
    d, s = r // spatial, r % spatial
    assert out["place"] == (d, s)
    mine = one[d * b:(d + 1) * b, s * h:(s + 1) * h]
    assert out["out"].shape == mine.shape
    np.testing.assert_allclose(out["out"], mine, rtol=1e-5, atol=1e-5)
    _assert_close(out["whole"], want)
    assert out["collectives"] == FRAME_HALO_CONVS
