"""Stage 2's training in mode_tpu_torch (``training.make_fusion_train_step``,
the fusion nets' training forward, ``utils/losses.py:silog_loss``) against
the JAX package, on the CPU, and which fusion convs take the port's 2-D
kernel in training.

The two sides share seeded numpy weights (JAX init shapes ->
``tests/port_weights.py:numpy_variables`` -> ``params_from_jax``),
channels (8, 16, 32, 64), on one packed frame of batch 2 at 128x64: six f16
depths in (1, 1000) m, six uint8 confidences, four uint8 views and an f32
ground truth with ~10% of its pixels past max_depth and a patch at 0. At
128x64 the full-resolution level's H is a multiple of 128, so its convs take
the kernel's Function (its plain version here) and the coarser levels'
convs ``F.conv2d``. The JAX steps are built and run once per module.

The 1x1 head is scaled by ``TRAIN_HEAD_SCALE`` so that its logits on the
frame have a std of ~0.8 in training (the batch's BN statistics make the
features O(1); ``tests/test_torch_fusion.py:HEAD_SCALE`` is the eval
forward's): the sigmoid is neither flat nor saturated.

Bars. The loss within 1e-5 relative, the BN running statistics within
1e-5, Adam on JAX's gradients within 1e-6 of optax's update. The gradients:
each leaf within ``||port - jax|| <= 1e-4 ||jax||`` plus twice the leaf's
own f32 spread (how far the port's step moves it when only the CPU thread
count changes), and the global norm within 1e-4 plus twice the global
spread. That spread is large at this operating point: a seeded net's
BN-ReLU stacks cancel most of each BN's backward, so a thread count alone
moves the median leaf by ~2% (1.9-2.0% measured) and the global norm by
the same; the transpose convs' biases, whose gradient under the next BN is
analytically zero, are pure rounding. In bf16 that amplification turns
most of the gradient into noise: JAX's own bf16 step parts from its f32
step by 77% of the gradient's norm, and only the leaves next to the head
are well conditioned. So the bf16 step is held (1) to be a bf16 step: its
loss and its gradients at least half as far from the port's f32 step as
JAX's bf16 step is from JAX's f32 step (a step that ignored
``compute_dtype`` lands at 0); (2) to JAX's bf16 step where bf16 is not
noise: the loss within 1e-3 relative and within twice what bf16 moves
either side's own f32 loss (one scalar's gap is one draw of the rounding
noise: 1.0e-4 for JAX's step, 3.7e-4 for the port's, measured), and each
leaf whose JAX bf16 gap is under 0.15 of its norm (the head and its last
block, 6 leaves here) within 0.25 of its norm and within twice the larger
of JAX's and the port's own bf16 gaps on that leaf. The port's bf16 moves
a step further from f32 than JAX's does on this CPU, where XLA is free to
keep f32 between fused bf16 operations and torch rounds each op's result
to bf16.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from mode_tpu import training as jtraining
from mode_tpu.models import fusion as jfusion
from mode_tpu.ops.pallas import conv2d_kernel as c2k
from mode_tpu.ops.pallas import conv3d_kernel as c3k
from mode_tpu.utils import losses as jlosses
from mode_tpu_torch import training as ttraining
from mode_tpu_torch.models import fusion as tfusion
from mode_tpu_torch.ops import conv2d as conv2d_ops
from mode_tpu_torch.utils import losses as tlosses
from mode_tpu_torch.utils.convert import grads_from_jax
from tests.background import in_threads, started
from tests.port_weights import carry, numpy_variables

torch.set_num_threads(2)

SMALL = (8, 16, 32, 64)
B, H, W = 2, 128, 64
MAX_DEPTH = 1000.0
TRAIN_HEAD_SCALE = 0.5
F32, BF16 = "f32", "bf16"
JAX_DTYPE = {F32: None, BF16: jnp.bfloat16}
TORCH_DTYPE = {F32: None, BF16: torch.bfloat16}


def _wire(seed=0, b=B, h=H, w=W):
  """A packed frame: numpy lists of depths (f16), confidences and views
  (uint8), and the ground truth (f32)."""
  rng = np.random.default_rng(seed)
  depths = [rng.uniform(1, MAX_DEPTH, (b, h, w, 1)).astype(np.float16)
            for _ in range(6)]
  confs = [rng.integers(0, 256, (b, h, w, 1), dtype=np.uint8)
           for _ in range(6)]
  rgbs = [rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8)
          for _ in range(4)]
  gt = rng.uniform(1, 1.1 * MAX_DEPTH, (b, h, w)).astype(np.float32)
  gt[:, 20:30, 10:20] = 0.0
  return depths, confs, rgbs, gt


def _jax_unpack(wire, dtype):
  """The JAX step's ``raw_inputs`` unpack (``mode_tpu/training.py:
  make_fusion_train_step``), line for line, jitted as the step is; numpy
  lists out."""
  dt = JAX_DTYPE[dtype] or jnp.float32

  @jax.jit
  def unpack(depths, confs, rgbs):
    return ([d.astype(dt) for d in depths],
            [c.astype(dt) * jnp.asarray(1.0 / 255.0, dt) for c in confs],
            [jtraining.normalize_rgb_on_device(r, dt) for r in rgbs])

  out = unpack(*([jnp.asarray(a) for a in xs] for xs in wire[:3]))
  return [[np.array(a.astype(jnp.float32)) for a in xs] for xs in out]


def _float_inputs(wire):
  """The wire frame unpacked in f32, as the step would."""
  return _jax_unpack(wire, F32)


@pytest.fixture(scope="module")
def wire():
  return _wire()


@pytest.fixture(scope="module")
def variables():
  zeros = [np.zeros((B, H, W, 1), np.float32)] * 6
  views = [np.zeros((B, H, W, 3), np.float32)] * 4
  shapes = jax.eval_shape(lambda: jfusion.ModeFusion(MAX_DEPTH, SMALL).init(
      jax.random.PRNGKey(0), zeros, zeros, views, False))
  return numpy_variables(shapes, 3, head_scale=TRAIN_HEAD_SCALE)


def _numpy(tree):
  return jax.tree_util.tree_map(lambda a: np.array(a, copy=True), tree)


def _jax_step(variables, inputs, gt, raw, dtype):
  """One JAX step: loss, gradients (optax's first moment / (1 - b1)), BN
  statistics and the parameters before and after."""
  model = jfusion.ModeFusion(MAX_DEPTH, SMALL)
  optimizer = jtraining.make_optimizer()
  state = jtraining.TrainState(
      params=variables["params"], batch_stats=variables["batch_stats"],
      opt_state=optimizer.init(variables["params"]),
      step=jnp.zeros((), jnp.int32))
  state = jtraining.set_learning_rate(state, ttraining.FUSION_LR)
  step = jtraining.make_fusion_train_step(
      model, optimizer, MAX_DEPTH, compute_dtype=JAX_DTYPE[dtype],
      raw_inputs=raw)
  new, loss = step(state, *([jnp.asarray(a) for a in xs] for xs in inputs),
                   jnp.asarray(gt))
  mu = new.opt_state.inner_state[0].mu
  return {"loss": float(loss), "stats": _numpy(new.batch_stats),
          "grads": grads_from_jax(jax.tree_util.tree_map(
              lambda m: np.asarray(m) / 0.1, mu)),
          "before": _numpy(state.params), "after": _numpy(new.params)}


@pytest.fixture(scope="module")
def jax_steps(variables, wire):
  """The three JAX steps, each built and run in a thread of its own
  (tracing takes turns, XLA compiles them at once)."""
  floats = _float_inputs(wire)
  gt = wire[3]
  return in_threads({(raw, dtype): functools.partial(
      _jax_step, variables, wire[:3] if raw else floats, gt, raw, dtype)
                     for raw, dtype in ((False, F32), (True, F32),
                                        (True, BF16))})


def _port_step(variables, wire, raw, dtype):
  """One port step; returns the model (its ``.grad`` and BN buffers after
  the step), the optimizer and the loss."""
  model = carry(tfusion.ModeFusion(MAX_DEPTH, SMALL, device="cpu"),
                variables)
  optimizer = ttraining.make_optimizer(model.parameters())
  ttraining.set_learning_rate(optimizer, ttraining.FUSION_LR)
  step = ttraining.make_fusion_train_step(
      model, optimizer, MAX_DEPTH, compute_dtype=TORCH_DTYPE[dtype],
      raw_inputs=raw)
  inputs = wire[:3] if raw else _float_inputs(wire)
  loss = step(*([torch.from_numpy(a) for a in xs] for xs in inputs),
              torch.from_numpy(wire[3]))
  return model, optimizer, float(loss)


def _grads(model):
  return {n: p.grad for n, p in model.named_parameters()}


def _spread(run, grads):
  """Per leaf, the largest distance of ``run()``'s gradients at 1 and 3 CPU
  threads from ``grads`` (taken at 2)."""
  spread = dict.fromkeys(grads, 0.0)
  try:
    for threads in (1, 3):
      torch.set_num_threads(threads)
      for name, g in run().items():
        spread[name] = max(spread[name],
                           float(torch.linalg.vector_norm(g - grads[name])))
  finally:
    torch.set_num_threads(2)
  return spread


def _assert_grads_within_spread(got, want, spread):
  assert set(got) == set(want)
  err2 = norm2 = spread2 = 0.0
  for name, g in got.items():
    ref = want[name]
    assert g is not None and g.shape == ref.shape, name
    err = float(torch.linalg.vector_norm(g - ref))
    norm = float(torch.linalg.vector_norm(ref))
    assert norm > 0, name
    assert err <= 1e-4 * norm + 2 * spread[name], (name, err, norm,
                                                   spread[name])
    err2, norm2, spread2 = err2 + err**2, norm2 + norm**2, spread2 + spread[
        name]**2
  assert err2**0.5 <= 1e-4 * norm2**0.5 + 2 * spread2**0.5
  assert err2 > 0                    # the two sides computed independently


def _assert_bn_statistics_match(model, stats):
  state = model.state_dict()
  n = 0
  for path, value in jax.tree_util.tree_leaves_with_path(stats):
    keys = [p.key for p in path]
    name = ".".join(keys[:-1]) + (".running_mean" if keys[-1] == "mean"
                                  else ".running_var")
    assert state[name].dtype == torch.float32, name
    np.testing.assert_allclose(state[name].numpy(), value, rtol=1e-5,
                               atol=1e-5, err_msg=name)
    key = name.rsplit(".", 1)[0] + ".num_batches_tracked"
    assert int(state[key]) == 1, key
    n += 1
  assert n == 2 * sum(1 for k in state if k.endswith("running_mean"))


# --- silog and the unpack ----------------------------------------------------


@pytest.mark.parametrize("lamda", [0.0, 0.5, 0.85])
def test_silog_loss_matches_jax(lamda):
  """Value and gradient on maps with masked pixels, ground truth <= 0 and
  predictions <= 0, none of which may enter or give a NaN."""
  rng = np.random.default_rng(2)
  pred = rng.uniform(0.5, 900.0, (2, 16, 8)).astype(np.float32)
  gt = rng.uniform(0.5, 1100.0, (2, 16, 8)).astype(np.float32)
  pred[0, :3] = -rng.uniform(0, 5, (3, 8))
  pred[1, 0, :4] = 0.0
  gt[1, 5:8] = 0.0
  gt[0, 10, :3] = -1.0
  mask = gt <= MAX_DEPTH

  def jloss(p):
    return jlosses.silog_loss(lamda, p, jnp.asarray(gt), jnp.asarray(mask))

  want, want_grad = jax.value_and_grad(jloss)(jnp.asarray(pred))
  p = torch.from_numpy(pred).requires_grad_()
  got = tlosses.silog_loss(lamda, p, torch.from_numpy(gt),
                           torch.from_numpy(mask))
  got.backward()
  assert abs(float(got) - float(want)) <= 1e-6 * abs(float(want))
  g = p.grad.numpy()
  assert np.isfinite(g).all() and (g[0, :3] == 0).all()
  np.testing.assert_allclose(g, np.asarray(want_grad), rtol=1e-6,
                             atol=1e-6 * np.abs(want_grad).max())


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_raw_unpack_matches_jax(wire, dtype):
  """The wire frame unpacked on the device, bit-equal to the JAX step's
  unpack, in f32 and bf16 (the 1/255 constant rounded to bf16 first)."""
  want = _jax_unpack(wire, dtype)
  tdt = TORCH_DTYPE[dtype] or torch.float32
  got = ttraining.unpack_fusion_inputs(
      *([torch.from_numpy(a) for a in xs] for xs in wire[:3]), tdt)
  assert [len(xs) for xs in got] == [len(xs) for xs in want] == [6, 6, 4]
  for gs, ws in zip(got, want):
    for g, w in zip(gs, ws):
      assert g.dtype == tdt
      np.testing.assert_array_equal(g.float().numpy(), w)


# --- the step ----------------------------------------------------------------


@pytest.mark.parametrize("raw", [False, True])
def test_fusion_step_matches_jax(variables, wire, jax_steps, raw):
  """One f32 step from float inputs and from the packed wire frame: loss,
  gradients and BN statistics against the JAX step's."""
  want = jax_steps[(raw, F32)]
  model, _, loss = _port_step(variables, wire, raw, F32)
  assert np.isfinite(loss) and loss > 0
  assert abs(loss - want["loss"]) <= 1e-5 * abs(want["loss"]), (
      loss, want["loss"])
  grads = _grads(model)
  spread = _spread(lambda: _grads(_port_step(variables, wire, raw, F32)[0]),
                   grads)
  _assert_grads_within_spread(grads, want["grads"], spread)
  _assert_bn_statistics_match(model, want["stats"])


def test_adam_update_matches_optax(variables, jax_steps):
  """JAX's gradients through the port's optimizer at ``FUSION_LR`` give
  optax's update."""
  want = jax_steps[(False, F32)]
  model = carry(tfusion.ModeFusion(MAX_DEPTH, SMALL, device="cpu"),
                variables)
  optimizer = ttraining.make_optimizer(model.parameters())
  ttraining.set_learning_rate(optimizer, ttraining.FUSION_LR)
  before = {n: p.detach().clone() for n, p in model.named_parameters()}
  for name, p in model.named_parameters():
    p.grad = want["grads"][name].clone()
  optimizer.step()
  want_before = grads_from_jax(want["before"])
  want_after = grads_from_jax(want["after"])
  for name, p in model.named_parameters():
    assert torch.equal(before[name], want_before[name]), name
    got = p.detach() - before[name]
    assert float((got - (want_after[name] - want_before[name])).abs().max()
                 ) <= 1e-6, name


def _dist(a, b):
  return sum(float(torch.linalg.vector_norm(a[k] - b[k]))**2
             for k in a)**0.5


def test_bf16_fusion_step_matches_jax(variables, wire, jax_steps):
  """The bf16 step on the wire frame against JAX's bf16 step, by the bf16
  bars of the module's docstring; the master weights, their gradients,
  Adam's state and the BN statistics stay f32."""
  jb, jf = jax_steps[(True, BF16)], jax_steps[(True, F32)]
  model, optimizer, loss = _port_step(variables, wire, True, BF16)
  model_f32, _, loss_f32 = _port_step(variables, wire, True, F32)
  grads, grads_f32 = _grads(model), _grads(model_f32)
  jax_gap = _dist(jb["grads"], jf["grads"])
  print({"jax_gap_over_norm": jax_gap / _dist(jb["grads"], {
      k: torch.zeros_like(v) for k, v in jb["grads"].items()}),
         "to_jax_bf16": _dist(grads, jb["grads"]) / jax_gap,
         "to_f32": _dist(grads, grads_f32) / jax_gap})
  # a bf16 step
  assert _dist(grads, grads_f32) >= 0.5 * jax_gap
  assert abs(loss - loss_f32) >= 0.5 * abs(jb["loss"] - jf["loss"]) > 0
  # JAX's bf16 step
  bf16_gap = max(abs(jb["loss"] - jf["loss"]), abs(loss - loss_f32))
  assert 0 < abs(loss - jb["loss"]) <= min(2 * bf16_gap,
                                           1e-3 * abs(jb["loss"])), (
                                               loss, jb["loss"], jf["loss"],
                                               loss_f32)
  held = []
  for name, g in grads.items():
    want = jb["grads"][name]
    norm = float(torch.linalg.vector_norm(want))
    gap = float(torch.linalg.vector_norm(want - jf["grads"][name]))
    if gap >= 0.15 * norm:
      continue
    own = float(torch.linalg.vector_norm(g - grads_f32[name]))
    err = float(torch.linalg.vector_norm(g - want))
    held.append((name, err / norm, gap / norm, own / norm))
    assert err <= min(0.25 * norm, 2 * max(gap, own)), held[-1]
  print(held)
  assert len(held) >= 4 and any("depth_layer7.2" in h[0] for h in held), held
  for name, p in model.named_parameters():
    assert p.dtype == p.grad.dtype == torch.float32, name
    state = optimizer.state[p]
    assert state["exp_avg"].dtype == state["exp_avg_sq"].dtype == (
        torch.float32), name
  for name, buf in model.named_buffers():
    if name.endswith(("running_mean", "running_var")):
      assert buf.dtype == torch.float32, name


def test_baseline_trains_as_jax():
  """``Baseline`` in train mode: its forward and the silog gradient against
  the JAX ``Baseline(train=True)``, batch 2 at 32x16. The forward is held
  elementwise within 1e-4 relative and 1e-2 m plus twice its own spread
  over the CPU thread counts (a thread count alone moves a few pixels by up
  to ~0.06 m of a 325 m spread), and its MAE within 1e-2 m."""
  depths = [d.astype(np.float32) for d in _wire(7, 2, 32, 16)[0]]
  gt = _wire(8, 2, 32, 16)[3]
  jmodel = jfusion.Baseline(MAX_DEPTH)
  shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), depths,
                                              False))
  variables = numpy_variables(shapes, 4, head_scale=TRAIN_HEAD_SCALE)
  mask = jnp.asarray(gt <= MAX_DEPTH)

  def jloss(params):
    out, _ = jmodel.apply({"params": params,
                           "batch_stats": variables["batch_stats"]},
                          depths, True, mutable=["batch_stats"])
    return jlosses.silog_loss(0.5, out[..., 0], jnp.asarray(gt), mask), out

  # the JAX side in a thread of its own, while the port's runs go on here
  jax_run = started(jax.value_and_grad(jloss, has_aux=True),
                    variables["params"])

  def run():
    port = carry(tfusion.Baseline(MAX_DEPTH, device="cpu"), variables).train()
    out = port([torch.from_numpy(d) for d in depths])
    gt_t = torch.from_numpy(gt)
    tlosses.silog_loss(0.5, out[..., 0], gt_t, gt_t <= MAX_DEPTH).backward()
    return {"out": out.detach(), **_grads(port)}

  got = run()
  spread = _spread(run, got)
  # the output elementwise, by its own spread over the thread counts
  out = got.pop("out").numpy()
  out_spread = np.zeros_like(out)
  try:
    for threads in (1, 3):
      torch.set_num_threads(threads)
      out_spread = np.maximum(out_spread, np.abs(run()["out"].numpy() - out))
  finally:
    torch.set_num_threads(2)
  (_, want_out), want = jax_run.result()
  want_out = np.asarray(want_out)
  assert 50.0 < want_out.std()
  assert np.abs(out - want_out).mean() <= 1e-2
  assert (np.abs(out - want_out)
          <= 1e-4 * np.abs(want_out) + 1e-2 + 2 * out_spread).all()
  _assert_grads_within_spread(got, grads_from_jax(want), spread)


# --- which convs take the kernel in training ---------------------------------


def _count_jax(monkeypatch, batch, h, w, channels, dtype):
  """The JAX fusion net's training forward traced (``jax.eval_shape``) with
  its Pallas policy on and the conv kernels and inputs in ``dtype``: calls
  of the batch-packed 2-D kernel's training twin. The stub returns zeros of
  the output's shape, so no kernel is traced."""
  monkeypatch.setattr(c3k, "_CONV3D_MODE", "on")
  calls = []

  def stub(x, k, g, dil):
    calls.append(tuple(x.shape))
    return jnp.zeros((*x.shape[:3], k.shape[-1]), x.dtype)

  monkeypatch.setattr(c2k, "conv2d_3x3_fast_train", stub)
  jdt = JAX_DTYPE[dtype] or jnp.float32
  model = jfusion.ModeFusion(MAX_DEPTH, channels)
  zeros = [jnp.zeros((batch, h, w, 1), jdt)] * 6
  views = [jnp.zeros((batch, h, w, 3), jdt)] * 4
  variables = jax.eval_shape(lambda: model.init(
      jax.random.PRNGKey(0), zeros, zeros, views, False))
  params = variables["params"]
  if dtype == BF16:
    params = jax.eval_shape(lambda p: jtraining.cast_conv_params(p, jdt),
                            params)
  calls.clear()
  jax.eval_shape(lambda p, s: model.apply(
      {"params": p, "batch_stats": s}, zeros, zeros, views, True,
      mutable=["batch_stats"]), params, variables["batch_stats"])
  return calls


def _count_port(monkeypatch, batch, h, w, channels, dtype):
  """The port's training forward on the ``meta`` device (shapes only):
  calls of ``ops/conv2d.py:conv2d_train``, whose stub returns an empty
  tensor of the output's shape."""
  calls = []

  def stub(x, weight, dilation=1, *, plain=False):
    calls.append(tuple(x.shape))
    return torch.empty((*x.shape[:3], weight.shape[0]), dtype=x.dtype,
                       device=x.device)

  monkeypatch.setattr(conv2d_ops, "conv2d_train", stub)
  model = tfusion.ModeFusion(MAX_DEPTH, channels, device="cpu").to("meta")
  model.device = torch.device("meta")
  tdt = TORCH_DTYPE[dtype] or torch.float32
  zeros = [torch.empty((batch, h, w, 1), dtype=tdt, device="meta")] * 6
  views = [torch.empty((batch, h, w, 3), dtype=tdt, device="meta")] * 4
  model.train()(zeros, zeros, views)
  return calls


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_training_routes_as_the_jax_package(monkeypatch, dtype):
  """At the test shape (batch 2, 128x64) the full-resolution level's convs
  with a Cin off 8 stay off the kernel, the others of that level take it
  (H a multiple of 128), the coarser levels do not; at ``chip_smoke.py``'s
  fusion training shape (batch 4, 1024x512, the full widths) every conv
  but the two 12-channel input convs takes it, in f32 and in bf16 (the
  JAX gate's memory budget at each itemsize admits them all): 36 a
  forward, ``chip_smoke.FUSION_TRAIN_K9``."""
  small_j = _count_jax(monkeypatch, B, H, W, SMALL, dtype)
  small_p = _count_port(monkeypatch, B, H, W, SMALL, dtype)
  assert small_p == small_j and 0 < len(small_p)
  assert all(s[1] == H for s in small_p)
  full = (4, 1024, 512, (32, 64, 128, 256), dtype)
  full_j = _count_jax(monkeypatch, *full)
  full_p = _count_port(monkeypatch, *full)
  assert full_p == full_j
  assert len(full_p) == chip_smoke.FUSION_TRAIN_K9 == 36
  assert chip_smoke.FUSION_TRAINS["fusion_train_b4"][:2] == (4, (1024, 512))
