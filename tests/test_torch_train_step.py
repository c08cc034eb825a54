"""The stage-1 training step of mode_tpu_torch against the JAX package's,
f32 on the CPU, and which convs take the port's kernels in training.

One step of ``mode_tpu_torch.training.make_disparity_train_step`` against
``mode_tpu.training.make_disparity_train_step`` on the same Sphere model
(``tests/data/trained_mirror.npz`` on both sides), the same uint8 pair and
the same ground truth with a NaN patch, 64x32, maxdisp 16, batch 2. The JAX
step runs its XLA path on the CPU (its Pallas gates are off there), the
plain reference of its kernels; it is built and run once per module.

Bars: the loss within 1e-5 relative; the BN running statistics within
1e-5; Adam on JAX's own gradients: fed to the port's optimizer, the update
must equal optax's within 1e-6 (on a first step Adam maps every gradient to
about +-lr, so two independent steps would part on the sign of gradients
that are noise). The gradients: all of them within 1e-4 of JAX's in
relative norm, and each leaf within ||port - jax|| <= 1e-4 ||jax|| plus
twice the leaf's own f32 spread, how far the port's step moves it when only
the order of its sums changes (other CPU thread counts). That spread is
real: the shift of a BN whose output feeds a batch-normalised conv has a
gradient that is mostly cancelled by the next BN's mean, and at this
operating point a thread count alone moves some such leaves of the port's
own step by more than 1e-4 of their norm, while the median leaf moves by
far less.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mode_tpu import training as jtraining
from mode_tpu.models import disparity as jdisp
from mode_tpu.ops.pallas import conv2d_kernel as c2k
from mode_tpu.ops.pallas import conv3d_kernel as c3k
from mode_tpu.utils.torch_convert import convert_state_dict
from mode_tpu_torch import training as ttraining
from mode_tpu_torch.models import disparity as tdisp
from mode_tpu_torch.ops import conv2d as conv2d_ops
from mode_tpu_torch.ops import conv3d as conv3d_ops
from mode_tpu_torch.ops import sphere_conv as sphere_ops
from mode_tpu_torch.utils.convert import grads_from_jax, load_npz
from tests.background import started
from tests.trained_mirror import get_trained_state_dict

jsc = importlib.import_module("mode_tpu.ops.sphere_conv")
torch.set_num_threads(2)

NPZ = "tests/data/trained_mirror.npz"
H, W, MAXDISP, BATCH = 64, 32, 16, 2


def _batch(seed=0, h=H, w=W):
  """A uint8 pair (the right view is the left rolled by 4 or 8 columns)
  and the ground truth, with a NaN patch where there is none."""
  rng = np.random.default_rng(seed)
  fine = rng.normal(size=(BATCH, h // 2, w // 2, 3))
  coarse = rng.normal(size=(BATCH, h // 8, w // 8, 3))
  tex = (np.repeat(np.repeat(fine, 2, 1), 2, 2)
         + 0.5 * np.repeat(np.repeat(coarse, 8, 1), 8, 2))
  left = np.clip(128 + 40 * tex, 0, 255).astype(np.uint8)
  disps = (4, 8)
  right = np.stack([np.roll(left[b], -disps[b], axis=1)
                    for b in range(BATCH)])
  gt = np.stack([np.full((h, w), float(d)) for d in disps])
  gt = (gt + rng.uniform(-0.5, 0.5, size=gt.shape)).astype(np.float32)
  gt[:, 10:20, 5:12] = np.nan
  return left, right, gt


def _jax_state(sphere_type="Cassini", h=H, w=W):
  model = jdisp.ModeDisparity(maxdisp=MAXDISP, conv="Sphere",
                              sphere_type=sphere_type, out_conf=False)
  left = jnp.zeros((1, h, w, 3), jnp.float32)
  variables = jax.eval_shape(lambda: model.init(
      jax.random.PRNGKey(0), left, left, train=False))
  variables = jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype),
                                     variables)
  variables = convert_state_dict(get_trained_state_dict(), variables)
  optimizer = jtraining.make_optimizer()
  state = jtraining.TrainState(
      params=variables["params"], batch_stats=variables["batch_stats"],
      opt_state=optimizer.init(variables["params"]),
      step=jnp.zeros((), jnp.int32))
  return model, optimizer, state


def _numpy(tree):
  return jax.tree_util.tree_map(lambda a: np.array(a, copy=True), tree)


def _jax_step(sphere_type="Cassini", h=H, w=W, x64=False):
  """The JAX step on the batch: the parameters before and after, its loss,
  its gradients (from optax's first moment, mu = (1 - b1) * g after one
  step) and its BN statistics after. With ``x64`` the step runs in f64
  under ``jax.enable_x64``: the parameters and statistics cast up and
  ``compute_dtype=float64``."""
  with jax.enable_x64(x64):
    return _run_jax_step(sphere_type, h, w, jnp.float64 if x64 else None)


def _run_jax_step(sphere_type, h, w, compute_dtype):
  model, optimizer, state = _jax_state(sphere_type, h, w)
  if compute_dtype is not None:
    up = functools.partial(jax.tree_util.tree_map,
                           lambda a: jnp.asarray(a, compute_dtype))
    state = jtraining.TrainState(
        params=up(state.params), batch_stats=up(state.batch_stats),
        opt_state=optimizer.init(up(state.params)), step=state.step)
  before = _numpy(state.params)
  step = jtraining.make_disparity_train_step(model, optimizer,
                                             compute_dtype=compute_dtype)
  left, right, gt = _batch(0, h, w)
  state, loss = step(state, jnp.asarray(left), jnp.asarray(right),
                     jnp.asarray(gt, compute_dtype or jnp.float32))
  mu = state.opt_state.inner_state[0].mu
  return {"before": before, "after": _numpy(state.params),
          "loss": float(loss),
          "grads": jax.tree_util.tree_map(lambda m: np.asarray(m) / 0.1, mu),
          "stats": _numpy(state.batch_stats)}


@pytest.fixture(scope="module")
def jax_step_started():
  return started(_jax_step)


@pytest.fixture(scope="module")
def jax_step(jax_step_started, port_step, port_spread):
  """(The port's step and its spread are computed while the JAX step
  compiles.)"""
  return jax_step_started.result()


def _port_run(sphere_type="Cassini", h=H, w=W, compute_dtype=None,
              optimizer_out=None):
  """One port step; ``optimizer_out`` (a list) receives the optimizer."""
  model = load_npz(tdisp.ModeDisparity(MAXDISP, "Sphere", sphere_type,
                                       device="cpu"), NPZ)
  optimizer = ttraining.make_optimizer(model.parameters())
  step = ttraining.make_disparity_train_step(model, optimizer,
                                             compute_dtype=compute_dtype)
  left, right, gt = _batch(0, h, w)
  loss = step(torch.from_numpy(left), torch.from_numpy(right),
              torch.from_numpy(gt))
  if optimizer_out is not None:
    optimizer_out.append(optimizer)
  return model, float(loss)


@pytest.fixture(scope="module")
def port_step():
  return _port_run()


def _port_spread(port_step, *geometry):
  """Per leaf, the largest distance of the port's gradient at 1 and 3 CPU
  threads from the one at 2 (the other fixtures' count)."""
  model, _ = port_step
  spread = dict.fromkeys((n for n, _ in model.named_parameters()), 0.0)
  try:
    for threads in (1, 3):
      torch.set_num_threads(threads)
      other, _ = _port_run(*geometry)
      for (name, p), (_, q) in zip(model.named_parameters(),
                                   other.named_parameters()):
        spread[name] = max(spread[name],
                           float(torch.linalg.vector_norm(q.grad - p.grad)))
  finally:
    torch.set_num_threads(2)
  return spread


@pytest.fixture(scope="module")
def port_spread(port_step):
  return _port_spread(port_step)


def _assert_loss_matches(jax_step, port_step):
  _, loss = port_step
  assert np.isfinite(loss) and loss > 0
  assert abs(loss - jax_step["loss"]) <= 1e-5 * abs(jax_step["loss"]), (
      loss, jax_step["loss"])


def test_loss_matches_jax(jax_step, port_step):
  _assert_loss_matches(jax_step, port_step)


def _assert_gradients_match(jax_step, port_step, port_spread):
  model, _ = port_step
  want = grads_from_jax(jax_step["grads"])
  got = {name: p.grad for name, p in model.named_parameters()}
  assert set(got) == set(want)
  rel, total_err, total = [], 0.0, 0.0
  for name, g in got.items():
    ref = want[name]
    assert g is not None and g.shape == ref.shape, name
    err = float(torch.linalg.vector_norm(g - ref))
    norm = float(torch.linalg.vector_norm(ref))
    assert norm > 0, name
    rel.append(err / norm)
    total_err, total = total_err + err**2, total + norm**2
    assert err <= 1e-4 * norm + 2 * port_spread[name], (
        name, err, norm, port_spread[name])
  assert total_err**0.5 <= 1e-4 * total**0.5
  assert float(np.median(rel)) <= 1e-5
  assert max(rel) > 0                # the two sides computed independently


def test_gradients_match_jax(jax_step, port_step, port_spread):
  _assert_gradients_match(jax_step, port_step, port_spread)


def _assert_bn_statistics_match(jax_step, port_step):
  model, _ = port_step
  state = model.state_dict()
  with np.load(NPZ) as z:
    tracked = {k: int(z[k]) for k in z.files
               if k.endswith("num_batches_tracked")}
  n = 0
  for path, value in jax.tree_util.tree_leaves_with_path(jax_step["stats"]):
    keys = [p.key for p in path]
    name = ".".join(keys[:-1]) + (".running_mean" if keys[-1] == "mean"
                                  else ".running_var")
    np.testing.assert_allclose(state[name].numpy(), value, rtol=1e-5,
                               atol=1e-5, err_msg=name)
    key = name.rsplit(".", 1)[0] + ".num_batches_tracked"
    passes = 2 if key.startswith("feature_extraction.") else 1  # two views
    assert int(state[key]) == tracked[key] + passes, key
    n += 1
  assert n == 2 * sum(1 for k in state if k.endswith("running_mean"))


def test_bn_statistics_match_jax(jax_step, port_step):
  _assert_bn_statistics_match(jax_step, port_step)


def test_adam_update_matches_optax(jax_step):
  """JAX's gradients through the port's optimizer give optax's update."""
  model = load_npz(tdisp.ModeDisparity(MAXDISP, device="cpu"), NPZ)
  optimizer = ttraining.make_optimizer(model.parameters())
  grads = grads_from_jax(jax_step["grads"])
  before = {n: p.detach().clone() for n, p in model.named_parameters()}
  for name, p in model.named_parameters():
    p.grad = grads[name].clone()
  optimizer.step()
  want_before = grads_from_jax(jax_step["before"])
  want_after = grads_from_jax(jax_step["after"])
  for name, p in model.named_parameters():
    torch.testing.assert_close(before[name], want_before[name], rtol=0,
                               atol=0)
    got = p.detach() - before[name]
    want = want_after[name] - want_before[name]
    assert float((got - want).abs().max()) <= 1e-6, name


def test_learning_rate_schedule():
  assert ttraining.learning_rate(45) == 1e-3
  assert ttraining.learning_rate(46) == pytest.approx(1e-4)
  model = tdisp.ModeDisparity(MAXDISP, device="cpu")
  optimizer = ttraining.make_optimizer(model.parameters())
  ttraining.set_learning_rate(optimizer, 1e-4)
  assert all(g["lr"] == 1e-4 for g in optimizer.param_groups)


def test_normalize_matches_jax():
  x = np.random.default_rng(1).integers(0, 256, (2, 4, 5, 3), np.uint8)
  got = ttraining.normalize_rgb_on_device(torch.from_numpy(x))
  want = np.asarray(jtraining.normalize_rgb_on_device(jnp.asarray(x)))
  np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
  f = torch.ones(2)
  assert ttraining.normalize_rgb_on_device(f) is f


# --- which convs take the kernels in training --------------------------------

# per training forward of one pair, by kernel family
FAMILIES = ("conv3d_s1", "conv3d_s2", "deconv3d", "conv2d", "sphere")


def _count_jax(monkeypatch, batch, h, w, maxdisp, sphere_type="Cassini",
               dtype=None):
  """Trace the JAX model's training forward (``jax.eval_shape``) with its
  Pallas gates on, and count the calls of its Pallas custom VJPs; stubs
  return zeros of the right shape, so no kernel is traced. The strided
  gates are asked at the bf16 itemsize, at which the stride-1 gate always
  sizes its blocks (``band_pallas_ok``'s default): so no VMEM budget that
  only f32 exceeds enters, as the port leaves the TPU's memory budgets
  out. ``dtype`` (``jnp.bfloat16``) traces the mixed-precision forward:
  the inputs and the conv kernels cast, as the JAX step casts them."""
  model = jdisp.ModeDisparity(maxdisp=maxdisp, sphere_type=sphere_type,
                              remat=False)
  left = jnp.zeros((batch, h, w, 3), dtype or jnp.float32)
  variables = jax.eval_shape(lambda: model.init(
      jax.random.PRNGKey(0), left, left, train=False))
  if dtype is not None:
    variables = {**variables, "params": jax.eval_shape(
        lambda p: jtraining.cast_conv_params(p, dtype),
        variables["params"])}
  calls = dict.fromkeys(FAMILIES, 0)

  def stub(family, shape_fn):
    def fn(*args):
      calls[family] += 1
      return jnp.zeros(shape_fn(*args), args[0].dtype)
    return fn

  monkeypatch.setattr(c3k, "_CONV3D_MODE", "on")
  monkeypatch.setattr(jsc, "_PALLAS_MODE", "on")
  for name in ("train_s2_eligible", "train_deconv_eligible"):
    monkeypatch.setattr(c3k, name, lambda x, c, itemsize=2, gate=getattr(
        c3k, name): gate(x, c, 2))
  monkeypatch.setattr(c3k, "conv3d_ndhwc_fast", stub(
      "conv3d_s1", lambda x, k: (*x.shape[:4], k.shape[-1])))
  monkeypatch.setattr(c3k, "conv3d_s2_fast", stub(
      "conv3d_s2", lambda x, k: (x.shape[0], *[n // 2 for n in x.shape[1:4]],
                                 k.shape[-1])))
  monkeypatch.setattr(c3k, "convtranspose3d_fast", stub(
      "deconv3d", lambda x, k: (x.shape[0], *[2 * n for n in x.shape[1:4]],
                                k.shape[3])))
  monkeypatch.setattr(c2k, "conv2d_3x3_fast_train", stub(
      "conv2d", lambda x, k, g, d: (*x.shape[:3], k.shape[-1])))
  monkeypatch.setattr(jsc, "_sphere_conv_fast", stub(
      "sphere", lambda x, k, s: (*x.shape[:3], k.shape[-1])))
  jax.eval_shape(lambda v: model.apply(v, left, left, train=True,
                                       mutable=["batch_stats"]), variables)
  return calls


def _count_port(monkeypatch, batch, h, w, maxdisp, sphere_type="Cassini",
                dtype=torch.float32):
  """The port's training forward, as :func:`_count_jax` traces the JAX
  model's: the calls of the kernels' Functions counted, each replaced by
  zeros of the shape its plain version gives on meta tensors, so no
  eligible conv computes."""
  calls = dict.fromkeys(FAMILIES, 0)

  def counted(family, fn):
    def wrapper(*args, **kwargs):
      calls[family] += 1
      meta = [a.to("meta") if isinstance(a, torch.Tensor) else a
              for a in args]
      out = fn(*meta, **{**kwargs, "plain": True})
      return torch.zeros(out.shape, dtype=out.dtype)
    return wrapper

  conv3d_train = conv3d_ops.conv3d_train
  monkeypatch.setattr(conv3d_ops, "conv3d_train", lambda x, wt, s, **kw: (
      counted("conv3d_s1" if s == 1 else "conv3d_s2", conv3d_train)(
          x, wt, s, **kw)))
  monkeypatch.setattr(conv3d_ops, "deconv3d_train", counted(
      "deconv3d", conv3d_ops.deconv3d_train))
  monkeypatch.setattr(conv2d_ops, "conv2d_train", counted(
      "conv2d", conv2d_ops.conv2d_train))
  monkeypatch.setattr(sphere_ops, "sphere_conv_train", counted(
      "sphere", sphere_ops.sphere_conv_train))
  model = tdisp.ModeDisparity(maxdisp, "Sphere", sphere_type,
                              device="cpu").train()
  left = torch.zeros((batch, h, w, 3), dtype=dtype)
  with torch.no_grad():
    model(left, left)
  return calls


@pytest.mark.parametrize("batch,want", [
    # 512x256: the smallest Cassini size at which every family has a lane
    # axis somewhere. batch 2: the 1/4-level stride-1 convs (dres 4,
    # classif 3), conv1 of each hourglass (its grad-input deconv folds the
    # 1/8 level), conv6; every stride-1 3x3 FE conv (32 per view) and the
    # 16 sphere convs per view.
    (2, {"conv3d_s1": 7, "conv3d_s2": 3, "deconv3d": 3, "conv2d": 64,
         "sphere": 32}),
    # batch 1: the stride-1 3-D and the 2-D convs need batch >= 2; the
    # strided convs and the sphere conv have no batch gate
    (1, {"conv3d_s1": 0, "conv3d_s2": 3, "deconv3d": 3, "conv2d": 0,
         "sphere": 32}),
])
def test_training_routes_as_the_jax_package(monkeypatch, batch, want):
  """Which convs of a training forward take the kernels' Functions, against
  the JAX package's Pallas training gates traced on the same shapes."""
  jax_calls = _count_jax(monkeypatch, batch, 512, 256, 16)
  port_calls = _count_port(monkeypatch, batch, 512, 256, 16)
  assert jax_calls == want
  assert port_calls == want


def test_no_kernel_at_the_small_test_shape(monkeypatch):
  """At 64x32 no axis reaches the TPU kernels' 128 lanes, so the JAX
  package trains every conv on XLA and the port on PyTorch autograd: the
  train-step comparison above holds the layers' training semantics, and
  the Functions are held in tests/test_torch_autograd.py."""
  assert _count_jax(monkeypatch, 2, H, W, MAXDISP) == dict.fromkeys(
      FAMILIES, 0)
  assert _count_port(monkeypatch, 2, H, W, MAXDISP) == dict.fromkeys(
      FAMILIES, 0)
