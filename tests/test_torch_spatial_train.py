"""Stage-1 training over the ``spatial`` axis in mode_tpu_torch
(``training.make_disparity_train_step(..., mesh=make_mesh(data=D,
spatial=S))``), on the CPU: gloo ranks in processes of their own
(``parallel/launch.py:run_ranks``; their code is
``tests/torch_spatial_train_ranks.py``, which imports no JAX).

1. The collectives' backwards, at worlds 2 and 4: ``halo_concat``'s (each
   halo plane's gradient added to the neighbour's edge row) and
   ``gather_rows``'s (the gradient summed over the group, the rank's rows
   kept), against autograd through slices of the whole tensor, at 1e-6.
2. Each training conv on every shard of a 2-way and a 4-way split: the
   kernels' Functions on the rows (``conv3d_train``/``deconv3d_train`` with
   ``mesh``: stride 1, stride 2, the deconv) and the library convs on the
   haloed rows (``shard_ops``: the same three, the stride-1 one as a Cout-1
   head). Its output rows, its grad-input rows and its grad-weight summed
   over the shards against the unsharded ``conv3d_train``/
   ``deconv3d_train``, each within 1e-6 of its norm (the grad-weight sums
   ~10^3 products a tap, which two summation orders put ~1e-5 apart
   elementwise).
3. The reductions on ``(1, 2)``, ``(1, 4)`` and ``(2, 2)`` meshes: the 3-D
   stack's BN (over the whole mesh) against one BN over the whole batch:
   output and input gradient rows at 1e-5 / 1e-4, the parameters' gradients
   summed over the ranks at 1e-5, the running statistics at 1e-6; the
   feature extractor's BN (over the data group, every spatial rank on its
   data index's whole maps) the same way, its parameters' gradients ``S``
   times the whole batch's; both losses against the unsharded loss on the
   whole batch at 1e-6 relative, each rank's prediction gradient ``W = D x
   S`` times its share at 1e-5.
4. The training heads' row window (``models/disparity.py:_regress`` with
   ``rows``) against the rows of the whole head at 1e-6, forward and
   backward.
5. The step: the trained ``tests/data/trained_mirror.npz`` weights, 64x32,
   maxdisp 16, global batch 2 with NaN patches of different sizes on the
   two examples (``tests/test_torch_parallel.py``'s batch). On ``(1, 2)``
   and ``(2, 2)`` meshes against the JAX package's single-device
   ``make_disparity_train_step`` on the same global batch, at
   ``tests/test_torch_parallel.py``'s bars: the loss within 1e-5 relative,
   each gradient leaf within 1e-4 of its norm plus twice the port's own
   spread, and all of them within 1e-4 of their norm plus twice the
   spread's, the median leaf within 1e-5 (the spread: how far the
   one-process step at 2 CPU threads moves at 1 and 3 threads, with the
   batch's two examples swapped, and split over two data ranks, PR 14's
   path; some feature-extractor leaves move by more than 1e-4 of their
   norm with the thread count alone, ``tests/test_torch_train_step.py``,
   so the ranks run at the one-process step's 2 threads),
   the BN running statistics within 1e-5, Adam's update within 2 lr
   elementwise and all but 1% of the elements within 1e-6; against the
   port's one-process step at the same bars; every rank bit-equal to rank
   0 (parameters, gradients, buffers). The same ``(1, 2)`` step with the
   3-D training gates forced on (every 3-D conv on the kernels' Function
   over its rows, their plain versions here) at the same bars. The ERP
   model (32x64) on ``(1, 2)`` against its one-process step at the same
   bars (its own thread spread). ``remat_policy="full"`` on ``(1, 2)``
   against the default policy's ``(1, 2)`` step: loss and gradients bit
   for bit, BN statistics within 1e-6 relative (``tests/test_torch_
   remat.py``'s bars).
"""

import concurrent.futures

import jax
import numpy as np
import pytest
import torch

from mode_tpu import training as jtraining
from mode_tpu_torch import training as ttraining
from mode_tpu_torch.models import disparity as tdisp
from mode_tpu_torch.models.blocks import TorchBatchNorm
from mode_tpu_torch.ops import conv3d as C
from mode_tpu_torch.parallel.launch import run_ranks
from mode_tpu_torch.utils import losses
from mode_tpu_torch.utils.convert import grads_from_jax, load_npz
from tests import test_torch_train_step as train_step
from tests import torch_spatial_train_ranks as ranks
from tests.test_torch_parallel import _batch
from tests.test_torch_train_cli import _assert_state_matches

torch.set_num_threads(2)

TIMEOUT = 300                # seconds a run_ranks call may take
NPZ, MAXDISP = train_step.NPZ, train_step.MAXDISP
ERP_HW = (32, 64)
UNIT = 1e-6


def _t(a) -> torch.Tensor:
  return torch.from_numpy(np.ascontiguousarray(a))


def _assert_near(got, want, what, bar=UNIT):
  """``||got - want|| <= bar ||want||``."""
  err = float(np.linalg.norm(np.asarray(got) - want))
  norm = float(np.linalg.norm(want))
  assert err <= bar * norm, (what, err, norm)


# --- 1. the collectives' backwards -----------------------------------------

def _collective_inputs(spatial):
  rng = np.random.default_rng(spatial)
  x = rng.normal(size=(1, 2, 8, 3, 4)).astype(np.float32)
  n = x.shape[2] // spatial
  gh = rng.normal(size=(spatial, 1, 2, n + 2, 3, 4)).astype(np.float32)
  gg = rng.normal(size=(spatial,) + x.shape).astype(np.float32)
  return x, gh, gg


# the unit cases' meshes by world: the reductions run on each
UNIT_MESHES = {2: [(1, 2)], 4: [(1, 4), (2, 2)]}


@pytest.fixture(scope="module")
def units():
  """Every unit case, one ``run_ranks`` call a world."""
  inputs = {world: (_collective_inputs(world), _conv_cases(),
                    _reduction_inputs(), meshes)
            for world, meshes in UNIT_MESHES.items()}
  return inputs, {world: run_ranks(ranks.units, world, inputs[world],
                                   timeout=TIMEOUT, device="cpu", threads=1)
                  for world in UNIT_MESHES}


@pytest.mark.parametrize("spatial", sorted(UNIT_MESHES))
def test_halo_and_gather_backwards_are_their_transposes(units, spatial):
  """Rank r's gradient of its rows from ``sum(halo_concat(x_r) * gh[r])``
  summed over the ranks, and from ``sum(gather_rows(x_r) * gg[r])``, is
  the gradient of the same sums over slices of the whole tensor (zero
  planes past the ends); two collectives each, forward and backward."""
  x, gh, gg = units[0][spatial][0]
  outs = [out["collectives"] for out in units[1][spatial]]
  n = x.shape[2] // spatial
  xt = _t(x).requires_grad_(True)
  pad = torch.nn.functional.pad(xt, (0, 0, 0, 0, 1, 1))
  sum((pad[:, :, r * n:r * n + n + 2] * _t(gh[r])).sum()
      for r in range(spatial)).backward()
  halo = xt.grad.numpy()
  gather = gg.sum(0)
  for r, out in enumerate(outs):
    rows = slice(r * n, (r + 1) * n)
    np.testing.assert_allclose(out["halo"], halo[:, :, rows], rtol=UNIT,
                               atol=UNIT)
    np.testing.assert_allclose(out["gather"], gather[:, :, rows], rtol=UNIT,
                               atol=UNIT)
    assert out["collectives"] == 4


# --- 2. the training convs on every shard -----------------------------------

def _conv_cases():
  """name -> (x, weight, cotangent of the whole output, kind): NDHWC
  volumes whose H splits into even rows 4 ways, weights He-scaled."""
  rng = np.random.default_rng(1)

  def vol(*shape):
    return rng.normal(size=shape).astype(np.float32)

  def weight(cout, cin, transpose=False):
    shape = (cin, cout) if transpose else (cout, cin)
    return (rng.normal(size=shape + (3, 3, 3))
            * np.sqrt(2 / (27 * cin))).astype(np.float32)

  x, xd = vol(2, 4, 16, 6, 8), vol(2, 2, 8, 3, 8)
  cases = {}
  for lib in ("", "lib_"):
    cases[lib + "s1"] = (x, weight(8, 8), vol(2, 4, 16, 6, 8), lib + "s1")
    cases[lib + "s2"] = (x, weight(16, 8), vol(2, 2, 8, 3, 16), lib + "s2")
    cases[lib + "deconv"] = (xd, weight(8, 8, True), vol(2, 4, 16, 6, 8),
                             lib + "deconv")
  cases["lib_head"] = (x, weight(1, 8), vol(2, 4, 16, 6, 1), "lib_s1")
  return cases


CONV_CASES = ("s1", "s2", "deconv", "lib_s1", "lib_s2", "lib_deconv",
              "lib_head")


@pytest.mark.parametrize("spatial", sorted(UNIT_MESHES))
@pytest.mark.parametrize("name", CONV_CASES)
def test_sharded_training_conv_is_the_whole_conv(units, name, spatial):
  """On every shard: the output rows are the rows of the whole volume's
  conv, the gradient of the shard's rows of ``x`` the rows of the whole
  one's, and the weight's gradient summed over the shards the whole one's;
  two collectives a conv (the halo planes of ``x``, then of the
  cotangent)."""
  cases = units[0][spatial][1]
  outs = {spatial: [out["convs"] for out in units[1][spatial]]}
  x, w, g, kind = cases[name]
  xt, wt = _t(x).requires_grad_(True), _t(w).requires_grad_(True)
  if kind.endswith("deconv"):
    y = C.deconv3d_train(xt, wt)
  else:
    y = C.conv3d_train(xt, wt, 2 if kind.endswith("s2") else 1)
  (y * _t(g)).sum().backward()
  n_in = x.shape[2] // spatial
  n_out = y.shape[2] // spatial
  _assert_near(sum(out[name]["dw"] for out in outs[spatial]),
               wt.grad.numpy(), "dw")
  for r, out in enumerate(outs[spatial]):
    got = out[name]
    _assert_near(got["y"],
                 y.detach().numpy()[:, :, r * n_out:(r + 1) * n_out], "y")
    _assert_near(got["dx"], xt.grad.numpy()[:, :, r * n_in:(r + 1) * n_in],
                 "dx")
    assert out["collectives"] == 2 * len(CONV_CASES)


# --- 3. the BatchNorm layers and the losses ---------------------------------

def _reduction_inputs():
  rng = np.random.default_rng(2)
  x = (rng.normal(size=(2, 6, 3, 8, 5)) * 2 + 1).astype(np.float32)
  g = rng.normal(size=x.shape).astype(np.float32)
  preds = rng.uniform(0, 16, (3, 2, 8, 6)).astype(np.float32)
  gt = rng.uniform(0, 16, (2, 8, 6)).astype(np.float32)
  mask = np.ones(gt.shape, bool)
  mask[0, :5] = False                   # the ranks keep unequal counts
  mask[1, 6:, 2:] = False
  return x, g, preds, gt, mask


MESHES = [m for meshes in UNIT_MESHES.values() for m in meshes]


def _bn(x, g):
  bn = TorchBatchNorm(x.shape[1]).train()
  with torch.no_grad():
    bn.weight.uniform_(0.5, 1.5, generator=torch.Generator().manual_seed(1))
    bn.bias.uniform_(-0.5, 0.5, generator=torch.Generator().manual_seed(2))
  xt = _t(x).requires_grad_(True)
  y = bn(xt)
  (y * _t(g)).sum().backward()
  return bn, y.detach().numpy(), xt.grad.numpy()


@pytest.mark.parametrize("data,spatial", MESHES)
def test_batch_norms_use_the_global_batch(units, data, spatial):
  """The 3-D BN on a rank's rows of the batch and of H is one BN over the
  whole batch: its rows of the output and of the input's gradient, the
  parameters' gradients summed over the ranks, the running statistics.
  The feature extractor's BN (over the data group) on its data index's
  whole maps gives the whole batch's output and input gradient rows; its
  parameters' gradients, one whole batch's on every spatial rank, sum to
  ``spatial`` times the whole batch's."""
  x, g = _reduction_inputs()[:2]
  outs = [out["reductions"][(data, spatial)]
          for out in units[1][data * spatial]]
  b = x.shape[0] // data
  for name, xs, gs, h_axis, copies in (
      ("bn3d", x, g, 3, 1), ("bn2d", x[:, :, 0], g[:, :, 0], None,
                             spatial)):
    bn, y, dx = _bn(xs, gs)
    for r, out in enumerate(outs):
      got = out[name]
      idx = [slice(r // spatial * b, (r // spatial + 1) * b)]
      if h_axis is not None:
        n = xs.shape[h_axis] // spatial
        idx += [slice(None)] * (h_axis - 1) + [
            slice(r % spatial * n, (r % spatial + 1) * n)]
      np.testing.assert_allclose(got["y"], y[tuple(idx)], rtol=1e-5,
                                 atol=1e-5, err_msg=name)
      np.testing.assert_allclose(got["dx"], dx[tuple(idx)], rtol=1e-4,
                                 atol=1e-5, err_msg=name)
      np.testing.assert_allclose(got["dweight"],
                                 copies * bn.weight.grad.numpy(), rtol=1e-5,
                                 atol=1e-5, err_msg=name)
      np.testing.assert_allclose(got["dbias"], copies * bn.bias.grad.numpy(),
                                 rtol=1e-5, atol=1e-5, err_msg=name)
      for key in ("running_mean", "running_var"):
        np.testing.assert_allclose(got[key], getattr(bn, key).numpy(),
                                   rtol=UNIT, atol=UNIT, err_msg=name)


@pytest.mark.parametrize("data,spatial", MESHES)
def test_losses_are_global_masked_means(units, data, spatial):
  """The deep-supervision loss on a rank's rows of the batch and of H is
  the loss of the whole batch, on every rank; each rank's gradient of its
  prediction rows is ``W`` times that share of the whole loss's, which
  the gradient average over the mesh divides out."""
  preds, gt, mask = _reduction_inputs()[2:]
  outs = [out["reductions"][(data, spatial)]
          for out in units[1][data * spatial]]
  pt = _t(preds).requires_grad_(True)
  value = losses.disparity_deep_supervision(tuple(pt), _t(gt), _t(mask))
  value.backward()
  grad = pt.grad.numpy()
  b, n = gt.shape[0] // data, gt.shape[1] // spatial
  for r, out in enumerate(outs):
    got = out["loss"]
    assert abs(float(got["value"]) - value.item()) <= UNIT * value.item()
    assert float(got["value"]) == float(outs[0]["loss"]["value"])
    rows = (slice(None), slice(r // spatial * b, (r // spatial + 1) * b),
            slice(r % spatial * n, (r % spatial + 1) * n))
    np.testing.assert_allclose(got["grad"] / (data * spatial), grad[rows],
                               rtol=1e-5, atol=1e-8)


# --- 4. the training heads' row window --------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_training_head_row_window_is_the_rows_of_the_whole_head(dtype):
  """``_regress`` on the whole quarter-resolution logits with ``rows`` is
  those rows of the whole head's prediction, and its gradient is the
  gradient of the same rows of the whole head (the casts of the bf16
  logits included)."""
  cost = (np.random.default_rng(3).normal(size=(2, 4, 8, 8)) * 2.0)
  h = w = 32
  g = np.random.default_rng(4).normal(size=(2, h, w)).astype(np.float32)
  whole_in = _t(cost).to(dtype).requires_grad_(True)
  whole = tdisp._regress(whole_in, 16, h, w)
  for rows in (slice(0, 8), slice(8, 16), slice(24, 32), slice(5, 8)):
    part_in = _t(cost).to(dtype).requires_grad_(True)
    part = tdisp._regress(part_in, 16, h, w, rows)
    torch.testing.assert_close(part, whole[:, rows], rtol=UNIT, atol=UNIT)
    (part * _t(g[:, rows])).sum().backward()
    ref_in = _t(cost).to(dtype).requires_grad_(True)
    (tdisp._regress(ref_in, 16, h, w)[:, rows] * _t(g[:, rows])).sum(
        ).backward()
    torch.testing.assert_close(part_in.grad, ref_in.grad, rtol=UNIT,
                               atol=UNIT)


# --- 5. the step --------------------------------------------------------------

def _jax_single_step():
  """The JAX package's single-device step on the global batch."""
  model, optimizer, state = train_step._jax_state()
  before = train_step._numpy(state.params)
  step = jtraining.make_disparity_train_step(model, optimizer)
  state, loss = step(state, *_batch())
  mu = state.opt_state.inner_state[0].mu
  return {"before": before, "after": train_step._numpy(state.params),
          "loss": float(loss),
          "grads": jax.tree_util.tree_map(lambda m: np.asarray(m) / 0.1, mu),
          "stats": train_step._numpy(state.batch_stats)}


@pytest.fixture(scope="module")
def jax_single(steps_started):
  """(The ranks of ``STEPS`` run meanwhile, in processes of their own.)"""
  return _jax_single_step()


def _one_process(batch, sphere_type="Cassini", threads=2):
  """The port's one-process step on ``batch``: the model after it, and its
  loss."""
  torch.set_num_threads(threads)
  try:
    model = load_npz(tdisp.ModeDisparity(MAXDISP, "Sphere", sphere_type,
                                         device="cpu"), NPZ)
    step = ttraining.make_disparity_train_step(
        model, ttraining.make_optimizer(model.parameters()))
    loss = float(step(*(_t(a) for a in batch)))
  finally:
    torch.set_num_threads(2)
  return model, loss


def _spread(batch, sphere_type="Cassini", others=()):
  """The one-process step at 2 CPU threads, and per leaf the largest
  distance of its gradient from it when only the order of the sums
  changes: at 1 and 3 threads, with the batch's two examples swapped, and
  in the gradients ``others`` (the data-parallel step of the same batch)."""
  model, loss = _one_process(batch, sphere_type)
  spread = dict.fromkeys((n for n, _ in model.named_parameters()), 0.0)
  swapped = tuple(a[::-1] for a in batch)
  variants = [{n: p.grad for n, p in _one_process(b, sphere_type,
                                                  threads)[0]
               .named_parameters()}
              for b, threads in ((batch, 1), (batch, 3), (swapped, 2))]
  for grads in [*variants, *others]:
    for name, p in model.named_parameters():
      spread[name] = max(spread[name], float(torch.linalg.vector_norm(
          torch.as_tensor(grads[name]) - p.grad)))
  return model, loss, spread


@pytest.fixture(scope="module")
def one_process(steps):
  return _spread(_batch(), others=[steps["2x1"][0]["grads"]])


def _erp_batch():
  left, right, gt = train_step._batch(0, *ERP_HW)
  gt[1, 20:30, 2:60] = np.nan
  return left, right, gt


# label: (data, spatial, sphere_type, remat_policy, 3-D gates forced on);
# "2x1", the data-parallel step, is a variant of the one-process step's
# summation order (``one_process``)
STEPS = {"1x2": (1, 2, "Cassini", "save_convs", False),
         "1x2_full": (1, 2, "Cassini", "full", False),
         "1x2_erp": (1, 2, "ERP", "save_convs", False),
         "2x1": (2, 1, "Cassini", "save_convs", False),
         "1x2_kernels": (1, 2, "Cassini", "save_convs", True),
         "2x2": (2, 2, "Cassini", "save_convs", False)}


def _run_steps():
  """Every step of ``STEPS``, one ``run_ranks`` call a world, each rank at
  the one-process step's 2 CPU threads."""
  out = {}
  for world in (2, 4):
    runs = {label: (_erp_batch() if sphere_type == "ERP" else _batch(),
                    data, spatial, sphere_type, policy, kernels)
            for label, (data, spatial, sphere_type, policy, kernels)
            in STEPS.items() if data * spatial == world}
    done = run_ranks(ranks.train_steps, world, (NPZ, MAXDISP, runs),
                     timeout=TIMEOUT, device="cpu", threads=2)
    out.update({label: [rank[label] for rank in done] for label in runs})
  return out


@pytest.fixture(scope="module")
def steps_started():
  """:func:`_run_steps` started in a thread of this process."""
  pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
  yield pool.submit(_run_steps)
  pool.shutdown()


@pytest.fixture(scope="module")
def steps(steps_started):
  return steps_started.result()


def _as_model(rank_out, sphere_type="Cassini"):
  """A model holding a rank's state, its gradients on the parameters."""
  model = tdisp.ModeDisparity(MAXDISP, "Sphere", sphere_type, device="cpu")
  model.load_state_dict({k: torch.from_numpy(v)
                         for k, v in rank_out["state"].items()})
  for name, p in model.named_parameters():
    p.grad = torch.from_numpy(rank_out["grads"][name])
  return model


def _assert_ranks_agree(outs, data, spatial):
  assert [o["place"] for o in outs] == [(r // spatial, r % spatial)
                                        for r in range(data * spatial)]
  for out in outs:
    assert out["same"], "the ranks parted"
    assert out["loss"] == outs[0]["loss"]


def _assert_grads_near(got: dict, want: dict, spread: dict):
  """Each leaf within 1e-4 of its norm plus twice its spread, all of them
  within 1e-4 of their norm plus twice the spread's, the median leaf
  within 1e-5 of its norm."""
  assert set(got) == set(want)
  rel, err2, norm2, spread2 = [], 0.0, 0.0, 0.0
  for name, g in got.items():
    err = float(torch.linalg.vector_norm(g - want[name]))
    norm = float(torch.linalg.vector_norm(want[name]))
    assert err <= 1e-4 * norm + 2 * spread[name], (name, err, norm,
                                                   spread[name])
    rel.append(err / norm)
    err2, norm2, spread2 = (err2 + err**2, norm2 + norm**2,
                            spread2 + spread[name]**2)
  assert err2**0.5 <= 1e-4 * norm2**0.5 + 2 * spread2**0.5
  assert float(np.median(rel)) <= 1e-5


def _grads(model) -> dict:
  return {n: p.grad for n, p in model.named_parameters()}


def _assert_matches_one_process(model, loss, ref, ref_loss, spread):
  """The port's bars against its own one-process step: the loss within
  1e-5 relative, the gradients as :func:`_assert_grads_near`, the BN
  running statistics within 1e-5 relative of their norm."""
  assert abs(loss - ref_loss) <= 1e-5 * abs(ref_loss), (loss, ref_loss)
  _assert_grads_near(_grads(model), _grads(ref), spread)
  state = ref.state_dict()
  for key, value in model.state_dict().items():
    if key.endswith(("running_mean", "running_var")):
      err = float(torch.linalg.vector_norm(value - state[key]))
      assert err <= 1e-5 * float(torch.linalg.vector_norm(state[key])), key


@pytest.mark.parametrize("label", ["1x2", "2x2"])
def test_step_matches_the_jax_single_device_step(jax_single, one_process,
                                                 steps, label):
  """A ``(D, S)`` step on the global batch is the single-device step on
  that batch: the JAX package's and the port's one process, at the bars of
  the module docstring; every rank ends bit-equal."""
  data, spatial = STEPS[label][:2]
  outs = steps[label]
  _assert_ranks_agree(outs, data, spatial)
  model = _as_model(outs[0])
  ref, ref_loss, spread = one_process
  train_step._assert_loss_matches(jax_single, (model, outs[0]["loss"]))
  _assert_grads_near(_grads(model), grads_from_jax(jax_single["grads"]),
                     spread)
  train_step._assert_bn_statistics_match(jax_single, (model, None))
  before = grads_from_jax(jax_single["before"])
  after = grads_from_jax(jax_single["after"])
  _assert_state_matches({n: p.detach() for n, p in model.named_parameters()},
                        after, before, 1e-3, 1e-6)
  _assert_matches_one_process(model, outs[0]["loss"], ref, ref_loss, spread)


def test_step_on_the_kernels_functions_matches_one_process(one_process,
                                                           steps):
  """With the 3-D training gates forced on, every 3-D conv of a ``(1,
  2)`` step runs the kernels' Function on its rows (the plain versions
  here): the same step at the same bars."""
  outs = steps["1x2_kernels"]
  _assert_ranks_agree(outs, 1, 2)
  ref, ref_loss, spread = one_process
  _assert_matches_one_process(_as_model(outs[0]), outs[0]["loss"], ref,
                              ref_loss, spread)


def test_erp_step_matches_one_process(steps):
  outs = steps["1x2_erp"]
  _assert_ranks_agree(outs, 1, 2)
  ref, ref_loss, spread = _spread(_erp_batch(), "ERP")
  _assert_matches_one_process(_as_model(outs[0], "ERP"), outs[0]["loss"],
                              ref, ref_loss, spread)


def test_full_remat_step_is_the_default_policy_step(steps):
  """``"full"`` reruns every conv of the feature extractor and the
  hourglasses, their halo exchanges and BN reductions with them: the same
  loss and gradients bit for bit, the BN statistics within 1e-6, and the
  same collectives (a rerun exchanges its halo planes and reduces its BN
  statistics again under either policy)."""
  full, default = steps["1x2_full"], steps["1x2"]
  _assert_ranks_agree(full, 1, 2)
  assert full[0]["loss"] == default[0]["loss"]
  for name, g in default[0]["grads"].items():
    np.testing.assert_array_equal(full[0]["grads"][name], g, err_msg=name)
  for key, value in default[0]["state"].items():
    if key.endswith(("running_mean", "running_var")):
      np.testing.assert_allclose(full[0]["state"][key], value, rtol=UNIT,
                                 atol=UNIT, err_msg=key)
  assert full[0]["collectives"] == default[0]["collectives"]


def test_chip_smoke_expects_the_step_collectives(steps):
  """``chip_smoke.py``'s ``sp_train_gloo_2`` expects
  ``SP_TRAIN_COLLECTIVES`` collectives a rank and step on a ``(1, 2)``
  mesh, whatever the shape, the layout, the remat policy and the 3-D convs'
  route: the count the ranks here make. Its halo launches are a step's 3-D
  kernel launches (``train_expect``), every one on its rows."""
  import chip_smoke
  for label in ("1x2", "1x2_full", "1x2_erp", "1x2_kernels"):
    for out in steps[label]:
      assert out["collectives"] == chip_smoke.SP_TRAIN_COLLECTIVES, label
  assert chip_smoke.SP_TRAIN_HALO == {
      k: n for k, n in chip_smoke.train_expect("train_b2").items()
      if k.startswith(("conv3d", "deconv3d"))}
