"""Data-parallel training in mode_tpu_torch (``parallel/mesh.py``, the
steps' ``mesh=``) against the JAX package's ``data=2`` mesh steps, on the
CPU: two ranks in processes of their own (``parallel/launch.py:run_ranks``,
gloo), each on its half of the global batch, against
``mode_tpu.training.make_disparity_train_step(model, optimizer,
make_mesh(data=2))`` (and ``make_fusion_train_step``) on two of the
conftest's eight virtual CPU devices, the batch sharded over ``data``.

The steps themselves are held in ``tests/test_torch_parallel_steps.py``,
with this file's helpers. The stage-1 step: the trained ``tests/data/trained_mirror.npz`` weights,
64x32, maxdisp 16, global batch 2 (one pair a rank), the ground truth's NaN
patches of different sizes on the two ranks. The fusion step:
``ModeFusion`` with seeded weights and ``TRAIN_HEAD_SCALE``, 128x64, global
batch 2, float inputs. The bars are those of the single-device tests
(``tests/test_torch_train_step.py``, ``tests/test_torch_fusion_train.py``):
the loss within 1e-5 relative, each gradient leaf within 1e-4 of its norm
plus twice the port's own spread over CPU thread counts, the BN running
statistics within 1e-5; Adam's update each element within 2 lr of JAX's and
all but 1% within 1e-6 (``tests/test_torch_train_cli.py``'s bars; Adam's
first step maps a gradient that is noise to +-lr). Both ranks must end the
step with bit-equal parameters, gradients and buffers. The JAX steps are
built and run once per module; each ``run_ranks`` call has its own timeout,
so a hang fails its test.

Unit cases: the global-statistics BN against one BN over the whole batch,
forward and backward; both losses against the global masked means with
unequal valid counts (each rank's gradient is W times its share, which the
gradient average divides out); ``shard_batch``'s rows against the shards of
``P("data")``; the mesh's refusals.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from mode_tpu import training as jtraining
from mode_tpu.models import fusion as jfusion
from mode_tpu.parallel import make_mesh as jax_mesh
from mode_tpu.utils import losses as jlosses
from mode_tpu_torch.models import fusion as tfusion
from mode_tpu_torch.models.blocks import TorchBatchNorm
from mode_tpu_torch.models.disparity import ModeDisparity
from mode_tpu_torch.parallel.launch import run_ranks
from mode_tpu_torch.parallel.mesh import make_mesh
from mode_tpu_torch.utils.convert import grads_from_jax
from tests import test_torch_fusion_train as fusion_train
from tests import test_torch_train_step as train_step
from tests import torch_parallel_ranks as ranks
from tests.port_weights import carry

torch.set_num_threads(2)

WORLD = 2
TIMEOUT = 300                # seconds a run_ranks call may take
NOISE, NORM_BAR = 0.1, 0.05  # the fusion leaves' norm check
NPZ, MAXDISP = train_step.NPZ, train_step.MAXDISP


def _batch():
  """``test_torch_train_step``'s pair and ground truth, with a second NaN
  patch on the second example only: the two ranks' masks differ in size."""
  left, right, gt = train_step._batch(0)
  gt[1, 40:60, 2:30] = np.nan
  return left, right, gt


def _jax_stage1_step():
  model, optimizer, state = train_step._jax_state()
  mesh = jax_mesh(data=WORLD)
  before = train_step._numpy(state.params)
  step = jtraining.make_disparity_train_step(model, optimizer, mesh)
  batch = jtraining.shard_batch(mesh, _batch())
  state, loss = step(state, *batch)
  mu = state.opt_state.inner_state[0].mu
  return {"before": before, "after": train_step._numpy(state.params),
          "loss": float(loss),
          "grads": jax.tree_util.tree_map(lambda m: np.asarray(m) / 0.1, mu),
          "stats": train_step._numpy(state.batch_stats)}


def _as_model(rank_out) -> ModeDisparity:
  """A model holding a rank's state, its gradients on the parameters."""
  model = ModeDisparity(MAXDISP, device="cpu")
  model.load_state_dict({k: torch.from_numpy(v)
                         for k, v in rank_out["state"].items()})
  for name, p in model.named_parameters():
    p.grad = torch.from_numpy(rank_out["grads"][name])
  return model


def test_world_of_one_is_the_single_card_step():
  """At one rank the mesh step is the single-card step, bit for bit:
  without a process group (a process that torchrun did not start) and
  with one, whose gradient all-reduce then runs over one rank."""
  model, loss = train_step._port_run()
  want = {n: p.grad for n, p in model.named_parameters()}
  alone = train_step.load_npz(ModeDisparity(MAXDISP, device="cpu"), NPZ)
  optimizer = train_step.ttraining.make_optimizer(alone.parameters())
  mesh = make_mesh(device="cpu")
  assert mesh.shape == {"data": 1, "spatial": 1}
  step = train_step.ttraining.make_disparity_train_step(alone, optimizer,
                                                        mesh=mesh)
  l0, r0, g0 = (torch.from_numpy(a) for a in train_step._batch(0))
  assert float(step(l0, r0, g0)) == loss
  for name, p in alone.named_parameters():
    assert torch.equal(p.grad, want[name]), name
  assert mesh.collectives == 0
  (one,) = run_ranks(ranks.stage1_step, 1, (NPZ, MAXDISP, train_step._batch(
      0)), timeout=TIMEOUT, device="cpu", threads=2)
  assert one["loss"] == loss and one["same"]
  assert one["collectives"] > 0
  for name, g in want.items():
    np.testing.assert_array_equal(one["grads"][name], g.numpy(), name)


# --- the fusion step --------------------------------------------------------


def _jax_fusion_step(variables, wire):
  model = jfusion.ModeFusion(fusion_train.MAX_DEPTH, fusion_train.SMALL)
  optimizer = jtraining.make_optimizer()
  state = jtraining.TrainState(
      params=variables["params"], batch_stats=variables["batch_stats"],
      opt_state=optimizer.init(variables["params"]),
      step=jnp.zeros((), jnp.int32))
  state = jtraining.set_learning_rate(state, fusion_train.ttraining.FUSION_LR)
  mesh = jax_mesh(data=WORLD)
  step = jtraining.make_fusion_train_step(model, optimizer,
                                          fusion_train.MAX_DEPTH, mesh)
  inputs = fusion_train._float_inputs(wire)
  batch = jtraining.shard_batch(mesh, (*inputs, wire[3]))
  new, loss = step(state, *batch)
  mu = new.opt_state.inner_state[0].mu
  return {"loss": float(loss), "stats": train_step._numpy(new.batch_stats),
          "grads": grads_from_jax(jax.tree_util.tree_map(
              lambda m: np.asarray(m) / 0.1, mu)),
          "before": train_step._numpy(state.params),
          "after": train_step._numpy(new.params)}


def _fusion_ranks(fusion_setup):
  wire, variables = fusion_setup
  model = carry(tfusion.ModeFusion(fusion_train.MAX_DEPTH, fusion_train.SMALL,
                                   device="cpu"), variables)
  state = {k: v.numpy() for k, v in model.state_dict().items()}
  return run_ranks(ranks.fusion_step, WORLD, (
      state, fusion_train.SMALL, fusion_train.MAX_DEPTH,
      fusion_train._float_inputs(wire), wire[3]), timeout=TIMEOUT,
                   device="cpu", threads=2)


def _reversed(wire):
  """The frame with its two examples swapped."""
  return tuple([a[::-1].copy() for a in part] if isinstance(part, list)
               else part[::-1].copy() for part in wire)


# --- units -------------------------------------------------------------------


def _unit_inputs():
  rng = np.random.default_rng(0)
  x = (rng.normal(size=(4, 6, 5, 3)) * 2 + 1).astype(np.float32)
  g = rng.normal(size=x.shape).astype(np.float32)
  rng = np.random.default_rng(1)
  pred = rng.uniform(0, 16, (2, 8, 6)).astype(np.float32)
  gt = rng.uniform(0, 16, (2, 8, 6)).astype(np.float32)
  mask = np.ones(gt.shape, bool)
  mask[0, :5] = False                      # rank 0 keeps 18 of 48 pixels
  depth = rng.uniform(1, 100, (2, 8, 6)).astype(np.float32)
  depth_gt = rng.uniform(1, 100, (2, 8, 6)).astype(np.float32)
  depth_gt[1, 2:] = 200.0                  # rank 1 keeps few pixels
  rows = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
  return {"bn": (x, g), "losses": (pred, gt, mask, depth, depth_gt),
          "mesh": (rows,)}


@pytest.fixture(scope="module")
def units():
  inputs = _unit_inputs()
  return inputs, run_ranks(ranks.units, WORLD, (inputs,), timeout=TIMEOUT,
                           device="cpu", threads=1)


def test_batch_norm_uses_the_global_batch(units):
  """Each rank's BN on its rows equals one BN on the whole batch: output,
  input gradient, the parameters' gradients summed over the ranks, and the
  running statistics (unbiased variance with the global count)."""
  inputs, outs = units
  x, g = inputs["bn"]
  outs = [out["bn"] for out in outs]
  bn = TorchBatchNorm(6).train()
  with torch.no_grad():
    bn.weight.uniform_(0.5, 1.5, generator=torch.Generator().manual_seed(1))
    bn.bias.uniform_(-0.5, 0.5, generator=torch.Generator().manual_seed(2))
  xt = torch.from_numpy(x).requires_grad_(True)
  y = bn(xt)
  (y * torch.from_numpy(g)).sum().backward()
  half = x.shape[0] // WORLD
  for r, out in enumerate(outs):
    rows = slice(r * half, (r + 1) * half)
    np.testing.assert_allclose(out["y"], y.detach().numpy()[rows],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out["dx"], xt.grad.numpy()[rows], rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(out["dweight"], bn.weight.grad.numpy(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out["dbias"], bn.bias.grad.numpy(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out["running_mean"], bn.running_mean.numpy(),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(out["running_var"], bn.running_var.numpy(),
                               rtol=1e-6, atol=1e-6)
    assert int(out["tracked"]) == 1


def test_losses_are_global_masked_means(units):
  """Both losses under the mesh equal the JAX package's over the whole
  batch, on every rank, with the two ranks' valid counts unequal; each
  rank's gradient of its rows is W times that share of the global loss's
  gradient."""
  inputs, outs = units
  pred, gt, mask, depth, depth_gt = inputs["losses"]
  outs = [out["losses"] for out in outs]

  def smooth(p):
    return jlosses.disparity_deep_supervision((p, p * 0.5, p * 2.0), gt,
                                              mask)

  def silog(d):
    return jlosses.silog_loss(0.5, d, depth_gt, depth_gt <= 80.0)

  for name, fn, x in (("smooth_l1", smooth, pred), ("silog", silog, depth)):
    value, grad = jax.value_and_grad(fn)(jnp.asarray(x))
    for r, out in enumerate(outs):
      got = out[name]
      assert abs(float(got["value"]) - float(value)) <= 1e-6 * abs(
          float(value)), (name, r)
      np.testing.assert_allclose(got["grad"] / WORLD, np.asarray(grad)[r:r + 1],
                                 rtol=1e-5, atol=1e-8, err_msg=name)
    assert float(outs[0][name]["value"]) == float(outs[1][name]["value"])


def test_shard_batch_takes_the_p_data_rows(units):
  """Rank r's rows are the shard of ``P("data")`` on the mesh's r-th
  device; the mesh refuses a data axis off the world size, a ``data x
  spatial`` mesh off it and a batch that does not split. (Until the
  spatial axis was ported, ``spatial=2`` was refused too.) ``spatial=2``
  at ``data=1`` puts rank r at spatial place r with the whole batch."""
  inputs, outs = units
  (rows,) = inputs["mesh"]
  outs = [out["mesh"] for out in outs]
  mesh = jax_mesh(data=WORLD)
  arr = jax.device_put(rows, NamedSharding(mesh, P("data")))
  shards = {s.device: np.asarray(s.data) for s in arr.addressable_shards}
  for r, out in enumerate(outs):
    assert out["shape"] == {"data": WORLD, "spatial": 1}
    assert out["rank"] == r
    np.testing.assert_array_equal(out["rows"],
                                  shards[mesh.devices[r, 0]])
    np.testing.assert_array_equal(out["gathered"], rows)
    refused = out["refused"]
    assert set(refused) == {"data_off_world", "data_3", "mesh_off_world",
                            "batch_3"}
    assert "world size, 2" in refused["data_off_world"]
    assert "must hold the world size, 2" in refused["mesh_off_world"]
    assert "does not split" in refused["batch_3"]
    shape, data_rank, spatial_rank, batch = out["spatial_mesh"]
    assert shape == {"data": 1, "spatial": WORLD}
    assert (data_rank, spatial_rank) == (0, r)
    np.testing.assert_array_equal(batch, rows)


def test_chip_smoke_expects_the_rank_launches(monkeypatch):
  """``chip_smoke.py``'s data-parallel phases split ``train_b2``'s batch of
  2 over two ranks and ``fusion_train_b4``'s frame of 4: each rank's
  launches are the JAX package's training gates traced at the per-rank
  batch, 1024x512: ``RANK_TRACED`` for stage 1 at batch 1 (the stride-1
  3-D and the 2-D convs need batch >= 2), ``FUSION_TRAIN_K9`` for the
  fusion net at batch 2, in the JAX package and the port alike."""
  import chip_smoke
  h, w = chip_smoke.GEOMETRY["Cassini"]
  assert chip_smoke.TRAINS["train_b2"][1] == WORLD == chip_smoke.DDP_WORLD
  assert train_step._count_jax(monkeypatch, 1, h, w,
                               chip_smoke.MAXDISP) == chip_smoke.RANK_TRACED
  per_rank = chip_smoke.FUSION_TRAINS["fusion_train_b4"][0] // WORLD
  full = (per_rank, h, w, (32, 64, 128, 256), fusion_train.F32)
  assert (len(fusion_train._count_jax(monkeypatch, *full))
          == len(fusion_train._count_port(monkeypatch, *full))
          == chip_smoke.FUSION_TRAIN_K9)
