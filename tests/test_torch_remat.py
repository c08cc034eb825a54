"""Rematerialisation of the stage-1 training forward in mode_tpu_torch
(``remat.py``; ``ModeDisparity(remat=..., remat_policy=...)``), on the CPU
at 64x32, maxdisp 16, batch 2, the trained ``tests/data/trained_mirror.npz``
weights and ``tests/test_torch_train_step.py``'s batch.

- The step gives the same loss and gradients, bit for bit, with
  ``remat=False``, ``"save_convs"`` and ``"full"``: the rerun computes the
  same operations on the same values. The BN running statistics are held
  to 1e-6 relative: the CPU's vectorised reductions can depend on where a
  tensor lies in memory, and one run in several at 4 CPU threads has put a
  statistic an ulp (2.8e-7) off, with the loss and gradients still
  bit-equal.
- No conv runs twice under ``"save_convs"``; under ``"full"`` every conv of
  the feature extractor (both views) and of the three hourglasses runs once
  more. Counted with the recorder of the routing tests on the kernels'
  (plain here) forward and grad-input calls, with the kernels' training
  gates forced on, so every conv the card would give a kernel takes its
  Function here; and the library convs as the ``aten.convolution`` calls
  that reach a dispatch mode.
- The port's defaults are the JAX model's (``remat=True``,
  ``"save_convs"``).
"""

import dataclasses

import pytest
import torch
from torch import nn
from torch.utils._python_dispatch import TorchDispatchMode

from mode_tpu.models import disparity as jdisp
from mode_tpu_torch import remat, training
from mode_tpu_torch.models import blocks
from mode_tpu_torch.models.disparity import ModeDisparity
from mode_tpu_torch.ops import conv2d as conv2d_ops
from mode_tpu_torch.ops import conv3d as conv3d_ops
from mode_tpu_torch.ops import sphere_conv as sphere_ops
from mode_tpu_torch.utils.convert import load_npz
from tests.test_torch_train_step import MAXDISP, NPZ, _batch

torch.set_num_threads(2)

POLICIES = ((False, "save_convs"), (True, "save_convs"), (True, "full"))


def _step(remat, policy):
  model = load_npz(ModeDisparity(MAXDISP, device="cpu", remat=remat,
                                 remat_policy=policy), NPZ)
  optimizer = training.make_optimizer(model.parameters())
  step = training.make_disparity_train_step(model, optimizer)
  loss = float(step(*(torch.from_numpy(a) for a in _batch(0))))
  return model, loss


def test_policies_give_the_same_step():
  base, base_loss = _step(False, "save_convs")
  want = {n: p.grad for n, p in base.named_parameters()}
  stats = base.state_dict()
  for remat, policy in POLICIES[1:]:
    model, loss = _step(remat, policy)
    assert loss == base_loss, policy
    for name, p in model.named_parameters():
      assert torch.equal(p.grad, want[name]), (policy, name)
    for name, value in model.state_dict().items():
      if name.endswith("num_batches_tracked"):
        assert int(value) == int(stats[name]), name    # updated once
      elif name.endswith(("running_mean", "running_var")):
        torch.testing.assert_close(value, stats[name], rtol=1e-6, atol=0)
      else:
        assert torch.equal(value, stats[name]), name


# the functions that compute a conv through a kernel's Function, by what
# they compute: the kernels' plain versions (forward and grad-input)
COUNTED = ((conv3d_ops, "_run"), (conv2d_ops, "conv2d_s1_bn_act"),
           (sphere_ops, "sphere_conv_bn_act"))
GATES = ((conv3d_ops, "train_s1_eligible"), (conv3d_ops, "train_s2_eligible"),
         (conv3d_ops, "train_deconv_eligible"),
         (conv2d_ops, "train_kernel_eligible"),
         (sphere_ops, "train_kernel_eligible"))


class _LibraryConvs(TorchDispatchMode):
  """Counts the ``aten.convolution`` calls that reach it outside a counted
  function: the library convs. A conv whose kept output the rerun takes
  back does not reach it."""

  def __init__(self, depth):
    super().__init__()
    self.depth, self.calls = depth, 0

  def __torch_dispatch__(self, func, types, args=(), kwargs=None):
    self.calls += (func is torch.ops.aten.convolution.default
                   and self.depth[0] == 0)
    return func(*args, **(kwargs or {}))


def _conv_calls(monkeypatch, remat, policy) -> tuple[int, int]:
  """The convs a step computes: ``(kernel convs, library convs)``, the
  calls of ``COUNTED`` and the ``aten.convolution`` calls outside them (a
  plain version's own library conv is not counted again)."""
  calls, depth = [0], [0]

  def counted(fn):
    def wrapper(*args, **kwargs):
      calls[0] += depth[0] == 0
      depth[0] += 1
      try:
        return fn(*args, **kwargs)
      finally:
        depth[0] -= 1
    return wrapper

  with monkeypatch.context() as m:
    for module, name in GATES:
      m.setattr(module, name, lambda *a, **k: True)
    for module, name in COUNTED:
      m.setattr(module, name, counted(getattr(module, name)))
    with _LibraryConvs(depth) as library:
      _step(remat, policy)
  return calls[0], library.calls


def _convs(module: nn.Module) -> int:
  return sum(isinstance(m, (nn.Conv2d, blocks.SphereConv,
                            blocks.Conv3dWeight, blocks.ConvTranspose3dWeight))
             for m in module.modules())


def test_save_convs_runs_no_conv_twice(monkeypatch):
  """The counts, and under ``"save_convs"`` the backward's rerun of the
  blocks took every kept conv output back."""
  model = ModeDisparity(MAXDISP, device="cpu")
  rerun = (2 * _convs(model.feature_extraction)
           + sum(_convs(getattr(model, f"dres{i}")) for i in (2, 3, 4)))
  assert rerun == 2 * 55 + 3 * 6
  kernel, library = _conv_calls(monkeypatch, False, "save_convs")
  kernel_full, library_full = _conv_calls(monkeypatch, True, "full")
  assert kernel_full - kernel + library_full - library == rerun
  assert kernel_full > kernel and library_full > library
  handed_back = []
  keep = remat.Scope.keep

  def watched(scope, compute):
    handed_back.append(scope.runs > 1)
    return keep(scope, compute)

  monkeypatch.setattr(remat.Scope, "keep", watched)
  assert _conv_calls(monkeypatch, True, "save_convs") == (kernel, library)
  assert (sum(handed_back), len(handed_back)) == (rerun, 2 * rerun)


def test_defaults_are_the_jax_models():
  fields = {f.name: f.default for f in dataclasses.fields(jdisp.ModeDisparity)}
  model = ModeDisparity(MAXDISP, device="cpu")
  assert (model.remat, model.remat_policy) == (fields["remat"],
                                               fields["remat_policy"])
  assert (model.remat, model.remat_policy) == (True, "save_convs")
  with pytest.raises(ValueError, match="remat_policy"):
    ModeDisparity(MAXDISP, device="cpu", remat_policy="dots")
