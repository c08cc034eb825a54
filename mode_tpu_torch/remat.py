"""Rematerialisation of the stage-1 feature extractor and hourglasses in
training (``mode_tpu/models/disparity.py``'s ``remat`` and
``remat_policy``).

:func:`rematerialise` runs a block under ``torch.utils.checkpoint`` (non
reentrant, so the gradient hooks of the data-parallel step keep working):
its forward keeps no activation for the backward, and the backward runs the
block again to make them. The policy says what the block keeps:

- ``"full"``: nothing; the backward runs every conv of the block again;
- ``"save_convs"`` (the JAX package's default, which names each conv's
  output ``checkpoint_name(y, "conv_out")`` and saves it by name): each
  conv's output, so the rerun computes only the BatchNorm, residual and
  ReLU tails and no conv runs twice. Each conv of the block passes its
  computation through :func:`conv_output`, which keeps the output in the
  block's :class:`Scope` on the forward and hands it back on the rerun
  instead of computing it: the kernels' autograd Functions around their
  launch, the library convs through :func:`library_conv`. So a kernel
  launches as often as without rematerialisation. (The plain sphere conv,
  which trains only where its kernel does not, is an einsum over gathered
  samples and reruns whole, as the JAX package's backward regathers
  them.)

A policy inside the convs, and not ``torch.utils.checkpoint``'s selective
policy: that one sees ATen operations and not a kernel that an autograd
Function launches through ``ctypes``, and it intercepts every operation of
the block in Python, on the forward and in the rerun: keeping cuDNN's
conv outputs that way made a 1024x512 f32 step at batch 2 13.7% slower
than without rematerialisation on an H100 (bf16: 39.5%), this policy
2.5% (bf16: 17.1%; ``scripts/remat_cost.py``). In the rerun each
conv still saves its input and weight for its own backward, as it did on
the forward, so the checkpoint finds the tensors it expects.

The BatchNorm layers update their running statistics on the forward only
(:func:`replaying`). The block's rerun may run in autograd's backward
thread: it makes its scope, and the mesh that was active on the forward,
current there for its own duration. Each rerun, the training heads' too
(:func:`checkpoint`), opens the tracer's span ``remat.rerun``
(``utils/profiling.py``).
"""

from __future__ import annotations

import threading
import types
from typing import Callable

import torch
import torch.utils.checkpoint

from mode_tpu_torch.parallel.mesh import activate, active_mesh
from mode_tpu_torch.utils.profiling import span

POLICIES = ("save_convs", "full")

_state = threading.local()


class Scope:
  """One rematerialised call of a block: its policy, the mesh active on
  its forward, and (``"save_convs"``) the conv outputs it keeps, in call
  order. ``runs`` counts the block's runs: the forward, then each
  rerun."""

  def __init__(self, policy: str):
    if policy not in POLICIES:
      raise ValueError(f"remat_policy must be one of {POLICIES}, got "
                       f"{policy!r}")
    self.policy = policy
    self.mesh = active_mesh()
    self.kept: list[torch.Tensor] = []
    self.runs = 0
    self._next = 0

  def keep(self, compute: Callable[[], torch.Tensor]) -> torch.Tensor:
    """``compute()`` on the forward, kept; the kept tensor on a rerun."""
    if self.runs > 1:
      y = self.kept[self._next]
      self._next += 1
      return y.detach()
    y = compute()
    self.kept.append(y.detach())
    return y


def current() -> Scope | None:
  return getattr(_state, "scope", None)


def replaying() -> bool:
  """Whether a rematerialised block is being run again for its backward."""
  scope = current()
  return scope is not None and scope.runs > 1


def checkpoint(fn: Callable, *args, scope=None):
  """``fn(*args)`` under ``torch.utils.checkpoint`` (non reentrant): its
  backward runs ``fn`` again, in a ``remat.rerun`` span. ``scope.runs``
  counts the runs, where a rematerialised block's :class:`Scope` is
  given."""
  scope = scope if scope is not None else types.SimpleNamespace(runs=0)

  def run(*a):
    scope.runs += 1
    if scope.runs == 1:
      return fn(*a)
    with span("remat.rerun"):
      return fn(*a)

  return torch.utils.checkpoint.checkpoint(run, *args, use_reentrant=False)


def rematerialise(fn: Callable, policy: str, *args, **kwargs):
  """``fn(*args, **kwargs)``, rematerialised under ``policy`` (module
  docstring). Without autograd recording it is just the call."""
  if not torch.is_grad_enabled():
    return fn(*args, **kwargs)
  scope = Scope(policy)

  def run(*a):
    scope._next = 0
    prev = current()
    _state.scope = scope
    try:
      with activate(scope.mesh):
        return fn(*a, **kwargs)
    finally:
      _state.scope = prev

  return checkpoint(run, *args, scope=scope)


def conv_output(compute: Callable[[], torch.Tensor]) -> torch.Tensor:
  """A conv's output inside an autograd Function's forward: under a
  ``"save_convs"`` scope kept on the forward and handed back on a rerun
  (:meth:`Scope.keep`), else ``compute()``."""
  scope = current()
  if scope is None or scope.policy != "save_convs":
    return compute()
  return scope.keep(compute)


class _LibraryConv(torch.autograd.Function):
  """A library conv without a bias, ``fn(x, weight, **kw)``, under a
  ``"save_convs"`` scope: the output kept (:func:`conv_output`), the
  gradients from the saved input and weight by
  ``aten.convolution_backward``, the call autograd makes for ``fn``."""

  @staticmethod
  def forward(ctx, x, weight, fn, kw):
    ctx.save_for_backward(x, weight)
    ctx.kw = kw
    return conv_output(lambda: fn(x, weight, **kw))

  @staticmethod
  def backward(ctx, g):
    x, weight = ctx.saved_tensors
    kw = ctx.kw
    nd = weight.dim() - 2

    def per_dim(key, default):
      v = kw.get(key, default)
      return [v] * nd if isinstance(v, int) else list(v)

    dx, dw, _ = torch.ops.aten.convolution_backward(
        g, x, weight, None, per_dim("stride", 1), per_dim("padding", 0),
        per_dim("dilation", 1), "output_padding" in kw,
        per_dim("output_padding", 0), 1,
        [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False])
    return dx, dw, None, None


def library_conv(fn, x: torch.Tensor, weight: torch.Tensor,
                 **kw) -> torch.Tensor:
  """``fn(x, weight, **kw)``, a library conv without a bias (``F.conv2d``,
  ``F.conv3d``, ``F.conv_transpose3d``), its output kept under a
  ``"save_convs"`` scope."""
  scope = current()
  if scope is None or scope.policy != "save_convs":
    return fn(x, weight, **kw)
  return _LibraryConv.apply(x, weight, fn, kw)
