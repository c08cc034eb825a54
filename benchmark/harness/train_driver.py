"""What the training drivers share: a step fed from a pool of pinned
batches, one upload per array a step; the first ``checked_steps`` steps are
the ones the reference follows."""

from __future__ import annotations

import torch

from benchmark.harness import compare, inputs
from benchmark.harness import driver as base
from benchmark.reference import models as ref_models
from benchmark.reference import steps as ref_steps
from benchmark.reference.precision import PRECISIONS

BETA1 = 0.9


class TrainDriver(base.Driver):
  """Subclasses set ``self.pool``, ``self.state`` and ``self._make`` (the
  program's step from a model and its optimizer) in ``setup`` and give the
  reference's model and loss."""
  program_state = ("model", "optimizer", "step", "out1")

  def warm_calls(self) -> int:
    return max(self.traffic["checked_steps"], self.traffic["warmup_calls"])

  def _start_with(self, model) -> None:
    from mode_tpu_torch import training
    from mode_tpu_torch.utils.convert import load_reference_state_dict
    load_reference_state_dict(model, self.state)
    self.model = model
    self.optimizer = training.make_optimizer(model.parameters())
    training.set_learning_rate(self.optimizer, self.traffic["lr"])
    self.step = self._make(model, self.optimizer)
    self.init = {k: self.state[k] for k, _ in model.named_parameters()}
    self.losses, self.grads, self.params, first = [], None, None, []
    hook = model.register_forward_hook(
        lambda m, a, out: first.append(out) if not first else None)
    self.mark("program")
    for i in range(self.warm_calls()):
      self.call(i)
      hook.remove()
      self.mark(f"call {i}")
    out = first[0]
    # stage 1's three heads (B, H, W); the fusion net's (B, H, W, 1)
    out = torch.stack(out) if isinstance(out, tuple) else out[..., 0]
    self.out1 = out.detach().float()

  def call(self, i: int) -> None:
    batch = inputs.to_device(self.pool[i % len(self.pool)], self.device)
    loss = float(self.step(*batch))
    n = self.traffic["checked_steps"]
    if i < n:
      self.losses.append(loss)
      if i == 0:
        self.grads = self._first_gradient()
      if i == n - 1:
        self.params = {k: p.detach().clone()
                       for k, p in self.model.named_parameters()}

  def _first_gradient(self) -> dict:
    """Each parameter's first gradient as Adam got it: its first moment
    after one step is ``(1 - beta1) g``."""
    state = self.optimizer.state
    return {k: state[p]["exp_avg"].detach() / (1 - BETA1)
            for k, p in self.model.named_parameters() if p in state}

  def program_outputs(self) -> dict:
    return {"losses": self.losses, "grads": self.grads, "out1": self.out1,
            "params": self.params, "init": self.init}

  def reference_outputs(self, precision: str = "float32",
                        judged: dict | None = None,
                        variant: str | None = None) -> dict:
    """The reference's first steps on the checked batches, from the same
    start (``judged`` is not needed). ``variant`` gives readings the limits
    are set from: ``"reversed"`` reverses each batch's rows (equal in exact
    arithmetic: f32 rounding alone), ``"half"`` leaves out the second half
    of each batch (a fault)."""
    model = self._reference_model()
    model.load_state_dict(self.state)
    quant = PRECISIONS[precision]
    if quant is not None:
      ref_models.set_quant(model, quant)
    model.to(self.device)
    batches = [inputs.to_device(self.pool[i], self.device)
               for i in range(self.traffic["checked_steps"])]
    n = self.traffic["batch"]
    index = {None: slice(None), "reversed": torch.arange(n - 1, -1, -1),
             "half": slice(0, n // 2)}[variant]
    batches = [inputs.rows(b, index) for b in batches]
    with base.ieee_f32():
      out = ref_steps.train_steps(model, self._reference_loss, batches,
                                  self.traffic["lr"])
    if variant == "reversed":        # the first outputs in the batch's order
      out["out1"] = out["out1"].flip(-3)
    return out

  def control(self, variant: str) -> tuple[dict, dict]:
    """The reference in ``variant``'s way in the program's place ("fp8";
    "reversed" and "half" as in ``reference_outputs``), and the f32
    reference to judge it by."""
    if variant == "fp8":
      got = self.reference_outputs("fp8")
    else:
      got = self.reference_outputs("float32", variant=variant)
    got["init"] = {k: self.state[k] for k in got["params"]}
    if not hasattr(self, "_want"):
      self._want = self.reference_outputs("float32")
    return got, self._want

  numbers = staticmethod(compare.train_numbers)
