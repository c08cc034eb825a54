"""Traffic of fusion training steps: the step of ``make_fusion_train_step``
(``raw_inputs=True``) on packed frames made from the seed (f16 depths,
uint8 confidences and views, f32 ground truth), one upload per array a
step; the fusion net is seeded, its head calibrated by the reference."""

from __future__ import annotations

from benchmark.harness import driver as base
from benchmark.harness import inputs
from benchmark.harness.train_driver import TrainDriver
from benchmark.harness.weights import seeded_state
from benchmark.reference import models as ref_models
from benchmark.reference import steps as ref_steps


class Driver(TrainDriver):

  def setup(self) -> None:
    from mode_tpu_torch import training
    from mode_tpu_torch.models.fusion import ModeFusion
    cfg, tr = self.config, self.traffic
    self.examples_per_call = tr["batch"]
    self.mark("imports")
    self.pool = inputs.fusion_batches(self.gen, tr["pool"], tr["batch"],
                                      cfg["height"], cfg["width"],
                                      cfg["max_depth"], self.device)
    self.mark("inputs")
    template = self._reference_model().state_dict()
    self.state = seeded_state(template, self.gen, self.device)
    with self.reference_time():
      self._calibrate_head()
    self.mark("weights")
    model = ModeFusion(cfg["max_depth"], cfg["fusion_channels"],
                       device=self.device)
    self._make = lambda m, o: training.make_fusion_train_step(
        m, o, cfg["max_depth"], compute_dtype=self.dtype, raw_inputs=True)
    self._start_with(model)

  def _calibrate_head(self) -> None:
    """The head calibrated on batch 0 in training (batch statistics)."""
    depths, confs, views, _ = inputs.to_device(self.pool[0], self.device)
    unpacked = ref_steps.fusion_inputs(depths, confs, views)
    base.scale_head(self.state, self._reference_model().train(),
                    lambda n: n(*unpacked), self.device)

  def _reference_model(self):
    cfg = self.config
    return ref_models.ModeFusion(cfg["max_depth"], cfg["fusion_channels"])

  def _reference_loss(self, model, batch):
    return ref_steps.fusion_loss(model, batch, self.config["max_depth"])
