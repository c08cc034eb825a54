"""Traffic of stage-1 training steps: the step of
``make_disparity_train_step`` on uint8 pairs and NaN-masked disparities
made from the seed, one upload per array a step, fine-tuning the
configuration's ``stage1_weights``."""

from __future__ import annotations

from benchmark.harness import driver as base
from benchmark.harness import inputs
from benchmark.harness.train_driver import TrainDriver
from benchmark.reference import models as ref_models
from benchmark.reference import steps as ref_steps


class Driver(TrainDriver):

  def setup(self) -> None:
    from mode_tpu_torch import training
    from mode_tpu_torch.models.disparity import ModeDisparity
    cfg, tr = self.config, self.traffic
    self.examples_per_call = tr["batch"]
    self.mark("imports")
    self.pool = inputs.stage1_batches(
        self.gen, tr["pool"], tr["batch"], cfg["height"], cfg["width"],
        tr["disparity_px"], tr["nan_patch"], self.device)
    self.mark("inputs")
    self.state = base.load_npz(cfg["stage1_weights"], self.device)
    self.mark("weights")
    model = ModeDisparity(cfg["maxdisp"], "Sphere", cfg["sphere_type"],
                          out_conf=False, device=self.device)
    self._make = lambda m, o: training.make_disparity_train_step(
        m, o, compute_dtype=self.dtype)
    self._start_with(model)

  def _reference_model(self):
    cfg = self.config
    return ref_models.ModeDisparity(cfg["maxdisp"], cfg["height"],
                                    cfg["width"], cfg["sphere_type"],
                                    checkpoint=True)

  def _reference_loss(self, model, batch):
    return ref_steps.disparity_loss(model, batch)
