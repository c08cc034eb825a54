"""The frozen counts: the FLOP copy equals the program's ``utils/flops.py``,
and the least times are positive and below the model FLOPs at peak."""

import pytest

from benchmark.counts import flops as frozen
from benchmark.counts.roofline import PEAK_OPS_PER_S, stage1_least_s
from mode_tpu_torch.utils import flops as program

SHAPES = [(1, 1024, 512, 192), (6, 1024, 512, 192), (16, 512, 256, 192),
          (2, 64, 32, 16)]


@pytest.mark.parametrize("b, h, w, d", SHAPES)
def test_frozen_flops_equal_the_program_counts(b, h, w, d):
  assert frozen.disparity_flops(b, h, w, d) == program.disparity_flops(
      b, h, w, d)
  assert frozen.fusion_flops(b, h, w) == program.fusion_flops(b, h, w)


def test_frozen_pipeline_flops():
  assert frozen.pipeline_flops() == program.pipeline_flops()
  assert 9.0e12 < frozen.pipeline_flops() < 10.5e12


def test_stage1_least_time_is_a_lower_bound():
  least = stage1_least_s(6, 1024, 512, 192, "bfloat16")
  assert least["fe"] > 0 and least["cv"] > 0
  # the least time covers at least the useful conv MACs of stage 1 at peak,
  # less the sphere convs' blend, which it leaves out
  fwd = frozen.disparity_flops(6, 1024, 512, 192)["fwd"]
  at_peak = fwd / PEAK_OPS_PER_S["bfloat16"]
  assert 0.9 * at_peak < least["fe"] + least["cv"] < 1.5 * at_peak
