"""The frozen reference agrees with the program's plain path (f32, on the
CPU, at a tiny size), through the harness's own comparison: a frame's five
numbers, and a training step's first loss and gradients."""

import pytest

import tiny


@pytest.mark.parametrize("kind", tiny.KINDS)
def test_reference_agrees_with_the_plain_program(kind):
  result, diag = tiny.run(kind)
  assert result["correct"], diag
  numbers = diag["numbers"]
  if kind == "frame":
    assert numbers["disp_mae_px"] < 1e-4 and numbers["fused_rel"] < 1e-5
  else:
    assert numbers["loss1_gap"] < 1e-5
    assert numbers["grad_gap_median"] < 5e-3
