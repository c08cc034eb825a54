"""``ModeFusion`` of mode_tpu_torch against the JAX net, on its NHWC
forward (2x32x16) and on its lane-major forward (1x16x128, the JAX
package's Pallas convs in interpret mode), at shared seeded weights and
``tests/test_torch_fusion.py``'s bars (rtol 1e-4, atol 1e-2 m; the outputs
spread over the depth range).
"""

import torch

from mode_tpu.models import fusion as jfusion
from mode_tpu.ops.pallas import conv3d_kernel as c3k
from mode_tpu_torch.models import fusion as tfusion
from tests.test_torch_fusion import (_assert_close, _fusion_case,
                                     interpret_pallas)

torch.set_num_threads(2)


def test_fusion_nhwc_matches_jax():
  _assert_close(*_fusion_case(2, 32, 16))


def test_fusion_lane_forward_matches_jax(monkeypatch, interpret_pallas):
  monkeypatch.setattr(c3k, "_CONV3D_MODE", "on")
  assert jfusion._lane_eligible((1, 16, 128, 12))
  assert tfusion.lane_eligible((1, 16, 128, 12))
  _assert_close(*_fusion_case(1, 16, 128))
