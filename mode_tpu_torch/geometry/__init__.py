"""Spherical-projection geometry for 360° multi-view depth
(``mode_tpu/geometry``): the Cassini / ERP projections and the
disparity -> depth bridge with its cross-camera re-projection."""

from mode_tpu_torch.geometry.projection import (
    cassini_to_erp,
    erp_to_rect_cassini,
    rotate_cassini,
    rotation_matrix,
    rodrigues,
)
from mode_tpu_torch.geometry.reprojection import (
    cassini_disp_to_depth,
    depth_view_transform_with_conf,
    depth_to_cassini_disp,
)

__all__ = [
    "cassini_to_erp",
    "erp_to_rect_cassini",
    "rotate_cassini",
    "rotation_matrix",
    "rodrigues",
    "cassini_disp_to_depth",
    "depth_view_transform_with_conf",
    "depth_to_cassini_disp",
]
