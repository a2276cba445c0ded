"""Vectorized per-gaussian math: the device twin of reference
src/gaussians.rs."""

from splat_tpu.ops.transforms import quat_to_rotmat, compute_cov3d
from splat_tpu.ops.sh import eval_sh, SH_C0
from splat_tpu.ops.projection import project_gaussians, ProjectedGaussians
from splat_tpu.ops.sort import (sort_gaussians, sort_gaussians_front_to_back,
                                camera_space_z)

__all__ = [
    "quat_to_rotmat",
    "compute_cov3d",
    "eval_sh",
    "SH_C0",
    "project_gaussians",
    "ProjectedGaussians",
    "sort_gaussians",
    "sort_gaussians_front_to_back",
    "camera_space_z",
]
