"""splat_tpu — a 3D Gaussian Splatting engine in JAX/XLA/Pallas.

A ground-up rebuild of the capabilities of ``thomasantony/splat`` (a CPU
software-rasterizer viewer for pretrained 3DGS ``.ply`` models), re-designed
for an accelerator (it runs on an NVIDIA GPU; tests run on the CPU):

* gaussian data lives in device-resident SoA arrays (:mod:`splat_tpu.scene`),
* all per-gaussian math (cov3d, EWA projection, spherical harmonics, depth
  keys) is vectorized device code (:mod:`splat_tpu.ops`),
* the per-pixel painter's-algorithm blend loop of the reference
  (reference: src/pipelines.rs:127-168) is replaced by a tile-binned
  front-to-back alpha-compositing Pallas kernel (:mod:`splat_tpu.render`),
* everything between "camera pose" and "u8 image" is one jitted function.

Public API::

    import splat_tpu as st

    scene  = st.load_ply("point_cloud.ply")         # or st.io.load_scene
    camera = st.Camera.create(h=1080, w=1920, position=(0., 0., 5.))
    img    = st.render(scene, camera)               # float32 (H, W, 3)
"""

from splat_tpu.config import RenderConfig
from splat_tpu.scene import DeviceScene, GaussianScene
from splat_tpu.camera import Camera, SE3Camera, stack_cameras
from splat_tpu.io.ply import load_ply, save_ply
from splat_tpu.render.api import (auto_config, pair_stats, render,
                                  render_fn)
from splat_tpu.render.dense import render_dense
from splat_tpu.render.diff import render_tiled_diff
from splat_tpu.train import FitResult, RawParams, fit, psnr
from splat_tpu.utils.fixtures import (naive_gaussians, random_scene,
                                      surface_scene)

__version__ = "0.1.0"

__all__ = [
    "RenderConfig",
    "GaussianScene",
    "DeviceScene",
    "Camera",
    "SE3Camera",
    "stack_cameras",
    "load_ply",
    "save_ply",
    "auto_config",
    "pair_stats",
    "render",
    "render_dense",
    "render_tiled_diff",
    "render_fn",
    "fit",
    "FitResult",
    "RawParams",
    "psnr",
    "naive_gaussians",
    "random_scene",
    "surface_scene",
]
