"""Tiled renderer: the production path (SURVEY §7 step 5).

frustum cull -> tile binning (binning.py) -> Pallas compositing kernel
(kernels.py; route.py picks how it is compiled).  Everything is one
jitted function of (scene, camera).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from splat_tpu.camera import Camera
from splat_tpu.config import RenderConfig
from splat_tpu.ops.projection import project_gaussians
from splat_tpu.render.binning import build_tile_bins
from splat_tpu.render.kernels import rasterize_tiles


def render_tiled(scene, camera: Camera, config: RenderConfig | None = None,
                 *, return_stats: bool = False):
    """Render to float32 (H, W, 3) — or (H, W, 4) RGBA with
    config.alpha_channel.  Jit-friendly; camera pose is traced.

    return_stats: additionally return a dict with pair counts / overflow /
      tile occupancy (all device scalars; cheap).
    """
    config = config or RenderConfig()
    ss = config.supersample
    if ss > 1:  # supersampled AA: render hi-res, box-filter at the end
        camera = camera.scaled(ss)
    h, w = camera.h, camera.w
    if scene.num_gaussians == 0:  # static: binning has no N=0 shape
        bgc = tuple(config.background)
        if config.alpha_channel:
            bgc = bgc + (0.0,)  # nothing rendered: zero coverage
        img = jnp.broadcast_to(
            jnp.asarray(bgc, jnp.float32),
            (h // ss, w // ss, len(bgc))).astype(jnp.float32)
        if return_stats:
            z = jnp.int32(0)
            return img, {"num_pairs": z, "overflow": z, "visible": z,
                         "max_tile_pairs": z,
                         "mean_tile_pairs": jnp.float32(0.0)}
        return img
    # named scopes label the frame's layers in profiler traces
    with jax.named_scope("project"):
        proj = project_gaussians(scene, camera, config)
    with jax.named_scope("bin"):
        bins = build_tile_bins(proj, h, w, config)
    with jax.named_scope("composite"):
        img = rasterize_tiles(bins, h, w, config)
    if ss > 1:
        from splat_tpu.utils.image import box_downsample

        img = box_downsample(img, ss)
    if return_stats:
        occupancy = bins.tile_end - bins.tile_start
        stats = {
            "num_pairs": bins.num_pairs,
            "overflow": bins.overflow,
            "visible": jnp.sum(proj.visible.astype(jnp.int32)),
            "max_tile_pairs": jnp.max(occupancy),
            "mean_tile_pairs": jnp.mean(occupancy.astype(jnp.float32)),
        }
        return img, stats
    return img


def render_tiled_checked(scene, camera: Camera,
                         config: RenderConfig | None = None):
    """Non-jit wrapper that raises on duplication-buffer overflow
    (capacity-bounded binning must never silently truncate)."""
    img, stats = jax.jit(
        lambda s, c: render_tiled(s, c, config, return_stats=True))(scene,
                                                                    camera)
    overflow = int(stats["overflow"])
    if overflow > 0:
        raise RuntimeError(
            f"tile duplication buffer overflow: {overflow} pairs dropped "
            f"(num_pairs={int(stats['num_pairs'])}); raise "
            f"RenderConfig.max_dup_factor")
    return img
