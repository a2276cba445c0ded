"""Dense renderer: every gaussian evaluated against every pixel.

The minimum end-to-end slice (SURVEY §7 step 4): correct, fully jitted, no
binning.  O(N * H * W) work, so only sensible for small scenes / parity
tests — but it defines the exact semantics the tiled Pallas path must
reproduce, and it exercises the whole per-gaussian pipeline on device.

Compositing uses the associativity of the 'over' operator:
(C1, T1) op (C2, T2) = (C1 + T1*C2, T1*T2).  Within a chunk of K gaussians
the front-to-back accumulation is a cumulative product over (1 - alpha) —
one vectorized pass instead of K sequential steps; chunks are then folded
front-to-back with ``lax.scan``.  This replaces the reference's per-pixel
back-to-front blend loop (src/pipelines.rs:147-168) with math that
vectorizes well.
"""

from __future__ import annotations



import jax
import jax.numpy as jnp

from splat_tpu.camera import Camera
from splat_tpu.config import RenderConfig
from splat_tpu.ops.projection import project_gaussians


def _splat_alpha(proj, idx, px, py, config: RenderConfig):
    """Alpha of gaussians ``idx`` (K,) at pixel grids px/py (H, W)."""
    cx = proj.center_px[idx, 0][:, None, None]
    cy = proj.center_px[idx, 1][:, None, None]
    ca = proj.conic[idx, 0][:, None, None]
    cb = proj.conic[idx, 1][:, None, None]
    cc = proj.conic[idx, 2][:, None, None]
    rx = proj.radius_px[idx, 0][:, None, None]
    ry = proj.radius_px[idx, 1][:, None, None]
    op = proj.opacity[idx][:, None, None]
    visible = proj.visible[idx][:, None, None]

    dx = px[None] - cx
    dy = cy - py[None]  # local +y up (reference quad orientation)
    power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
    alpha = jnp.minimum(config.alpha_clamp, op * jnp.exp(power))
    keep = ((power <= 0)
            & (alpha >= config.alpha_min)
            & (jnp.abs(dx) <= rx) & (jnp.abs(dy) <= ry)
            & visible)
    return jnp.where(keep, alpha, 0.0)


def render_dense(scene, camera: Camera, config: RenderConfig | None = None,
                 *, chunk: int = 16) -> jax.Array:
    """Render to a float32 (H, W, 3) image in [0, 1] — or (H, W, 4) RGBA
    with config.alpha_channel (fourth channel = accumulated 1 - T).
    Jit-friendly."""
    config = config or RenderConfig()
    ss = config.supersample
    if ss > 1:  # supersampled AA: render hi-res, box-filter at the end
        import dataclasses

        camera = camera.scaled(ss)
    h, w = camera.h, camera.w
    n = scene.num_gaussians
    bg = jnp.asarray(config.background, jnp.float32)
    if n == 0:  # empty scene: pure background, zero coverage
        bgc = (jnp.concatenate([bg, jnp.zeros((1,), jnp.float32)])
               if config.alpha_channel else bg)
        return jnp.broadcast_to(
            bgc, (h // ss, w // ss, bgc.shape[0])).astype(jnp.float32)
    proj = project_gaussians(scene, camera, config)

    # Front-to-back: ascending view depth.  Invisible splats get +inf keys so
    # they sort to the end (their alpha is masked to 0 anyway).
    key = jnp.where(proj.visible, proj.depth, jnp.inf)
    order = jnp.argsort(key)

    pad = (-n) % chunk
    order = jnp.concatenate(
        [order, jnp.zeros((pad,), order.dtype)]) if pad else order
    valid = jnp.concatenate(
        [jnp.ones((n,), bool), jnp.zeros((pad,), bool)]) if pad else jnp.ones(
            (n,), bool)
    order = order.reshape(-1, chunk)
    valid = valid.reshape(-1, chunk)

    py, px = jnp.mgrid[0:h, 0:w]
    px = px.astype(jnp.float32)
    py = py.astype(jnp.float32)

    def step(carry, chunk_in):
        img, transmit = carry
        idx, ok = chunk_in
        alpha = _splat_alpha(proj, idx, px, py, config)      # (K, H, W)
        alpha = jnp.where(ok[:, None, None], alpha, 0.0)
        color = jnp.clip(proj.color[idx], 0.0, 1.0)           # (K, 3)
        one_minus = 1.0 - alpha
        # T before each splat within the chunk (exclusive cumprod).
        t_within = jnp.cumprod(one_minus, axis=0)
        t_before = jnp.concatenate(
            [jnp.ones_like(t_within[:1]), t_within[:-1]], axis=0)
        contrib = jnp.einsum("khw,kc->hwc", alpha * t_before, color,
                             precision=jax.lax.Precision.HIGHEST)
        img = img + transmit[..., None] * contrib
        transmit = transmit * t_within[-1]
        return (img, transmit), None

    init = (jnp.zeros((h, w, 3), jnp.float32), jnp.ones((h, w), jnp.float32))
    (img, transmit), _ = jax.lax.scan(step, init, (order, valid))
    img = img + transmit[..., None] * bg
    if config.alpha_channel:
        img = jnp.concatenate([img, 1.0 - transmit[..., None]], axis=-1)
    img = jnp.clip(img, 0.0, 1.0)
    if ss > 1:
        from splat_tpu.utils.image import box_downsample

        img = box_downsample(img, ss)
    return img


render_dense_jit = jax.jit(render_dense,
                           static_argnames=("config", "chunk"))
