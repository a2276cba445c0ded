"""EWA 3D->2D projection and per-gaussian screen-space quantities.

This is "stage A" of the frame: everything per-gaussian, fully vectorized —
the batched twin of reference src/gaussians.rs:114-161 / :473-522
(``project_cov3d_to_screen``) plus the center/bbox math the reference's quad
vertex shader performs (src/pipelines.rs:17-51), computed ONCE per gaussian
instead of once per quad corner.

Pixel-space conventions (matching the notebook oracle, notes/util.py:99-114):
the 2D covariance is expressed in *pixel* units (the EWA Jacobian is scaled by
``focal = h / (2 tan(fovy/2))``), centers map through clip -> NDC ->
``x_px = (x+1) w/2, y_px = (1-y) h/2``.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from splat_tpu.camera import Camera
from splat_tpu.config import RenderConfig
from splat_tpu.ops.transforms import pack_cov3d


@partial(jax.tree_util.register_dataclass,
         data_fields=["depth", "center_px", "conic", "radius_px", "color",
                      "opacity", "visible"],
         meta_fields=[])
@dataclasses.dataclass(frozen=True)
class ProjectedGaussians:
    """Per-gaussian screen-space quantities (all (N, ...) float32).

    Attributes:
      depth: (N,) camera-space view depth (-z_cam; positive in front).
      center_px: (N, 2) splat center in pixel coordinates (x, y).
      conic: (N, 3) upper-triangle (a, b, c) of the inverse 2D covariance in
        pixel units (reference src/pipelines.rs:22-23).
      radius_px: (N, 2) axis-aligned half-extents of the splat bbox in
        pixels: min(sigma_cutoff, opacity-aware cutoff) * sqrt(diag(cov2d))
        (reference src/pipelines.rs:27 uses a fixed 3σ quad; shrinking to
        the opacity-aware radius is lossless — see project_gaussians).
      color: (N, 3) SH-evaluated RGB (with +0.5, unclamped).
      opacity: (N,) activated opacities.
      visible: (N,) bool — in front of the near plane, finite conic, and bbox
        intersecting the screen.
    """

    depth: jax.Array
    center_px: jax.Array
    conic: jax.Array
    radius_px: jax.Array
    color: jax.Array
    opacity: jax.Array
    visible: jax.Array


def _pos_cam(means: jax.Array, view: jax.Array) -> jax.Array:
    """(N,3) world -> camera space, elementwise (no batched tiny matmuls —
    see compute_cov3d_packed)."""
    mx, my, mz = means[:, 0], means[:, 1], means[:, 2]
    out = [view[i, 0] * mx + view[i, 1] * my + view[i, 2] * mz + view[i, 3]
           for i in range(3)]
    return jnp.stack(out, axis=-1)


def ewa_project(means: jax.Array, cov3d: jax.Array, view: jax.Array,
                htanx, htany, focal, lowpass: float) -> jax.Array:
    """Project (N,3,3) world covariances to (N,2,2) pixel-space covariances.

    Reference math (src/gaussians.rs:114-161, identically notebook cell 1
    ``get_cov2d``): camera-space position, perspective Jacobian J scaled by
    ``focal`` so the result is in pixel units, W = view[:3,:3]^T, T = W J,
    cov2d = (T^T Sigma^T T)[:2,:2] + lowpass * I.  ``htanx``/``htany`` are
    accepted for signature stability but the reference's +-1.3 tan(fov)
    clamp only affects the skew terms that the truncation discards (see
    inline comment below).
    """
    del htanx, htany  # see docstring
    a, b, c = ewa_project_packed(means, pack_cov3d(cov3d), view, focal,
                                 lowpass)
    row0 = jnp.stack([a, b], axis=-1)
    row1 = jnp.stack([b, c], axis=-1)
    return jnp.stack([row0, row1], axis=-2)


def ewa_project_packed(means, cov6, view, focal, lowpass: float):
    """Packed elementwise EWA: (N,3),(N,6) -> conic-ready (a, b, c) of the
    2D pixel-space covariance, each (N,).

    Math (reference src/gaussians.rs:114-161 == notebook cell 1 get_cov2d):
    the reference builds a row-major J whose first two COLUMNS are
    (f/tz, 0, 0) and (0, f/tz, 0); with T = W J and cov = (T^T Sigma T)
    truncated to [:2,:2], only those two columns ever reach the result —
    the perspective-skew entries J[0,2], J[1,2] land in the discarded third
    row/column (so the +-1.3 tan(fov) clamp has no observable effect; both
    reference implementations share this).  Net effect with W = R_view^T:
      cov2d = (f/tz)^2 * [u^T Sigma u, u^T Sigma v; ., v^T Sigma v]
    where u, v are the first two rows of the view rotation.

    Everything is fused multiply-adds over (N,) vectors — no matrix-unit
    dispatch, full f32 (parity needs true f32; a float32 matmul may run in
    a reduced-precision mode unless asked for HIGHEST).
    """
    xx, xy, xz, yy, yz, zz = (cov6[:, i] for i in range(6))
    u = view[0, :3]
    v = view[1, :3]

    def quad(p, q):  # p^T Sigma q, elementwise over N
        return (xx * (p[0] * q[0]) + yy * (p[1] * q[1]) + zz * (p[2] * q[2])
                + xy * (p[0] * q[1] + p[1] * q[0])
                + xz * (p[0] * q[2] + p[2] * q[0])
                + yz * (p[1] * q[2] + p[2] * q[1]))

    tz = _pos_cam(means, view)[:, 2]
    s2 = (focal / tz) ** 2
    a = s2 * quad(u, u) + lowpass
    b = s2 * quad(u, v)
    c = s2 * quad(v, v) + lowpass
    return a, b, c


def _scene_cols(scene):
    """Dense (N,) component streams of any scene type.

    A DeviceScene (scene.py) already stores components as separate dense
    leaves — its fields pass through untouched, so every HBM read in the
    projection is a contiguous (N,) stream.  A GaussianScene is sliced
    in-graph (strided column reads of (N, 3)/(N, 16, 3) arrays — correct
    but layout-hostile; hot loops should feed pack_device() output).
    """
    if hasattr(scene, "mx"):
        return ((scene.mx, scene.my, scene.mz),
                (scene.qw, scene.qx, scene.qy, scene.qz),
                (scene.sx, scene.sy, scene.sz),
                jnp.asarray(scene.opacities), tuple(scene.sh))
    m, q, s, sh = scene.means, scene.quats, scene.scales, scene.sh
    shs = tuple(sh[:, k, c] for k in range(16) for c in range(3))
    return ((m[:, 0], m[:, 1], m[:, 2]),
            (q[:, 0], q[:, 1], q[:, 2], q[:, 3]),
            (s[:, 0], s[:, 1], s[:, 2]),
            # jnp.asarray: scenes may carry host (NumPy) leaves;
            # downstream indexes with tracers.
            jnp.asarray(scene.opacities), shs)


def encode_depth_color(depth, visible, config: RenderConfig):
    """Normalized view depth to ride the per-gaussian color rows.

    ``render_mode="depth"`` replaces every splat's RGB with its normalized
    view depth, so the unchanged compositing machinery produces the
    alpha-weighted expected depth sum(alpha_i T_i d_i) — the 3DGS
    ecosystem's "expected depth" map (the reference has no depth output).
    Mapping: explicit ``config.depth_range`` (near, far) -> [0, 1], or
    auto = this frame's visible depth min/max.  The result is clipped to
    [0, 1], which both the u16 feature quantization (binning.py) and the
    final image clip require anyway.

    The auto range is a PER-CALL reduction over ``visible``: under
    shard_map it would be per-shard and chips would disagree, so the
    sharded renderers (parallel/sharding.py) demand an explicit range in
    depth mode.
    """
    if config.depth_range is not None:
        lo = jnp.float32(config.depth_range[0])
        hi = jnp.float32(config.depth_range[1])
    else:
        lo = jnp.min(jnp.where(visible, depth, jnp.inf))
        hi = jnp.max(jnp.where(visible, depth, -jnp.inf))
        # empty frame / single depth plane: any constant in [0, 1] works,
        # but the division must stay finite
        ok = jnp.isfinite(lo) & (hi > lo)
        lo = jnp.where(ok, lo, 0.0)
        hi = jnp.where(ok, hi, lo + 1.0)
    return jnp.clip((depth - lo) / (hi - lo), 0.0, 1.0)


def project_gaussians(scene, camera: Camera,
                      config: RenderConfig) -> ProjectedGaussians:
    """All per-gaussian screen-space quantities for one frame, vectorized.

    Everything is fused multiply-adds over dense (N,) component columns
    (see _scene_cols): no batched tiny matmuls, no strided intermediate
    layouts.  The stacked (N, 2)/(N, 3) output fields are assembled once
    at the end; inside a jit the consumers slice them straight back to
    columns, which XLA folds away.
    """
    from splat_tpu.ops.sh import eval_sh_cols
    from splat_tpu.ops.transforms import compute_cov6_cols

    view = camera.view_matrix()
    # Pinhole intrinsics protocol (Camera/SE3Camera.intrinsics_px): the
    # orbit camera returns fx = fy = focal with a centered principal
    # point (reference src/camera.rs:84-89); an SE3Camera may carry
    # COLMAP-style fx != fy and off-center (cx0, cy0).
    fx, fy, cx0, cy0 = camera.intrinsics_px()
    (mx, my, mz), q4, s3, opacity, shs = _scene_cols(scene)

    if config.cov3d_transpose:
        # Notebook convention R^T diag(s^2) R (PARITY.md): conjugating
        # the quaternion transposes its rotation matrix, so the same
        # elementwise cov6 math serves both orderings.
        qw, qx, qy, qz = q4
        q4 = (qw, -qx, -qy, -qz)
    cov6 = compute_cov6_cols(q4, s3)

    # Camera-space position, elementwise (view rows broadcast over N).
    px = view[0, 0] * mx + view[0, 1] * my + view[0, 2] * mz + view[0, 3]
    py = view[1, 0] * mx + view[1, 1] * my + view[1, 2] * mz + view[1, 3]
    pz = view[2, 0] * mx + view[2, 1] * my + view[2, 2] * mz + view[2, 3]

    # EWA 2D covariance (same math as ewa_project_packed: the reference's
    # truncation discards the perspective-skew Jacobian entries, so only
    # the first two view-rotation rows u, v reach the result).
    xx, xy_, xz, yy, yz, zz = cov6
    u = (view[0, 0], view[0, 1], view[0, 2])
    v = (view[1, 0], view[1, 1], view[1, 2])

    def quad(p, q):  # p^T Sigma q, elementwise over N
        return (xx * (p[0] * q[0]) + yy * (p[1] * q[1]) + zz * (p[2] * q[2])
                + xy_ * (p[0] * q[1] + p[1] * q[0])
                + xz * (p[0] * q[2] + p[2] * q[0])
                + yz * (p[1] * q[2] + p[2] * q[1]))

    # J = diag(fx, fy)/tz (anisotropic when fx != fy; the reference's
    # square-pixel case reduces to the single (focal/tz)² scale).
    sx = fx / pz
    sy = fy / pz
    a = (sx * sx) * quad(u, u) + config.lowpass
    b = (sx * sy) * quad(u, v)
    c = (sy * sy) * quad(v, v) + config.lowpass

    det = a * c - b * b
    det_safe = jnp.where(det > 0, det, 1.0)
    inv_det = 1.0 / det_safe
    conic = jnp.stack([c * inv_det, -b * inv_det, a * inv_det], axis=-1)

    # Splat half-extents.  The reference paints a fixed sigma_cutoff (3σ)
    # quad (src/pipelines.rs:27) and lets the fragment α-test kill pixels
    # below alpha_min (src/pipelines.rs:140-143).  The final image only
    # contains pixels with α >= alpha_min, so the bbox may shrink to the
    # opacity-aware radius LOSSLESSLY: by the marginal bound
    # min_dy Q(dx, dy) = dx²/Σxx, any pixel with
    # |dx| > sqrt(Σxx · 2·ln(opacity/alpha_min)) has α < alpha_min and is
    # dropped by the kernel's own cutoff anyway.  This cuts (gaussian, tile)
    # pair counts at N-cost — the key scale-by-N lever for binning.
    cut2 = jnp.asarray(config.sigma_cutoff, jnp.float32) ** 2
    if config.tight_radius:
        qmax = 2.0 * jnp.log(
            jnp.maximum(opacity / config.alpha_min, 1e-12))
        cut2 = jnp.minimum(cut2, jnp.maximum(qmax, 0.0))
    rx = jnp.sqrt(cut2 * jnp.maximum(a, 0.0))
    ry = jnp.sqrt(cut2 * jnp.maximum(c, 0.0))

    # Camera space -> pixel center via the pinhole intrinsics
    # (reference src/pipelines.rs:37-48 goes through the clip-space
    # matrix; with w_clip = -z that reduces to exactly
    # x_px = cx0 + fx·x/(-z), y_px = cy0 - fy·y/(-z) — the pixel mapping
    # of notes/util.py:109-111 == camera.ndc_to_pixel, generalized to
    # off-center principal points).
    clip_w = -pz
    cx = cx0 + fx * (px / clip_w)
    cy = cy0 - fy * (py / clip_w)

    depth = -pz                                   # view depth >0 in front

    # View-dependent color: SH is evaluated from the ORBITED eye — a
    # deliberate deviation from the reference, which computes ray directions
    # from the un-orbited base position (src/pipelines.rs:99 uses
    # camera.position, and camera.rs:41-68 never writes the rotated position
    # back), so its colors don't follow the orbit.  Using the true eye is
    # the physically-correct behavior; the oracle shares this convention and
    # tests/test_render_parity.py pins it at nonzero yaw.  See PARITY.md.
    # config.sh_stale_eye opts back into the reference's stale-eye bug.
    eye = camera.sh_eye(config.sh_stale_eye)
    rdx = mx - eye[0]
    rdy = my - eye[1]
    rdz = mz - eye[2]
    rinv = 1.0 / jnp.maximum(
        jnp.sqrt(rdx * rdx + rdy * rdy + rdz * rdz), 1e-12)
    col_r, col_g, col_b = eval_sh_cols(shs, rdx * rinv, rdy * rinv,
                                       rdz * rinv, config.sh_degree)

    # Visibility: in front of near plane, positive-definite cov2d, bbox
    # overlapping the screen.  The reference has no culling (splats behind
    # the camera are clipped by euc); culling only removes zero-contribution
    # splats so parity is unaffected.
    visible = ((depth > camera.znear)
               & (det > 0)
               & (cx + rx > 0) & (cx - rx < camera.w)
               & (cy + ry > 0) & (cy - ry < camera.h)
               & jnp.isfinite(cx) & jnp.isfinite(cy)
               # peak α = min(clamp, opacity·e⁰) — below alpha_min the splat
               # can never pass the kernel's cutoff at any pixel (lossless)
               & (opacity >= config.alpha_min))

    if config.render_mode == "depth":
        dn = encode_depth_color(depth, visible, config)
        col_r = col_g = col_b = dn

    return ProjectedGaussians(depth=depth,
                              center_px=jnp.stack([cx, cy], axis=-1),
                              conic=conic,
                              radius_px=jnp.stack([rx, ry], axis=-1),
                              color=jnp.stack([col_r, col_g, col_b],
                                              axis=-1),
                              opacity=opacity,
                              visible=visible)
