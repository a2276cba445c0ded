"""Golden-image oracle: a slow, exact NumPy renderer.

Independent re-implementation of the reference's per-pixel semantics
(notebook cell 3 ``plot_opacity`` / Rust fragment+blend at
src/pipelines.rs:127-168) used to validate the device renderers.  Deliberately
written in plain double-loop-free NumPy, sharing **no** code with the JAX
path, so agreement is meaningful.

Semantics (and deliberate deviations from reference quirks, per SURVEY §7):

* cov3d = R diag(s^2) R^T (active Rust renderer, src/gaussians.rs:111; the
  notebook's transposed variant is NOT used);
* EWA projection identical to both reference paths, low-pass +0.3 (SoA /
  notebook value);
* full SH degree selectable (reference Rust caps at degree 2 via sh_dim=15);
* pixel offsets evaluated exactly at integer pixel coordinates via the
  affine center mapping (the notebook's linspace-over-bbox sampling is an
  approximation of this; local +y points up: dy = cy - py);
* alpha cutoff tests alpha (the notebook's cell-3 bug tests a stale
  ``opacity`` variable — SURVEY §2.1 'Notebook prototype');
* back-to-front 'over' compositing onto the config.background canvas
  (the reference clears its framebuffer to 0 each frame, src/main.rs:73;
  a nonzero background is this engine's extension and must match the
  tiled path's front-to-back "+ T * background" term exactly), float32
  accumulation, final clip to [0, 1].
"""

from __future__ import annotations

import numpy as np

from splat_tpu.config import RenderConfig


def _np_look_at(eye, center, up):
    f = center - eye
    f = f / np.linalg.norm(f)
    s = np.cross(f, up)
    s = s / np.linalg.norm(s)
    u = np.cross(s, f)
    m = np.eye(4, dtype=np.float64)
    m[0, :3], m[1, :3], m[2, :3] = s, u, -f
    m[0, 3], m[1, 3], m[2, 3] = -s @ eye, -u @ eye, f @ eye
    return m


def _np_perspective(fovy, aspect, znear, zfar):
    t = np.tan(fovy / 2)
    m = np.zeros((4, 4), np.float64)
    m[0, 0] = 1 / (aspect * t)
    m[1, 1] = 1 / t
    m[2, 2] = -(zfar + znear) / (zfar - znear)
    m[2, 3] = -2 * zfar * znear / (zfar - znear)
    m[3, 2] = -1
    return m


def _np_quat_to_rot(q):
    q = q / np.linalg.norm(q)
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def _np_eval_sh(sh, d, degree):
    c0 = 0.28209479177387814
    c1 = 0.4886025119029199
    c2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
          -1.0925484305920792, 0.5462742152960396)
    c3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
          0.3731763325901154, -0.4570457994644658, 1.445305721320277,
          -0.5900435899266435)
    color = c0 * sh[0]
    if degree >= 1:
        x, y, z = d
        color = color - c1 * y * sh[1] + c1 * z * sh[2] - c1 * x * sh[3]
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        color = (color + c2[0] * xy * sh[4] + c2[1] * yz * sh[5]
                 + c2[2] * (2 * zz - xx - yy) * sh[6]
                 + c2[3] * xz * sh[7] + c2[4] * (xx - yy) * sh[8])
    if degree >= 3:
        color = (color
                 + c3[0] * y * (3 * xx - yy) * sh[9]
                 + c3[1] * xy * z * sh[10]
                 + c3[2] * y * (4 * zz - xx - yy) * sh[11]
                 + c3[3] * z * (2 * zz - 3 * xx - 3 * yy) * sh[12]
                 + c3[4] * x * (4 * zz - xx - yy) * sh[13]
                 + c3[5] * z * (xx - yy) * sh[14]
                 + c3[6] * x * (xx - 3 * yy) * sh[15])
    return color + 0.5


def _auto_depth_range(d, view, intr, h, w, znear, config):
    """Visible depth min/max with the PROJECTION's visibility rule.

    Depth mode's auto range normalizes by the frame's visible depth
    min/max as ops/projection.encode_depth_color defines "visible":
    depth > znear, positive-definite cov2d, opacity >= alpha_min, and the
    (tight_radius-aware) bbox intersecting the screen.  The oracle's own
    paint loop uses the plain sigma_cutoff quad (a superset — pixels
    outside the tight radius fail alpha_min anyway), so the range must be
    computed with the projection rule, not the paint rule.
    """
    fx, fy, cx0, cy0 = intr
    lo, hi = np.inf, -np.inf
    for i in range(d["means"].shape[0]):
        pos_cam = view[:3, :3] @ d["means"][i] + view[:3, 3]
        depth = -pos_cam[2]
        if depth <= znear or d["opacities"][i] < config.alpha_min:
            continue
        rot = _np_quat_to_rot(d["quats"][i])
        if config.cov3d_transpose:
            rot = rot.T            # notebook R^T S^2 R (PARITY.md)
        cov3d = rot @ np.diag(d["scales"][i] ** 2) @ rot.T
        w2 = view[:3, :3].T[:, :2]
        sc = np.array([fx, fy]) / pos_cam[2]
        cov2d = ((sc[:, None] * sc[None, :]) * (w2.T @ cov3d @ w2)
                 + config.lowpass * np.eye(2))
        det = cov2d[0, 0] * cov2d[1, 1] - cov2d[0, 1] ** 2
        if det <= 0:
            continue
        cut2 = config.sigma_cutoff ** 2
        if config.tight_radius:
            qmax = 2.0 * np.log(max(d["opacities"][i] / config.alpha_min,
                                    1e-12))
            cut2 = min(cut2, max(qmax, 0.0))
        rx = np.sqrt(cut2 * max(cov2d[0, 0], 0.0))
        ry = np.sqrt(cut2 * max(cov2d[1, 1], 0.0))
        cx = cx0 + fx * pos_cam[0] / -pos_cam[2]
        cy = cy0 - fy * pos_cam[1] / -pos_cam[2]
        if not (np.isfinite(cx) and np.isfinite(cy)):
            continue
        if cx + rx <= 0 or cx - rx >= w or cy + ry <= 0 or cy - ry >= h:
            continue
        lo = min(lo, depth)
        hi = max(hi, depth)
    if not np.isfinite(lo):
        return 0.0, 1.0
    return (lo, hi) if hi > lo else (lo, lo + 1.0)


def render_oracle(scene, camera, config: RenderConfig | None = None):
    """Render with plain NumPy.  Returns float32 (H, W, 3) in [0, 1]."""
    import jax  # local import; only used to pull arrays to host

    config = config or RenderConfig()
    d = {k: np.asarray(v, np.float64) for k, v in {
        "means": scene.means, "quats": scene.quats, "scales": scene.scales,
        "opacities": scene.opacities, "sh": scene.sh}.items()}
    # Supersampled AA mirrors the device renderers: evaluate at ss x the
    # resolution (pixel-unit intrinsics scale with h, so the field of
    # view is unchanged) and box-filter down at the end.
    ss = config.supersample
    h, w = camera.h * ss, camera.w * ss
    znear = float(jax.device_get(camera.znear))
    if hasattr(camera, "view"):
        # SE3Camera: explicit world-to-camera + pinhole intrinsics
        # (fx != fy / off-center principal point supported).
        cam_ss = camera.scaled(ss) if ss > 1 else camera
        view = np.asarray(jax.device_get(cam_ss.view), np.float64)
        fx = float(jax.device_get(cam_ss.fx))
        fy = float(jax.device_get(cam_ss.fy))
        cx0 = float(jax.device_get(cam_ss.cx))
        cy0 = float(jax.device_get(cam_ss.cy))
        eye = -view[:3, :3].T @ view[:3, 3]
        sh_origin = eye            # no orbit state to go stale
    else:
        eye = np.asarray(jax.device_get(camera.eye()), np.float64)
        # sh_stale_eye: SH rays from the UN-ORBITED base position, the
        # reference viewer's stale-state bug (src/pipelines.rs:99;
        # PARITY.md) — the view matrix still uses the orbited eye.
        sh_origin = (np.asarray(jax.device_get(camera.position),
                                np.float64)
                     if config.sh_stale_eye else eye)
        target = np.asarray(jax.device_get(camera.target), np.float64)
        up = np.asarray(jax.device_get(camera.up), np.float64)
        fovy = float(jax.device_get(camera.fovy))
        view = _np_look_at(eye, target, up)
        htany = np.tan(fovy / 2)
        fx = fy = h / (2 * htany)
        cx0, cy0 = w / 2, h / 2

    n = d["means"].shape[0]
    # Back-to-front paint order: ascending camera-space z (most negative =
    # farthest first), reference src/gaussians.rs:297-306.
    z_cam = (d["means"] @ view[:3, :3].T + view[:3, 3])[:, 2]
    order = np.argsort(z_cam, kind="stable")

    depth_lo = depth_hi = None
    if config.render_mode == "depth":
        if config.depth_range is not None:
            depth_lo, depth_hi = (float(config.depth_range[0]),
                                  float(config.depth_range[1]))
        else:
            depth_lo, depth_hi = _auto_depth_range(
                d, view, (fx, fy, cx0, cy0), h, w, znear, config)

    img = np.broadcast_to(
        np.asarray(config.background, np.float64), (h, w, 3)).copy()
    # alpha_channel: T = prod(1 - alpha_i) is order-independent, so the
    # back-to-front paint loop can accumulate it directly.
    trans = np.ones((h, w), np.float64)
    for i in order:
        mean = d["means"][i]
        pos_cam = view[:3, :3] @ mean + view[:3, 3]
        depth = -pos_cam[2]
        if depth <= znear:
            continue
        rot = _np_quat_to_rot(d["quats"][i])
        if config.cov3d_transpose:
            rot = rot.T            # notebook R^T S^2 R (PARITY.md)
        cov3d = rot @ np.diag(d["scales"][i] ** 2) @ rot.T
        w2 = view[:3, :3].T[:, :2]
        sc = np.array([fx, fy]) / pos_cam[2]
        cov2d = (sc[:, None] * sc[None, :]) * (w2.T @ cov3d @ w2)
        cov2d = cov2d + config.lowpass * np.eye(2)
        det = cov2d[0, 0] * cov2d[1, 1] - cov2d[0, 1] ** 2
        if det <= 0:
            continue
        conic_a = cov2d[1, 1] / det
        conic_b = -cov2d[0, 1] / det
        conic_c = cov2d[0, 0] / det

        cx = cx0 + fx * pos_cam[0] / -pos_cam[2]
        cy = cy0 - fy * pos_cam[1] / -pos_cam[2]
        rx = config.sigma_cutoff * np.sqrt(cov2d[0, 0])
        ry = config.sigma_cutoff * np.sqrt(cov2d[1, 1])
        # sigma_cutoff=inf (truncation-free mode): the loop bounds span the
        # whole screen and the |dx|<=rx quad test below is vacuous; only
        # the alpha_min cutoff limits the splat's support.
        rxi = rx if np.isfinite(rx) else abs(cx) + w
        ryi = ry if np.isfinite(ry) else abs(cy) + h
        x1 = max(int(np.floor(cx - rxi)), 0)
        x2 = min(int(np.ceil(cx + rxi)) + 1, w)
        y1 = max(int(np.floor(cy - ryi)), 0)
        y2 = min(int(np.ceil(cy + ryi)) + 1, h)
        if x1 >= x2 or y1 >= y2:
            continue

        raydir = mean - sh_origin
        raydir = raydir / np.linalg.norm(raydir)
        color = _np_eval_sh(d["sh"][i], raydir, config.sh_degree)
        if config.render_mode == "depth":
            dn = np.clip((depth - depth_lo) / (depth_hi - depth_lo),
                         0.0, 1.0)
            color = np.full((3,), dn)

        xs = np.arange(x1, x2, dtype=np.float64)
        ys = np.arange(y1, y2, dtype=np.float64)
        dx = (xs - cx)[None, :]
        dy = (cy - ys)[:, None]  # local +y is up on screen
        power = (-0.5 * (conic_a * dx * dx + conic_c * dy * dy)
                 - conic_b * dx * dy)
        alpha = np.minimum(config.alpha_clamp,
                           d["opacities"][i] * np.exp(power))
        alpha = np.where(power > 0, 0.0, alpha)
        alpha = np.where(alpha < config.alpha_min, 0.0, alpha)
        # Quad-coverage model: the reference paints only the sigma_cutoff
        # quad (src/pipelines.rs:27-34); model it as the continuous rectangle
        # |dx| <= rx, |dy| <= ry (see module docstring).
        inside = (np.abs(dx) <= rx) & (np.abs(dy) <= ry)
        alpha = np.where(inside, alpha, 0.0)
        tile = img[y1:y2, x1:x2]
        img[y1:y2, x1:x2] = (tile * (1 - alpha[..., None])
                             + color[None, None, :] * alpha[..., None])
        trans[y1:y2, x1:x2] *= 1 - alpha

    if config.alpha_channel:
        img = np.concatenate([img, (1 - trans)[..., None]], axis=-1)
    img = np.clip(img, 0.0, 1.0)
    if ss > 1:
        from splat_tpu.utils.image import box_downsample

        img = box_downsample(img, ss)
    return img.astype(np.float32)
