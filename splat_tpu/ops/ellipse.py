"""Ellipse-decomposition view of projected gaussians.

The reference carries an alternative (unused by its active pipeline, but
compiled and public) formulation from the 'splatter' project: instead of
rasterizing with the conic form, decompose the projected 2D gaussian into
explicit ellipse parameters — semi-axes, rotation, center
(reference: src/gaussians.rs:172-243, exercised only by the dead
src/bin/attempt03.rs).  Provided here, vectorized, because it is genuinely
useful: debug overlays, splat statistics, LOD heuristics.

All functions take the packed 2D covariance/conic produced by
:mod:`splat_tpu.ops.projection` and are elementwise over N.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def projected_covariance_of_ellipsoid(means, quats, scales, view,
                                      clamp: float = 1.0):
    """Reference ``projected_covariance_of_ellipsoid``
    (src/gaussians.rs:172-197), batched.

    Returns the full (N, 3, 3) homogeneous conic matrix T^T T with
    T = M^T R_c J, where M = diag(s) R is the gaussian's world transform,
    R_c the camera->world rotation, and J the (unit-focal) perspective
    Jacobian with view-plane coordinates clamped to +-clamp.
    """
    from splat_tpu.ops.transforms import quat_to_rotmat

    rot = quat_to_rotmat(quats)                       # (N,3,3)
    # reference scales ROWS of the rotation matrix (transform.row_mut(i) *=
    # scale[i], src/gaussians.rs:178-180) — i.e. M = diag(s) R.
    m = rot * scales[..., :, None]

    cam_rot = view[:3, :3].T                          # camera -> world
    pos_cam = means @ view[:3, :3].T + view[:3, 3]
    tz = pos_cam[:, 2]
    tx = jnp.clip(pos_cam[:, 0] / tz, -clamp, clamp) * tz
    ty = jnp.clip(pos_cam[:, 1] / tz, -clamp, clamp) * tz

    inv = 1.0 / tz
    n = means.shape[0]
    zeros = jnp.zeros_like(inv)
    j_mat = jnp.stack([
        jnp.stack([inv, zeros, -tx * inv * inv], -1),
        jnp.stack([zeros, inv, -ty * inv * inv], -1),
        jnp.stack([zeros, zeros, zeros], -1),
    ], -2)                                            # (N,3,3) row-major J

    # T = M^T R_c J ; covariance = T^T T  (src/gaussians.rs:193-194).
    # Small per-row contractions; N is the vector axis so keep everything
    # elementwise via explicit sums (no batched tiny matmuls).
    rcj = jnp.einsum("ab,nbc->nac", cam_rot, j_mat,
                     precision=jax.lax.Precision.HIGHEST)
    t = jnp.einsum("nba,nbc->nac", m, rcj,
                   precision=jax.lax.Precision.HIGHEST)
    return jnp.einsum("nba,nbc->nac", t, t,
                      precision=jax.lax.Precision.HIGHEST)


def extract_scale_of_covariance(cov2d_a, cov2d_b, cov2d_c):
    """Semi-major/minor axes of a 2x2 covariance (a, b; b, c) — batched twin
    of reference ``extract_scale_of_covariance`` (src/gaussians.rs:199-206).
    """
    d = (cov2d_a - cov2d_c) ** 2
    root = jnp.sqrt(d + 4.0 * cov2d_b * cov2d_b)
    major = jnp.sqrt(jnp.maximum((cov2d_a + cov2d_c + root) * 0.5, 0.0))
    minor = jnp.sqrt(jnp.maximum((cov2d_a + cov2d_c - root) * 0.5, 0.0))
    return major, minor


def extract_rotation_of_ellipse(cov2d_a, cov2d_b, cov2d_c):
    """(sin phi, cos phi) of the ellipse orientation via the half-angle
    identities — reference ``extract_rotation_of_ellipse``
    (src/gaussians.rs:208-230), batched and sign-convention preserved.
    """
    diff = cov2d_a - cov2d_c
    aa = diff * diff
    bb = aa + 4.0 * cov2d_b * cov2d_b
    c = 0.5 * jnp.sqrt(jnp.where(bb > 0, aa / jnp.where(bb > 0, bb, 1.0),
                                 0.0))
    j = jnp.sqrt(jnp.maximum(0.5 - c, 0.0))
    k = -jnp.sqrt(jnp.maximum(0.5 + c, 0.0)) * jnp.sign(cov2d_b) * \
        jnp.sign(diff)
    flip = (cov2d_b < 0) | (diff < 0)
    j2 = jnp.where(flip, -j, j)
    k2 = jnp.where(flip, -k, k)
    swap = diff < 0
    sin_phi = jnp.where(swap, -k2, j2)
    cos_phi = jnp.where(swap, j2, k2)
    return sin_phi, cos_phi


def extract_translation_of_ellipse(conic3):
    """Ellipse center from a homogeneous conic matrix (N, 3, 3) — reference
    ``extract_translation_of_ellipse`` (src/gaussians.rs:231-243): the
    extremum of the implicit curve via the roots of its partial derivatives.
    """
    a = conic3[:, 0, 0]
    b = conic3[:, 0, 1]
    c = conic3[:, 1, 1]
    d = conic3[:, 0, 2]
    e = conic3[:, 1, 2]
    disc = a * c - b * b
    inv = 1.0 / jnp.where(disc != 0, disc, 1.0)
    return jnp.stack([(b * e - c * d) * inv, (b * d - a * e) * inv], -1)
