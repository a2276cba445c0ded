"""Quaternion / covariance transforms, batched over the gaussian axis.

The reference computes Sigma_3D = R diag(s^2) R^T one gaussian at a time in a
Rust loop (reference: src/gaussians.rs:101-113 AoS, :446-462 SoA).  Here the
whole batch is a couple of einsums the XLA fusion engine turns into one pass
over HBM.

Convention note: the reference's *notebook* computes the transposed ordering
R^T diag(s^2) R (notes/00_Gaussian_Projection.ipynb cell 1), which is a
different (still symmetric) matrix.  The active Rust renderer uses
R diag(s^2) R^T, which is also what the INRIA GLSL derivation in notes.md
reduces to — we match the Rust renderer.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def quat_to_rotmat(quats: jax.Array) -> jax.Array:
    """(N, 4) scalar-first quaternions -> (N, 3, 3) rotation matrices.

    Quaternions are normalized first (nalgebra's UnitQuaternion does the same
    at reference src/gaussians.rs:103; the Python loader normalizes at
    notes/util_gau.py:100).
    """
    q = quats / jnp.maximum(
        jnp.linalg.norm(quats, axis=-1, keepdims=True), 1e-12)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - w * z)
    r02 = 2 * (x * z + w * y)
    r10 = 2 * (x * y + w * z)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - w * x)
    r20 = 2 * (x * z - w * y)
    r21 = 2 * (y * z + w * x)
    r22 = 1 - 2 * (x * x + y * y)
    rows = [
        jnp.stack([r00, r01, r02], axis=-1),
        jnp.stack([r10, r11, r12], axis=-1),
        jnp.stack([r20, r21, r22], axis=-1),
    ]
    return jnp.stack(rows, axis=-2)


def compute_cov3d(quats: jax.Array, scales: jax.Array) -> jax.Array:
    """(N,4),(N,3) -> (N,3,3) world-space covariances R diag(s^2) R^T.

    Reference: src/gaussians.rs:101-113 (one gaussian); here batched.
    """
    return unpack_cov3d(compute_cov3d_packed(quats, scales))


def compute_cov3d_packed(quats: jax.Array, scales: jax.Array) -> jax.Array:
    """(N,4),(N,3) -> (N,6) packed (xx, xy, xz, yy, yz, zz) covariances.

    Written as pure elementwise math: a batched (N,3,3) einsum is a
    batch of tiny matrix products that waste a matrix unit, while these
    fused multiply-adds over (N,) vectors are bandwidth-bound.
    """
    rot = quat_to_rotmat(quats)                    # (N,3,3) elementwise
    m = rot * scales[..., None, :]                 # R * s (columns scaled)
    mx, my, mz = m[..., 0, :], m[..., 1, :], m[..., 2, :]   # rows, (N,3)
    xx = jnp.sum(mx * mx, axis=-1)
    xy = jnp.sum(mx * my, axis=-1)
    xz = jnp.sum(mx * mz, axis=-1)
    yy = jnp.sum(my * my, axis=-1)
    yz = jnp.sum(my * mz, axis=-1)
    zz = jnp.sum(mz * mz, axis=-1)
    return jnp.stack([xx, xy, xz, yy, yz, zz], axis=-1)


def compute_cov6_cols(q, s):
    """Column form of compute_cov3d_packed: component tuples in, 6 out.

    q = (qw, qx, qy, qz), s = (sx, sy, sz), each a dense (N,) array;
    returns (xx, xy, xz, yy, yz, zz) columns of R diag(s^2) R^T.  Same
    math as the (N,4)/(N,3) entry points but with zero strided column
    slices — the projection hot path feeds it straight from a
    DeviceScene's component leaves (scene.py), keeping every HBM read a
    dense (N,) stream.
    """
    qw, qx, qy, qz = q
    sx, sy, sz = s
    inv = 1.0 / jnp.maximum(
        jnp.sqrt(qw * qw + qx * qx + qy * qy + qz * qz), 1e-12)
    w, x, y, z = qw * inv, qx * inv, qy * inv, qz * inv
    # rotation entries (same formulas as quat_to_rotmat), columns scaled
    m00 = (1 - 2 * (y * y + z * z)) * sx
    m01 = (2 * (x * y - w * z)) * sy
    m02 = (2 * (x * z + w * y)) * sz
    m10 = (2 * (x * y + w * z)) * sx
    m11 = (1 - 2 * (x * x + z * z)) * sy
    m12 = (2 * (y * z - w * x)) * sz
    m20 = (2 * (x * z - w * y)) * sx
    m21 = (2 * (y * z + w * x)) * sy
    m22 = (1 - 2 * (x * x + y * y)) * sz
    xx = m00 * m00 + m01 * m01 + m02 * m02
    xy = m00 * m10 + m01 * m11 + m02 * m12
    xz = m00 * m20 + m01 * m21 + m02 * m22
    yy = m10 * m10 + m11 * m11 + m12 * m12
    yz = m10 * m20 + m11 * m21 + m12 * m22
    zz = m20 * m20 + m21 * m21 + m22 * m22
    return xx, xy, xz, yy, yz, zz


def pack_cov3d(cov: jax.Array) -> jax.Array:
    """(N,3,3) symmetric -> (N,6) compact (xx, xy, xz, yy, yz, zz)."""
    return jnp.stack([cov[..., 0, 0], cov[..., 0, 1], cov[..., 0, 2],
                      cov[..., 1, 1], cov[..., 1, 2], cov[..., 2, 2]],
                     axis=-1)


def unpack_cov3d(packed: jax.Array) -> jax.Array:
    """(N,6) compact -> (N,3,3) symmetric."""
    xx, xy, xz, yy, yz, zz = [packed[..., i] for i in range(6)]
    rows = [
        jnp.stack([xx, xy, xz], axis=-1),
        jnp.stack([xy, yy, yz], axis=-1),
        jnp.stack([xz, yz, zz], axis=-1),
    ]
    return jnp.stack(rows, axis=-2)
