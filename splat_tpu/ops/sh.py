"""Real spherical-harmonics color evaluation, degrees 0-3.

Constants and band combinations mirror reference src/gaussians.rs:11-26 and
:41-99 (which in turn follow the INRIA CUDA snippet quoted in notes.md), with
the same sign pattern for degree 1 (``- C1*y*c1 + C1*z*c2 - C1*x*c3``) and the
final +0.5 shift.

Differences from the reference, by design:
* ``degree`` is a static argument instead of the float-count ``sh_dim``
  gating (sh_dim>3 / >12 / >27 at src/gaussians.rs:46,61,77).  degree 2
  corresponds to the Rust renderer's hard-coded sh_dim=15.
* evaluation is batched over N on the device, not per-quad-corner (the reference
  re-evaluates SH 6x per gaussian, once per quad vertex —
  src/pipelines.rs:96-125; that waste has no equivalent here).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)


def eval_sh(sh: jax.Array, dirs: jax.Array, degree: int) -> jax.Array:
    """Evaluate view-dependent color.

    Args:
      sh: (..., 16, 3) coefficients (DC first, interleaved RGB).
      dirs: (..., 3) unit view directions (gaussian center - camera eye,
        normalized; reference src/pipelines.rs:99).
      degree: static int in [0, 3].

    Returns:
      (..., 3) color with the +0.5 shift applied (not clamped; the rasterizer
      clamps at the end, matching the notebook's final clip).
    """
    if not 0 <= degree <= 3:
        raise ValueError(f"degree must be in [0,3], got {degree}")
    c = jnp.moveaxis(sh, -2, 0)  # (16, ..., 3)
    color = SH_C0 * c[0]
    if degree >= 1:
        x = dirs[..., 0:1]
        y = dirs[..., 1:2]
        z = dirs[..., 2:3]
        color = color - SH_C1 * y * c[1] + SH_C1 * z * c[2] - SH_C1 * x * c[3]
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        color = (color
                 + SH_C2[0] * xy * c[4]
                 + SH_C2[1] * yz * c[5]
                 + SH_C2[2] * (2.0 * zz - xx - yy) * c[6]
                 + SH_C2[3] * xz * c[7]
                 + SH_C2[4] * (xx - yy) * c[8])
    if degree >= 3:
        color = (color
                 + SH_C3[0] * y * (3.0 * xx - yy) * c[9]
                 + SH_C3[1] * xy * z * c[10]
                 + SH_C3[2] * y * (4.0 * zz - xx - yy) * c[11]
                 + SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy) * c[12]
                 + SH_C3[4] * x * (4.0 * zz - xx - yy) * c[13]
                 + SH_C3[5] * z * (xx - yy) * c[14]
                 + SH_C3[6] * x * (xx - 3.0 * yy) * c[15])
    return color + 0.5


def eval_sh_cols(shs, x, y, z, degree: int):
    """Column form of eval_sh: 48 dense (N,) coefficient streams in,
    (r, g, b) columns out.

    shs[k * 3 + c] is coefficient k of channel c (the DeviceScene layout,
    scene.py) — the hot projection path reads each coefficient as one
    dense (N,) HBM stream instead of strided slices of an (N, 16, 3)
    array.  x/y/z are the unit view-direction components.  Same band
    polynomials and +0.5 shift as eval_sh.
    """
    if not 0 <= degree <= 3:
        raise ValueError(f"degree must be in [0,3], got {degree}")

    def band(k):
        return shs[3 * k], shs[3 * k + 1], shs[3 * k + 2]

    out = [SH_C0 * c for c in band(0)]
    if degree >= 1:
        for i, c in enumerate(band(1)):
            out[i] = out[i] - SH_C1 * y * c
        for i, c in enumerate(band(2)):
            out[i] = out[i] + SH_C1 * z * c
        for i, c in enumerate(band(3)):
            out[i] = out[i] - SH_C1 * x * c
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        basis2 = (SH_C2[0] * xy, SH_C2[1] * yz,
                  SH_C2[2] * (2.0 * zz - xx - yy),
                  SH_C2[3] * xz, SH_C2[4] * (xx - yy))
        for k, bk in enumerate(basis2):
            for i, c in enumerate(band(4 + k)):
                out[i] = out[i] + bk * c
    if degree >= 3:
        basis3 = (SH_C3[0] * y * (3.0 * xx - yy),
                  SH_C3[1] * xy * z,
                  SH_C3[2] * y * (4.0 * zz - xx - yy),
                  SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
                  SH_C3[4] * x * (4.0 * zz - xx - yy),
                  SH_C3[5] * z * (xx - yy),
                  SH_C3[6] * x * (xx - 3.0 * yy))
        for k, bk in enumerate(basis3):
            for i, c in enumerate(band(9 + k)):
                out[i] = out[i] + bk * c
    return out[0] + 0.5, out[1] + 0.5, out[2] + 0.5


def rgb_to_dc(rgb: jax.Array) -> jax.Array:
    """Inverse of the DC band: encode plain RGB into sh[...,0,:].

    The reference builds its synthetic fixture this way:
    ``(color - 0.5) / 0.28209`` (src/gaussians.rs:330, note the truncated
    constant there; we use the full-precision SH_C0).
    """
    return (jnp.asarray(rgb, jnp.float32) - 0.5) / SH_C0
