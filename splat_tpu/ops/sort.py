"""Depth ordering helpers — public twins of the reference sort API.

Reference: ``sort_gaussians`` / ``sort_gaussians_by_depth`` / the SoA
``GaussianList::sort`` (src/gaussians.rs:297-317, :464-471): project centers
into camera space, argsort ascending by camera-space z.  With the RH
``look_at`` frame visible points have negative z, so ascending order is
farthest-first — the painter's (back-to-front) order.

On the device these are one fused elementwise pass + ``jnp.argsort``; the renderers
use the front-to-back variant internally.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from splat_tpu.camera import Camera


def camera_space_z(means, view: jax.Array) -> jax.Array:
    """(N,) camera-space z of world-space points (negative in front)."""
    means = jnp.asarray(means)
    return (view[2, 0] * means[:, 0] + view[2, 1] * means[:, 1]
            + view[2, 2] * means[:, 2] + view[2, 3])


def sort_gaussians(scene, camera: Camera) -> jax.Array:
    """Back-to-front (painter's) order — reference semantics."""
    return jnp.argsort(camera_space_z(scene.means, camera.view_matrix()))


def sort_gaussians_front_to_back(scene, camera: Camera) -> jax.Array:
    """Front-to-back order (what the compositing renderers consume)."""
    return jnp.argsort(-camera_space_z(scene.means, camera.view_matrix()))
