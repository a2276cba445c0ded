"""Gaussian scene data model.

The reference keeps two copies of the model: an AoS ``Gaussian`` struct
(reference: src/gaussians.rs:31-38) and a column-major SoA ``GaussianList``
(src/gaussians.rs:408-416).  On an accelerator only the SoA layout makes
sense — each field is one device-resident array the kernels stream over — so
that is the single data model here.

All activation functions (exp on scales, sigmoid on opacity, quaternion
normalization — reference: src/gaussians.rs:265-268, notes/util_gau.py:98-105)
are applied at load time; the arrays stored here are the *activated* values.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


@partial(jax.tree_util.register_dataclass,
         data_fields=["means", "quats", "scales", "opacities", "sh"],
         meta_fields=[])
@dataclasses.dataclass(frozen=True)
class GaussianScene:
    """SoA batch of N gaussians (a pytree; every field is a leaf array).

    Attributes:
      means: (N, 3) float32 world-space centers (mean-centered at load, per
        reference src/gaussians.rs:394-402).
      quats: (N, 4) float32 unit quaternions, scalar-first (w, x, y, z) — the
        PLY order rot_0..rot_3 (reference src/gaussians.rs:269-272 stores
        rot_0 into the w slot).
      scales: (N, 3) float32, exp-activated.
      opacities: (N,) float32 in (0, 1), sigmoid-activated.
      sh: (N, 16, 3) float32 spherical-harmonics coefficients, coefficient-
        major with interleaved RGB channels — sh[:, 0] is the DC term
        (f_dc_0..2) and sh[:, 1:] the 15 higher-order coefficients after the
        channel-major -> coefficient-major transpose the loaders perform
        (reference notes/util_gau.py:82-84).
    """

    means: jax.Array
    quats: jax.Array
    scales: jax.Array
    opacities: jax.Array
    sh: jax.Array

    @property
    def num_gaussians(self) -> int:
        return self.means.shape[0]

    def __len__(self) -> int:
        return self.num_gaussians

    @classmethod
    def create(cls, means, quats, scales, opacities, sh) -> "GaussianScene":
        """Build a scene from array-likes, validating shapes and dtypes.

        Host-built scenes keep NumPy leaves (JAX transfers them on first
        dispatch; use :meth:`to_device` to pin them in HBM for render
        loops).  Device-array inputs are kept as-is — they are never pulled
        back to the host here.
        """
        on_device = any(
            isinstance(a, jax.Array) for a in (means, quats, scales,
                                               opacities, sh))
        xp = jnp if on_device else np
        means = xp.asarray(means, xp.float32)
        quats = xp.asarray(quats, xp.float32)
        scales = xp.asarray(scales, xp.float32)
        opacities = xp.asarray(opacities, xp.float32).reshape(-1)
        sh = xp.asarray(sh, xp.float32)
        n = means.shape[0]
        if sh.ndim == 2:  # (N, 48) flat layout -> (N, 16, 3)
            sh = sh.reshape(n, -1, 3)
        if sh.shape[1] < 16:  # pad missing high-order coefficients with zeros
            pad = 16 - sh.shape[1]
            sh = xp.pad(sh, ((0, 0), (0, pad), (0, 0)))
        chex_shapes = {
            "means": (means.shape, (n, 3)),
            "quats": (quats.shape, (n, 4)),
            "scales": (scales.shape, (n, 3)),
            "opacities": (opacities.shape, (n,)),
            "sh": (sh.shape, (n, 16, 3)),
        }
        for name, (got, want) in chex_shapes.items():
            if got != want:
                raise ValueError(f"{name}: expected shape {want}, got {got}")
        return cls(means=means, quats=quats, scales=scales,
                   opacities=opacities, sh=sh)

    def pad_to(self, n: int) -> "GaussianScene":
        """Pad with fully-transparent degenerate gaussians up to n rows.

        Padding splats have opacity 0 and are placed far behind any plausible
        camera so they never contribute; static sizes keep jit caches warm
        across scenes of different N.
        """
        cur = self.num_gaussians
        if n < cur:
            raise ValueError(f"pad_to({n}) smaller than current N={cur}")
        if n == cur:
            return self
        pad = n - cur
        xp = jnp if isinstance(self.means, jax.Array) else np
        return GaussianScene(
            means=xp.concatenate(
                [self.means, xp.full((pad, 3), 1e8, xp.float32)]),
            quats=xp.concatenate(
                [self.quats,
                 xp.tile(xp.asarray([[1., 0., 0., 0.]], dtype=xp.float32),
                         (pad, 1))]),
            scales=xp.concatenate(
                [self.scales, xp.full((pad, 3), 1e-8, xp.float32)]),
            opacities=xp.concatenate(
                [self.opacities, xp.zeros((pad,), xp.float32)]),
            sh=xp.concatenate(
                [self.sh, xp.zeros((pad, 16, 3), xp.float32)]),
        )

    def slice(self, start: int, stop: int) -> "GaussianScene":
        return jax.tree.map(lambda a: a[start:stop], self)

    def permuted(self, seed: int = 0) -> "GaussianScene":
        """Randomly permute the gaussian order (host-side).

        Rendering is order-independent (depth sorting happens per frame),
        but SHARDING is not: the a2a slab routing's per-(src, dst)
        capacity assumes shards are spatially uncorrelated, and scenes
        stored in spatial order (common in pretrained .ply exports) can
        concentrate a whole shard into one slab (the surface fixture
        does).  Shuffle once before
        sharding to restore the i.i.d. assumption.
        """
        perm = np.random.default_rng(seed).permutation(self.num_gaussians)
        return jax.tree.map(lambda a: a[perm], self)

    def to_device(self, device=None) -> "GaussianScene":
        """Pin all leaves in device memory (one transfer; subsequent jit
        calls reuse the resident buffers instead of re-uploading)."""
        return jax.tree.map(lambda a: jax.device_put(a, device), self)

    def pack_device(self, device=None) -> "DeviceScene":
        """Transpose to the feature-major DeviceScene layout and pin it.

        The hot render path wants every per-gaussian quantity as one dense
        (N,) device stream; (N, 3)/(N, 4)/(N, 16, 3) arrays force strided
        column reads.
        The transpose happens ONCE here, on the host when the leaves are
        NumPy (contiguous memcpy per component), then one device_put.
        The default-device result is memoized on the (immutable) scene so
        per-frame callers of the auto-packing ``render()`` do not re-slice
        and re-upload every call; derived scenes (pad_to/permuted/...) are
        new instances and never see a stale cache.
        """
        if device is None:
            cached = getattr(self, "_packed_cache", None)
            if cached is not None:
                return cached
        host = not isinstance(self.means, jax.Array)
        col = (lambda a: np.ascontiguousarray(a)) if host else (lambda a: a)
        m, q, s = self.means, self.quats, self.scales
        cols = DeviceScene(
            mx=col(m[:, 0]), my=col(m[:, 1]), mz=col(m[:, 2]),
            qw=col(q[:, 0]), qx=col(q[:, 1]), qy=col(q[:, 2]),
            qz=col(q[:, 3]),
            sx=col(s[:, 0]), sy=col(s[:, 1]), sz=col(s[:, 2]),
            opacities=self.opacities,
            sh=tuple(col(self.sh[:, k, c])
                     for k in range(16) for c in range(3)),
        )
        out = jax.tree.map(lambda a: jax.device_put(a, device), cols)
        if device is None:
            object.__setattr__(self, "_packed_cache", out)
        return out

    def to_numpy(self) -> dict[str, np.ndarray]:
        return {f.name: np.asarray(getattr(self, f.name))
                for f in dataclasses.fields(self)}


@partial(jax.tree_util.register_dataclass,
         data_fields=["mx", "my", "mz", "qw", "qx", "qy", "qz",
                      "sx", "sy", "sz", "opacities", "sh"],
         meta_fields=[])
@dataclasses.dataclass(frozen=True)
class DeviceScene:
    """Feature-major scene: one dense (N,) device array per component.

    The device twin of GaussianScene for render hot loops — every
    projection input is a contiguous (N,) stream (no strided column
    slices).  Produced by
    :meth:`GaussianScene.pack_device`; consumed structurally by
    ``ops.projection._scene_cols``.  ``sh`` is a 48-tuple of (N,) leaves,
    coefficient-major with interleaved RGB: ``sh[3 * k + c]`` is
    coefficient k of channel c (same ordering as GaussianScene.sh).
    """

    mx: jax.Array
    my: jax.Array
    mz: jax.Array
    qw: jax.Array
    qx: jax.Array
    qy: jax.Array
    qz: jax.Array
    sx: jax.Array
    sy: jax.Array
    sz: jax.Array
    opacities: jax.Array
    sh: tuple

    @property
    def num_gaussians(self) -> int:
        return self.mx.shape[0]

    def __len__(self) -> int:
        return self.num_gaussians
