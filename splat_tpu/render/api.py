"""Public render API: ``render(scene, camera, config) -> image``.

One jitted function from camera pose to image; only the pose is a per-frame
input (the reference's dirty-flag re-render loop at src/main.rs:69-78 maps to
"call the compiled function again with a new Camera pytree").
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from splat_tpu.camera import Camera
from splat_tpu.config import RenderConfig


def resolve_method(method: str, scene) -> str:
    """'auto' -> 'dense' for tiny scenes, 'tiled' otherwise."""
    if method == "auto":
        return "dense" if scene.num_gaussians <= 4096 else "tiled"
    return method


def render_fn(method: str = "auto", config: RenderConfig | None = None):
    """Return a jitted ``f(scene, camera) -> float32 (H, W, 3)`` renderer
    ((H, W, 4) RGBA when ``config.alpha_channel``; both methods agree).

    method: 'dense' (exact, O(N*H*W); small scenes / parity tests),
    'tiled' (tile-binned Pallas rasterizer; the production path), or
    'auto' (tiled unless the scene is tiny).
    """
    config = config or RenderConfig()

    def f(scene, camera: Camera):
        m = resolve_method(method, scene)
        if m == "dense":
            from splat_tpu.render.dense import render_dense
            return render_dense(scene, camera, config)
        elif m == "tiled":
            from splat_tpu.render.tiled import render_tiled
            return render_tiled(scene, camera, config)
        raise ValueError(f"unknown render method {method!r}")

    return jax.jit(f)


def auto_config(scene, camera: Camera, config: RenderConfig | None = None,
                *, headroom: float = 1.1,
                quantum: float = 0.25) -> RenderConfig:
    """Size ``max_dup_factor`` from the scene's measured pair load.

    Every K-sized binning op (expansion, sort, feature gather) scales
    with the capacity, so the default 4.0 costs ~2x the throughput of a
    tuned setting on typical scenes — and conversely a heavy-footprint
    scene can *overflow* 4.0.  This measures the true slot demand at the
    given pose (one cheap jit: projection + span counting, no render)
    and returns a config whose capacity is ``slots/N * headroom``,
    rounded UP to a multiple of ``quantum`` so nearby poses reuse the
    same compiled pipeline (capacity is a static shape: a new value
    recompiles).

    headroom: 1.1 suits rendering the measured pose; use ~1.25+ when one
    measurement must cover a pose sweep (orbit/serve).  The public
    paths' overflow audit remains the backstop either way — a pose that
    outgrows the sized capacity raises, never truncates silently.

    The reference needs no tuning knobs (its CPU pipeline has no
    capacity concept); with this, neither does the default path here.
    """
    import dataclasses
    import math

    config = config or RenderConfig()
    stats = pair_stats(scene, camera, config)
    n = max(scene.num_gaussians, 1)
    need = stats["slots"] / n * headroom
    dup = max(1.0, math.ceil(need / quantum) * quantum)
    return dataclasses.replace(config, max_dup_factor=dup)


@functools.partial(jax.jit, static_argnames=("config",))
def _count_pairs_jit(scene, camera, config):
    # Module-level so the jit cache persists across pair_stats calls: a
    # per-call closure would retrace+recompile for EVERY view of a
    # multi-view capacity audit (train._check_tiled_capacity); the pose
    # is a traced pytree leaf, so all views of one (shape, config) share
    # a single compile.
    from splat_tpu.ops.projection import project_gaussians
    from splat_tpu.render.binning import count_pairs

    proj = project_gaussians(scene, camera, config)
    return count_pairs(proj, camera.h, camera.w, config)


def pair_stats(scene, camera: Camera, config: RenderConfig | None = None):
    """Measure the scene's true (gaussian, tile) pair load at a pose.

    Returns a dict with ``visible``, ``num_pairs``, ``pairs_per_gaussian``,
    ``slots`` and ``suggested_dup_factor`` (true slot load + 25% headroom,
    floored at 1.25) — feed the suggestion into
    ``RenderConfig.max_dup_factor`` to shrink every K-sized binning op;
    the overflow stats on the public paths will catch a pose that
    outgrows it.

    The count comes from the binning stage's own span machinery
    (binning.count_pairs — same ceil-quantized radii), so the suggestion
    can never under-provision relative to what binning actually produces.
    ``slots`` is the capacity-relevant demand: with the default
    ``binning_key="depth"`` every invisible gaussian additionally spends
    ONE sentinel slot (binning.py step 2), so slots = pairs +
    (n - visible); in rank mode slots = pairs.
    """
    config = config or RenderConfig()
    if config.supersample > 1:
        # render_tiled bins at the supersampled resolution; the capacity
        # suggestion must count pairs at the same scale.
        camera = camera.scaled(config.supersample)

    visible, pairs = (int(x) for x in jax.device_get(
        _count_pairs_jit(scene, camera, config)))
    n = scene.num_gaussians
    slots = pairs + (n - visible if config.binning_key == "depth" else 0)
    per = pairs / max(n, 1)
    return {
        "visible": visible,
        "num_pairs": pairs,
        "pairs_per_gaussian": per,
        "slots": slots,
        "suggested_dup_factor": max(1.25, round(slots / max(n, 1) * 1.25,
                                                2)),
    }


# auto-sized configs keyed per scene OBJECT: the key carries id(scene)
# plus a weakref so a recycled id (the original scene GC'd, a new one
# allocated at the same address) can never serve a stale capacity —
# with check_overflow=False a stale UNDERsized config would truncate
# silently, the one failure mode the capacity design forbids.
_AUTO_CONFIG_CACHE: dict = {}


def render(scene, camera: Camera, config: RenderConfig | None = None,
           method: str = "auto", as_uint8: bool = False,
           check_overflow: bool = True):
    """Render one frame.  Convenience wrapper over :func:`render_fn`.

    When the tiled path is used, duplication-buffer overflow (pairs dropped
    because ``max_dup_factor`` was too small) is checked and raises — the
    capacity design promises no *silent* truncation.  Hot loops that want to
    skip the per-frame device sync should use :func:`render_fn` and audit
    overflow themselves via ``render_tiled(..., return_stats=True)``, or
    pass ``check_overflow=False``.
    """
    auto_capacity = config is None
    config = config or RenderConfig()
    m = resolve_method(method, scene)
    cache_key = None
    if m == "tiled":
        from splat_tpu.scene import GaussianScene
        if isinstance(scene, GaussianScene):
            # Feature-major DeviceScene is the tiled hot-path layout
            # ((N,) component streams; (N, 3)/(N, 16, 3) jit inputs pay
            # strided column reads — CLAUDE.md rule 15).  Hot loops
            # should pack ONCE and reuse: scene.pack_device().
            scene = scene.pack_device()
        if auto_capacity and scene.num_gaussians > 0:
            # No config given -> size the duplication capacity from the
            # measured pair load instead of the conservative default
            # (K-sized costs scale with capacity: ~2x throughput on
            # typical scenes; heavy scenes that would overflow 4.0 now
            # just work).  The measurement is its own jit dispatch +
            # host sync, so it is cached per (scene, resolution, base
            # config): a frame loop over render() pays it once, not per
            # frame.  A pose
            # that outgrows the cached capacity is caught by the
            # overflow check below and re-measured — never silent.
            import weakref
            cache_key = (id(scene), scene.num_gaussians, camera.h,
                         camera.w, config)
            hit = _AUTO_CONFIG_CACHE.get(cache_key)
            cfg = None
            if hit is not None:
                ref, cfg = hit
                if ref() is not scene:      # id recycled: stale entry
                    cfg = None
            if cfg is None:
                cfg = auto_config(scene, camera, config)
                if len(_AUTO_CONFIG_CACHE) > 64:
                    _AUTO_CONFIG_CACHE.clear()
                try:
                    _AUTO_CONFIG_CACHE[cache_key] = (weakref.ref(scene),
                                                     cfg)
                except TypeError:
                    pass                    # un-weakref-able: skip cache
            config = cfg
    if m == "tiled" and check_overflow:
        from splat_tpu.render.tiled import render_tiled_checked
        try:
            img = render_tiled_checked(scene, camera, config)
        except RuntimeError:
            if cache_key is None:
                raise
            # stale cached auto-capacity (the pose moved into a heavier
            # view): evict, re-measure at THIS pose, retry once
            import weakref
            _AUTO_CONFIG_CACHE.pop(cache_key, None)
            config = auto_config(scene, camera, RenderConfig())
            try:
                _AUTO_CONFIG_CACHE[cache_key] = (weakref.ref(scene),
                                                 config)
            except TypeError:
                pass
            img = render_tiled_checked(scene, camera, config)
    else:
        img = render_fn(m, config)(scene, camera)
    if as_uint8:
        img = (jnp.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(jnp.uint8)
    return img
