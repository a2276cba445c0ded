"""Multi-chip rendering via jax.sharding / shard_map over a device Mesh.

The reference is strictly single-process single-thread (SURVEY §2.3: no DP /
TP / PP / comms anywhere).  This engine adds two orthogonal axes of
scaling, both riding XLA collectives between devices:

* **gaussian/tensor parallelism** (mesh axis ``"g"``): the per-gaussian
  stage (cov3d + EWA + SH — the FLOP-heavy part at large N) runs on each
  chip's shard of the gaussian arrays; the compact projected records
  (~13 f32 each vs 59 f32 of raw splat state) are then ``all_gather``-ed so
  every chip can composite in correct global depth order.  Compositing
  itself is image-parallel: each chip owns a horizontal slab of rows, so no
  further communication happens in the pixel stage.
* **data parallelism** (mesh axis ``"d"``): independent frames (cameras) of
  a trajectory batch.

Over-compositing is order-dependent across depth, which is why gaussians
cannot simply be composited shard-locally and psum-ed; the
project-local/gather-compact/composite-slab decomposition keeps the math
exact while the collective payload stays small.
"""

from __future__ import annotations



import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from splat_tpu.camera import Camera
from splat_tpu.config import RenderConfig
from splat_tpu.ops.projection import ProjectedGaussians, project_gaussians


def make_mesh(n_data: int = 1, n_gaussian: int | None = None,
              devices=None) -> Mesh:
    """Build a (d, g) mesh.  Defaults to all devices on the gaussian axis."""
    if devices is None:
        devices = jax.devices()
    total = len(devices)
    if n_gaussian is None:
        n_gaussian = total // n_data
    if n_data * n_gaussian != total:
        raise ValueError(
            f"mesh {n_data}x{n_gaussian} != {total} devices")
    arr = np.asarray(devices).reshape(n_data, n_gaussian)
    return Mesh(arr, axis_names=("d", "g"))


def _check_sharded_config(config: RenderConfig) -> None:
    """Depth mode's AUTO range is a per-call reduction over the visible
    splats (ops/projection.encode_depth_color); under shard_map each chip
    would normalize by its own shard's depth min/max and the slabs would
    disagree.  Sharded renders therefore require an explicit range."""
    if config.render_mode == "depth" and config.depth_range is None:
        raise ValueError(
            "sharded rendering with render_mode='depth' requires an "
            "explicit RenderConfig.depth_range: the auto range would be "
            "computed per gaussian shard and chips would disagree")


def _composite_rows(proj: ProjectedGaussians, row0, h_local: int, w: int,
                    config: RenderConfig, chunk: int) -> jax.Array:
    """Front-to-back composite of already-sorted projected gaussians over a
    row slab [row0, row0 + h_local).  Mirrors render_dense's inner loop."""
    n = proj.depth.shape[0]
    py, px = jnp.mgrid[0:h_local, 0:w]
    px = px.astype(jnp.float32)
    py = py.astype(jnp.float32) + row0

    pad = (-n) % chunk
    def padded(a):
        if pad == 0:
            return a
        return jnp.concatenate([a, jnp.zeros((pad,) + a.shape[1:], a.dtype)])
    idx = padded(jnp.arange(n)).reshape(-1, chunk)
    ok = padded(jnp.ones((n,), bool)).reshape(-1, chunk)

    def step(carry, io):
        img, transmit = carry
        i, o = io
        cx = proj.center_px[i, 0][:, None, None]
        cy = proj.center_px[i, 1][:, None, None]
        ca = proj.conic[i, 0][:, None, None]
        cb = proj.conic[i, 1][:, None, None]
        cc = proj.conic[i, 2][:, None, None]
        rx = proj.radius_px[i, 0][:, None, None]
        ry = proj.radius_px[i, 1][:, None, None]
        op = proj.opacity[i][:, None, None]
        vis = proj.visible[i][:, None, None] & o[:, None, None]
        dx = px[None] - cx
        dy = cy - py[None]
        power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
        alpha = jnp.minimum(config.alpha_clamp, op * jnp.exp(power))
        keep = ((power <= 0) & (alpha >= config.alpha_min)
                & (jnp.abs(dx) <= rx) & (jnp.abs(dy) <= ry) & vis)
        alpha = jnp.where(keep, alpha, 0.0)
        color = jnp.clip(proj.color[i], 0.0, 1.0)
        t_within = jnp.cumprod(1.0 - alpha, axis=0)
        t_before = jnp.concatenate(
            [jnp.ones_like(t_within[:1]), t_within[:-1]], axis=0)
        contrib = jnp.einsum("khw,kc->hwc", alpha * t_before, color,
                             precision=jax.lax.Precision.HIGHEST)
        img = img + transmit[..., None] * contrib
        transmit = transmit * t_within[-1]
        return (img, transmit), None

    init = (jnp.zeros((h_local, w, 3), jnp.float32),
            jnp.ones((h_local, w), jnp.float32))
    (img, transmit), _ = jax.lax.scan(step, init, (idx, ok))
    img = img + transmit[..., None] * jnp.asarray(config.background,
                                                  jnp.float32)
    return jnp.clip(img, 0.0, 1.0)


def render_sharded(scene, camera: Camera, mesh: Mesh,
                   config: RenderConfig | None = None,
                   chunk: int = 16) -> jax.Array:
    """Single-frame render, gaussians sharded over mesh axis 'g'.

    Call under jit with ``scene`` sharded along axis 0 of every leaf
    (``P("g")``) and camera replicated.  Returns the full (H, W, 3) image
    (replicated).  H must be divisible by the 'g' axis size.
    """
    config = config or RenderConfig()
    _check_sharded_config(config)
    h, w = camera.h, camera.w
    if scene.num_gaussians == 0:  # empty shards break all_gather
        # the dense sharded compositor is RGB-only; stay consistent
        return _empty_frame(h, w, config)[..., :3]
    n_g = mesh.shape["g"]
    if h % n_g:
        raise ValueError(f"image height {h} not divisible by g={n_g}")
    h_local = h // n_g

    def fn(scene_local, cam):
        # --- TP stage: project only the local gaussian shard. ---
        proj_local = project_gaussians(scene_local, cam, config)
        # --- gather compact projected records to all chips. ---
        proj = jax.tree.map(
            lambda a: jax.lax.all_gather(a, "g", axis=0, tiled=True),
            proj_local)
        # --- replicated global depth sort (front-to-back). ---
        key = jnp.where(proj.visible, proj.depth, jnp.inf)
        order = jnp.argsort(key)
        proj = jax.tree.map(lambda a: a[order], proj)
        # --- image-parallel compositing: this chip's row slab. ---
        g_idx = jax.lax.axis_index("g")
        slab = _composite_rows(proj, g_idx * h_local, h_local, w,
                               config, chunk)
        # --- reassemble full image on every chip. ---
        img = jax.lax.all_gather(slab, "g", axis=0, tiled=True)
        return img

    specs = P("g")
    fn_mapped = jax.shard_map(
        fn, mesh=mesh,
        in_specs=(jax.tree.map(lambda _: specs, scene), P()),
        out_specs=P(),
        check_vma=False)
    return fn_mapped(scene, camera)


def render_batch_sharded(scene, cameras: Camera, mesh: Mesh,
                         config: RenderConfig | None = None,
                         chunk: int = 16) -> jax.Array:
    """Trajectory batch: frames over mesh axis 'd', gaussians over 'g'.

    ``cameras`` is a batched Camera (leading frame axis on every leaf, e.g.
    from :func:`splat_tpu.camera.orbit_trajectory`); the frame count must be
    divisible by the 'd' axis size.  Returns (F, H, W, 3).
    """
    config = config or RenderConfig()
    _check_sharded_config(config)
    if scene.num_gaussians == 0:  # empty shards break all_gather
        f = jnp.asarray(jax.tree.leaves(cameras)[0]).shape[0]
        bg = _empty_frame(cameras.h, cameras.w, config)[..., :3]
        return jnp.broadcast_to(bg, (f,) + bg.shape)

    def one_frame(scene_local, cam):
        # Identical to render_sharded's body but usable under vmap over 'd'
        # local frames.
        proj_local = project_gaussians(scene_local, cam, config)
        proj = jax.tree.map(
            lambda a: jax.lax.all_gather(a, "g", axis=0, tiled=True),
            proj_local)
        key = jnp.where(proj.visible, proj.depth, jnp.inf)
        order = jnp.argsort(key)
        proj = jax.tree.map(lambda a: a[order], proj)
        g_idx = jax.lax.axis_index("g")
        h_local = cam.h // mesh.shape["g"]
        slab = _composite_rows(proj, g_idx * h_local, h_local, cam.w,
                               config, chunk)
        return jax.lax.all_gather(slab, "g", axis=0, tiled=True)

    def fn(scene_local, cams_local):
        return jax.vmap(one_frame, in_axes=(None, 0))(scene_local,
                                                      cams_local)

    cam_specs = jax.tree.map(lambda _: P("d"), cameras)
    fn_mapped = jax.shard_map(
        fn, mesh=mesh,
        in_specs=(jax.tree.map(lambda _: P("g"), scene), cam_specs),
        out_specs=P("d"),
        check_vma=False)
    return fn_mapped(scene, cameras)


def _render_slab_tiled(proj, row0, h_local: int, w: int,
                       config: RenderConfig):
    """Tile-binned rasterization of a horizontal row slab [row0, row0+h_local).

    Shifts projected centers into slab coordinates and re-gates visibility to
    splats whose bbox intersects the slab, then reuses the single-device
    binning + compositing kernel on the slab's own tile grid.
    """
    import dataclasses as _dc

    from splat_tpu.render.binning import build_tile_bins
    from splat_tpu.render.kernels import rasterize_tiles

    shift = jnp.stack([jnp.zeros_like(row0.astype(jnp.float32)),
                       row0.astype(jnp.float32)])
    center = proj.center_px - shift[None, :]
    lo_y = center[:, 1] - proj.radius_px[:, 1]
    hi_y = center[:, 1] + proj.radius_px[:, 1]
    visible = proj.visible & (hi_y > 0) & (lo_y < h_local)
    proj2 = _dc.replace(proj, center_px=center, visible=visible)
    bins = build_tile_bins(proj2, h_local, w, config)
    return rasterize_tiles(bins, h_local, w, config), bins.overflow


def render_slab_tiled_diff(scene_local, camera: Camera,
                           config: RenderConfig):
    """DIFFERENTIABLE tensor-parallel tiled render — call INSIDE a
    shard_map with a ``"g"`` axis, scene leaves sharded on the gaussian
    axis.  Returns the full (H, W, C) image (identical on every chip).

    TP TRAINING composition (round 5; SURVEY §2.3 TP row extended to
    training): each chip projects its own parameter shard
    (differentiable, local), all_gathers the four differentiable
    projected fields over ``"g"`` (the transpose — a psum-scatter —
    routes the pixel-side cotangents back to the OWNING shard, which is
    exactly the gradient communication TP training needs), rasterizes
    its row slab through the custom-VJP core, and all_gathers the slabs
    into the full image (transpose: slab slicing).  Parameters,
    gradients, and optimizer state all stay sharded — the >HBM-scene
    training memory plan; only the compact projected records (~13 f32 vs
    ~177 f32 of param+adam state) and the image are replicated.

    Restrictions: supersample == 1 (slab grids at the supersampled
    resolution are not wired), H divisible by the ``"g"`` axis size.
    """
    if config.supersample != 1:
        raise NotImplementedError(
            "TP training with supersample > 1 is not supported")
    _check_sharded_config(config)
    from splat_tpu.render.diff import _check_config, core_from_proj
    _check_config(config)
    h, w = camera.h, camera.w
    n_g = jax.lax.axis_size("g")
    if h % n_g:
        raise ValueError(f"image height {h} not divisible by g={n_g}")
    h_local = h // n_g

    proj_local = project_gaussians(scene_local, camera, config)
    gather = lambda a: jax.lax.all_gather(a, "g", axis=0, tiled=True)
    center = gather(proj_local.center_px)
    conic = gather(proj_local.conic)
    color = gather(proj_local.color)
    opacity = gather(proj_local.opacity)
    sg = jax.lax.stop_gradient
    depth = gather(sg(proj_local.depth))
    radius = gather(sg(proj_local.radius_px))
    visible = gather(sg(proj_local.visible))

    # shift centers into this chip's slab frame and re-gate visibility
    # to bbox-intersecting splats (same geometry as _render_slab_tiled)
    row0 = (jax.lax.axis_index("g") * h_local).astype(jnp.float32)
    center = center - jnp.stack([jnp.zeros_like(row0), row0])[None, :]
    cy = center[:, 1]
    visible = (visible & (cy + radius[:, 1] > 0)
               & (cy - radius[:, 1] < h_local))

    proj = ProjectedGaussians(depth=depth, center_px=center, conic=conic,
                              radius_px=radius, color=color,
                              opacity=opacity, visible=visible)
    c_raw, lt = core_from_proj(proj, h_local, w, config)

    # finalize exactly as render_tiled_diff does (render/diff.py)
    t_n = jnp.exp(lt)
    bg = jnp.asarray(config.background, jnp.float32)
    img = jnp.clip(c_raw + t_n[..., None] * bg, 0.0, 1.0)
    if config.alpha_channel:
        img = jnp.concatenate(
            [img, jnp.clip(1.0 - t_n, 0.0, 1.0)[..., None]], axis=-1)
    return jax.lax.all_gather(img, "g", axis=0, tiled=True)


def _resolve_route(route: str, n_g: int) -> str:
    """'auto' -> the traffic crossover: with the default cap
    ``min(1, 4/n_g) * N_local``, a2a traffic is n_g*cap*13 vs gather's
    (n_g-1)*N_local*13 per chip —
    a2a only undercuts gather once n_g > 5 (ratio 2.0 at n_g=2, 1.33 at
    n_g=4, 0.57 at n_g=8), so small meshes replicate."""
    if route == "auto":
        return "a2a" if n_g >= 6 else "gather"
    if route not in ("a2a", "gather"):
        raise ValueError(
            f"route must be 'auto', 'a2a' or 'gather', got {route!r}")
    return route


def render_sharded_tiled(scene, camera: Camera, mesh: Mesh,
                         config: RenderConfig | None = None,
                         route: str = "auto",
                         slab_cap_factor: float | None = None):
    """Single-frame tile-binned render, gaussians sharded over mesh axis 'g'.

    Same project-local / composite-slab decomposition as
    :func:`render_sharded`, but each chip rasterizes its row slab with the
    production tiled compositing kernel, and the projected records are
    routed by **tile ownership** when that is cheaper than replication:

    route="a2a": each chip compacts, per destination chip d, the
      records whose bbox intersects slab d, then ONE ``all_to_all`` over
      the interconnect delivers to every chip exactly the records that
      touch its slab.
      Per-chip traffic is ``n_g * cap * 13`` floats where
      ``cap = slab_cap_factor * N_local`` (default factor
      ``min(1, 4/n_g)``), constant in mesh size.  Records beyond ``cap``
      for one (src, dst) pair are dropped deepest-last and COUNTED — same
      no-silent-truncation contract as binning.  CAUTION for a2a at scale:
      the per-(src, dst) cap assumes shards are spatially uncorrelated;
      a scene stored in spatial order can need factor ~1.0 (measured on
      the surface fixture: one shard's records all landed in one slab).
      ``GaussianScene.permuted()`` de-clusters such scenes.
    route="gather": replicate all records (``all_gather``) — never
      overflows on routing; cheaper up to ~5 chips (see _resolve_route).
    route="auto" (default): gather for n_g < 6, a2a above.

    Returns ``(image, overflow)`` where overflow is the psum of ROUTING
    overflow (slab cap too small) and per-slab BINNING overflow
    (``max_dup_factor`` too small) — zero means no truncation anywhere.
    Callers that do not audit the count should use
    :func:`render_sharded_tiled_checked`.
    """
    config = config or RenderConfig()
    _check_sharded_config(config)
    h, w = camera.h, camera.w
    if scene.num_gaussians == 0:  # static: binning has no N=0 shape
        return _empty_frame(h, w, config), jnp.int32(0)
    n_g = mesh.shape["g"]
    if h % n_g:
        raise ValueError(f"image height {h} not divisible by g={n_g}")
    h_local = h // n_g
    route = _resolve_route(route, n_g)
    if route == "a2a" and slab_cap_factor is None:
        # spatially-ordered scenes break the default cap's i.i.d.
        # assumption; detect and raise it (see _auto_cap_factor)
        slab_cap_factor = _auto_cap_factor(scene, n_g)

    def fn(scene_local, cam):
        proj_local = project_gaussians(scene_local, cam, config)
        g_idx = jax.lax.axis_index("g")
        if route == "gather":
            proj = jax.tree.map(
                lambda a: jax.lax.all_gather(a, "g", axis=0, tiled=True),
                proj_local)
            overflow = jnp.int32(0)
        else:
            proj, overflow = _route_records_by_slab(
                proj_local, n_g, h_local, slab_cap_factor)
        slab, bin_ov = _render_slab_tiled(proj, g_idx * h_local, h_local, w,
                                          config)
        img = jax.lax.all_gather(slab, "g", axis=0, tiled=True)
        return img, jax.lax.psum(overflow + bin_ov, "g")

    fn_mapped = jax.shard_map(
        fn, mesh=mesh,
        in_specs=(jax.tree.map(lambda _: P("g"), scene), P()),
        out_specs=(P(), P()),
        check_vma=False)
    img, overflow = fn_mapped(scene, camera)
    return img, overflow


def render_batch_sharded_tiled(scene, cameras: Camera, mesh: Mesh,
                               config: RenderConfig | None = None,
                               route: str = "auto",
                               slab_cap_factor: float | None = None):
    """Trajectory batch on the PRODUCTION tiled path: frames over mesh
    axis 'd', gaussians over 'g', per-frame record routing (see
    render_sharded_tiled for the route semantics and overflow contract).

    ``cameras`` is a batched Camera (leading frame axis); the frame count
    must be divisible by the 'd' axis size and the height by 'g'.  Frames
    within a shard run as a ``lax.scan`` (the kernels are compiled
    once and iterated).  Returns ((F, H, W, 3) images, total overflow).
    """
    config = config or RenderConfig()
    _check_sharded_config(config)
    h, w = cameras.h, cameras.w
    n_g = mesh.shape["g"]
    if scene.num_gaussians == 0:  # static: binning has no N=0 shape
        f = jnp.asarray(jax.tree.leaves(cameras)[0]).shape[0]
        bg = _empty_frame(h, w, config)
        return jnp.broadcast_to(bg, (f,) + bg.shape), jnp.int32(0)
    if h % n_g:
        raise ValueError(f"image height {h} not divisible by g={n_g}")
    h_local = h // n_g
    route = _resolve_route(route, n_g)
    if route == "a2a" and slab_cap_factor is None:
        slab_cap_factor = _auto_cap_factor(scene, n_g)

    def fn(scene_local, cams_local):
        g_idx = jax.lax.axis_index("g")

        def one(carry, cam):
            proj_local = project_gaussians(scene_local, cam, config)
            if route == "gather":
                proj = jax.tree.map(
                    lambda a: jax.lax.all_gather(a, "g", axis=0,
                                                 tiled=True), proj_local)
                overflow = jnp.int32(0)
            else:
                proj, overflow = _route_records_by_slab(
                    proj_local, n_g, h_local, slab_cap_factor)
            slab, bin_ov = _render_slab_tiled(proj, g_idx * h_local,
                                              h_local, w, config)
            img = jax.lax.all_gather(slab, "g", axis=0, tiled=True)
            return carry + overflow + bin_ov, img

        ov, imgs = jax.lax.scan(one, jnp.int32(0), cams_local)
        return imgs, jax.lax.psum(jax.lax.psum(ov, "g"), "d")

    cam_specs = jax.tree.map(lambda _: P("d"), cameras)
    fn_mapped = jax.shard_map(
        fn, mesh=mesh,
        in_specs=(jax.tree.map(lambda _: P("g"), scene), cam_specs),
        out_specs=(P("d"), P()),
        check_vma=False)
    return fn_mapped(scene, cameras)


def render_sharded_tiled_checked(scene, camera: Camera, mesh: Mesh,
                                 config: RenderConfig | None = None,
                                 route: str = "auto",
                                 slab_cap_factor: float | None = None):
    """render_sharded_tiled that RAISES on any truncation.

    The multi-chip twin of render.tiled.render_tiled_checked: a caller who
    ignores the overflow count would get a silently truncated image, which
    the capacity design forbids (config.py contract).  Costs one device
    sync per frame; hot loops should call render_sharded_tiled and audit
    the returned count themselves.
    """
    img, overflow = render_sharded_tiled(
        scene, camera, mesh, config, route=route,
        slab_cap_factor=slab_cap_factor)
    _raise_on_overflow(int(overflow))
    return img


def render_batch_sharded_tiled_checked(scene, cameras: Camera, mesh: Mesh,
                                       config: RenderConfig | None = None,
                                       route: str = "auto",
                                       slab_cap_factor: float | None = None):
    """render_batch_sharded_tiled that RAISES on any truncation."""
    imgs, overflow = render_batch_sharded_tiled(
        scene, cameras, mesh, config, route=route,
        slab_cap_factor=slab_cap_factor)
    _raise_on_overflow(int(overflow))
    return imgs


def _empty_frame(h: int, w: int, config: RenderConfig):
    """Pure-background frame for zero-gaussian scenes (same semantics as
    render_tiled's N=0 path; RGBA gets zero coverage)."""
    bgc = tuple(config.background)
    if config.alpha_channel:
        bgc = bgc + (0.0,)
    return jnp.broadcast_to(jnp.asarray(bgc, jnp.float32),
                            (h, w, len(bgc))).astype(jnp.float32)


def shard_spatial_score(scene, n_g: int) -> float:
    """How i.i.d. the scene's storage order is across ``n_g`` contiguous
    shards: the median fraction of the scene's bounding volume each
    shard's own bbox covers.

    ~1.0: every shard spans the whole scene (random order — the a2a slab
    routing's default per-(src, dst) cap holds).  << 1: the scene is
    stored in SPATIAL order (common in pretrained .ply exports: a
    y-sorted or octree-ordered export scores ~(1/n_g) or ~(1/2)^3), so
    one shard's records can all land in one destination slab and
    overflow the default cap (measured on the surface fixture,
    ARCHITECTURE.md §Multi-chip).

    Host-side, O(N): device-resident means are fetched to the host.
    """
    if hasattr(scene, "mx"):  # feature-major DeviceScene
        means = np.stack([np.asarray(scene.mx), np.asarray(scene.my),
                          np.asarray(scene.mz)], axis=1)
    else:
        means = np.asarray(scene.means)
    n = means.shape[0]
    if n < 2 * n_g:
        return 1.0
    ext = means.max(axis=0) - means.min(axis=0) + 1e-12
    fracs = [
        float(np.prod(np.clip(
            (shard.max(axis=0) - shard.min(axis=0)) / ext, 1e-6, 1.0)))
        for shard in np.array_split(means, n_g)
    ]
    return float(np.median(fracs))


# Below this score a scene is treated as spatially ordered.  A random
# order scores ~0.9+ (each shard's coordinate ranges nearly span the
# scene); y-sorted scores ~1/n_g and octree-ordered ~(1/2)^3 ~ 0.125.
_SPATIAL_SCORE_THRESHOLD = 0.35


_CAP_FACTOR_CACHE: dict = {}


def _auto_cap_factor(scene, n_g: int) -> float:
    """Slab-cap factor for route='a2a' when the caller didn't pin one:
    the default ``min(1, 4/n_g)`` for i.i.d.-ordered scenes,
    raised toward 1.0 (= replication-equivalent traffic, can never
    rout-overflow) when the host-side spatial score says the shards are
    clustered.  The overflow count still surfaces any truncation —
    nothing is ever silent.

    The score is an O(N) host pass over the means, so it is computed
    ONCE per (scene, n_g) and cached (a per-frame recompute at 6M splats
    would dominate dispatch).  :func:`prepare_scene_for_sharding` on the
    host scene fixes the distribution instead of raising traffic."""
    default = min(1.0, 4.0 / n_g)
    key = (id(scene), getattr(scene, "num_gaussians", 0), n_g)
    hit = _CAP_FACTOR_CACHE.get(key)
    if hit is not None:
        return hit
    score = shard_spatial_score(scene, n_g)
    out = default
    if score < _SPATIAL_SCORE_THRESHOLD:
        out = min(1.0, max(default, default / max(score, 1e-3)))
    if len(_CAP_FACTOR_CACHE) > 256:
        _CAP_FACTOR_CACHE.clear()
    _CAP_FACTOR_CACHE[key] = out
    return out


def prepare_scene_for_sharding(scene, n_g: int, *, seed: int = 0,
                               threshold: float = _SPATIAL_SCORE_THRESHOLD):
    """De-cluster a spatially-ordered host scene before sharding.

    Returns ``(scene, permuted)``: when the spatial score is below
    ``threshold`` the gaussians are randomly permuted
    (:meth:`GaussianScene.permuted` — rendering is order-independent,
    the a2a routing's capacity assumption is restored), otherwise the
    scene passes through untouched.  Cheaper at scale than the
    :func:`_auto_cap_factor` fallback (which raises traffic toward
    replication instead of fixing the distribution).
    """
    score = shard_spatial_score(scene, n_g)
    if score < threshold:
        return scene.permuted(seed), True
    return scene, False


def _raise_on_overflow(overflow: int) -> None:
    if overflow > 0:
        raise RuntimeError(
            f"sharded render truncated: {overflow} records/pairs dropped "
            f"(routing slab cap and/or tile duplication buffer too small); "
            f"raise slab_cap_factor and/or RenderConfig.max_dup_factor")


def _route_records_by_slab(proj: ProjectedGaussians, n_g: int,
                           h_local: int, cap_factor: float | None):
    """Compact projected records per destination slab and all_to_all them.

    Inside shard_map: ``proj`` holds this chip's N_local records.  Returns
    (ProjectedGaussians of n_g*cap received records, local overflow count).
    """
    n_local = proj.depth.shape[0]
    if cap_factor is None:
        cap_factor = min(1.0, 4.0 / n_g)
    cap = max(128, -(-int(n_local * cap_factor) // 128) * 128)
    cap = min(cap, n_local)

    # 13 f32 rows per record (the kernel-facing compact payload).
    rows = jnp.stack([
        proj.center_px[:, 0], proj.center_px[:, 1],
        proj.conic[:, 0], proj.conic[:, 1], proj.conic[:, 2],
        proj.radius_px[:, 0], proj.radius_px[:, 1],
        proj.color[:, 0], proj.color[:, 1], proj.color[:, 2],
        jnp.asarray(proj.opacity), proj.depth,
        proj.visible.astype(jnp.float32),
    ])                                                   # (13, N_local)

    lo_y = proj.center_px[:, 1] - proj.radius_px[:, 1]
    hi_y = proj.center_px[:, 1] + proj.radius_px[:, 1]
    slab_ids = jnp.arange(n_g, dtype=jnp.float32)[:, None]
    y0 = slab_ids * h_local
    touches = (proj.visible[None, :]
               & (hi_y[None, :] > y0)
               & (lo_y[None, :] < y0 + h_local))         # (n_g, N_local)

    # Per-destination compaction: position of record i in dest d's buffer
    # is its prefix count; records past cap are dropped (front-most kept —
    # record order is scene order here, depth sorting happens in binning,
    # so "deepest dropped" is enforced by sorting proj by depth first).
    order = jnp.argsort(jnp.where(proj.visible, proj.depth, jnp.inf))
    rows_sorted = jnp.take(rows, order, axis=1)
    touches = jnp.take(touches, order, axis=1)
    pos = jnp.cumsum(touches.astype(jnp.int32), axis=1) - 1   # (n_g, N)
    sent = jnp.take_along_axis(
        pos, jnp.full((n_g, 1), n_local - 1), axis=1)[:, 0] + 1
    overflow = jnp.sum(jnp.maximum(sent - cap, 0))
    dest_slot = jnp.where(touches & (pos < cap), pos, cap)    # cap = drop
    # One batched row-scatter per destination (n_g is small and static;
    # all 13 rows share each destination's index vector, so this is n_g
    # scatters of N_local indices — no (n_g * N) gather materializes).
    blocks = []
    for d in range(n_g):
        b = jnp.zeros((13, cap + 1), jnp.float32)
        b = b.at[:, dest_slot[d]].set(rows_sorted, mode="drop")
        blocks.append(b[:, :cap])
    buf = jnp.concatenate(blocks, axis=1)                     # (13, n_g*cap)
    valid_local = (jnp.arange(cap)[None, :]
                   < jnp.minimum(sent, cap)[:, None])         # (n_g, cap)

    # Route: chip s's buffer block d -> chip d's block s (all_to_all).
    buf = jax.lax.all_to_all(buf, "g", split_axis=1, concat_axis=1,
                             tiled=True)                      # (13, n_g*cap)
    valid = jax.lax.all_to_all(
        valid_local.reshape(-1).astype(jnp.float32), "g",
        split_axis=0, concat_axis=0, tiled=True) > 0.5

    buf = buf.reshape(13, n_g * cap)
    received = ProjectedGaussians(
        depth=buf[11],
        center_px=jnp.stack([buf[0], buf[1]], axis=-1),
        conic=jnp.stack([buf[2], buf[3], buf[4]], axis=-1),
        radius_px=jnp.stack([buf[5], buf[6]], axis=-1),
        color=jnp.stack([buf[7], buf[8], buf[9]], axis=-1),
        opacity=buf[10],
        visible=(buf[12] > 0.5) & valid,
    )
    return received, overflow
