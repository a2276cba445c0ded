"""Differentiable tiled rendering: a custom VJP for the production path.

The reference is feed-forward only (SURVEY §1: "renderer, not trainer");
train.py adds gradients through the *dense* renderer, which caps fitting
at small-to-medium scenes — O(N·H·W) has no tile culling.  This module
gives the TILE-BINNED pipeline a backward pass, making production-scale
scenes trainable: the forward is the compositing kernel of
render/kernels.py in its training mode, the backward a second Pallas
kernel over the same per-tile pair ranges.

Design (the INRIA 3DGS backward recurrences, one program per tile):

* **Forward** (``kernels.composite_tiles(train=True)``): the compositing
  walk emitting RAW accumulated color C (no background, no clip) plus
  **log T** per pixel and the number of pairs each tile walked.
  Log-space transmittance is what makes the backward walk possible at
  all: after thousands of opaque pairs T underflows f32, and a
  multiplicative reconstruction from T_final would zero the gradients of
  every *front* splat — log T stays finite (~-1e4) and exp() underflows
  only where the gradient is genuinely ~0.
* **Exact saturation cut**: once EVERY pixel of a tile has
  logT < SAT_CUT_LOG (-105, below which f32 exp() is exactly +0.0) AND
  the multiplicative transmittance carry reached exactly +0.0, every
  later pair's forward contribution (T·contrib) and backward gradient
  (w_i = α_i·T_i = 0, the D-suffix terms it feeds, and ḡlogT — which
  the finalize computes as g·bg·exp(logT) = exact 0) are IEEE-exact
  zeros.  The forward therefore exits there and emits the per-tile cut
  (pairs walked); the backward walks only the cut prefix, back to front.
  The gradient buffer starts as zeros, so the skipped pairs' gradients
  are exact zeros.  The two-condition guard matters because a
  denormal-stalled multiplicative carry can keep contributing
  denormal-sized bits to the image long after the true T underflows.
* **Optional INRIA-style exit** (``config.train_sat_exit``): the same cut
  machinery with the INFERENCE threshold (every pixel's T < alpha_min)
  instead of the exp-underflow one: an INRIA-inspired whole-tile exit
  (the INRIA CUDA forward stops each pixel at T < 1e-4 and its backward
  starts from the last contributor).  The custom VJP remains EXACT for
  the truncated composite it actually computes, and
  the truncation error vs the full walk is bounded by the residual
  transmittance (< alpha_min).
* **Finalize in plain JAX**: img = clip(C + exp(logT)·bg) (+ coverage
  channel) sits OUTSIDE the custom_vjp, so XLA autodiff handles the
  clip/background/alpha-channel/supersample chain for free and the
  kernel boundary stays minimal: (projected gaussians) -> (C, logT).
* **Backward** (``_bwd_kernel``): per tile, walk the cut prefix in
  REVERSE, recomputing each pair's alpha exactly as the forward did (the
  packed feature table is a forward residual).  With
  ĝc_i = Σ_c ḡC_c·c_{i,c}, the recurrences per pair i (back to front):

      logT_i = logT_{i+1} − log1p(−α_i)
      dL/dc_{i,c} = ḡC_c · α_i T_i
      dL/dα_i     = T_i·ĝc_i − D_i/(1−α_i),
      D_i = ḡlogT + Σ_{k>i} ĝc_k·α_k·T_k

  (D folds the background/coverage terms automatically: they reach the
  kernel through ḡlogT from the finalize chain.)  dα then chains into
  the conic/center/color/opacity rows; each pair's nine gradient rows
  are summed over the tile's pixels and written at the pair's own sorted
  slot (a pair belongs to exactly one tile, so writes never collide).
* **Segment-sum + pullback in XLA**: per-pair gradients reduce to
  per-gaussian cotangents by sorting on the pair→gaussian index map
  (``bins.ranks``) and differencing a compensated running cumsum at
  segment boundaries the binning's own count arithmetic provides
  (``_scatter_pair_grads``).  ``jax.vjp`` of the pure-JAX projection then
  pulls them back to scene parameters (and the camera pose — pose
  gradients come free).  The u16/bit packing of the feature table is
  treated straight-through: gradients are assigned to the unquantized
  projected values (quantization noise is ~1.5e-5, far below training
  noise).

Non-differentiable machinery (depth ordering, tile spans, the sort,
visibility/keep indicators, radii) correctly contributes zero cotangent.

Restrictions (checked): render_mode="color" or "depth" (the latter
with an explicit depth_range — depth-supervised training),
binning_key="depth", cull_pairs off — the production defaults.

Match: beyond the reference (no training anywhere in it); the dense-path
gradients this extends are train.py; the INRIA backward this
reformulates is described at reference notes.md:19-42 only as the
forward algorithm.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from splat_tpu.camera import Camera
from splat_tpu.config import RenderConfig
from splat_tpu.ops.projection import project_gaussians
from splat_tpu.render import kernels as K
from splat_tpu.render.binning import FEATURE_DIM, build_tile_bins
from splat_tpu.render.route import kernel_route

# Per-pair gradient rows: [dcx, dcy, da2, db2, dc2, dcr, dcg, dcb, dop],
# against the PACKED feature values (conic prescaled as -a/2, -b, -c/2).
GRAD_ROWS = 9

# The exact-saturation threshold: exp(x) == +0.0 in f32 for every
# x < ln(2^-150) ~ -103.97; -105 leaves margin.  Pairs behind a batch
# where ALL pixels are below it (and the multiplicative carry reached
# exact +0.0 — see the module docstring on denormal stall) have
# bit-exact zero forward contributions and gradients, so cutting there
# is not an approximation.  Tests may monkeypatch to -inf to disable.
SAT_CUT_LOG = -105.0


def _bwd_kernel(start_ref, cut_ref, feat_ref, gc_ref, glt_ref, lt_ref,
                zeros_ref, grads_ref, *, tile_w: int, tile_h: int,
                tiles_x: int, alpha_clamp: float, alpha_min: float,
                skip_bbox: bool):
    del zeros_ref                    # aliased to grads_ref (zero-filled)
    t = pl.program_id(0)
    s = start_ref[t]
    cut = cut_ref[t]
    y0 = (t // tiles_x) * tile_h
    x0 = (t % tiles_x) * tile_w
    shape = (tile_h, tile_w)
    px = (x0 + jax.lax.broadcasted_iota(jnp.int32, shape, 1)).astype(
        jnp.float32)
    py = (y0 + jax.lax.broadcasted_iota(jnp.int32, shape, 0)).astype(
        jnp.float32)
    rows, cols = pl.ds(y0, tile_h), pl.ds(x0, tile_w)
    gr = gc_ref[rows, cols, 0]
    gg = gc_ref[rows, cols, 1]
    gb = gc_ref[rows, cols, 2]

    def body(step, carry):
        d, lt_after = carry                 # D_i and logT after pair i
        k = s + cut - 1 - step
        g = K.decode_features([feat_ref[r, k] for r in range(FEATURE_DIM)],
                              skip_bbox)
        alpha, expp, keep, unclamped, dx, dy = K.pair_alpha(
            g, g["op"], px, py, alpha_clamp, alpha_min, skip_bbox)
        lt_i = lt_after - K.log_one_minus(alpha, alpha_clamp)
        # True logT is <= 0; the clamp only guards pixels whose anchor
        # is meaningless (their cotangents are zero), where exp could
        # otherwise overflow and turn 0 * inf into NaN.
        t_i = jnp.exp(jnp.minimum(lt_i, 0.0))
        wgt = alpha * t_i                                 # w_i = alpha T_i
        gc_w = gr * g["r"] + gg * g["g"] + gb * g["b"]
        if alpha_clamp >= K._ALPHA_LOG_MAX:
            # alpha can reach exactly 1.0 (u16 opacity 65535 where
            # exp(power) rounds to 1); guard as the forward's log does
            denom = 1.0 - jnp.minimum(alpha, K._ALPHA_LOG_MAX)
        else:
            denom = 1.0 - alpha
        da = t_i * gc_w - d / denom
        live = keep & unclamped        # alpha = op * exp(power) there
        dp = jnp.where(live, da * alpha, 0.0)             # d power
        dop = jnp.where(live, da * expp, 0.0)             # d opacity
        r_dx = jnp.sum(dp * dx)
        r_dy = jnp.sum(dp * dy)
        # power = a2 dx^2 + c2 dy^2 + b2 dx dy; dx = px - cx, dy = cy - py
        vals = (-(2.0 * g["a2"] * r_dx + g["b2"] * r_dy),
                2.0 * g["c2"] * r_dy + g["b2"] * r_dx,
                jnp.sum(dp * dx * dx), jnp.sum(dp * dx * dy),
                jnp.sum(dp * dy * dy),
                jnp.sum(gr * wgt), jnp.sum(gg * wgt), jnp.sum(gb * wgt),
                jnp.sum(dop))
        for r, v in enumerate(vals):
            grads_ref[r, k] = v
        return d + gc_w * wgt, lt_i

    jax.lax.fori_loop(0, cut, body,
                      (glt_ref[rows, cols], lt_ref[rows, cols]))


# --------------------------------------------------------------------------
# Host-side wiring
# --------------------------------------------------------------------------

def _check_config(config: RenderConfig):
    if config.render_mode == "depth":
        # Depth supervision: normalized depth rides the color rows
        # through the SAME pure-JAX projection the VJP pulls back
        # through, so the kernel pair needs no change — but the range
        # must be explicit: the auto range is a per-frame min/max over
        # visible depths, and gradients flowing through data-dependent
        # normalization BOUNDS would couple every splat's depth gradient
        # to the current extremes (and per-step range drift would make
        # the loss non-stationary).
        if config.depth_range is None:
            raise NotImplementedError(
                "render_tiled_diff in depth mode needs an explicit "
                "config.depth_range=(near, far): the auto range is a "
                "data-dependent per-frame reduction (unstable "
                "normalization under optimization)")
    elif config.render_mode != "color":
        raise NotImplementedError(
            "render_tiled_diff supports render_mode='color' or 'depth' "
            f"(explicit depth_range), got {config.render_mode!r}")
    if config.binning_key != "depth":
        raise NotImplementedError(
            "render_tiled_diff requires binning_key='depth'")
    if config.cull_pairs:
        raise NotImplementedError(
            "render_tiled_diff requires cull_pairs=False")


def _fwd_raster(bins, config):
    """Training forward: the padded (Hp, Wp, 4) plane of raw C + logT and
    the per-tile cut (pairs walked; the backward walks only these, later
    pairs hold exact-zero gradients)."""
    return K.composite_tiles(bins, config, train=True,
                             sat_cut_log=float(SAT_CUT_LOG))


def _bwd_raster(bins, g_c, g_lt, lt_pad, cut, config):
    """Run the backward kernel: (GRAD_ROWS, K) per-pair gradients in the
    sorted slot order of ``bins`` (zeros past each tile's cut and in
    unused capacity slots).

    ``g_c``/``g_lt`` are the cotangents of the cropped (H, W) raw C and
    logT; ``lt_pad`` is the forward's padded logT plane."""
    tw, th = config.tile_w, config.tile_h
    ntx, nty = bins.tiles_x, bins.tiles_y
    hp, wp = lt_pad.shape
    h, w = g_lt.shape
    pad = ((0, hp - h), (0, wp - w))
    g_c = jnp.pad(g_c, pad + ((0, 0),))
    g_lt = jnp.pad(g_lt, pad)
    kernel = functools.partial(
        _bwd_kernel, tile_w=tw, tile_h=th, tiles_x=ntx,
        alpha_clamp=config.alpha_clamp, alpha_min=config.alpha_min,
        skip_bbox=not math.isfinite(config.sigma_cutoff))
    kcap = bins.features.shape[1]
    return pl.pallas_call(
        kernel, grid=(ntx * nty,),
        out_shape=jax.ShapeDtypeStruct((GRAD_ROWS, kcap), jnp.float32),
        input_output_aliases={6: 0},
        name="splat_composite_bwd",
        **kernel_route(K._num_warps(config)),
    )(bins.tile_start, cut, bins.features, g_c, g_lt, lt_pad,
      jnp.zeros((GRAD_ROWS, kcap), jnp.float32))


def _pair_gaussian_ids(bins, n):
    """Each sorted slot's gaussian index, ``n`` for slots holding no pair
    (real pairs fill [0, tile_end[-1]) — fakes and unused capacity sort
    past the last tile)."""
    k_ids = jnp.arange(bins.ranks.shape[0], dtype=jnp.int32)
    valid = k_ids < bins.tile_end[-1]
    return jnp.where(valid, bins.ranks, n), valid


def _scatter_pair_grads_xla(grads, bins, n):
    """(GRAD_ROWS, K) pair grads -> (GRAD_ROWS, N) per-gaussian grads via
    a plain XLA scatter-add: the reference the sorted path is tested
    against."""
    gidx, valid = _pair_gaussian_ids(bins, n)
    out = jnp.zeros((GRAD_ROWS, n + 1), jnp.float32)
    out = out.at[:, gidx].add(jnp.where(valid[None, :], grads, 0.0),
                              mode="drop")
    return out[:, :n]


def _segment_offsets(proj, k_cap, tiles_x, tiles_y, config):
    """(N+1,) exclusive offsets of each gaussian's run in the
    sorted-by-gaussian valid pair slots.

    Depth-mode binning keeps pre-sort slots in SCENE order (binning.py
    step 2), so capacity truncation drops exactly the pre-sort slots at
    index >= k_cap; a gaussian's retained pair count is its slot-range
    intersection with [0, k_cap).  Invisible gaussians' sentinel-tile
    fake slots consume capacity (counts = 1) but are never inside a real
    tile's [start, end) range, so they retain zero.  This reproduces the
    binning's accounting exactly — the offsets are the segment
    boundaries of the backward's sort-by-gaussian, with no searchsorted
    at K scale."""
    from splat_tpu.render.binning import quantize_radius_bits, tile_spans

    rbits = quantize_radius_bits(proj.radius_px[:, 0], proj.radius_px[:, 1],
                                 proj.visible)
    _, _, _, counts = tile_spans(
        proj.center_px[:, 0], proj.center_px[:, 1], rbits,
        config.tile_w, config.tile_h, tiles_x, tiles_y)
    counts = jnp.where(proj.visible, counts, 1)    # depth-mode fake slots
    cum = jnp.cumsum(counts)
    first = cum - counts
    retained = jnp.where(
        proj.visible,
        jnp.clip(jnp.minimum(cum, k_cap) - jnp.minimum(first, k_cap),
                 0, None),
        0).astype(jnp.int32)
    return jnp.concatenate([jnp.zeros((1,), jnp.int32),
                            jnp.cumsum(retained).astype(jnp.int32)])


def _scatter_pair_grads(grads, bins, proj, n, config):
    """(GRAD_ROWS, K) pair grads -> (GRAD_ROWS, N) per-gaussian grads, as
    a sort + gather + compensated segment cumsum — no K-scale scatter.

    1. each slot's gaussian id is ``bins.ranks`` (the binning sort's own
       payload), ``n`` for slots holding no pair;
    2. ONE unstable sort by gaussian id;
    3. per-gaussian sums = differences of the sorted rows' running
       cumsum at segment boundaries known EXACTLY from the binning's
       own count arithmetic (_segment_offsets — no searchsorted);
    4. the cumsum is COMPENSATED (a second cumsum of the per-element
       rounding residuals): a plain f32 prefix at K=2.5M leaves
       ~4e-3 worst-case relative error on short segments riding a large
       running prefix; the residual pass restores ~1e-7.
    """
    k_cap = bins.ranks.shape[0]
    gidx, valid = _pair_gaussian_ids(bins, n)
    # unstable: segment sums are order-independent within a segment
    _, order = jax.lax.sort(
        (gidx, jnp.arange(k_cap, dtype=jnp.int32)), num_keys=1,
        is_stable=False)
    sv = jnp.take(jnp.where(valid[None, :], grads, 0.0), order, axis=1)
    c0 = jnp.cumsum(sv, axis=1)
    resid = sv - jnp.diff(c0, axis=1,
                          prepend=jnp.zeros((GRAD_ROWS, 1), jnp.float32))
    c1 = jnp.cumsum(resid, axis=1)
    zero = jnp.zeros((2 * GRAD_ROWS, 1), jnp.float32)
    cpad = jnp.concatenate([zero, jnp.concatenate([c0, c1], axis=0)],
                           axis=1)                          # (18, K+1)
    off = _segment_offsets(proj, k_cap, bins.tiles_x, bins.tiles_y,
                           config)                          # (N+1,)
    q = jnp.take(cpad, off, axis=1)                         # (18, N+1)
    seg = q[:, 1:] - q[:, :-1]
    return seg[:GRAD_ROWS] + seg[GRAD_ROWS:]


def _proj_arrays(scene, camera, config):
    """The differentiable projected quantities, plus the full projection
    record as a non-differentiated auxiliary (``jax.vjp(..., has_aux)``):
    the backward needs proj.radius_px/visible for the segment offsets and
    proj.color/opacity for the straight-through masks, and threading them
    through the SAME trace guarantees one projection pass per backward
    instead of relying on XLA CSE to merge a duplicate."""
    proj = project_gaussians(scene, camera, config)
    return (proj.center_px, proj.conic, proj.color, proj.opacity), proj


def _rebuild_proj(fields, aux):
    """Reassemble a ProjectedGaussians from the custom-VJP input split
    (differentiable fields, stop-gradient aux)."""
    from splat_tpu.ops.projection import ProjectedGaussians

    center, conic, color, opacity = fields
    depth, radius_px, vis_f = aux
    return ProjectedGaussians(depth=depth, center_px=center, conic=conic,
                              radius_px=radius_px, color=color,
                              opacity=opacity, visible=vis_f > 0.5)


def _core_proj_impl(fields, aux, h, w, config):
    proj = _rebuild_proj(fields, aux)
    bins = build_tile_bins(proj, h, w, config)
    planes, cut = _fwd_raster(bins, config)
    return planes[:h, :w, :3], planes[:h, :w, 3], bins, planes[..., 3], cut


@functools.partial(jax.custom_vjp, nondiff_argnums=(2, 3, 4))
def _core_proj(fields, aux, h, w, config):
    """The custom-VJP boundary: (projected quantities) -> (raw C, logT).

    Placing the boundary at the PROJECTED per-gaussian quantities buys
    two things at once: (a) the backward never re-runs the projection
    (jax's own autodiff of project_gaussians supplies the pullback), and
    (b) tensor-parallel TRAINING composes naturally — a sharded caller
    all_gathers each device's projected fields over the gaussian axis
    and calls this; the all_gather's transpose (psum-scatter) routes the
    pixel-side cotangents back to the owning shard
    (parallel/sharding.py).

    ``fields`` = (center_px, conic, color, opacity) — differentiable.
    ``aux`` = (depth, radius_px, visible-as-f32) — zero cotangent (the
    binning machinery: orderings, spans, indicators).
    """
    c_raw, lt, _, _, _ = _core_proj_impl(fields, aux, h, w, config)
    return c_raw, lt


def _core_proj_fwd(fields, aux, h, w, config):
    c_raw, lt, bins, lt_pad, cut = _core_proj_impl(fields, aux, h, w,
                                                   config)
    return (c_raw, lt), (fields, aux, bins, lt_pad, cut)


def _core_proj_bwd(h, w, config, res, cts):
    fields, aux, bins, lt_pad, cut = res
    center, conic, color, opacity = fields
    g_c, g_lt = cts
    n = center.shape[0]

    grads = _bwd_raster(bins, g_c, g_lt, lt_pad, cut, config)
    per_g = _scatter_pair_grads(grads, bins, _rebuild_proj(fields, aux), n,
                                config)

    # per-pair rows were computed against the PACKED values: rows 2-4 are
    # the prescaled conic (-a/2, -b, -c/2); undo the prescale here
    d_center = jnp.stack([per_g[0], per_g[1]], axis=-1)          # (N, 2)
    d_conic = jnp.stack([-0.5 * per_g[2], -per_g[3],
                         -0.5 * per_g[4]], axis=-1)              # (N, 3)
    d_color_packed = jnp.stack([per_g[5], per_g[6], per_g[7]],
                               axis=-1)                          # (N, 3)
    d_opacity = per_g[8]                                         # (N,)

    # straight-through the u16 packing; the pack clips color AND opacity
    # to [0, 1] (binning._pack_u16), whose subgradient masks
    # out-of-range values (same as the clip the dense path applies)
    in01 = (color >= 0.0) & (color <= 1.0)
    d_color = jnp.where(in01, d_color_packed, 0.0)
    d_opacity = jnp.where((opacity >= 0.0) & (opacity <= 1.0),
                          d_opacity, 0.0)

    return ((d_center, d_conic, d_color, d_opacity),
            tuple(jnp.zeros_like(a) for a in aux))


_core_proj.defvjp(_core_proj_fwd, _core_proj_bwd)


def core_from_proj(proj, h: int, w: int, config: RenderConfig):
    """Differentiable (ProjectedGaussians -> raw C, logT).

    The entry point for sharded callers that assemble a full projection
    record from gathered shards (TP training, parallel/sharding.py);
    gradients flow to center_px/conic/color/opacity, zero to the rest.
    """
    fields = (proj.center_px, proj.conic, proj.color, proj.opacity)
    aux = (jax.lax.stop_gradient(proj.depth),
           jax.lax.stop_gradient(proj.radius_px),
           jax.lax.stop_gradient(proj.visible.astype(jnp.float32)))
    return _core_proj(fields, aux, h, w, config)


def _core(scene, camera, config):
    """(scene, camera) -> (raw C, logT), differentiable: plain-JAX
    projection (autodiffed) composed with the custom-VJP raster core."""
    proj = project_gaussians(scene, camera, config)
    return core_from_proj(proj, camera.h, camera.w, config)


def render_tiled_diff(scene, camera: Camera,
                      config: RenderConfig | None = None) -> jax.Array:
    """Differentiable tiled render: same image semantics as render_tiled
    (its exit replaced by the exact saturation cut unless
    config.train_sat_exit), with a custom VJP through the Pallas kernels.

    ``jax.grad`` flows to every scene parameter and to the camera pose.
    """
    config = config or RenderConfig()
    _check_config(config)
    ss = config.supersample
    if ss > 1:
        camera = camera.scaled(ss)
    if scene.num_gaussians == 0:
        bgc = tuple(config.background)
        if config.alpha_channel:
            bgc = bgc + (0.0,)
        return jnp.broadcast_to(
            jnp.asarray(bgc, jnp.float32),
            (camera.h // ss, camera.w // ss, len(bgc))).astype(jnp.float32)

    c_raw, lt = _core(scene, camera, config)
    t_n = jnp.exp(lt)
    bg = jnp.asarray(config.background, jnp.float32)
    img = jnp.clip(c_raw + t_n[..., None] * bg, 0.0, 1.0)
    if config.alpha_channel:
        img = jnp.concatenate(
            [img, jnp.clip(1.0 - t_n, 0.0, 1.0)[..., None]], axis=-1)
    if ss > 1:
        from splat_tpu.utils.image import box_downsample

        img = box_downsample(img, ss)
    return img
