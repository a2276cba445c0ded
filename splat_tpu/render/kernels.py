"""Per-tile front-to-back alpha compositing: the Pallas kernel and its
plain reference.

The kernel follows the INRIA 3DGS rasterizer's layout on the GPU: one
program per tile, the tile's pixels spread across the block as a
(tile_h, tile_w) array, and the tile's sorted pair range
[tile_start, tile_end) walked one pair at a time.  Each step reads the
pair's packed feature column (eight int32 scalars, broadcast to every
pixel), evaluates its conic at every pixel and composites it under the
per-pixel transmittance T.  Every ``chunk`` pairs the block checks
saturation and stops once every pixel of the tile is below the exit
threshold.  The tile is written straight into the padded (H, W, C) image.

One kernel body serves both callers, with a static ``train`` switch:

* render (``train=False``): the final colour clip(C + T * background),
  plus the coverage 1 - T when ``config.alpha_channel``; exit once every
  pixel has T < alpha_min;
* training forward (``train=True``, render/diff.py): the raw colour C,
  log T (the sum of log1p(-alpha), the backward's anchor) and the number
  of pairs each tile walked.  The exit is either exact (every pixel's log
  T below diff.SAT_CUT_LOG and T exactly 0, after which every
  contribution and gradient is an IEEE zero) or, with
  ``config.train_sat_exit``, the render threshold.

:func:`composite_reference` is the same computation in plain
``jax.numpy``/``lax`` over the same TileBins: every tile padded to the
longest range in the frame and walked in batches of ``chunk`` pairs with
the same exit rule.  Tests and chip_smoke.py compare the kernel with it.

This replaces the reference's per-pixel fragment/blend callbacks
(src/pipelines.rs:127-168).
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from splat_tpu.config import RenderConfig
from splat_tpu.render.binning import FEATURE_DIM, _R15_MAX, TileBins
from splat_tpu.render.route import kernel_route

_INV_U16 = 1.0 / 65535.0

# Largest alpha whose log1p is taken when alpha_clamp allows alpha ~ 1.
_ALPHA_LOG_MAX = 0.999999


def decode_features(f, skip_bbox: bool) -> dict:
    """Packed feature rows (binning.py layout) -> float fields.

    ``f`` is a sequence of the eight int32 rows, each of any shape (the
    kernel passes scalars, the reference (T, chunk) arrays).  Rows 0-4 are
    f32 bits of [cx, cy, -a/2, -b, -c/2]; rows 5/6 are u16 pairs of (r, g)
    and (b, opacity); row 7 packs 15-bit (rx, ry) in 1/8-px units.  A
    saturated radius field (_R15_MAX) decodes to an infinite squared
    radius, so the bbox test always passes.
    """
    frow = lambda i: jax.lax.bitcast_convert_type(f[i], jnp.float32)
    lo16 = lambda i: (f[i] & 0xFFFF).astype(jnp.float32) * _INV_U16
    hi16 = lambda i: ((f[i] >> 16) & 0xFFFF).astype(jnp.float32) * _INV_U16
    out = dict(cx=frow(0), cy=frow(1), a2=frow(2), b2=frow(3), c2=frow(4),
               r=lo16(5), g=hi16(5), b=lo16(6), op=hi16(6))
    if not skip_bbox:
        rxq = f[7] & 0x7FFF
        ryq = (f[7] >> 15) & 0x7FFF
        rx = rxq.astype(jnp.float32) * 0.125
        ry = ryq.astype(jnp.float32) * 0.125
        out["rx2"] = jnp.where(rxq == _R15_MAX, jnp.inf, rx * rx)
        out["ry2"] = jnp.where(ryq == _R15_MAX, jnp.inf, ry * ry)
    return out


def pair_alpha(g, op, px, py, alpha_clamp: float, alpha_min: float,
               skip_bbox: bool):
    """One pair's alpha at pixels (px, py), exactly as the kernels
    evaluate it.  ``g`` holds decoded fields broadcastable against the
    pixel arrays; ``op`` is the opacity, already zero for masked pairs.

    Returns (alpha, expp, keep, unclamped, dx, dy): the kept, clamped
    alpha plus the pieces the backward chains through.
    """
    dx = px - g["cx"]
    dy = g["cy"] - py                       # local +y up on screen
    dx2 = dx * dx
    dy2 = dy * dy
    power = g["a2"] * dx2 + g["c2"] * dy2 + g["b2"] * (dx * dy)
    # No power <= 0 test: visibility gating requires det(cov2d) > 0
    # (projection.py), so the conic is PSD and power <= 0 always holds.
    expp = jnp.exp(power)
    a_raw = op * expp
    alpha = jnp.minimum(alpha_clamp, a_raw)
    keep = alpha >= alpha_min
    if not skip_bbox:
        keep = keep & (dx2 <= g["rx2"]) & (dy2 <= g["ry2"])
    # sigma_cutoff=inf + tight_radius: the stored bbox IS the alpha_min
    # kill radius, so the alpha test subsumes the bbox compares
    alpha = jnp.where(keep, alpha, 0.0)
    return alpha, expp, keep, a_raw < alpha_clamp, dx, dy


def log_one_minus(alpha, alpha_clamp: float):
    """log(1 - alpha), guarded where alpha_clamp lets alpha reach ~1."""
    if alpha_clamp >= _ALPHA_LOG_MAX:
        alpha = jnp.minimum(alpha, _ALPHA_LOG_MAX)
    return jnp.log1p(-alpha)


def _exit_now(tile_max, transmit, logt, *, train: bool, sat_exit: bool,
              alpha_min: float, sat_cut_log: float):
    """The tile-wide saturation test, shared by kernel and reference;
    ``tile_max`` reduces a per-pixel array over the tile's pixels."""
    t_max = tile_max(transmit)
    if not train or sat_exit:
        return t_max < alpha_min
    return (tile_max(logt) < sat_cut_log) & (t_max == 0.0)


def _composite_kernel(start_ref, end_ref, feat_ref, *out_refs,
                      tile_w: int, tile_h: int, tiles_x: int, chunk: int,
                      alpha_clamp: float, alpha_min: float,
                      bg: tuple[float, float, float], skip_bbox: bool,
                      alpha_channel: bool, train: bool, sat_exit: bool,
                      sat_cut_log: float):
    t = pl.program_id(0)
    s = start_ref[t]
    e = end_ref[t]
    n_pairs = e - s
    n_batches = (n_pairs + chunk - 1) // chunk
    kmax = feat_ref.shape[1] - 1
    y0 = (t // tiles_x) * tile_h
    x0 = (t % tiles_x) * tile_w
    shape = (tile_h, tile_w)
    px = (x0 + jax.lax.broadcasted_iota(jnp.int32, shape, 1)).astype(
        jnp.float32)
    py = (y0 + jax.lax.broadcasted_iota(jnp.int32, shape, 0)).astype(
        jnp.float32)

    def pair(k, state):
        cr, cg, cb, tr, lt = state
        kc = jnp.minimum(k, kmax)
        g = decode_features([feat_ref[r, kc] for r in range(FEATURE_DIM)],
                            skip_bbox)
        op = jnp.where(k < e, g["op"], 0.0)
        alpha, _, _, _, _, _ = pair_alpha(g, op, px, py, alpha_clamp,
                                          alpha_min, skip_bbox)
        wgt = alpha * tr
        cr = cr + wgt * g["r"]
        cg = cg + wgt * g["g"]
        cb = cb + wgt * g["b"]
        if train:
            lt = lt + log_one_minus(alpha, alpha_clamp)
        return cr, cg, cb, tr * (1.0 - alpha), lt

    def batch(carry):
        b, _, state = carry
        k0 = s + b * chunk
        state = jax.lax.fori_loop(0, chunk,
                                  lambda i, st: pair(k0 + i, st), state)
        sat = _exit_now(jnp.max, state[3], state[4], train=train,
                        sat_exit=sat_exit, alpha_min=alpha_min,
                        sat_cut_log=sat_cut_log)
        return b + 1, sat, state

    def cond(carry):
        b, sat, _ = carry
        return (b < n_batches) & jnp.logical_not(sat)

    zeros = jnp.zeros(shape, jnp.float32)
    init = (zeros, zeros, zeros, jnp.ones(shape, jnp.float32), zeros)
    b_end, _, (cr, cg, cb, tr, lt) = jax.lax.while_loop(
        cond, batch, (jnp.int32(0), jnp.bool_(False), init))

    out_ref = out_refs[0]
    rows, cols = pl.ds(y0, tile_h), pl.ds(x0, tile_w)
    if train:
        for c, v in enumerate((cr, cg, cb, lt)):
            out_ref[rows, cols, c] = v
        cut_ref = out_refs[1]
        cut_ref[t] = jnp.minimum(b_end * chunk, n_pairs)
        return
    for c, v in enumerate((cr, cg, cb)):
        out_ref[rows, cols, c] = jnp.clip(v + tr * float(bg[c]), 0.0, 1.0)
    if alpha_channel:
        # accumulated coverage (notebook semantics; see config.py) — NOT
        # the reference's last-fragment alpha byte
        out_ref[rows, cols, 3] = jnp.clip(1.0 - tr, 0.0, 1.0)


def _num_warps(config: RenderConfig) -> int:
    """Warps per tile program: about one thread per 4 pixels, 4..8."""
    return max(4, min(8, (config.tile_w * config.tile_h) // 128))


def composite_tiles(bins: TileBins, config: RenderConfig, *,
                    train: bool = False, sat_cut_log: float = -math.inf):
    """Run the compositing kernel over every tile.

    Returns the padded (nty*tile_h, ntx*tile_w, C) float32 image: render
    mode gives the final RGB(A); ``train=True`` gives (raw C, log T) and,
    as a second result, the (num_tiles,) int32 count of pairs each tile
    walked before its exit.
    """
    tw, th = config.tile_w, config.tile_h
    ntx, nty = bins.tiles_x, bins.tiles_y
    num_tiles = ntx * nty
    nchan = 4 if (train or config.alpha_channel) else 3
    kernel = functools.partial(
        _composite_kernel, tile_w=tw, tile_h=th, tiles_x=ntx,
        chunk=config.chunk, alpha_clamp=config.alpha_clamp,
        alpha_min=config.alpha_min, bg=tuple(config.background),
        skip_bbox=not math.isfinite(config.sigma_cutoff),
        alpha_channel=config.alpha_channel, train=train,
        sat_exit=bool(config.train_sat_exit), sat_cut_log=float(sat_cut_log))
    out_shape = [jax.ShapeDtypeStruct((nty * th, ntx * tw, nchan),
                                      jnp.float32)]
    if train:
        out_shape.append(jax.ShapeDtypeStruct((num_tiles,), jnp.int32))
    out = pl.pallas_call(
        kernel, grid=(num_tiles,), out_shape=out_shape,
        name="splat_composite_train" if train else "splat_composite",
        **kernel_route(_num_warps(config)),
    )(bins.tile_start, bins.tile_end, bins.features)
    return tuple(out) if train else out[0]


def rasterize_tiles(bins: TileBins, h: int, w: int,
                    config: RenderConfig) -> jax.Array:
    """Composite the binned pairs into a float32 (H, W, 3) image in [0, 1]
    (or (H, W, 4) with config.alpha_channel: RGB + accumulated 1 - T)."""
    return composite_tiles(bins, config)[:h, :w]


# --------------------------------------------------------------------------
# Plain reference: the same walk in jax.numpy / lax
# --------------------------------------------------------------------------

PAIR_FIELDS = ("cx", "cy", "a2", "b2", "c2", "r", "g", "b", "op")


def decode_pairs(bins: TileBins, config: RenderConfig) -> dict:
    """Every sorted slot's decoded fields as (K,) float arrays."""
    skip_bbox = not math.isfinite(config.sigma_cutoff)
    return decode_features([bins.features[r] for r in range(FEATURE_DIM)],
                           skip_bbox)


def composite_reference(bins: TileBins, config: RenderConfig, *,
                        train: bool = False, sat_cut_log: float = -math.inf,
                        fields: dict | None = None,
                        num_batches: int | None = None):
    """The kernel's computation in plain jax.numpy, over all tiles at once.

    Every tile walks its range in batches of ``config.chunk`` pairs (a
    batch is one (tiles, pixels, chunk) array program; the transmittance
    prefix inside a batch is a cumulative product) with the kernel's exit
    rule checked after each batch.  Outputs match :func:`composite_tiles`.

    ``fields`` replaces the decoded pair fields (:func:`decode_pairs`),
    which makes the reference differentiable in them.  ``num_batches``
    (static) walks exactly that many batches with ``lax.scan`` and a
    rematerialised step, so ``jax.vjp`` works; None walks a
    ``while_loop`` until every tile has exited.
    """
    tw, th = config.tile_w, config.tile_h
    ntx, nty = bins.tiles_x, bins.tiles_y
    num_tiles = ntx * nty
    chunk = config.chunk
    skip_bbox = not math.isfinite(config.sigma_cutoff)
    if fields is None:
        fields = decode_pairs(bins, config)
    kcap = fields["cx"].shape[0]
    s = bins.tile_start
    e = bins.tile_end
    n_t = e - s
    nb_t = (n_t + chunk - 1) // chunk
    tile = jnp.arange(num_tiles)
    pix = jnp.arange(th * tw)
    px = ((tile % ntx)[:, None] * tw + pix[None, :] % tw).astype(
        jnp.float32)[..., None]                                  # (T, P, 1)
    py = ((tile // ntx)[:, None] * th + pix[None, :] // tw).astype(
        jnp.float32)[..., None]
    lane = jnp.arange(chunk)

    def step(carry, b):
        active, c, tr, lt, walked = carry
        idx = s[:, None] + b * chunk + lane[None, :]              # (T, B)
        valid = (idx < e[:, None]) & active[:, None]
        idc = jnp.clip(idx, 0, kcap - 1)
        g = {k: v[idc][:, None, :] for k, v in fields.items()}   # (T,1,B)
        op = jnp.where(valid[:, None, :], g["op"], 0.0)
        alpha, _, _, _, _, _ = pair_alpha(g, op, px, py, config.alpha_clamp,
                                          config.alpha_min, skip_bbox)
        one_minus = 1.0 - alpha                                   # (T,P,B)
        incl = jnp.cumprod(one_minus, axis=-1)
        excl = jnp.concatenate([jnp.ones_like(incl[..., :1]),
                                incl[..., :-1]], axis=-1)
        wgt = alpha * excl * tr[..., None]
        col = jnp.concatenate([g["r"], g["g"], g["b"]], axis=1)  # (T,3,B)
        c = c + jnp.einsum("tpb,tcb->tpc", wgt, col,
                           precision=jax.lax.Precision.HIGHEST)
        tr = tr * incl[..., -1]
        if train:
            lt = lt + jnp.sum(log_one_minus(alpha, config.alpha_clamp),
                              axis=-1)
        walked = walked + jnp.where(
            active, jnp.clip(n_t - b * chunk, 0, chunk), 0)
        sat = _exit_now(functools.partial(jnp.max, axis=-1), tr, lt,
                        train=train,
                        sat_exit=bool(config.train_sat_exit),
                        alpha_min=config.alpha_min, sat_cut_log=sat_cut_log)
        active = active & (b + 1 < nb_t) & jnp.logical_not(sat)
        return (active, c, tr, lt, walked), None

    init = (nb_t > 0,
            jnp.zeros((num_tiles, th * tw, 3), jnp.float32),
            jnp.ones((num_tiles, th * tw), jnp.float32),
            jnp.zeros((num_tiles, th * tw), jnp.float32),
            jnp.zeros((num_tiles,), jnp.int32))
    if num_batches is None:
        def body(carry):
            b, state = carry
            return b + 1, step(state, b)[0]

        _, (_, c, tr, lt, walked) = jax.lax.while_loop(
            lambda carry: jnp.any(carry[1][0]), body, (jnp.int32(0), init))
    else:
        (_, c, tr, lt, walked), _ = jax.lax.scan(
            jax.checkpoint(step), init,
            jnp.arange(num_batches, dtype=jnp.int32))

    def untile(x):                                   # (T, P, C) -> image
        nc = x.shape[-1]
        x = x.reshape(nty, ntx, th, tw, nc).transpose(0, 2, 1, 3, 4)
        return x.reshape(nty * th, ntx * tw, nc)

    if train:
        return untile(jnp.concatenate([c, lt[..., None]], axis=-1)), walked
    bg = jnp.asarray(config.background, jnp.float32)
    img = jnp.clip(c + tr[..., None] * bg, 0.0, 1.0)
    if config.alpha_channel:
        img = jnp.concatenate(
            [img, jnp.clip(1.0 - tr, 0.0, 1.0)[..., None]], axis=-1)
    return untile(img)
