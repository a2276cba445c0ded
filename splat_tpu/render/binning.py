"""Stage B: tile binning — (gaussian, tile) pair expansion + ordering.

This is the INRIA-style tiled decomposition the reference *describes* but
never built (reference notes.md:19-42: DuplicateWithKeys, radix sort,
per-tile ranges), reformulated for XLA's static shapes:

1. establish front-to-back order.  Two modes (config.binning_key):
   "depth" (the default): NO global reorder — the pair sort key's low bits
   are the gaussian's quantized view depth (min(24, 32 - tile_bits)
   bits over the frame's visible depth range) and its index rides the
   pair sort as one int32 payload.  "rank": one argsort of N depth
   keys; all later stages work in depth order and the key's low bits
   are the unique depth RANK (exact tie-breaking, at the price of the
   argsort plus a gather into depth order);
2. each visible gaussian covers a rectangle of tiles derived from its
   sigma_cutoff bbox; per-gaussian pair counts -> exclusive prefix sum;
3. expand to a capacity-bounded slot array with a batched
   diff-scatter-cumsum (each per-gaussian sequence becomes a per-slot
   one by scattering wrapped differences at first slots and taking a
   cumulative sum) and emit the packed (tile id ‖ depth) sort key (plus,
   in depth mode, the gaussian-index payload);
4. ONE unstable sort groups pairs per tile, front-to-back inside each
   tile: in rank mode a single-array sort whose sorted low bits are
   directly the feature-gather indices; in depth mode a key+ONE-payload
   sort whose sorted payload is the gather index (features are gathered
   after the sort in both modes rather than riding it as payload);
5. per-tile [start, end) ranges via searchsorted over the sorted keys;
6. ONE 8-row feature gather at K: the 11 per-pair quantities are packed
   into exactly 8 int32 rows (32 bytes a pair): 5 rows carry f32 bits
   verbatim, 3 rows carry u16 pairs (colors/opacity at 1/65535, radii at
   1/8 px); the compositing kernel decodes them per pair.

Everything that rides a gather is INT32-typed: f32-typed arrays holding
int bit patterns are denormal floats, which a backend may flush to zero.
Int arrays see no float arithmetic, so bit patterns survive verbatim.

Capacity: K_cap = max_dup_factor * N slots.  If a frame produces more pairs,
the overflow count is returned and surfaced by the non-jit wrapper (in
rank mode the dropped pairs are the *deepest* ones — graceful
degradation; in depth mode they are the highest-index gaussians of the
scene's storage order — either way overflow is never silent).  Depth
mode additionally spends ONE sentinel slot per invisible gaussian (see
step 2 in build_tile_bins); num_pairs and
overflow count REAL pairs exactly in both modes (conservation:
num_pairs + overflow == true pair count), and pair_stats' suggested
capacity covers pairs + invisible.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from splat_tpu.config import RenderConfig
from splat_tpu.ops.projection import ProjectedGaussians


@partial(jax.tree_util.register_dataclass,
         data_fields=["features", "tile_start", "tile_end", "ranks",
                      "num_pairs", "overflow"],
         meta_fields=["tiles_x", "tiles_y"])
@dataclasses.dataclass(frozen=True)
class TileBins:
    """Sorted (gaussian, tile) pairs ready for the raster kernel.

    features: (8, K_cap) int32 feature-major, columns ordered by
      (tile, depth).  Rows 0-4 are f32 BITS of
      [cx, cy, -a/2, -b, -c/2] with (a, b, c) the conic — prescaled so
      the kernel evaluates power = r2*dx^2 + r4*dy^2 + r3*(dx*dy)
      directly.  Rows 5-7 are u16 pairs (low ‖ high << 16):
      row 5 (r, g) and row 6 (b, opacity) in 1/65535 units; row 7 packs
      (rx, ry) as 15-bit 1/8-px fields with the visibility flag in bit
      30.  The compositing kernel decodes them per pair.
    tile_start/tile_end: (T,) int32 pair ranges per tile.
    ranks: (K_cap,) int32 — each sorted pair's feature-gather index:
      with binning_key="rank" the depth rank (strictly increasing within
      every tile's range — the exact front-to-back contract); with
      binning_key="depth" the pair's gaussian index in original scene
      order (within a tile, the gaussians' quantized depths are
      nondecreasing).  The training backward reduces per-pair
      gradients to gaussians through it.
    num_pairs: () int32 total valid pairs (pre-capacity).
    overflow: () int32 pairs dropped due to capacity.
    """

    features: jax.Array
    tile_start: jax.Array
    tile_end: jax.Array
    ranks: jax.Array
    num_pairs: jax.Array
    overflow: jax.Array
    tiles_x: int
    tiles_y: int


FEATURE_DIM = 8

# Capacity grain: k_cap rounds up to a multiple of this many slots, so
# nearby max_dup_factor values share one compiled shape.
K_GRAIN = 1024

_U16 = 65535.0

# 15-bit 1/8-px radius fields saturate at 4095.875 px.  A saturated field
# is a SENTINEL meaning "covers everything along this axis": the span
# covers the full tile grid and the kernel's bbox test is disabled (the
# half-extent decodes to +inf).  Without the sentinel, a >4096-px splat
# (screen-filling at 4K, or a near-camera fly-through) would have its tile
# span and bbox silently truncated at the field maximum, dropping its
# contribution to pixels far from center.
_R15_MAX = 32767


def quantize_radius_bits(rx, ry, visible):
    """Pack bbox half-extents + visibility into one int32 per gaussian.

    Radii are CEIL-quantized to 1/8-px units (15 bits each): the quantized
    value is >= the exact radius, so the tile span derived from it always
    covers every pixel the kernel's (equally quantized) bbox test can
    accept — and pair-count estimates from these bits (count_pairs) match
    the binning stage exactly.  Fields that would exceed 15 bits clamp to
    the _R15_MAX saturation sentinel.  Bit 30 carries visibility.
    """
    rxq = jnp.clip(jnp.ceil(rx * 8.0), 0.0, float(_R15_MAX)).astype(
        jnp.int32)
    ryq = jnp.clip(jnp.ceil(ry * 8.0), 0.0, float(_R15_MAX)).astype(
        jnp.int32)
    return rxq | (ryq << 15) | (visible.astype(jnp.int32) << 30)


def decode_radius_bits(bits):
    """Inverse of quantize_radius_bits: (rx, ry, visible).

    Saturated fields decode to +inf, which makes the span math below
    cover the whole tile grid (floor/clip of -inf/+inf) and the kernel's
    squared-radius bbox compare always pass — no extra branches anywhere.
    """
    rxq = bits & 0x7FFF
    ryq = (bits >> 15) & 0x7FFF
    rx = jnp.where(rxq == _R15_MAX, jnp.inf,
                   rxq.astype(jnp.float32) * 0.125)
    ry = jnp.where(ryq == _R15_MAX, jnp.inf,
                   ryq.astype(jnp.float32) * 0.125)
    vis = ((bits >> 30) & 1).astype(jnp.bool_)
    return rx, ry, vis


def tile_spans(cx, cy, rbits, tpx: int, tpy: int, ntx: int, nty: int):
    """Tile-rect spans + pair counts from quantized radius bits.

    The single source of truth for the (gaussian, tile) pair geometry:
    build_tile_bins uses it post-gather and count_pairs pre-gather, so
    capacity suggestions match the real binning counts exactly.
    Invisible gaussians may carry NaN centers, so every derived field is
    gated on the visibility bit.
    """
    rx, ry, vis = decode_radius_bits(rbits)
    tx0 = jnp.where(vis, jnp.clip(
        jnp.floor((cx - rx) / tpx), 0, ntx - 1).astype(jnp.int32), 0)
    tx1 = jnp.where(vis, jnp.clip(
        jnp.floor((cx + rx) / tpx), 0, ntx - 1).astype(jnp.int32), 0)
    ty0 = jnp.where(vis, jnp.clip(
        jnp.floor((cy - ry) / tpy), 0, nty - 1).astype(jnp.int32), 0)
    ty1 = jnp.where(vis, jnp.clip(
        jnp.floor((cy + ry) / tpy), 0, nty - 1).astype(jnp.int32), 0)
    sw = tx1 - tx0 + 1
    counts = jnp.where(vis, sw * (ty1 - ty0 + 1), 0)
    return tx0, ty0, sw, counts


def count_pairs(proj: ProjectedGaussians, h: int, w: int,
                config: RenderConfig):
    """Exact (pre-cull) pair count the binning stage will produce.

    Shares tile_spans/quantize_radius_bits with build_tile_bins, so a
    capacity sized from this count can never under-provision (the dropped
    round-2 implementation used raw f32 radii and could).  With
    config.cull_pairs the kernel-walked count can be lower, but capacity
    (and overflow) are pre-cull quantities either way.
    Returns (visible, num_pairs) device scalars.
    """
    rbits = quantize_radius_bits(proj.radius_px[:, 0], proj.radius_px[:, 1],
                                 proj.visible)
    _, _, _, counts = tile_spans(
        proj.center_px[:, 0], proj.center_px[:, 1], rbits,
        config.tile_w, config.tile_h,
        -(-w // config.tile_w), -(-h // config.tile_h))
    return (jnp.sum(proj.visible.astype(jnp.int32)),
            jnp.sum(counts).astype(jnp.int32))


def _pack_u16(lo, hi, scale_lo: float, scale_hi: float):
    """Two non-negative floats -> one int32 (lo | hi << 16), rounded."""
    li = jnp.clip(jnp.round(lo * scale_lo), 0.0, _U16).astype(jnp.int32)
    hi_ = jnp.clip(jnp.round(hi * scale_hi), 0.0, _U16).astype(jnp.int32)
    return li | (hi_ << 16)


def _f32_bits(v):
    return jax.lax.bitcast_convert_type(v, jnp.int32)


def _bits_f32(v):
    return jax.lax.bitcast_convert_type(v, jnp.float32)


def _decode_cull_inputs(feats_d, alpha_min: float):
    """Per-gaussian cull quantities from the packed feature table.

    Returns (cx, cy, r_cull, lam_min, thresh): r_cull is the radius
    beyond which alpha < alpha_min everywhere (kernel-consistent: uses
    the same u16-decoded opacity the kernel will use); lam_min/thresh
    support the per-pair form of the same bound."""
    cx = _bits_f32(feats_d[0])
    cy = _bits_f32(feats_d[1])
    ca = -2.0 * _bits_f32(feats_d[2])
    cb = -_bits_f32(feats_d[3])
    cc = -2.0 * _bits_f32(feats_d[4])
    op = ((feats_d[6] >> 16) & 0xFFFF).astype(jnp.float32) / _U16
    half = 0.5 * (ca + cc)
    lam_min = half - jnp.sqrt(jnp.maximum(
        half * half - (ca * cc - cb * cb), 0.0))
    thresh = 2.0 * jnp.log(jnp.maximum(op, 1e-12) / alpha_min)
    r_cull = jnp.sqrt(jnp.maximum(thresh, 0.0)
                      / jnp.maximum(lam_min, 1e-12))
    return cx, cy, r_cull, lam_min, thresh


def build_tile_bins(proj: ProjectedGaussians, h: int, w: int,
                    config: RenderConfig) -> TileBins:
    """Bin projected gaussians into per-tile, front-to-back pair ranges."""
    tpx, tpy = config.tile_w, config.tile_h
    ntx = -(-w // tpx)
    nty = -(-h // tpy)
    num_tiles = ntx * nty
    n = proj.depth.shape[0]
    # capacity in slots, rounded up to K_GRAIN (max_dup_factor may be
    # fractional — every K-sized op below scales linearly with k_cap, so
    # tracking the scene's true pair count pays)
    k_cap = -(-int(config.max_dup_factor * n) // K_GRAIN) * K_GRAIN

    # -- 1. front-to-back global order ------------------------------------
    # binning_key == "rank": ONE argsort of N depth keys; every later
    #   stage works in depth order and the pair key's low bits are the
    #   depth RANK (unique, ascending -> exact front-to-back per tile,
    #   and the sorted key's low bits double as feature-gather indices).
    # binning_key == "depth": no global reorder at all.  The pair key's
    #   low bits are the QUANTIZED depth (min(24, 32 - tile_bits) bits,
    #   normalized to this frame's visible depth range) and the gaussian
    #   index rides the pair sort as one int32 payload operand.  This
    #   deletes the argsort AND the 8-row gather into depth order, for
    #   one int32 payload through the K-sort.  Ties (same quantized
    #   depth, same tile) composite in arbitrary order; at >= 2^18
    #   levels per frame depth range this is visually nil (the dense
    #   path and the oracle keep exact stable ordering).
    num_tiles_bits = max(int(num_tiles).bit_length(), 1)
    depth_mode = config.binning_key == "depth"
    if depth_mode:
        depth_bits = max(1, min(24, 32 - num_tiles_bits))
        qmax = float((1 << depth_bits) - 1)
        dvis = jnp.where(proj.visible, proj.depth, jnp.inf)
        dmin = jnp.min(dvis)
        dmax = jnp.max(jnp.where(proj.visible, proj.depth, -jnp.inf))
        scale = qmax / jnp.maximum(dmax - dmin, 1e-30)
        # monotone in depth: f32 subtract/multiply/floor/clip are all
        # correctly rounded monotone maps, so order is preserved exactly
        # up to quantization ties
        dqf = jnp.floor((dvis - dmin) * scale)
        dq = jnp.clip(jnp.where(jnp.isfinite(dqf), dqf, 0.0), 0.0, qmax
                      ).astype(jnp.int32)
        order = None
    else:
        depth_key = jnp.where(proj.visible, proj.depth, jnp.inf)
        order = jnp.argsort(depth_key)

    # -- 2. pack features; tile spans + pair counts --------------------------
    cx, cy = proj.center_px[:, 0], proj.center_px[:, 1]
    rx, ry = proj.radius_px[:, 0], proj.radius_px[:, 1]
    # Adaptive bit budget for the packed expansion word (see step 3):
    # tile coords need ceil(log2(ntx/nty)) bits, the span width one more
    # than x, and the within-span index r = slot - first_slot is bounded by
    # the span area (< num_tiles), so only the LOW bits of first_slot are
    # needed — modular subtraction recovers r exactly.  When everything
    # fits in 31 bits (sign clear), ONE expansion word carries geometry and
    # first_slot together; otherwise first_slot gets its own row.
    bits_x = max(int(ntx - 1).bit_length(), 1)
    # depth mode: invisible gaussians carry the sentinel span ty0 = nty
    # (one fake slot at tile id num_tiles — see below), so the packed
    # geometry word needs one more y value than the real tile rows
    bits_y = max(int(nty if depth_mode else nty - 1).bit_length(), 1)
    bits_w = max(int(ntx).bit_length(), 1)
    bits_r = max(int(num_tiles).bit_length(), 1)
    packed_first = (1 + bits_x + bits_y + bits_w + bits_r) <= 32
    shift_f = bits_x + bits_y + bits_w
    mask_r = (1 << bits_r) - 1
    # Move ALL per-gaussian state into depth order with ONE consolidated
    # 8-row take.  All rows are int32 (f32 bits / u16 pairs); see the
    # module docstring for why bit patterns must never ride in f32-typed
    # arrays.  Row 7
    # packs the radii as 15-bit 1/8-px fields plus the VISIBILITY bit:
    # tile spans and pair counts are recomputed post-gather from the
    # quantized radii (the quantized value is the single source of truth
    # for both the tile rect and the kernel's bbox test), which frees the
    # two geometry rows an explicit span encoding would need.
    feats_n = jnp.stack([
        _f32_bits(cx),
        _f32_bits(cy),
        _f32_bits(-0.5 * proj.conic[:, 0]),
        _f32_bits(-proj.conic[:, 1]),
        _f32_bits(-0.5 * proj.conic[:, 2]),
        _pack_u16(jnp.clip(proj.color[:, 0], 0.0, 1.0),
                  jnp.clip(proj.color[:, 1], 0.0, 1.0), _U16, _U16),
        _pack_u16(jnp.clip(proj.color[:, 2], 0.0, 1.0),
                  jnp.asarray(proj.opacity), _U16, _U16),
        quantize_radius_bits(rx, ry, proj.visible),
    ])                                                          # (8, N)
    # depth mode skips the reorder entirely: spans, the expansion walk,
    # and the feature table all stay in original scene order (the
    # post-sort gather indexes it through the sorted payload)
    feats_d = feats_n if depth_mode else jnp.take(feats_n, order, axis=1)
    cx_d = _bits_f32(feats_d[0])
    cy_d = _bits_f32(feats_d[1])
    tx0_d, ty0_d, sw_d, counts = tile_spans(cx_d, cy_d, feats_d[7],
                                            tpx, tpy, ntx, nty)
    vis_d = None
    if depth_mode:
        # Every invisible gaussian spends ONE fake slot aimed at the
        # sentinel tile (ty0 = nty, sw = 1 -> tile id = num_tiles
        # exactly), which keeps first_slot strictly increasing in scene
        # order; fake keys sort past the last tile edge and are never
        # walked.  (A windowed owner search needed the strict order; the
        # scatter-cumsum expansion does not, but pair_stats and
        # diff._segment_offsets mirror this accounting, so it stays until
        # all three change together.)  The accounting below removes
        # fakes from num_pairs and overflow exactly, so the public
        # contracts (real pairs walked, real pairs dropped) are
        # unchanged; the only real cost is capacity: depth-mode slot
        # demand is pairs + invisible (pair_stats mirrors this).
        _, _, vis_d = decode_radius_bits(feats_d[7])
        counts = jnp.where(vis_d, counts, 1)
        ty0_d = jnp.where(vis_d, ty0_d, nty)

    cum = jnp.cumsum(counts)
    total = cum[-1]
    first_slot = cum - counts                       # exclusive prefix sum
    overflow = jnp.maximum(total - k_cap, 0)

    # -- 3. per-slot expansion -> packed sort keys -------------------------
    bits_rank = max(int(n - 1).bit_length(), 1)
    bits_tile = num_tiles_bits                       # sentinel must fit
    # 32 bits are usable, not 31: when the key fills the sign bit, XOR-ing
    # the whole key space with 0x80000000 makes signed int32 order equal
    # unsigned order (the classic radix trick), so lax.sort still groups
    # by tile.  Low-bits extraction is unaffected (the flip touches only
    # the top tile bit).
    if depth_mode:
        low_bits = depth_bits        # chosen above to always fit 32 bits
        packed_key = True
    else:
        low_bits = bits_rank
        packed_key = bits_tile + bits_rank <= 32
    key_xor = -(1 << 31) if bits_tile + low_bits == 32 else 0
    num_pairs = jnp.minimum(total, jnp.int32(k_cap))
    if depth_mode:
        # Exact fake-slot accounting: an invisible gaussian's single fake
        # slot is first_slot[g], so fakes dropped by capacity are exactly
        # those with first_slot >= k_cap.  overflow = REAL pairs dropped;
        # num_pairs = REAL pairs within capacity (the kernel never walks
        # sentinel-tile fakes).  Conservation: num_pairs + overflow ==
        # true pair count, in every mode.
        invis = jnp.logical_not(vis_d)
        fake_dropped = jnp.sum(
            (invis & (first_slot >= k_cap)).astype(jnp.int32))
        n_invis = jnp.sum(invis.astype(jnp.int32))
        overflow = overflow - fake_dropped
        num_pairs = num_pairs - (n_invis - fake_dropped)
    # Expansion via batched diff-scatter-cumsum: any int32 per-gaussian
    # sequence v expands to slots exactly by scattering wrapped
    # differences at each gaussian's first slot and taking a wrapping
    # cumulative sum (telescoping; zero-count gaussians stack their
    # deltas on the next start, which telescopes through).  One scatter +
    # one cumsum per row expand all sequences at once:
    #   row 0: packed word: geometry (tx0, ty0, span_w) and, when the bit
    #          budget allows, the low bits of first_slot (for r_of_slot)
    #   plus a scatter of ONES whose cumsum is the depth RANK of each
    #   slot's gaussian (ranks increase by exactly 1 per gaussian, so the
    #   "wrapped differences" of the rank sequence are all ones — no
    #   gather needed).  The rank doubles as the feature-gather source
    #   into feats_d AND the low bits of the packed sort key.
    with jax.named_scope("expand"):
        slot_ids = jnp.arange(k_cap, dtype=jnp.int32)
        geom = tx0_d | (ty0_d << bits_x) | (sw_d << (bits_x + bits_y))
        if packed_first:
            row_list = [geom | ((first_slot & mask_r) << shift_f)]
        else:
            row_list = [geom, first_slot]
        if depth_mode:
            row_list.append(dq)        # expands to each slot's owner depth_q
        rows = jnp.stack(row_list)                                     # (R, N)
        deltas = jnp.concatenate(
            [rows[:, :1], rows[:, 1:] - rows[:, :-1]], axis=1)   # wraps ok
        idx = jnp.minimum(first_slot, k_cap)
        expanded = [
            jnp.cumsum(jnp.zeros((k_cap + 1,), jnp.int32).at[idx].add(
                deltas[r], mode="drop")[:k_cap])
            for r in range(rows.shape[0])
        ]
        ones = jnp.ones((n,), jnp.int32)
        rank_e = jnp.cumsum(
            jnp.zeros((k_cap + 1,), jnp.int32).at[idx].add(
                ones, mode="drop")[:k_cap]) - 1
        rank_e = jnp.clip(rank_e, 0, n - 1)
        dq_e = expanded.pop() if depth_mode else None
        if packed_first:
            (word_e,) = expanded
            geom_e = word_e  # low bits: geometry; masks select fields
            first_low = (word_e >> shift_f) & mask_r
            r_of_slot = (slot_ids - first_low) & mask_r
        else:
            geom_e, first_e = expanded
            r_of_slot = slot_ids - first_e

        tx0_e = geom_e & ((1 << bits_x) - 1)
        ty0_e = (geom_e >> bits_x) & ((1 << bits_y) - 1)
        sw = (geom_e >> (bits_x + bits_y)) & ((1 << bits_w) - 1)
        # slots past the last pair carry garbage spans (sw may be 0); they
        # are masked by `valid` below, so only keep the division defined
        dy = r_of_slot // jnp.maximum(sw, 1)
        dx_ = r_of_slot - dy * sw
        tile_col = tx0_e + dx_
        tile_row = ty0_e + dy
        tile_id = tile_row * ntx + tile_col
        valid = slot_ids < jnp.minimum(total, k_cap)

        if config.cull_pairs:
            # Fine-grained pair culling: a pair is dead when even the most
            # favorable pixel of the tile has alpha < alpha_min — exactly the
            # kernel's own per-pixel cutoff, so dropping it is lossless.
            # Per-gaussian quantities are computed once at N; the per-slot
            # lookup is ONE feature-major (4, K) gather.
            ccx, ccy, _, lam_min_n, thresh_n = _decode_cull_inputs(
                feats_d, config.alpha_min)
            cull_rows = jnp.stack([ccx, ccy, lam_min_n, thresh_n])   # (4, N)
            vals = jnp.take(cull_rows, rank_e, axis=1)               # (4, K)
            cxd, cyd, lam_min, thresh = vals[0], vals[1], vals[2], vals[3]
            x0 = tile_col.astype(jnp.float32) * tpx
            y0 = tile_row.astype(jnp.float32) * tpy
            ddx = jnp.maximum(jnp.maximum(x0 - cxd, cxd - (x0 + tpx - 1)), 0.0)
            ddy = jnp.maximum(jnp.maximum(y0 - cyd, cyd - (y0 + tpy - 1)), 0.0)
            q_low = lam_min * (ddx * ddx + ddy * ddy)
            # alpha_max = opacity * exp(-q_low / 2) < alpha_min  <=>
            # q_low > 2 * log(opacity / alpha_min)
            valid = valid & (q_low <= thresh)

        tile_id = jnp.where(valid, tile_id, num_tiles).astype(jnp.int32)
        # pairs the kernel will actually walk (post-cull, and never the
        # depth-mode sentinel-tile fake slots — their computed tile id is
        # num_tiles by construction)
        num_pairs = jnp.sum((tile_id != num_tiles).astype(jnp.int32))
        pair = None
        payload = None
        if depth_mode:
            dq_ok = jnp.clip(dq_e, 0, (1 << depth_bits) - 1)
            key = ((tile_id << depth_bits) | dq_ok) ^ key_xor
            payload = rank_e         # walk order == original order here
        elif packed_key:
            key = ((tile_id << bits_rank) | rank_e) ^ key_xor
        else:
            pair = (tile_id, rank_e)
    with jax.named_scope("sort_gather"):
        return _sort_and_gather(key, pair, payload=payload,
                                sorted_rank_bits=low_bits,
                                key_xor=key_xor, feats_d=feats_d,
                                num_tiles=num_tiles, num_pairs=num_pairs,
                                overflow=overflow, ntx=ntx, nty=nty)


def _sort_and_gather(key, pair, *, sorted_rank_bits: int, key_xor: int,
                     feats_d, num_tiles: int, num_pairs, overflow,
                     ntx: int, nty: int, payload=None):
    """Steps 4-6: tile sort, per-tile ranges, feature gather.

    Rank keys (``key`` given, no payload): ONE unstable single-array sort
    on the packed (tile ‖ rank) key replaces the stable key+payload sort:
    ranks are unique and ascending in depth, so ordering by the packed
    key groups by tile with exact front-to-back order inside each tile —
    and the sorted key's low bits ARE the feature-gather indices into the
    depth-ordered feature table.

    Depth keys (``payload`` given): the key is (tile ‖ quantized depth)
    and the payload carries each slot's gaussian index through the sort
    (one extra int32 operand in place of the N-side argsort + depth-order
    gather); the sorted payload is the feature-gather index into the
    ORIGINAL-order feature table.
    """
    if key is not None and payload is not None:
        sorted_key, sorted_rank = jax.lax.sort((key, payload), num_keys=1,
                                               is_stable=False)
        edge_queries = ((jnp.arange(num_tiles + 1, dtype=jnp.int32)
                         << sorted_rank_bits) ^ key_xor)
        edge_space = sorted_key
    elif key is not None:
        sorted_key = jax.lax.sort(key)
        sorted_rank = sorted_key & ((1 << sorted_rank_bits) - 1)
        edge_queries = ((jnp.arange(num_tiles + 1, dtype=jnp.int32)
                         << sorted_rank_bits) ^ key_xor)
        edge_space = sorted_key
    else:
        sorted_tile, sorted_rank = jax.lax.sort(pair, num_keys=1,
                                                is_stable=True)
        edge_queries = jnp.arange(num_tiles + 1, dtype=jnp.int32)
        edge_space = sorted_tile

    # -- 5. per-tile ranges -------------------------------------------------
    edges = jnp.searchsorted(edge_space, edge_queries,
                             side="left").astype(jnp.int32)
    tile_start, tile_end = edges[:-1], edges[1:]

    # -- 6. feature gather: the one unavoidable K-gather, feature-major ----
    # Each sorted pair pulls its gaussian's packed 32-byte feature column
    # in a single index operation.
    features = jnp.take(feats_d, sorted_rank, axis=1)          # (8, K)

    return TileBins(features=features, tile_start=tile_start,
                    tile_end=tile_end, ranks=sorted_rank,
                    num_pairs=num_pairs, overflow=overflow,
                    tiles_x=ntx, tiles_y=nty)
