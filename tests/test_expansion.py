"""Pair expansion (binning steps 2-5) against a small NumPy model.

The model expands every visible gaussian to the tiles its quantized bbox
covers, orders the pairs by (tile, depth key) and cuts them at the
capacity exactly as binning.py documents: pre-sort slots follow depth
order in rank mode and scene order in depth mode (where each invisible
gaussian also spends one sentinel slot).  The XLA expansion must agree
with it on per-tile ranges, pair sets and counts.
"""

import dataclasses

import numpy as np
import pytest

from splat_tpu.camera import Camera
from splat_tpu.config import RenderConfig
from splat_tpu.ops.projection import project_gaussians
from splat_tpu.render.binning import (K_GRAIN, build_tile_bins,
                                      quantize_radius_bits)
from splat_tpu.utils.fixtures import random_scene


def _np_expand(proj, h, w, cfg):
    """NumPy pair expansion: (tile_start, tile_end, per-tile gaussian
    sets, num_pairs, overflow)."""
    tpx, tpy = cfg.tile_w, cfg.tile_h
    ntx, nty = -(-w // tpx), -(-h // tpy)
    n = proj.depth.shape[0]
    rbits = np.asarray(quantize_radius_bits(
        proj.radius_px[:, 0], proj.radius_px[:, 1], proj.visible))
    rxq, ryq = rbits & 0x7FFF, (rbits >> 15) & 0x7FFF
    vis = ((rbits >> 30) & 1).astype(bool)
    rx = np.where(rxq == 32767, np.inf, rxq * 0.125)
    ry = np.where(ryq == 32767, np.inf, ryq * 0.125)
    c = np.asarray(proj.center_px)
    depth = np.asarray(proj.depth)
    k_cap = -(-int(cfg.max_dup_factor * n) // K_GRAIN) * K_GRAIN
    depth_mode = cfg.binning_key == "depth"
    order = (np.arange(n) if depth_mode
             else np.argsort(np.where(vis, depth, np.inf), kind="stable"))
    slots = []                       # pre-sort slot list: (tile, g)
    for g in order:
        if not vis[g]:
            if depth_mode:
                slots.append((ntx * nty, g))          # sentinel slot
            continue
        with np.errstate(invalid="ignore"):
            x0 = int(np.clip(np.floor((c[g, 0] - rx[g]) / tpx), 0, ntx - 1))
            x1 = int(np.clip(np.floor((c[g, 0] + rx[g]) / tpx), 0, ntx - 1))
            y0 = int(np.clip(np.floor((c[g, 1] - ry[g]) / tpy), 0, nty - 1))
            y1 = int(np.clip(np.floor((c[g, 1] + ry[g]) / tpy), 0, nty - 1))
        for ty in range(y0, y1 + 1):
            for tx in range(x0, x1 + 1):
                slots.append((ty * ntx + tx, g))
    real_total = sum(1 for t, _ in slots if t < ntx * nty)
    kept = [p for p in slots[:k_cap] if p[0] < ntx * nty]
    counts = np.bincount([t for t, _ in kept], minlength=ntx * nty)
    end = np.cumsum(counts)
    sets = [set() for _ in range(ntx * nty)]
    for t, g in kept:
        sets[t].add(int(g))
    return end - counts, end, sets, len(kept), real_total - len(kept)


def _check(scene, cam, cfg):
    proj = project_gaussians(scene, cam, cfg)
    bins = build_tile_bins(proj, cam.h, cam.w, cfg)
    start, end, sets, num_pairs, overflow = _np_expand(proj, cam.h, cam.w,
                                                       cfg)
    np.testing.assert_array_equal(np.asarray(bins.tile_start), start)
    np.testing.assert_array_equal(np.asarray(bins.tile_end), end)
    assert int(bins.num_pairs) == num_pairs
    assert int(bins.overflow) == overflow
    ranks = np.asarray(bins.ranks)
    if cfg.binning_key == "rank":   # ranks index the depth order
        depth = np.where(np.asarray(proj.visible), np.asarray(proj.depth),
                         np.inf)
        ranks = np.argsort(depth, kind="stable")[ranks]
    for t in range(bins.tiles_x * bins.tiles_y):
        got = ranks[start[t]:end[t]]
        assert len(set(got.tolist())) == got.size, f"tile {t} repeats"
        assert set(got.tolist()) == sets[t], f"tile {t}"
    return bins


@pytest.mark.parametrize("key", ["rank", "depth"])
def test_expansion_matches_numpy(small_random_scene, key):
    cam = Camera.create(h=96, w=128, position=(0.0, 0.0, 4.0))
    bins = _check(small_random_scene, cam,
                  RenderConfig(binning_key=key))
    assert int(bins.num_pairs) > 0
    assert int(bins.overflow) == 0


@pytest.mark.parametrize("key", ["rank", "depth"])
def test_expansion_overflow_matches_numpy(key):
    """Capacity overflow: the dropped pairs and the reported count must
    follow the documented pre-sort slot order exactly."""
    scene = random_scene(4096, seed=4, extent=0.5, scale_range=(0.3, 0.8))
    cam = Camera.create(h=128, w=128, position=(0.0, 0.0, 2.0))
    bins = _check(scene, cam,
                  RenderConfig(binning_key=key, max_dup_factor=1.0))
    assert int(bins.overflow) > 0


def test_expansion_multi_tile_spans():
    """Large splats spanning many tiles exercise the span decode."""
    scene = random_scene(256, seed=9, extent=1.0, scale_range=(0.1, 0.4))
    cam = Camera.create(h=160, w=224, position=(0.0, 0.0, 3.0))
    bins = _check(scene, cam, RenderConfig(tile_px=16, max_dup_factor=32))
    occ = np.asarray(bins.tile_end) - np.asarray(bins.tile_start)
    assert int(bins.overflow) == 0
    assert int(bins.num_pairs) > 4 * 256       # many tiles per splat
    assert occ.max() > 8


def test_expansion_empty_scene():
    """Camera looking away: zero visible pairs, all-sentinel keys."""
    scene = random_scene(128, seed=1)
    cam = Camera.create(h=64, w=64, position=(0.0, 0.0, 50.0),
                        target=(0.0, 0.0, 100.0))
    bins = _check(scene, cam, RenderConfig())
    assert int(bins.num_pairs) == 0
    assert int(np.asarray(bins.tile_end).max()) == 0


def test_expansion_huge_tile_grid():
    """A 257-tile-wide grid (far past the byte-split bounds an expansion
    kernel could assume) bins and renders correctly."""
    from splat_tpu.render.dense import render_dense
    from splat_tpu.render.tiled import render_tiled
    from splat_tpu.utils.image import psnr

    scene = random_scene(64, seed=2, extent=1.0, scale_range=(0.05, 0.2))
    cam = Camera.create(h=16, w=16 * 257, position=(0.0, 0.0, 4.0))
    cfg = RenderConfig(tile_px=16)
    bins = _check(scene, cam, cfg)
    assert bins.tiles_x == 257
    img = np.asarray(render_tiled(scene, cam, cfg))
    want = np.asarray(render_dense(scene, cam, cfg))
    assert psnr(img, want) >= 45.0


def test_expansion_depth_keys_front_to_back(small_random_scene):
    """Depth mode: within each tile, quantized depth keys never
    decrease, i.e. the sort key's low bits order pairs front to back."""
    cam = Camera.create(h=96, w=128, position=(0.0, 0.0, 4.0))
    cfg = RenderConfig(binning_key="depth")
    bins = _check(small_random_scene, cam, cfg)
    proj = project_gaussians(small_random_scene, cam, cfg)
    depth = np.asarray(proj.depth)
    idx = np.asarray(bins.ranks)
    start, end = np.asarray(bins.tile_start), np.asarray(bins.tile_end)
    vis = np.asarray(proj.visible)
    ntiles = bins.tiles_x * bins.tiles_y
    bits = max(1, min(24, 32 - max(int(ntiles).bit_length(), 1)))
    step = (depth[vis].max() - depth[vis].min()) / ((1 << bits) - 1)
    for t in range(ntiles):
        d = depth[idx[start[t]:end[t]]]
        assert np.all(np.diff(d) >= -step * (1 + 1e-3)), f"tile {t}"


def test_full_32bit_key_order_trick():
    """When tile+rank bits fill all 32, binning XORs the key space with
    0x80000000 so SIGNED int32 sort order equals unsigned order.  Pin the
    trick itself: for random (tile, rank) packs occupying the sign bit,
    sorting the XORed keys as signed ints must order pairs by (tile,
    rank) exactly, and rank extraction from the low bits is unaffected."""
    rng = np.random.default_rng(0)
    bits_rank = 20
    tiles = rng.integers(0, 4082, size=4096, dtype=np.int64)   # 12 bits
    ranks = rng.integers(0, 1 << bits_rank, size=4096, dtype=np.int64)
    unsigned = (tiles << bits_rank) | ranks                    # 32 bits
    keys = (unsigned & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    keys ^= np.int32(-(1 << 31))
    order_signed = np.argsort(keys, kind="stable")
    order_unsigned = np.argsort(unsigned, kind="stable")
    np.testing.assert_array_equal(order_signed, order_unsigned)
    # low rank bits survive the sign flip untouched
    np.testing.assert_array_equal(keys & ((1 << bits_rank) - 1), ranks)


def test_large_tile_grid_bins_in_order():
    """A 4096-tile grid (8-px tiles) bins by tile, strictly front to
    back in rank mode."""
    scene = random_scene(600, seed=3, extent=1.5, scale_range=(0.02, 0.06))
    cam = Camera.create(h=8 * 64, w=8 * 64, position=(0.0, 0.0, 4.0))
    cfg = RenderConfig(tile_px=8, binning_key="rank")
    bins = _check(scene, cam, cfg)
    assert bins.tiles_x * bins.tiles_y == 4096
    ranks = np.asarray(bins.ranks)
    start, end = np.asarray(bins.tile_start), np.asarray(bins.tile_end)
    for t in range(4096):
        assert np.all(np.diff(ranks[start[t]:end[t]]) > 0)


def test_pair_cull_is_lossless():
    """cull_pairs drops only pairs whose every pixel fails the alpha
    cutoff, so the rendered image must match the no-cull image — while
    actually culling something on a big-splat scene."""
    from splat_tpu.render.tiled import render_tiled
    from splat_tpu.utils.image import psnr

    scene = random_scene(256, seed=5, extent=0.8, scale_range=(0.4, 1.0))
    cam = Camera.create(h=256, w=256, position=(0.0, 0.0, 2.5))
    cfg = RenderConfig(chunk=64)
    cfg_cull = dataclasses.replace(cfg, cull_pairs=True)
    img0, s0 = render_tiled(scene, cam, cfg, return_stats=True)
    img1, s1 = render_tiled(scene, cam, cfg_cull, return_stats=True)
    assert int(s1["num_pairs"]) < int(s0["num_pairs"]), \
        "cull removed nothing on a big-splat scene"
    # Culled pairs contribute exactly zero alpha, but removing them shifts
    # the kernel's batch boundaries, and the saturation exit is
    # batch-granular — so images agree to the saturation tolerance
    # (contributions below transmittance 1/255), not bit-exactly.
    p = psnr(np.asarray(img0), np.asarray(img1))
    assert p >= 60.0, f"cull changed the image beyond tolerance: {p:.1f} dB"
