"""Tiled renderer tests: binning correctness + kernel parity (interpret
mode on CPU) against the dense renderer and the oracle."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from splat_tpu.camera import Camera
from splat_tpu.config import RenderConfig
from splat_tpu.ops.projection import project_gaussians
from splat_tpu.render.binning import build_tile_bins
from splat_tpu.render.dense import render_dense
from splat_tpu.render.oracle import render_oracle
from splat_tpu.render.tiled import render_tiled
from splat_tpu.utils.fixtures import naive_gaussians, random_scene
from splat_tpu.utils.image import psnr


def _cfg(**kw):
    kw.setdefault("chunk", 64)  # small chunks: cheap in interpret mode
    return RenderConfig(**kw)


class TestBinning:
    def test_counts_and_ranges_consistent(self, small_random_scene):
        cam = Camera.create(h=96, w=128, position=(0.0, 0.0, 4.0))
        config = _cfg()
        proj = project_gaussians(small_random_scene, cam, config)
        bins = build_tile_bins(proj, cam.h, cam.w, config)
        start = np.asarray(bins.tile_start)
        end = np.asarray(bins.tile_end)
        assert start.shape == end.shape == (bins.tiles_x * bins.tiles_y,)
        assert np.all(end >= start)
        assert np.all(np.diff(np.stack([start, end], 1).ravel()) >= 0)
        # total pairs match the per-tile ranges
        assert int(bins.num_pairs) == int((end - start).sum())
        assert int(bins.overflow) == 0

    def test_every_visible_gaussian_lands_in_its_center_tile(self):
        scene = random_scene(64, seed=3, extent=1.5, scale_range=(0.03, 0.1))
        cam = Camera.create(h=64, w=64, position=(0.0, 0.0, 4.0))
        config = _cfg()
        proj = project_gaussians(scene, cam, config)
        bins = build_tile_bins(proj, 64, 64, config)
        feats = np.asarray(bins.features)          # (8, Kp) packed int32
        cx_row = feats[0].view(np.float32)         # rows 0/1 are f32 bits
        cy_row = feats[1].view(np.float32)
        start = np.asarray(bins.tile_start)
        end = np.asarray(bins.tile_end)
        center = np.asarray(proj.center_px)
        visible = np.asarray(proj.visible)
        tp = config.tile_px
        for i in range(64):
            if not visible[i]:
                continue
            cx, cy = center[i]
            tx = min(max(int(cx // tp), 0), bins.tiles_x - 1)
            ty = min(max(int(cy // tp), 0), bins.tiles_y - 1)
            t = ty * bins.tiles_x + tx
            match = np.isclose(cx_row[start[t]:end[t]], cx, atol=1e-3) & \
                np.isclose(cy_row[start[t]:end[t]], cy, atol=1e-3)
            assert match.any(), f"gaussian {i} missing from center tile {t}"

    def test_within_tile_depth_order(self, small_random_scene):
        """Pairs inside each tile must be front-to-back: bins.ranks carries
        each sorted pair's depth rank (ranks are assigned by ascending view
        depth), and ranks must be strictly increasing within every tile's
        [start, end) range.  This is the correctness heart of the binning
        design (the packed (tile ‖ rank) key makes the unstable tile sort
        depth-ordered inside each tile); any ordering bug — e.g. dropping
        the rank bits from the key — must fail this test.  Rank order is
        verified against the actual view depths, not just monotonicity.
        (Pinned to binning_key='rank': the depth-key default's equivalent
        contract — nondecreasing quantized depth within every tile — is
        TestDepthKeyBinning.test_within_tile_depth_order.)"""
        cam = Camera.create(h=64, w=64, position=(0.0, 0.0, 4.0))
        config = _cfg(binning_key="rank")
        proj = project_gaussians(small_random_scene, cam, config)
        bins = build_tile_bins(proj, 64, 64, config)
        ranks = np.asarray(bins.ranks)
        start = np.asarray(bins.tile_start)
        end = np.asarray(bins.tile_end)
        # depth by rank: rank r is the r-th gaussian in ascending view
        # depth (invisible ones sort to the tail with depth inf)
        depth_key = np.where(np.asarray(proj.visible),
                             np.asarray(proj.depth), np.inf)
        depth_of_rank = np.sort(depth_key)
        checked_pairs = 0
        for t in range(bins.tiles_x * bins.tiles_y):
            r = ranks[start[t]:end[t]]
            assert np.all(np.diff(r) > 0), (
                f"tile {t} not front-to-back: ranks {r}")
            depths = depth_of_rank[r]
            assert np.all(np.diff(depths) >= 0)
            checked_pairs += r.size
        # the scene must actually exercise multi-pair tiles
        assert checked_pairs == int(bins.num_pairs)
        assert (end - start).max() >= 8

    def test_overflow_reported(self):
        # k_cap is grain-rounded to >= 4096 slots, so overflow needs a
        # scene whose pair count clears that floor: 4096 huge splats at
        # dup 1 produce ~60k pairs against a 4096-slot capacity.
        scene = random_scene(4096, seed=4, extent=0.5,
                             scale_range=(0.3, 0.8))  # huge splats
        cam = Camera.create(h=128, w=128, position=(0.0, 0.0, 2.0))
        config = _cfg(max_dup_factor=1)
        proj = project_gaussians(scene, cam, config)
        bins = build_tile_bins(proj, 128, 128, config)
        assert int(bins.overflow) > 0
        with pytest.raises(RuntimeError, match="overflow"):
            from splat_tpu.render.tiled import render_tiled_checked
            render_tiled_checked(scene, cam, config)


class TestTiledRender:
    def test_matches_dense_naive(self, naive_scene, demo_camera):
        config = _cfg()
        tiled = np.asarray(render_tiled(naive_scene, demo_camera, config))
        dense = np.asarray(render_dense(naive_scene, demo_camera, config))
        assert tiled.shape == dense.shape
        p = psnr(tiled, dense)
        assert p >= 45.0, f"tiled vs dense PSNR {p:.2f}"

    def test_matches_oracle_random(self, small_random_scene):
        cam = Camera.create(h=96, w=160, position=(0.0, 0.0, 4.0))
        config = _cfg()
        tiled = np.asarray(render_tiled(small_random_scene, cam, config))
        gold = render_oracle(small_random_scene, cam, config)
        p = psnr(tiled, gold)
        assert p >= 45.0, f"tiled vs oracle PSNR {p:.2f}"

    def test_sigma_cutoff_inf_matches_oracle(self, small_random_scene):
        """Truncation-free mode: sigma_cutoff=inf + tight_radius makes
        every bbox exactly the alpha_min kill radius, so the kernel
        statically drops its bbox compares (kernels.py skip_bbox); the
        oracle's quad test is vacuous and only the alpha cutoff limits
        support.  Parity must hold with the diet applied."""
        import math
        cam = Camera.create(h=96, w=160, position=(0.0, 0.0, 4.0))
        config = _cfg(sigma_cutoff=math.inf, max_dup_factor=8.0)
        tiled = np.asarray(render_tiled(small_random_scene, cam, config))
        gold = render_oracle(small_random_scene, cam, config)
        p = psnr(tiled, gold)
        assert p >= 45.0, f"sigma=inf tiled vs oracle PSNR {p:.2f}"
        # inf without tight_radius would pair every splat with every
        # tile — rejected at construction
        with pytest.raises(ValueError):
            RenderConfig(sigma_cutoff=math.inf, tight_radius=False)

    def test_alpha_channel_rgba(self, small_random_scene):
        """config.alpha_channel: the fourth channel is the accumulated
        coverage 1 - T (notebook semantics — NOT the reference's
        last-fragment alpha byte, see PARITY.md); tiled, dense, and the
        oracle must agree, and the RGB planes must be unchanged."""
        from splat_tpu.render.dense import render_dense
        cam = Camera.create(h=96, w=160, position=(0.0, 0.0, 4.0))
        config = _cfg(alpha_channel=True)
        tiled = np.asarray(render_tiled(small_random_scene, cam, config))
        assert tiled.shape == (96, 160, 4)
        gold = render_oracle(small_random_scene, cam, config)
        assert gold.shape == (96, 160, 4)
        p = psnr(tiled, gold)
        assert p >= 45.0, f"RGBA tiled vs oracle PSNR {p:.2f}"
        dense = np.asarray(render_dense(small_random_scene, cam, config))
        assert psnr(dense, gold) >= 45.0
        # RGB planes identical to the 3-channel render
        rgb = np.asarray(render_tiled(
            small_random_scene, cam, _cfg()))
        np.testing.assert_array_equal(tiled[..., :3], rgb)
        # coverage is real: some pixels opaque-ish, background pixels ~0
        assert tiled[..., 3].max() > 0.5
        assert tiled[..., 3].min() < 1e-3

    def test_alpha_clamp_near_one_matches_oracle(self, small_random_scene):
        """alpha_clamp ~ 1 takes the kernel's guarded log1p branch (the
        min(alpha, 0.999999) that alpha_clamp=0.99 compiles away); the
        oracle clamps at the configured value, so parity pins both the
        guard's correctness and its clamp constant."""
        cam = Camera.create(h=96, w=160, position=(0.0, 0.0, 4.0))
        config = _cfg(alpha_clamp=0.9999999)
        tiled = np.asarray(render_tiled(small_random_scene, cam, config))
        gold = render_oracle(small_random_scene, cam, config)
        p = psnr(tiled, gold)
        assert p >= 45.0, f"alpha_clamp~1 tiled vs oracle PSNR {p:.2f}"

    def test_rectangular_tiles(self, small_random_scene):
        """tile_py != tile_px: rect tiles trade pair count against pixel
        work; the image must match the square-tile render (same math,
        different decomposition) and the dense reference."""
        cam = Camera.create(h=96, w=160, position=(0.0, 0.0, 4.0))
        sq = np.asarray(render_tiled(small_random_scene, cam, _cfg()))
        for tpy in (16, 8):
            cfg = _cfg(tile_py=tpy)
            rect = np.asarray(render_tiled(small_random_scene, cam, cfg))
            p = psnr(rect, sq)
            assert p >= 60.0, f"32x{tpy} vs 32x32 PSNR {p:.2f}"
        dense = np.asarray(render_dense(small_random_scene, cam, _cfg()))
        assert psnr(rect, dense) >= 45.0

    def test_nondivisible_resolution(self, naive_scene):
        """H/W not multiples of tile_px: edge tiles crop correctly."""
        cam = Camera.create(h=70, w=90,
                            position=(-0.57651054, 2.99040512, -0.03924271))
        config = _cfg()
        tiled = np.asarray(render_tiled(naive_scene, cam, config))
        dense = np.asarray(render_dense(naive_scene, cam, config))
        assert tiled.shape == (70, 90, 3)
        assert psnr(tiled, dense) >= 45.0

    def test_saturation_early_exit_is_exact(self):
        """Opaque front splat: early exit must not change the image."""
        scene = random_scene(256, seed=9, extent=1.0,
                             scale_range=(0.1, 0.3))
        # crank opacities to force saturation
        scene = type(scene).create(
            means=scene.means, quats=scene.quats, scales=scene.scales,
            opacities=np.full(256, 0.99, np.float32), sh=scene.sh)
        cam = Camera.create(h=64, w=64, position=(0.0, 0.0, 3.0))
        config = _cfg(chunk=32)
        tiled = np.asarray(render_tiled(scene, cam, config))
        dense = np.asarray(render_dense(scene, cam, config))
        assert psnr(tiled, dense) >= 45.0

    def test_stats(self, small_random_scene):
        cam = Camera.create(h=64, w=64, position=(0.0, 0.0, 4.0))
        config = _cfg()
        img, stats = render_tiled(small_random_scene, cam, config,
                                  return_stats=True)
        assert int(stats["visible"]) > 0
        assert int(stats["num_pairs"]) >= int(stats["visible"])
        assert int(stats["overflow"]) == 0
        assert img.shape == (64, 64, 3)

    def test_empty_visibility(self):
        scene = naive_gaussians()
        cam = Camera.create(h=64, w=64, position=(0.0, 0.0, 50.0),
                            target=(0.0, 0.0, 100.0))  # looking away
        img = np.asarray(render_tiled(scene, cam, _cfg()))
        assert np.allclose(img, 0.0)

    def test_packed_device_scene_matches(self, small_random_scene):
        """pack_device (feature-major DeviceScene) is a pure layout
        change; the rendered image must be identical."""
        cam = Camera.create(h=96, w=160, position=(0.0, 0.0, 4.0))
        a = np.asarray(render_tiled(small_random_scene, cam, _cfg()))
        b = np.asarray(render_tiled(small_random_scene.pack_device(), cam,
                                    _cfg()))
        np.testing.assert_array_equal(a, b)

    def test_public_render_autopacks_host_scene(self, small_random_scene):
        """The convenience render() must route a host GaussianScene
        through the feature-major DeviceScene hot path (auto-pack) and
        produce the same pixels as an explicit pack_device().  (ulp-level
        tolerance: the checked wrapper's return_stats program fuses
        differently from the plain one — measured 2.7e-6 max abs after
        the round-5 intrinsics_px projection refactor reassociated the
        upstream math; this test gates ROUTING, precision parity is the
        PSNR suite's job.)"""
        from splat_tpu.render.api import render
        cam = Camera.create(h=96, w=160, position=(0.0, 0.0, 4.0))
        cfg = _cfg()
        a = np.asarray(render(small_random_scene, cam, cfg,
                              method="tiled"))
        b = np.asarray(render_tiled(small_random_scene.pack_device(),
                                    cam, cfg))
        np.testing.assert_allclose(a, b, atol=1e-5)

    def test_empty_scene_renders_background(self):
        """A zero-gaussian scene must render pure background through the
        tiled path (the binning pipeline has no N=0 shape; regression:
        cum[-1] IndexError)."""
        from splat_tpu.render.api import render
        from splat_tpu.utils.fixtures import random_scene
        cam = Camera.create(h=64, w=64, position=(0.0, 0.0, 4.0))
        cfg = _cfg(background=(0.25, 0.5, 0.75))
        img, stats = render_tiled(random_scene(0, seed=0), cam, cfg,
                                  return_stats=True)
        assert np.asarray(img).shape == (64, 64, 3)
        np.testing.assert_allclose(
            np.asarray(img)[0, 0], [0.25, 0.5, 0.75])
        assert int(stats["num_pairs"]) == 0
        # and through the public checked wrapper
        img2 = np.asarray(render(random_scene(0, seed=0), cam, cfg,
                                 method="tiled"))
        np.testing.assert_allclose(img2[-1, -1], [0.25, 0.5, 0.75])

    def test_radius_sentinel_screen_filling_splat(self):
        """A splat whose bbox half-extent exceeds the 15-bit 1/8-px field
        (4095.875 px) must still cover the whole screen: the saturated
        field is a covers-everything sentinel (full tile-grid span in
        binning, bbox test disabled in the kernel).  Pre-round-3 code
        silently truncated both."""
        from splat_tpu.ops.sh import rgb_to_dc
        from splat_tpu.scene import GaussianScene

        sh = np.zeros((1, 16, 3), np.float32)
        sh[0, 0] = np.asarray(rgb_to_dc(np.array([0.9, 0.2, 0.1])))
        scene = GaussianScene.create(
            means=np.zeros((1, 3), np.float32),
            quats=np.array([[1.0, 0, 0, 0]], np.float32),
            scales=np.full((1, 3), 20.0, np.float32),
            opacities=np.array([0.9], np.float32),
            sh=sh)
        cam = Camera.create(h=64, w=64, position=(0.0, 0.0, 0.3))
        proj = project_gaussians(scene, cam, _cfg())
        assert float(np.asarray(proj.radius_px).max()) > 4096.0
        bins = build_tile_bins(proj, 64, 64, _cfg())
        # sentinel span: the single splat lands in EVERY tile
        assert int(bins.num_pairs) == bins.tiles_x * bins.tiles_y
        tiled = np.asarray(render_tiled(scene, cam, _cfg()))
        dense = np.asarray(render_dense(scene, cam, _cfg()))
        assert float(tiled.min()) > 0.0  # covers every pixel
        assert psnr(tiled, dense) >= 45.0

    def test_pair_stats_matches_binning_exactly(self, small_random_scene):
        """--dup-factor auto sizing must agree with what binning actually
        produces (shared span machinery, not a drifting twin that uses
        raw f32 radii)."""
        from splat_tpu.render.api import pair_stats

        cam = Camera.create(h=96, w=160, position=(0.0, 0.0, 4.0))
        config = _cfg()
        stats = pair_stats(small_random_scene, cam, config)
        _, full = render_tiled(small_random_scene, cam, config,
                               return_stats=True)
        assert stats["num_pairs"] == int(full["num_pairs"])
        assert stats["visible"] == int(full["visible"])


class TestDepthKeyBinning:
    """binning_key='depth': (tile ‖ quantized depth) keys with the
    gaussian index riding the pair sort as a payload — no N-side argsort
    or depth-order gather (see binning.py step 1)."""

    def test_matches_rank_mode_pair_sets(self, small_random_scene):
        """Both modes must produce the same per-tile pair SETS and
        ranges; only the within-tile tie order may differ (and with
        distinct depths, not even that)."""
        cam = Camera.create(h=96, w=128, position=(0.0, 0.0, 4.0))
        proj = project_gaussians(small_random_scene, cam, _cfg())
        br = build_tile_bins(proj, 96, 128, _cfg(binning_key="rank"))
        bd = build_tile_bins(proj, 96, 128, _cfg(binning_key="depth"))
        np.testing.assert_array_equal(np.asarray(br.tile_start),
                                      np.asarray(bd.tile_start))
        np.testing.assert_array_equal(np.asarray(br.tile_end),
                                      np.asarray(bd.tile_end))
        assert int(br.num_pairs) == int(bd.num_pairs)
        # rank mode's ranks are depth ranks; map them to gaussian
        # indices via the depth order to compare pair sets
        depth_key = np.where(np.asarray(proj.visible),
                             np.asarray(proj.depth), np.inf)
        order = np.argsort(depth_key, kind="stable")
        start = np.asarray(br.tile_start)
        end = np.asarray(br.tile_end)
        rr = order[np.asarray(br.ranks)]       # gaussian index per pair
        rd = np.asarray(bd.ranks)
        for t in range(br.tiles_x * br.tiles_y):
            assert (set(rr[start[t]:end[t]].tolist())
                    == set(rd[start[t]:end[t]].tolist())), f"tile {t}"

    def test_within_tile_depth_order(self, small_random_scene):
        """Depth-mode front-to-back contract: within every tile's range,
        the pairs' QUANTIZED depths are nondecreasing — i.e. true view
        depths never decrease by more than one quantization step."""
        cam = Camera.create(h=64, w=64, position=(0.0, 0.0, 4.0))
        config = _cfg(binning_key="depth")
        proj = project_gaussians(small_random_scene, cam, config)
        bins = build_tile_bins(proj, 64, 64, config)
        idx = np.asarray(bins.ranks)
        start = np.asarray(bins.tile_start)
        end = np.asarray(bins.tile_end)
        visible = np.asarray(proj.visible)
        depth = np.asarray(proj.depth)
        num_tiles = bins.tiles_x * bins.tiles_y
        depth_bits = max(1, min(24, 32 - max(int(num_tiles).bit_length(),
                                             1)))
        dvis = depth[visible]
        step = (dvis.max() - dvis.min()) / ((1 << depth_bits) - 1)
        checked = 0
        for t in range(num_tiles):
            ii = idx[start[t]:end[t]]
            assert np.all((ii >= 0) & (ii < visible.size))
            assert visible[ii].all()
            d = depth[ii]
            # nondecreasing up to one quantization bucket
            assert np.all(np.diff(d) >= -step * (1 + 1e-3)), f"tile {t}"
            checked += ii.size
        assert checked == int(bins.num_pairs)
        assert (end - start).max() >= 8

    @pytest.mark.parametrize("extra", [{}, {"cull_pairs": True},
                                       {"tile_px": 16}])
    def test_matches_oracle(self, small_random_scene, extra):
        cam = Camera.create(h=96, w=160, position=(0.0, 0.0, 4.0))
        config = _cfg(binning_key="depth", **extra)
        img = np.asarray(render_tiled(small_random_scene, cam, config))
        want = render_oracle(small_random_scene, cam, config)
        p = psnr(img, want)
        assert p >= 45.0, f"depth-key parity {p:.2f} dB {extra}"

    def test_overflow_reported(self):
        scene = random_scene(4096, seed=4, extent=0.5,
                             scale_range=(0.3, 0.8))
        cam = Camera.create(h=128, w=128, position=(0.0, 0.0, 2.0))
        config = _cfg(binning_key="depth", max_dup_factor=1.0)
        proj = project_gaussians(scene, cam, config)
        bins = build_tile_bins(proj, 128, 128, config)
        assert int(bins.overflow) > 0

    def test_interleaved_invisibility_pair_sets(self):
        """Regression: depth mode keeps SCENE order, so invisible
        (zero-count) gaussians interleave with visible ones (the sharded
        slab re-gate leaves ~25% visible) and each spends one
        sentinel-tile fake slot.  This test re-gates visibility to a
        narrow row slab (the adversarial pattern) and requires depth
        mode's pair sets, counts, and ranges to match rank mode's
        exactly."""
        import dataclasses as dc

        scene = random_scene(6144, seed=9, extent=2.5,
                             scale_range=(0.01, 0.05))
        cam = Camera.create(h=128, w=128, position=(0.0, 0.0, 4.0))
        proj = project_gaussians(scene, cam, _cfg())
        # slab re-gate: rows [48, 64) only — most gaussians invisible,
        # interleaved in scene order
        center = proj.center_px - jnp.asarray([0.0, 48.0])[None, :]
        vis = (proj.visible
               & (center[:, 1] + proj.radius_px[:, 1] > 0)
               & (center[:, 1] - proj.radius_px[:, 1] < 16))
        proj2 = dc.replace(proj, center_px=center, visible=vis)
        frac = float(np.asarray(vis).mean())
        assert frac < 0.5, f"fixture not adversarial enough ({frac:.2f})"
        br = build_tile_bins(proj2, 16, 128, _cfg(binning_key="rank"))
        bd = build_tile_bins(proj2, 16, 128, _cfg(binning_key="depth"))
        np.testing.assert_array_equal(np.asarray(br.tile_start),
                                      np.asarray(bd.tile_start))
        np.testing.assert_array_equal(np.asarray(br.tile_end),
                                      np.asarray(bd.tile_end))
        assert int(br.num_pairs) == int(bd.num_pairs)
        assert int(bd.overflow) == 0
        order = np.argsort(np.where(np.asarray(vis),
                                    np.asarray(proj2.depth), np.inf),
                           kind="stable")
        rr = order[np.asarray(br.ranks)]
        rd = np.asarray(bd.ranks)
        start, end = np.asarray(br.tile_start), np.asarray(br.tile_end)
        for t in range(br.tiles_x * br.tiles_y):
            assert (set(rr[start[t]:end[t]].tolist())
                    == set(rd[start[t]:end[t]].tolist())), f"tile {t}"

    def test_fake_slot_accounting_conservation(self):
        """Depth-mode fake slots must be invisible to the public
        contracts: num_pairs + overflow == the true pair count at every
        capacity, and an all-invisible frame reports zero overflow even
        when capacity < N (only fakes are dropped)."""
        import dataclasses as dc

        scene = random_scene(8192, seed=3, extent=2.0,
                             scale_range=(0.02, 0.12))
        cam = Camera.create(h=64, w=64, position=(0.0, 0.0, 4.0))
        proj = project_gaussians(scene, cam, _cfg())
        # keep ~half visible, interleaved
        keep = jnp.asarray(np.arange(8192) % 2 == 0)
        proj2 = dc.replace(proj, visible=proj.visible & keep)
        ref = build_tile_bins(proj2, 64, 64, _cfg(binning_key="rank",
                                                  max_dup_factor=64.0))
        true_pairs = int(ref.num_pairs)
        assert true_pairs > 0
        saw_overflow = False
        for dup in (0.5, 1.0, 2.0, 64.0):
            bins = build_tile_bins(proj2, 64, 64,
                                   _cfg(binning_key="depth",
                                        max_dup_factor=dup))
            assert (int(bins.num_pairs) + int(bins.overflow)
                    == true_pairs), f"dup={dup}"
            saw_overflow |= int(bins.overflow) > 0
        assert saw_overflow  # the small capacities must actually bind
        # all-invisible: fakes fill slots but never count as overflow
        proj3 = dc.replace(proj, visible=jnp.zeros((8192,), jnp.bool_))
        bins = build_tile_bins(proj3, 64, 64,
                               _cfg(binning_key="depth",
                                    max_dup_factor=0.5))
        assert int(bins.num_pairs) == 0
        assert int(bins.overflow) == 0


class TestSupersample:
    """RenderConfig.supersample: render at k x (H, W), box-filter down —
    the notebook's supersampled-target AA (SURVEY §2.1 notebook row)."""

    def test_tiled_matches_oracle_at_2x(self, small_random_scene):
        cam = Camera.create(h=64, w=96, position=(0.0, 0.0, 4.0))
        config = _cfg(supersample=2)
        tiled = np.asarray(render_tiled(small_random_scene, cam, config))
        assert tiled.shape == (64, 96, 3)  # output stays native res
        gold = render_oracle(small_random_scene, cam, config)
        assert gold.shape == (64, 96, 3)
        p = psnr(tiled, gold)
        assert p >= 45.0, f"2x-supersampled tiled vs oracle PSNR {p:.2f}"

    def test_dense_matches_oracle_at_2x(self, small_random_scene):
        cam = Camera.create(h=48, w=64, position=(0.0, 0.0, 4.0))
        config = RenderConfig(supersample=2)
        dense = np.asarray(render_dense(small_random_scene, cam, config))
        assert dense.shape == (48, 64, 3)
        gold = render_oracle(small_random_scene, cam, config)
        p = psnr(dense, gold)
        assert p >= 45.0, f"2x-supersampled dense vs oracle PSNR {p:.2f}"

    def test_supersample_equals_manual_downsample(self, small_random_scene):
        """ss=2 is exactly: render at 2x resolution, box-average 2x2."""
        from splat_tpu.utils.image import box_downsample
        import dataclasses
        cam = Camera.create(h=48, w=64, position=(0.0, 0.0, 4.0))
        ss = np.asarray(render_dense(small_random_scene, cam,
                                     RenderConfig(supersample=2)))
        cam2 = dataclasses.replace(cam, h=96, w=128)
        hi = np.asarray(render_dense(small_random_scene, cam2,
                                     RenderConfig()))
        np.testing.assert_allclose(ss, box_downsample(hi, 2), atol=1e-6)

    def test_supersample_reduces_aliasing_error(self):
        """On a scene with sub-pixel splats, ss=4 must be closer to a
        high-res ground truth than the native render is."""
        scene = random_scene(64, seed=3, scale_range=(0.002, 0.008))
        cam = Camera.create(h=32, w=32, position=(0.0, 0.0, 3.0))
        gold = render_oracle(scene, cam, RenderConfig(supersample=8))
        native = render_oracle(scene, cam, RenderConfig())
        ss4 = render_oracle(scene, cam, RenderConfig(supersample=4))
        err_native = float(np.abs(native - gold).mean())
        err_ss = float(np.abs(ss4 - gold).mean())
        assert err_ss < err_native

    def test_config_validation(self):
        with pytest.raises(ValueError, match="supersample"):
            RenderConfig(supersample=0)
        with pytest.raises(ValueError, match="supersample"):
            RenderConfig(supersample=1.5)

    def test_pair_stats_counts_supersampled_pairs(self, small_random_scene):
        from splat_tpu.render.api import pair_stats
        cam = Camera.create(h=64, w=64, position=(0.0, 0.0, 4.0))
        s1 = pair_stats(small_random_scene, cam, RenderConfig())
        s2 = pair_stats(small_random_scene, cam,
                        RenderConfig(supersample=2))
        assert s2["num_pairs"] > s1["num_pairs"]


class TestAutoCapacity:
    """auto_config / render(config=None) capacity auto-sizing."""

    def test_auto_config_sizes_from_pair_load(self, small_random_scene):
        from splat_tpu.render.api import auto_config, pair_stats
        cam = Camera.create(h=96, w=128, position=(0.0, 0.0, 4.0))
        cfg = auto_config(small_random_scene, cam)
        stats = pair_stats(small_random_scene, cam, cfg)
        n = small_random_scene.num_gaussians
        # capacity covers the measured slots and is far below the 4.0
        # conservative default on this small-footprint scene
        assert cfg.max_dup_factor * n >= stats["slots"]
        assert cfg.max_dup_factor < 4.0
        # quantized to 0.25 steps (pose stability -> compile reuse)
        assert abs(cfg.max_dup_factor / 0.25
                   - round(cfg.max_dup_factor / 0.25)) < 1e-9

    def test_auto_config_quantization_is_pose_stable(self,
                                                     small_random_scene):
        from splat_tpu.render.api import auto_config
        cam = Camera.create(h=96, w=128, position=(0.0, 0.0, 4.0))
        a = auto_config(small_random_scene, cam)
        b = auto_config(small_random_scene, cam.rotate(dyaw=0.02))
        assert a.max_dup_factor == b.max_dup_factor  # same compiled shape

    def test_render_default_config_autosizes_and_does_not_overflow(self):
        """render() with no config on a >4096-splat scene (tiled path)
        must auto-size capacity and still render correctly."""
        from splat_tpu.render.api import render
        scene = random_scene(5000, seed=5)
        cam = Camera.create(h=96, w=128, position=(0.0, 0.0, 4.0))
        img = np.asarray(render(scene, cam))  # raises on overflow
        gold = render_oracle(scene, cam, RenderConfig())
        p = psnr(img, gold)
        assert p >= 45.0, f"auto-capacity render vs oracle PSNR {p:.2f}"

    def test_render_explicit_config_is_respected(self, small_random_scene):
        """An explicit config must never be silently re-sized."""
        from splat_tpu.render.api import render
        cam = Camera.create(h=64, w=64, position=(0.0, 0.0, 4.0))
        cfg = RenderConfig(max_dup_factor=1.25)
        scene = random_scene(5000, seed=5)
        try:
            render(scene, cam, cfg, method="tiled")
        except RuntimeError as e:
            assert "overflow" in str(e)  # tight capacity stays tight

    def test_render_auto_config_is_cached_per_scene(self, monkeypatch):
        """The auto-capacity measurement is one extra jit dispatch and
        host sync: a frame loop over render() must pay it once per
        (scene, resolution), not per frame."""
        from splat_tpu.render import api
        scene = random_scene(5000, seed=5).pack_device()
        cam = Camera.create(h=64, w=64, position=(0.0, 0.0, 4.0))
        calls = []
        real = api.auto_config
        monkeypatch.setattr(api, "auto_config",
                            lambda *a, **k: calls.append(1) or real(*a, **k))
        api._AUTO_CONFIG_CACHE.clear()
        api.render(scene, cam)
        api.render(scene, cam.rotate(dyaw=0.1))
        api.render(scene, cam.rotate(dyaw=0.2))
        assert len(calls) == 1, f"auto_config ran {len(calls)}x for one scene"

    def test_render_auto_config_remeasures_on_overflow(self):
        """A cached auto capacity outgrown by a pose change must be
        re-measured and retried, never raise to the caller or truncate."""
        from splat_tpu.render import api
        host = random_scene(5000, seed=5, extent=2.0,
                            scale_range=(0.01, 0.05))
        scene = host.pack_device()
        far = Camera.create(h=96, w=96, position=(0.0, 0.0, 12.0))
        near = Camera.create(h=96, w=96, position=(0.0, 0.0, 1.2))
        api._AUTO_CONFIG_CACHE.clear()
        api.render(scene, far)   # sizes capacity at the light pose
        img = np.asarray(api.render(scene, near))  # heavier: must retry
        gold = render_oracle(host, near, RenderConfig())
        assert float(psnr(img, gold)) >= 45.0
