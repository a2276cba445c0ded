"""Tiled-path differentiable rendering (render/diff.py).

Validation strategy (three tiers, strongest first):

1. **Exact-replica VJP**: a pure-JAX forward that composites the SAME
   pair structure (bins) with straight-through quantization must agree
   with the custom VJP to machine precision — this pins the backward
   kernel's math exactly, including the u16/radius packing semantics.
2. **Forward parity**: render_tiled_diff is bit-identical to the
   production render_tiled (one kernel body: the training mode only
   changes the exit rule and adds the logT plane).
3. **Dense-path agreement**: cosine similarity vs jax.grad through
   render_dense (forwards differ by feature quantization, so elementwise
   equality is not expected; direction must agree).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from splat_tpu.camera import Camera
from splat_tpu.config import RenderConfig
from splat_tpu.ops.projection import project_gaussians
from splat_tpu.render.binning import (build_tile_bins, decode_radius_bits,
                                      quantize_radius_bits)
from splat_tpu.render.dense import render_dense
from splat_tpu.render.diff import render_tiled_diff
from splat_tpu.render.tiled import render_tiled
from splat_tpu.utils.fixtures import random_scene


def _jscene(n, seed):
    return jax.tree.map(jnp.asarray, random_scene(n, seed=seed))


def _replica_forward(scene, cam, cfg, ranks, ts, te, ntx, nty):
    """Pure-JAX composite of the same (constant) pair structure with
    straight-through quantization — the analytic ground truth for the
    custom VJP."""
    tw, th = cfg.tile_w, cfg.tile_h
    h, w = cam.h, cam.w

    def st_q(x, scale):
        q = jnp.round(jnp.clip(x, 0.0, 1.0) * scale) / scale
        return x + jax.lax.stop_gradient(q - x)

    proj = project_gaussians(scene, cam, cfg)
    cx, cy = proj.center_px[:, 0], proj.center_px[:, 1]
    a2 = -0.5 * proj.conic[:, 0]
    b2 = -proj.conic[:, 1]
    c2 = -0.5 * proj.conic[:, 2]
    col = st_q(jnp.clip(proj.color, 0.0, 1.0), 65535.0)
    op = st_q(proj.opacity, 65535.0)
    rbits = quantize_radius_bits(proj.radius_px[:, 0], proj.radius_px[:, 1],
                                 proj.visible)
    rx, ry, _ = decode_radius_bits(rbits)
    rx = jax.lax.stop_gradient(rx.astype(jnp.float32))
    ry = jax.lax.stop_gradient(ry.astype(jnp.float32))
    img = jnp.zeros((nty * th, ntx * tw, 3))
    for t in range(nty * ntx):
        idx = ranks[ts[t]:te[t]]
        if len(idx) == 0:
            continue
        ty_, tx_ = t // ntx, t % ntx
        py, px = jnp.mgrid[0:th, 0:tw]
        px = (px + tx_ * tw).astype(jnp.float32)
        py = (py + ty_ * th).astype(jnp.float32)
        transmit = jnp.ones((th, tw))
        c_acc = jnp.zeros((th, tw, 3))
        for i in idx:
            dx = px - cx[i]
            dy = cy[i] - py
            power = (a2[i] * dx * dx + c2[i] * dy * dy
                     + b2[i] * (dx * dy))
            al = jnp.minimum(cfg.alpha_clamp, op[i] * jnp.exp(power))
            keep = ((al >= cfg.alpha_min) & (dx * dx <= rx[i] ** 2)
                    & (dy * dy <= ry[i] ** 2))
            al = jnp.where(keep, al, 0.0)
            c_acc = c_acc + (transmit * al)[..., None] * col[i][None, None]
            transmit = transmit * (1.0 - al)
        img = img.at[ty_ * th:(ty_ + 1) * th,
                     tx_ * tw:(tx_ + 1) * tw].set(
            jnp.clip(c_acc + transmit[..., None]
                     * jnp.asarray(cfg.background), 0.0, 1.0))
    return img[:h, :w]


class TestForwardParity:
    def test_bit_identical_to_render_tiled(self):
        scene = _jscene(300, 1)
        cam = Camera.create(h=64, w=96, position=(0.0, 0.0, 4.0))
        cfg = RenderConfig(max_dup_factor=8.0)
        a = np.asarray(render_tiled(scene, cam, cfg))
        b = np.asarray(render_tiled_diff(scene, cam, cfg))
        np.testing.assert_array_equal(a, b)

    def test_alpha_channel_and_supersample(self):
        scene = _jscene(150, 2)
        cam = Camera.create(h=32, w=64, position=(0.0, 0.0, 4.0))
        cfg = RenderConfig(max_dup_factor=8.0, alpha_channel=True,
                           supersample=2)
        a = np.asarray(render_tiled(scene, cam, cfg))
        b = np.asarray(render_tiled_diff(scene, cam, cfg))
        assert b.shape == (32, 64, 4)
        np.testing.assert_allclose(a, b, atol=1e-6)

    def test_empty_scene(self):
        scene = jax.tree.map(jnp.asarray, random_scene(0, seed=0))
        cam = Camera.create(h=32, w=32, position=(0.0, 0.0, 4.0))
        img = np.asarray(render_tiled_diff(scene, cam, RenderConfig()))
        assert img.shape == (32, 32, 3)
        assert float(np.abs(img).max()) == 0.0

    def test_config_restrictions(self):
        scene = _jscene(10, 0)
        cam = Camera.create(h=32, w=32, position=(0.0, 0.0, 4.0))
        for bad in (RenderConfig(render_mode="depth"),  # needs a range
                    RenderConfig(binning_key="rank"),
                    RenderConfig(cull_pairs=True)):
            with pytest.raises(NotImplementedError):
                render_tiled_diff(scene, cam, bad)
        # depth mode WITH an explicit range is supported (round 5)
        img = render_tiled_diff(scene, cam,
                                RenderConfig(render_mode="depth",
                                             depth_range=(1.0, 5.0)))
        assert np.isfinite(np.asarray(img)).all()


class TestBackwardExact:
    def test_vjp_matches_straight_through_replica(self):
        """The decisive test: grads through the Pallas backward kernel ==
        jax.grad of the pure-JAX replica, to machine precision."""
        scene = _jscene(120, 7)
        cam = Camera.create(h=32, w=64, position=(0.0, 0.0, 4.0))
        cfg = RenderConfig(max_dup_factor=16.0)
        proj0 = project_gaussians(scene, cam, cfg)
        bins0 = build_tile_bins(proj0, cam.h, cam.w, cfg)
        ranks = np.asarray(bins0.ranks)
        ts, te = np.asarray(bins0.tile_start), np.asarray(bins0.tile_end)

        tgt = jnp.full((cam.h, cam.w, 3), 0.3)
        loss_ref = lambda s: jnp.mean((_replica_forward(
            s, cam, cfg, ranks, ts, te, bins0.tiles_x, bins0.tiles_y)
            - tgt) ** 2)
        loss_til = lambda s: jnp.mean(
            (render_tiled_diff(s, cam, cfg) - tgt) ** 2)
        ir = np.asarray(_replica_forward(scene, cam, cfg, ranks, ts, te,
                                         bins0.tiles_x, bins0.tiles_y))
        it = np.asarray(render_tiled_diff(scene, cam, cfg))
        assert np.abs(ir - it).max() < 1e-5
        gr = jax.grad(loss_ref)(scene)
        gt = jax.grad(loss_til)(scene)
        for name in ["means", "quats", "scales", "opacities", "sh"]:
            a = np.asarray(getattr(gt, name))
            b = np.asarray(getattr(gr, name))
            scale = np.abs(b).max() + 1e-20
            assert np.abs(a - b).max() / scale < 1e-4, \
                f"{name}: rel {np.abs(a - b).max() / scale:.2e}"

    def test_camera_pose_gradient(self):
        """Pose gradients come free through the projection pullback."""
        scene = _jscene(100, 9)
        cam = Camera.create(h=32, w=32, position=(0.0, 0.0, 4.0))
        cfg = RenderConfig(max_dup_factor=16.0)
        tgt = jnp.full((32, 32, 3), 0.2)

        def loss(yaw):
            c = dataclasses.replace(cam, yaw=yaw)
            return jnp.mean((render_tiled_diff(scene, c, cfg) - tgt) ** 2)

        g = float(jax.grad(loss)(jnp.float32(0.1)))
        assert np.isfinite(g)
        # direction agrees with the (noisy, quantized) finite difference
        eps = 1e-2
        fd = (float(loss(jnp.float32(0.1 + eps)))
              - float(loss(jnp.float32(0.1 - eps)))) / (2 * eps)
        assert np.sign(g) == np.sign(fd) or abs(fd) < 1e-5


class TestScatterImpls:
    """The sorted segment-sum scatter (the fast path) must reproduce the
    XLA scatter-add fallback exactly — including under capacity
    truncation, where _segment_offsets' retained-count arithmetic must
    match the binning's own accounting slot for slot."""

    def _pair_grads(self, n, seed, dup):
        from splat_tpu.render import diff as D

        scene = _jscene(n, seed)
        cam = Camera.create(h=64, w=96, position=(0.0, 0.0, 4.0))
        cfg = RenderConfig(max_dup_factor=dup)
        proj = project_gaussians(scene, cam, cfg)
        bins = build_tile_bins(proj, cam.h, cam.w, cfg)
        rng = np.random.default_rng(seed)
        g_c = jnp.asarray(rng.normal(size=(cam.h, cam.w, 3))
                          .astype(np.float32))
        g_lt = jnp.asarray(rng.normal(size=(cam.h, cam.w))
                           .astype(np.float32))
        planes, cut = D._fwd_raster(bins, cfg)
        grads = D._bwd_raster(bins, g_c, g_lt, planes[..., 3], cut, cfg)
        return D, scene, cfg, proj, bins, grads

    def _compare(self, n, seed, dup):
        D, scene, cfg, proj, bins, grads = self._pair_grads(n, seed, dup)
        ref = np.asarray(D._scatter_pair_grads_xla(grads, bins, n))
        fast = np.asarray(D._scatter_pair_grads(grads, bins, proj, n, cfg))
        scale = np.abs(ref).max() + 1e-20
        assert np.abs(fast - ref).max() / scale < 1e-6, \
            f"rel {np.abs(fast - ref).max() / scale:.2e}"
        return bins

    def test_matches_xla_fallback(self):
        bins = self._compare(300, 11, 8.0)
        assert int(bins.overflow) == 0

    def test_matches_under_capacity_truncation(self):
        # a tight capacity drops trailing pre-sort slots; the offsets
        # must reproduce exactly which pairs survived
        bins = self._compare(4000, 11, 1.0)
        assert int(bins.overflow) > 0  # truncation actually exercised

    def test_pair_grads_only_in_walked_slots(self):
        """Per-pair gradients land at the pair's own sorted slot: slots
        past the last real pair (fakes, unused capacity) stay exactly
        zero, and the walked pairs carry nonzero gradients."""
        _, _, _, _, bins, grads = self._pair_grads(200, 5, 8.0)
        grads = np.asarray(grads)
        n_real = int(np.asarray(bins.tile_end)[-1])
        assert n_real == int(bins.num_pairs)
        assert np.all(grads[:, n_real:] == 0.0)
        assert np.abs(grads[:, :n_real]).max() > 0.0
        assert np.isfinite(grads).all()


class TestSaturationCut:
    """The exact saturation cut (diff.SAT_CUT_LOG): once every pixel of
    a tile is below the f32 exp-underflow threshold, the forward
    early-exits and the backward skips those windows — skipped pairs'
    gradients are IEEE-exact zeros, the forward image is bit-identical
    to the uncut walk, and pre-cut gradients only move within the logT
    reconstruction's own f32 rounding (the anchor changes from
    final-minus-suffix to the forward's running sum at the cut)."""

    def _deep_scene(self, n=8000):
        scene = random_scene(n, seed=2, extent=6.0,
                             scale_range=(0.4, 0.8))
        scene = dataclasses.replace(
            scene, opacities=np.full((n,), 0.999, np.float32))
        return jax.tree.map(jnp.asarray, scene)

    def test_cut_engages_and_matches_uncut(self):
        from splat_tpu.render import diff as D

        scene = self._deep_scene()
        cam = Camera.create(h=64, w=96, position=(0.0, 0.0, 4.0))
        cfg = RenderConfig(max_dup_factor=24.0, alpha_channel=True)
        proj = project_gaussians(scene, cam, cfg)
        bins = build_tile_bins(proj, cam.h, cam.w, cfg)
        _, cut = D._fwd_raster(bins, cfg)
        npairs = np.asarray(bins.tile_end) - np.asarray(bins.tile_start)
        cut = np.asarray(cut)
        assert (cut < npairs).any(), "fixture failed to engage the cut"
        assert (cut <= npairs).all()

        tgt = jnp.full((64, 96, 4), 0.3)
        loss = lambda s: jnp.mean(
            (render_tiled_diff(s, cam, cfg) - tgt) ** 2)
        img_cut = np.asarray(render_tiled_diff(scene, cam, cfg))
        g_cut = jax.grad(loss)(scene)
        orig = D.SAT_CUT_LOG
        try:
            D.SAT_CUT_LOG = float("-inf")   # disable the cut
            img_full = np.asarray(render_tiled_diff(scene, cam, cfg))
            g_full = jax.grad(loss)(scene)
        finally:
            D.SAT_CUT_LOG = orig
        # forward: bit-identical (skipped contributions are exact zeros)
        np.testing.assert_array_equal(img_cut, img_full)
        # gradients: within logT-reconstruction rounding of the uncut
        # walk (same noise scale as the backend-vs-interpret comparison)
        for name in ["means", "quats", "scales", "opacities", "sh"]:
            a = np.asarray(getattr(g_cut, name))
            b = np.asarray(getattr(g_full, name))
            scale = np.abs(b).max() + 1e-20
            assert np.abs(a - b).max() / scale < 1e-5, \
                f"{name}: rel {np.abs(a - b).max() / scale:.2e}"

    def test_train_sat_exit_truncates_and_bounds_error(self):
        """config.train_sat_exit: the INRIA-style exit engages where the
        exact cut cannot (T < alpha_min but far from f32 underflow), the
        truncation error vs the full walk is bounded by the residual
        transmittance, and gradients stay directionally faithful."""
        from splat_tpu.render import diff as D

        n = 2000
        scene = random_scene(n, seed=5, extent=6.0,
                             scale_range=(0.3, 0.6))
        scene = dataclasses.replace(
            scene, opacities=np.full((n,), 0.9, np.float32))
        scene = jax.tree.map(jnp.asarray, scene)
        cam = Camera.create(h=64, w=96, position=(0.0, 0.0, 4.0))
        cfg_full = RenderConfig(max_dup_factor=24.0)
        cfg_exit = dataclasses.replace(cfg_full, train_sat_exit=True)

        proj = project_gaussians(scene, cam, cfg_exit)
        bins = build_tile_bins(proj, cam.h, cam.w, cfg_exit)
        _, cut_x = D._fwd_raster(bins, cfg_exit)
        _, cut_f = D._fwd_raster(bins, cfg_full)
        cut_x, cut_f = np.asarray(cut_x), np.asarray(cut_f)
        assert (cut_x < cut_f).any(), \
            "approx exit should cut earlier than the exact one"

        tgt = jnp.full((cam.h, cam.w, 3), 0.3)
        loss_x = lambda s: jnp.mean(
            (render_tiled_diff(s, cam, cfg_exit) - tgt) ** 2)
        loss_f = lambda s: jnp.mean(
            (render_tiled_diff(s, cam, cfg_full) - tgt) ** 2)
        img_x = np.asarray(render_tiled_diff(scene, cam, cfg_exit))
        img_f = np.asarray(render_tiled_diff(scene, cam, cfg_full))
        # truncated tail carries < alpha_min transmittance; a few
        # epsilons of slack for the compositing chain
        assert np.abs(img_x - img_f).max() <= 4.0 * cfg_full.alpha_min, \
            np.abs(img_x - img_f).max()
        g_x = jax.grad(loss_x)(scene)
        g_f = jax.grad(loss_f)(scene)
        for name in ["means", "scales", "opacities", "sh"]:
            a = np.asarray(getattr(g_x, name)).ravel()
            b = np.asarray(getattr(g_f, name)).ravel()
            cos = float(a @ b / np.sqrt((a @ a) * (b @ b) + 1e-30))
            assert cos >= 0.99, f"{name}: cos {cos:.4f}"

    def test_light_scene_cut_never_fires(self):
        from splat_tpu.render import diff as D

        scene = _jscene(300, 1)
        cam = Camera.create(h=64, w=96, position=(0.0, 0.0, 4.0))
        cfg = RenderConfig(max_dup_factor=8.0)
        proj = project_gaussians(scene, cam, cfg)
        bins = build_tile_bins(proj, cam.h, cam.w, cfg)
        _, cut = D._fwd_raster(bins, cfg)
        npairs = np.asarray(bins.tile_end) - np.asarray(bins.tile_start)
        np.testing.assert_array_equal(np.asarray(cut), npairs)


class TestDenseAgreement:
    def test_cosine_similarity_vs_dense_vjp(self):
        scene = _jscene(200, 3)
        cam = Camera.create(h=64, w=64, position=(0.0, 0.0, 4.0))
        cfg = RenderConfig(max_dup_factor=8.0)
        tgt = jnp.full((64, 64, 3), 0.25)
        loss_t = lambda s: jnp.mean(
            (render_tiled_diff(s, cam, cfg) - tgt) ** 2)
        loss_d = lambda s: jnp.mean((render_dense(s, cam, cfg) - tgt) ** 2)
        gt = jax.grad(loss_t)(scene)
        gd = jax.grad(loss_d)(scene)
        for name in ["means", "quats", "scales", "opacities", "sh"]:
            a = np.asarray(getattr(gt, name)).ravel()
            b = np.asarray(getattr(gd, name)).ravel()
            cos = float(a @ b / np.sqrt((a @ a) * (b @ b) + 1e-30))
            assert cos > 0.995, f"{name}: cos {cos:.4f}"


class TestDepthSupervision:
    """render_mode='depth' through the tiled VJP (round 5): normalized
    depth rides the color rows through the same pure-JAX projection the
    VJP pulls back through, so depth gradients need no kernel change."""

    def test_depth_grads_match_dense(self):
        scene = _jscene(40, 2)
        cam = Camera.create(h=48, w=48, position=(0.0, 0.0, 4.0))
        cfg = RenderConfig(sh_degree=0, render_mode="depth",
                           depth_range=(1.0, 7.0), max_dup_factor=16.0,
                           alpha_channel=True)
        loss_t = lambda s: jnp.mean(
            (render_tiled_diff(s, cam, cfg) - 0.3) ** 2)
        loss_d = lambda s: jnp.mean((render_dense(s, cam, cfg) - 0.3) ** 2)
        gt = jax.grad(loss_t)(scene)
        gd = jax.grad(loss_d)(scene)
        for name in ["means", "scales", "opacities"]:
            a = np.asarray(getattr(gt, name)).ravel()
            b = np.asarray(getattr(gd, name)).ravel()
            cos = float(a @ b / np.sqrt((a @ a) * (b @ b) + 1e-30))
            assert cos > 0.995, f"{name}: cos {cos:.4f}"
        # depth reaches means through the encode: the z-direction
        # gradient must be nonzero (pure-color mode can zero it when
        # colors match)
        assert np.abs(np.asarray(gt.means)).max() > 0

    def test_depth_supervised_fit_converges(self):
        """End-to-end: recover perturbed splat DEPTHS from depth-map
        targets alone (the standard 3DGS depth-supervision add-on)."""
        from splat_tpu.camera import orbit_trajectory
        from splat_tpu.train import fit
        truth = _jscene(30, 7)
        truth = dataclasses.replace(
            truth, opacities=jnp.full((30,), 0.9),
            scales=jnp.asarray(np.random.default_rng(0).uniform(
                0.08, 0.2, (30, 3)).astype(np.float32)))
        cams = orbit_trajectory(
            Camera.create(h=32, w=32, position=(0.0, 0.0, 4.0)),
            num_frames=2, yaw_sweep=0.8)
        cfg = RenderConfig(sh_degree=0, render_mode="depth",
                           depth_range=(1.0, 7.0), max_dup_factor=32.0,
                           alpha_channel=True)
        targets = jax.vmap(
            lambda c: render_dense(truth, c, cfg))(cams)
        rng = np.random.default_rng(3)
        start = dataclasses.replace(
            truth, means=truth.means + jnp.asarray(
                rng.normal(0, 0.08, (30, 3)).astype(np.float32)))
        res = fit(start, cams, targets, steps=40, lr=5e-3,
                  method="tiled", config=cfg,
                  lr_scales={"means": 1.0, "sh": 0.0,
                             "logit_opacities": 0.0, "log_scales": 0.0,
                             "quats": 0.0})
        assert res.final_loss < float(res.losses[0]) / 3, (
            float(res.losses[0]), res.final_loss)


class TestPoseOptimization:
    def test_fit_camera_yaw(self):
        """Pose gradients through the tiled VJP are strong enough to
        recover a perturbed camera yaw by gradient descent — the
        pose-refinement building block (no reference counterpart)."""
        scene = _jscene(150, 13)
        cfg = RenderConfig(max_dup_factor=16.0)
        cam0 = Camera.create(h=48, w=48, position=(0.0, 0.0, 4.0),
                             yaw=0.15)
        target = render_tiled_diff(scene, cam0, cfg)

        def loss(yaw):
            c = dataclasses.replace(cam0, yaw=yaw)
            return jnp.mean((render_tiled_diff(scene, c, cfg)
                             - target) ** 2)

        g = jax.jit(jax.value_and_grad(loss))
        yaw = jnp.float32(0.08)  # ~4 degrees off
        lr = 1.0
        prev = None
        for _ in range(60):
            l, dy = g(yaw)
            if prev is not None and float(l) > float(prev):
                lr *= 0.5  # crude backtracking: the quantized forward
                #            makes the 1-D landscape piecewise
            prev = l
            yaw = yaw - lr * dy
        err0 = abs(0.08 - 0.15)
        err1 = abs(float(yaw) - 0.15)
        assert err1 < err0 * 0.5, f"yaw {float(yaw):.4f} (target 0.15)"


class TestHeavyOcclusion:
    def test_gradients_survive_transmittance_underflow(self):
        """Hundreds of stacked near-opaque splats drive T below f32
        range mid-tile; log-space reconstruction must keep the FRONT
        splats' gradients alive and exact (a multiplicative
        reconstruction from T_final would zero them — CLAUDE.md
        rule 17).  Verified against the pure-JAX replica."""
        n = 160
        rng = np.random.default_rng(0)
        scene = random_scene(n, seed=2)
        scene = jax.tree.map(jnp.asarray, scene)
        # stack everything near the origin with high opacity
        scene = dataclasses.replace(
            scene,
            means=jnp.asarray(
                rng.normal(0, 0.05, (n, 3)).astype(np.float32)),
            opacities=jnp.full((n,), 0.95, jnp.float32),
            scales=jnp.full((n, 3), 0.3, jnp.float32))
        cam = Camera.create(h=32, w=32, position=(0.0, 0.0, 3.0))
        cfg = RenderConfig(max_dup_factor=float(2 * 32 * 32))
        proj0 = project_gaussians(scene, cam, cfg)
        bins0 = build_tile_bins(proj0, cam.h, cam.w, cfg)
        ranks = np.asarray(bins0.ranks)
        ts, te = np.asarray(bins0.tile_start), np.asarray(bins0.tile_end)

        # transmittance genuinely underflows: 0.05^160 << f32 tiny
        img4 = render_tiled_diff(scene, cam, dataclasses.replace(
            cfg, alpha_channel=True))
        assert float(jnp.min(1.0 - img4[..., 3])) == 0.0

        tgt = jnp.full((32, 32, 3), 0.4)
        loss_ref = lambda s: jnp.mean((_replica_forward(
            s, cam, cfg, ranks, ts, te, bins0.tiles_x, bins0.tiles_y)
            - tgt) ** 2)
        loss_til = lambda s: jnp.mean(
            (render_tiled_diff(s, cam, cfg) - tgt) ** 2)
        gr = jax.grad(loss_ref)(scene)
        gt = jax.grad(loss_til)(scene)
        for name in ["means", "opacities", "sh"]:
            a = np.asarray(getattr(gt, name))
            b = np.asarray(getattr(gr, name))
            scale = np.abs(b).max() + 1e-20
            assert np.isfinite(a).all()
            assert np.abs(a - b).max() / scale < 1e-3, \
                f"{name}: rel {np.abs(a - b).max() / scale:.2e}"
        # the FRONT splat (smallest depth) must carry real gradient
        depth = np.asarray(project_gaussians(scene, cam, cfg).depth)
        front = int(np.argmin(depth))
        assert np.abs(np.asarray(gt.sh)[front]).max() > 0


class TestNumericalEdges:
    def test_grads_finite_with_cropped_boundary_tiles(self):
        """h not a multiple of tile_h: the crop-padded pixels enter the
        backward with a ZERO logT anchor (their true forward value was
        cropped away), so under heavy occlusion the reverse walk
        reconstructs a large-POSITIVE logT there — unclamped, exp()
        overflows to inf and the pad pixels' zero cotangents turn into
        NaNs that poison every per-pair gradient in the window."""
        n = 160
        rng = np.random.default_rng(1)
        scene = _jscene(n, 3)
        # huge near-opaque splats: every pad pixel of the boundary tile
        # accumulates sum(-log1p(-alpha)) >> 88.7 (the f32 exp overflow)
        scene = dataclasses.replace(
            scene,
            means=jnp.asarray(
                rng.normal(0, 0.05, (n, 3)).astype(np.float32)),
            opacities=jnp.full((n,), 0.99, jnp.float32),
            scales=jnp.full((n, 3), 6.0, jnp.float32))
        cam = Camera.create(h=40, w=32, position=(0.0, 0.0, 3.0))
        cfg = RenderConfig(max_dup_factor=8.0)
        tgt = jnp.full((40, 32, 3), 0.4)
        loss = lambda s: jnp.mean(
            (render_tiled_diff(s, cam, cfg) - tgt) ** 2)
        g = jax.grad(loss)(scene)
        for name in ("means", "opacities", "sh", "scales", "quats"):
            arr = np.asarray(getattr(g, name))
            assert np.isfinite(arr).all(), name
        # the image region is genuinely covered: gradients are live
        assert float(np.abs(np.asarray(g.sh)).max()) > 0

    def test_grads_finite_at_alpha_exactly_one(self):
        """alpha_clamp=1.0 with a u16-saturated opacity: pixels where
        exp(power) rounds to 1.0f see alpha == 1.0 exactly — the
        backward's 1/(1-alpha) must not turn those masked lanes into
        inf * 0 = NaN."""
        scene = _jscene(4, 5)
        scene = dataclasses.replace(
            scene,
            means=jnp.zeros((4, 3), jnp.float32),
            opacities=jnp.ones((4,), jnp.float32),
            # sigma_px ~ 3200 at this pose: pixels near the projected
            # center have |power| < 1e-7 and exp(power) == 1.0 in f32
            scales=jnp.full((4, 3), 600.0, jnp.float32))
        cam = Camera.create(h=32, w=32, position=(0.0, 0.0, 3.0))
        cfg = RenderConfig(alpha_clamp=1.0, max_dup_factor=8.0)
        img = np.asarray(render_tiled_diff(scene, cam, cfg))
        assert img.max() > 0
        tgt = jnp.full((32, 32, 3), 0.2)
        loss = lambda s: jnp.mean(
            (render_tiled_diff(s, cam, cfg) - tgt) ** 2)
        g = jax.grad(loss)(scene)
        for name in ("means", "opacities", "sh", "scales", "quats"):
            arr = np.asarray(getattr(g, name))
            assert np.isfinite(arr).all(), name
