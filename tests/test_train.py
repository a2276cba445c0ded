"""Tests for splat_tpu.train — the differentiable fitting module.

The reference has no training path at all (SURVEY §1); these tests pin the
extension: raw/activated round-trips, multi-view photometric
fitting, and recovery of a perturbed scene.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from splat_tpu.camera import Camera, orbit_trajectory
from splat_tpu.config import RenderConfig
from splat_tpu.render.dense import render_dense
from splat_tpu.train import RawParams, fit, photometric_loss, psnr
from splat_tpu.utils.fixtures import random_scene


def _device_scene(scene):
    return jax.tree.map(jnp.asarray, scene)


def test_raw_params_round_trip():
    scene = _device_scene(random_scene(12, seed=1))
    back = RawParams.from_scene(scene).to_scene()
    np.testing.assert_allclose(back.means, scene.means, rtol=1e-6)
    np.testing.assert_allclose(back.quats, scene.quats, rtol=1e-6)
    np.testing.assert_allclose(back.scales, scene.scales, rtol=1e-5)
    np.testing.assert_allclose(back.opacities, scene.opacities,
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(back.sh, scene.sh, rtol=1e-6)


def test_raw_params_logit_finite_at_extremes():
    scene = _device_scene(random_scene(4, seed=2))
    scene = dataclasses.replace(
        scene, opacities=jnp.asarray([0.0, 1.0, 0.5, 1.0], jnp.float32))
    raw = RawParams.from_scene(scene)
    assert np.all(np.isfinite(np.asarray(raw.logit_opacities)))
    back = raw.to_scene()
    assert float(back.opacities[0]) < 1e-3
    assert float(back.opacities[1]) > 1 - 1e-3


def test_psnr_basics():
    a = jnp.zeros((8, 8, 3))
    assert float(psnr(a, a)) > 100.0
    b = a + 0.1
    np.testing.assert_allclose(float(psnr(a, b)), 20.0, atol=1e-4)


def test_photometric_loss_grad_finite():
    scene = _device_scene(random_scene(8, seed=3, extent=1.0,
                                       scale_range=(0.1, 0.25)))
    cams = orbit_trajectory(Camera.create(h=16, w=16,
                                          position=(0.0, 0.0, 3.0)),
                            num_frames=2, yaw_sweep=0.6)
    config = RenderConfig(sh_degree=0)
    targets = jax.vmap(lambda c: render_dense(scene, c, config))(cams)
    raw = RawParams.from_scene(scene)
    g = jax.grad(photometric_loss)(raw, cams, targets, config)
    for f in dataclasses.fields(raw):
        assert np.all(np.isfinite(np.asarray(getattr(g, f.name)))), f.name
    # loss at the generating scene is (near) zero
    l0 = float(photometric_loss(raw, cams, targets, config))
    assert l0 < 1e-8


def test_fit_recovers_perturbed_scene():
    """Perturb colors + opacities + positions of the generating scene and
    fit them back from 3 rendered views."""
    true_scene = _device_scene(random_scene(6, seed=9, extent=0.8,
                                            scale_range=(0.15, 0.3)))
    true_scene = dataclasses.replace(
        true_scene, opacities=jnp.clip(true_scene.opacities, 0.3, 0.9))
    cams = orbit_trajectory(Camera.create(h=24, w=24,
                                          position=(0.0, 0.0, 3.0)),
                            num_frames=3, yaw_sweep=1.2)
    config = RenderConfig(sh_degree=0)
    targets = jax.vmap(lambda c: render_dense(true_scene, c, config))(cams)

    rng = np.random.default_rng(0)
    start = dataclasses.replace(
        true_scene,
        means=true_scene.means + jnp.asarray(
            rng.normal(0, 0.05, true_scene.means.shape), jnp.float32),
        sh=true_scene.sh + jnp.asarray(
            rng.normal(0, 0.35, true_scene.sh.shape), jnp.float32),
        opacities=jnp.clip(true_scene.opacities + jnp.asarray(
            rng.normal(0, 0.2, true_scene.opacities.shape), jnp.float32),
            0.05, 0.95))

    result = fit(start, cams, targets, steps=150, lr=2e-2, config=config)
    l0 = float(result.losses[0])
    assert l0 > 1e-5, "perturbation produced no initial error"
    assert result.final_loss < l0 / 5, (
        f"loss {l0:.3e} -> {result.final_loss:.3e}: fit stalled")

    # image-space recovery: fitted renders beat the perturbed start by
    # a wide PSNR margin on a held-in view
    img_start = render_dense(start, jax.tree.map(lambda a: a[0], cams),
                             config)
    img_fit = render_dense(result.scene,
                           jax.tree.map(lambda a: a[0], cams), config)
    tgt = targets[0]
    gain = float(psnr(img_fit, tgt)) - float(psnr(img_start, tgt))
    assert gain > 6.0, f"PSNR gain only {gain:.2f} dB"


def test_fit_accepts_lr_overrides_and_freezes():
    """lr_scales=0 freezes a leaf exactly."""
    scene = _device_scene(random_scene(5, seed=4, extent=0.8,
                                       scale_range=(0.15, 0.3)))
    cams = orbit_trajectory(Camera.create(h=16, w=16,
                                          position=(0.0, 0.0, 3.0)),
                            num_frames=1)
    config = RenderConfig(sh_degree=0)
    targets = jax.vmap(lambda c: render_dense(scene, c, config))(cams)
    start = dataclasses.replace(
        scene, sh=scene.sh + 0.3)
    result = fit(start, cams, targets, steps=10, lr=1e-2, config=config,
                 lr_scales={"means": 0.0, "quats": 0.0, "log_scales": 0.0,
                            "logit_opacities": 0.0})
    np.testing.assert_array_equal(np.asarray(result.scene.means),
                                  np.asarray(start.means))
    np.testing.assert_array_equal(np.asarray(result.raw.quats),
                                  np.asarray(start.quats))
    assert not np.allclose(np.asarray(result.scene.sh),
                           np.asarray(start.sh))


def test_ssim_properties():
    from splat_tpu.train import ssim
    rng = np.random.default_rng(0)
    a = jnp.asarray(rng.uniform(size=(32, 32, 3)).astype(np.float32))
    assert abs(float(ssim(a, a)) - 1.0) < 1e-5
    noisy = jnp.clip(a + 0.2 * jnp.asarray(
        rng.normal(size=a.shape).astype(np.float32)), 0, 1)
    s_noisy = float(ssim(a, noisy))
    assert s_noisy < 0.9
    # a slightly rescaled copy keeps structure: scores above heavy noise
    rescaled = jnp.clip(a * 0.9 + 0.05, 0, 1)
    assert float(ssim(a, rescaled)) > s_noisy
    # differentiable
    g = jax.grad(lambda x: ssim(x, a))(noisy)
    assert np.isfinite(np.asarray(g)).all()


def test_photometric_loss_dssim_term():
    scene = _device_scene(random_scene(8, seed=1, extent=0.8,
                                       scale_range=(0.15, 0.3)))
    cams = orbit_trajectory(Camera.create(h=16, w=16,
                                          position=(0.0, 0.0, 3.0)),
                            num_frames=2)
    config = RenderConfig(sh_degree=0)
    targets = jax.vmap(lambda c: render_dense(scene, c, config))(cams)
    raw = RawParams.from_scene(scene)
    l0 = float(photometric_loss(raw, cams, targets, config))
    l1 = float(photometric_loss(raw, cams, targets, config,
                                dssim_weight=0.2))
    assert abs(l0) < 1e-8  # perfect recon: every term ~0
    assert abs(l1) < 1e-4  # 1 - ssim(x, x) ~ 0
    # a perturbed scene scores worse with the D-SSIM term than without
    raw_p = dataclasses.replace(raw, sh=raw.sh + 0.3)
    lp0 = float(photometric_loss(raw_p, cams, targets, config))
    lp1 = float(photometric_loss(raw_p, cams, targets, config,
                                 dssim_weight=0.2))
    assert lp1 > lp0


def test_photometric_loss_tiled_method_matches_dense():
    """method='tiled' (the production pipeline's custom VJP) computes a
    loss and gradients consistent with the dense path."""
    scene = jax.tree.map(jnp.asarray,
                         random_scene(300, seed=2))
    cams = orbit_trajectory(Camera.create(h=32, w=32,
                                          position=(0.0, 0.0, 4.0)),
                            num_frames=2, yaw_sweep=0.3)
    config = RenderConfig(max_dup_factor=8.0)
    targets = jnp.stack([
        jnp.full((32, 32, 3), 0.25)] * 2)
    raw = RawParams.from_scene(scene)
    ld = float(photometric_loss(raw, cams, targets, config))
    lt = float(photometric_loss(raw, cams, targets, config,
                                method="tiled"))
    assert abs(ld - lt) / (abs(ld) + 1e-12) < 1e-2
    gd = jax.grad(lambda r: photometric_loss(r, cams, targets,
                                             config))(raw)
    gt = jax.grad(lambda r: photometric_loss(r, cams, targets, config,
                                             method="tiled"))(raw)
    for name in ["means", "sh", "logit_opacities"]:
        a = np.asarray(getattr(gt, name)).ravel()
        b = np.asarray(getattr(gd, name)).ravel()
        cos = float(a @ b / np.sqrt((a @ a) * (b @ b) + 1e-30))
        assert cos > 0.99, f"{name}: cos {cos:.4f}"


def test_fit_tiled_converges():
    """A small fit through the tiled custom VJP reduces the loss."""
    scene = jax.tree.map(jnp.asarray,
                         random_scene(100, seed=3))
    cams = orbit_trajectory(Camera.create(h=24, w=24,
                                          position=(0.0, 0.0, 4.0)),
                            num_frames=1)
    config = RenderConfig(max_dup_factor=8.0, sh_degree=0)
    from splat_tpu.render.diff import render_tiled_diff
    target = render_tiled_diff(scene, jax.tree.map(lambda a: a[0], cams),
                               config)[None]
    start = dataclasses.replace(scene, sh=scene.sh * 0.5)
    result = fit(start, cams, target, steps=15, lr=2e-2, config=config,
                 method="tiled")
    assert float(result.losses[-1]) < float(result.losses[0]) * 0.5


def test_densify_and_prune_mechanics():
    from splat_tpu.train import RawParams, densify_and_prune
    import jax.numpy as jnp
    n = 8
    raw = RawParams(
        means=jnp.zeros((n, 3)),
        quats=jnp.tile(jnp.asarray([[1., 0., 0., 0.]]), (n, 1)),
        # splats 0-3 small, 4-5 big, 6-7 whatever
        log_scales=jnp.log(jnp.asarray(
            [[0.001]*3]*4 + [[0.5]*3]*2 + [[0.01]*3]*2)),
        # splat 7 is transparent -> pruned
        logit_opacities=jnp.asarray([2.0]*7 + [-12.0]),
        sh=jnp.zeros((n, 16, 3)))
    # high grads on 0 (small -> clone) and 4 (big -> split); others low
    g = jnp.asarray([1.0, 0., 0., 0., 1.0, 0., 0., 1.0])
    new, stats = densify_and_prune(raw, g, grad_threshold=0.5,
                                   split_scale_threshold=0.1,
                                   pad_multiple=4)
    assert stats["cloned"] == 1       # splat 0
    assert stats["split"] == 1        # splat 4 -> two children
    assert stats["pruned"] == 1       # splat 7 (high grad but dead)
    # kept 6 (7 alive minus split parent) + 1 clone + 2 children = 9
    assert stats["n"] - stats["padded"] == 9
    assert new.means.shape[0] % 4 == 0
    # split children carry shrunken scales (0.5/1.6); the only remaining
    # 0.5-scale splat is the low-grad big one that was NOT split
    sc = np.exp(np.asarray(new.log_scales))
    big_left = np.isclose(sc.max(axis=1), 0.5, rtol=1e-4).sum()
    children = np.isclose(sc.max(axis=1), 0.5 / 1.6, rtol=1e-4).sum()
    assert big_left == 1 and children == 2
    # padding splats are dead (culled by visibility)
    op = 1/(1+np.exp(-np.asarray(new.logit_opacities)))
    assert (op[9:] < 1e-5).all()


def test_fit_with_densification_grows_and_converges():
    """Under-provisioned init + densification: the count grows and the
    loss beats the same budget without densification."""
    truth = _device_scene(random_scene(64, seed=11, extent=0.8,
                                       scale_range=(0.05, 0.12)))
    cams = orbit_trajectory(Camera.create(h=24, w=24,
                                          position=(0.0, 0.0, 3.0)),
                            num_frames=2, yaw_sweep=0.4)
    config = RenderConfig(sh_degree=0)
    targets = jax.vmap(lambda c: render_dense(truth, c, config))(cams)
    # start from a sparse subset: too few splats to reconstruct
    start = jax.tree.map(lambda a: np.asarray(a)[:16], truth)
    from splat_tpu.scene import GaussianScene
    start = GaussianScene(**{k: np.asarray(getattr(start, k))
                             for k in ("means", "quats", "scales",
                                       "opacities", "sh")})
    res_d = fit(start, cams, targets, steps=30, lr=2e-2, config=config,
                densify_every=10,
                densify_kwargs=dict(grad_threshold=1e-4,
                                    pad_multiple=16))
    assert res_d.densify_log, "densification never ran"
    assert res_d.raw.means.shape[0] > 16
    assert float(res_d.losses[-1]) < float(res_d.losses[0])


def test_fit_tiled_rejects_undersized_capacity():
    """A truncated training forward would silently bias every gradient;
    fit() audits capacity up front (config.py contract)."""
    import pytest
    scene = jax.tree.map(jnp.asarray, random_scene(5000, seed=4))
    cams = orbit_trajectory(Camera.create(h=48, w=48,
                                          position=(0.0, 0.0, 4.0)),
                            num_frames=1)
    targets = jnp.zeros((1, 48, 48, 3))
    with pytest.raises(ValueError, match="max_dup_factor"):
        fit(scene, cams, targets, steps=1, method="tiled",
            config=RenderConfig(max_dup_factor=1.0))


def test_fit_data_parallel_mesh_matches_single_device():
    """mesh= shards the views over 'd'; gradients and the fit must match
    the single-device run (scene replicated, loss pmean'd, grad psum
    riding the shard_map transpose)."""
    from splat_tpu.parallel.sharding import make_mesh
    scene = _device_scene(random_scene(12, seed=6, extent=0.8,
                                       scale_range=(0.12, 0.25)))
    cams = orbit_trajectory(Camera.create(h=16, w=16,
                                          position=(0.0, 0.0, 3.0)),
                            num_frames=4, yaw_sweep=1.0)
    config = RenderConfig(sh_degree=0)
    targets = jax.vmap(lambda c: render_dense(scene, c, config))(cams)
    start = dataclasses.replace(scene, sh=scene.sh * 0.6)
    mesh = make_mesh(n_data=4, n_gaussian=2)
    r_single = fit(start, cams, targets, steps=5, lr=1e-2, config=config)
    r_dp = fit(start, cams, targets, steps=5, lr=1e-2, config=config,
               mesh=mesh)
    np.testing.assert_allclose(np.asarray(r_dp.losses),
                               np.asarray(r_single.losses),
                               rtol=2e-4, atol=1e-7)
    np.testing.assert_allclose(np.asarray(r_dp.raw.sh),
                               np.asarray(r_single.raw.sh),
                               rtol=1e-3, atol=1e-6)


def test_fit_data_parallel_tiled_matches_single_device():
    """mesh= + method='tiled': shard_map wrapped around the Pallas
    custom-VJP pair — the composition production-scale training needs.
    Gradient flow (losses + fitted params) must match the single-device
    tiled run exactly (scene replicated, grad psum via the shard_map
    transpose)."""
    from splat_tpu.parallel.sharding import make_mesh
    scene = _device_scene(random_scene(12, seed=6, extent=0.8,
                                       scale_range=(0.12, 0.25)))
    cams = orbit_trajectory(Camera.create(h=32, w=32,
                                          position=(0.0, 0.0, 3.0)),
                            num_frames=4, yaw_sweep=1.0)
    config = RenderConfig(sh_degree=0, max_dup_factor=8.0)
    targets = jax.vmap(lambda c: render_dense(scene, c, config))(cams)
    start = dataclasses.replace(scene, sh=scene.sh * 0.6)
    mesh = make_mesh(n_data=4, n_gaussian=2)
    r_single = fit(start, cams, targets, steps=3, lr=1e-2, config=config,
                   method="tiled")
    r_dp = fit(start, cams, targets, steps=3, lr=1e-2, config=config,
               method="tiled", mesh=mesh)
    np.testing.assert_allclose(np.asarray(r_dp.losses),
                               np.asarray(r_single.losses),
                               rtol=2e-4, atol=1e-7)
    np.testing.assert_allclose(np.asarray(r_dp.raw.sh),
                               np.asarray(r_single.raw.sh),
                               rtol=1e-3, atol=1e-6)
    # and it actually learned (not a frozen no-op composition)
    assert float(r_dp.losses[-1]) < float(r_dp.losses[0])


def test_fit_tensor_parallel_tiled_matches_single_device():
    """mesh 'g' axis + method='tiled' = TENSOR-PARALLEL training: scene
    params/grads/adam state shard over gaussians, projected fields
    all_gather, each chip rasterizes its row slab, and the all_gather
    transpose (psum-scatter) routes pixel cotangents back to the owning
    shard.  Must match the single-device tiled run to ~1e-5 (the >HBM
    training plan, SURVEY §2.3 TP row extended to training)."""
    from splat_tpu.parallel.sharding import make_mesh
    scene = _device_scene(random_scene(16, seed=6, extent=0.8,
                                       scale_range=(0.12, 0.25)))
    cams = orbit_trajectory(Camera.create(h=32, w=32,
                                          position=(0.0, 0.0, 3.0)),
                            num_frames=2, yaw_sweep=1.0)
    config = RenderConfig(sh_degree=0, max_dup_factor=8.0)
    targets = jax.vmap(lambda c: render_dense(scene, c, config))(cams)
    start = dataclasses.replace(scene, sh=scene.sh * 0.6)
    mesh = make_mesh(n_data=2, n_gaussian=4)
    r_single = fit(start, cams, targets, steps=3, lr=1e-2, config=config,
                   method="tiled")
    r_tp = fit(start, cams, targets, steps=3, lr=1e-2, config=config,
               method="tiled", mesh=mesh)
    np.testing.assert_allclose(np.asarray(r_tp.losses),
                               np.asarray(r_single.losses),
                               rtol=1e-5, atol=1e-8)
    for k in ("means", "sh", "log_scales", "logit_opacities"):
        np.testing.assert_allclose(
            np.asarray(getattr(r_tp.raw, k)),
            np.asarray(getattr(r_single.raw, k)), rtol=1e-4, atol=1e-6,
            err_msg=f"TP diverged from single-device on {k}")
    assert float(r_tp.losses[-1]) < float(r_tp.losses[0])


def test_fit_tensor_parallel_rejects_indivisible_n():
    import pytest
    from splat_tpu.parallel.sharding import make_mesh
    scene = _device_scene(random_scene(10, seed=1))   # 10 % 4 != 0
    cams = orbit_trajectory(Camera.create(h=32, w=32,
                                          position=(0.0, 0.0, 3.0)),
                            num_frames=2)
    mesh = make_mesh(n_data=2, n_gaussian=4)
    with pytest.raises(ValueError, match="divisible"):
        fit(scene, cams, jnp.zeros((2, 32, 32, 3)), steps=1,
            method="tiled",
            config=RenderConfig(sh_degree=0, max_dup_factor=8.0),
            mesh=mesh)
    # densify pad_multiple must keep N % g == 0 across topologies
    scene16 = _device_scene(random_scene(16, seed=1))
    with pytest.raises(ValueError, match="pad_multiple"):
        fit(scene16, cams, jnp.zeros((2, 32, 32, 3)), steps=2,
            method="tiled", densify_every=1,
            densify_kwargs={"pad_multiple": 3},
            config=RenderConfig(sh_degree=0, max_dup_factor=8.0),
            mesh=mesh)


def test_fit_data_parallel_rejects_indivisible_views():
    import pytest
    from splat_tpu.parallel.sharding import make_mesh
    scene = _device_scene(random_scene(6, seed=6))
    cams = orbit_trajectory(Camera.create(h=16, w=16,
                                          position=(0.0, 0.0, 3.0)),
                            num_frames=3)
    mesh = make_mesh(n_data=4, n_gaussian=2)
    with pytest.raises(ValueError, match="divisible"):
        fit(scene, cams, jnp.zeros((3, 16, 16, 3)), steps=1,
            config=RenderConfig(sh_degree=0), mesh=mesh)


def test_raw_params_checkpoint_round_trip(tmp_path):
    from splat_tpu.train import load_raw_params, save_raw_params
    raw = RawParams.from_scene(_device_scene(random_scene(7, seed=8)))
    p = tmp_path / "ckpt.npz"
    save_raw_params(p, raw)
    back = load_raw_params(p)
    for k in ("means", "quats", "log_scales", "logit_opacities", "sh"):
        np.testing.assert_array_equal(np.asarray(getattr(back, k)),
                                      np.asarray(getattr(raw, k)))
    # resuming a fit from the checkpoint continues cleanly
    cams = orbit_trajectory(Camera.create(h=16, w=16,
                                          position=(0.0, 0.0, 3.0)),
                            num_frames=1)
    config = RenderConfig(sh_degree=0)
    targets = jax.vmap(
        lambda c: render_dense(back.to_scene(), c, config))(cams)
    res = fit(back.to_scene(), cams, targets, steps=2, config=config)
    assert np.isfinite(np.asarray(res.losses)).all()


def test_adam_refactor_is_exact():
    """fit's optimizer is scale_by_adam + an explicit -lr multiply (so
    the lr can follow a traced global step); with no decay this must be
    EXACTLY optax.adam — one update compared elementwise."""
    import optax

    rng = np.random.default_rng(4)
    params = jnp.asarray(rng.normal(size=(7, 3)), jnp.float32)
    grads = jnp.asarray(rng.normal(size=(7, 3)), jnp.float32)
    lr = 3e-3

    ref_opt = optax.adam(lr)
    u_ref, _ = ref_opt.update(grads, ref_opt.init(params))

    new_opt = optax.scale_by_adam()
    u_new, _ = new_opt.update(grads, new_opt.init(params))
    u_new = jax.tree.map(lambda u: u * -lr, u_new)

    np.testing.assert_array_equal(np.asarray(u_ref), np.asarray(u_new))


def test_fit_lr_decay_schedule():
    """lr_decay={"means": f} decays the positional lr exponentially over
    the GLOBAL step (the INRIA recipe's position schedule): with a tiny
    terminal factor the means barely move in the late steps, while the
    undecayed run keeps moving them."""
    true_scene = _device_scene(random_scene(6, seed=9, extent=0.8,
                                            scale_range=(0.15, 0.3)))
    cams = orbit_trajectory(Camera.create(h=16, w=16,
                                          position=(0.0, 0.0, 3.0)),
                            num_frames=2, yaw_sweep=1.0)
    config = RenderConfig(sh_degree=0)
    targets = jax.vmap(lambda c: render_dense(true_scene, c, config))(cams)
    rng = np.random.default_rng(1)
    start = dataclasses.replace(
        true_scene, means=true_scene.means + jnp.asarray(
            rng.normal(0, 0.08, true_scene.means.shape), jnp.float32))

    def late_motion(**kw):
        r1 = fit(start, cams, targets, steps=12, lr=2e-2, config=config,
                 **kw)
        r2 = fit(start, cams, targets, steps=24, lr=2e-2, config=config,
                 **kw)
        return float(jnp.abs(r2.raw.means - r1.raw.means).max()), r2

    m_plain, _ = late_motion()
    m_decay, res = late_motion(lr_decay={"means": 1e-6})
    assert np.isfinite(np.asarray(res.losses)).all()
    assert m_decay < m_plain / 10, (m_decay, m_plain)

    # the decay must survive a densification opt-state re-init (global
    # step, not per-segment step)
    res3 = fit(start, cams, targets, steps=12, lr=2e-2, config=config,
               lr_decay={"means": 1e-6}, densify_every=6,
               densify_kwargs={"pad_multiple": 4})
    assert np.isfinite(np.asarray(res3.losses)).all()


def test_fit_opacity_reset():
    """opacity_reset_every clamps every opacity to <= reset_to at the
    boundary (INRIA's periodic reset) with a surgical adam-state reset
    for the opacity group only; training continues and stays finite."""
    from splat_tpu.train import RawParams

    true_scene = _device_scene(random_scene(6, seed=9, extent=0.8,
                                            scale_range=(0.15, 0.3)))
    true_scene = dataclasses.replace(
        true_scene, opacities=jnp.clip(true_scene.opacities, 0.6, 0.9))
    cams = orbit_trajectory(Camera.create(h=16, w=16,
                                          position=(0.0, 0.0, 3.0)),
                            num_frames=2, yaw_sweep=1.0)
    config = RenderConfig(sh_degree=0)
    targets = jax.vmap(lambda c: render_dense(true_scene, c, config))(cams)

    # one step right after the reset boundary: opacities must still be
    # near the clamp (a single adam step moves a logit by ~lr)
    res = fit(true_scene, cams, targets, steps=7, lr=1e-3, config=config,
              opacity_reset_every=6, opacity_reset_to=0.01)
    op = np.asarray(res.scene.opacities)
    assert op.max() < 0.02, op.max()
    assert np.isfinite(np.asarray(res.losses)).all()

    # without the reset the opacities stay where they were
    res2 = fit(true_scene, cams, targets, steps=7, lr=1e-3, config=config)
    assert np.asarray(res2.scene.opacities).max() > 0.5

    # combined with densification at a shared boundary (densify first,
    # reset after, on the re-bucketed topology)
    res3 = fit(true_scene, cams, targets, steps=7, lr=1e-3, config=config,
               opacity_reset_every=6, densify_every=3,
               densify_kwargs={"pad_multiple": 4})
    assert np.isfinite(np.asarray(res3.losses)).all()


def test_fit_sh_warmup():
    """sh_warmup_every raises the active SH degree from 0 by one every K
    steps (INRIA warmup): during the degree-0 phase the higher-order
    coefficients hold their init exactly (zero gradient), and by the end
    of a full warmup they are training."""
    from splat_tpu.train import RawParams

    true_scene = _device_scene(random_scene(6, seed=9, extent=0.8,
                                            scale_range=(0.15, 0.3)))
    cams = orbit_trajectory(Camera.create(h=16, w=16,
                                          position=(0.0, 0.0, 3.0)),
                            num_frames=2, yaw_sweep=1.0)
    config = RenderConfig(sh_degree=3)
    targets = jax.vmap(lambda c: render_dense(true_scene, c, config))(cams)
    rng = np.random.default_rng(1)
    start = dataclasses.replace(
        true_scene, sh=true_scene.sh + jnp.asarray(
            rng.normal(0, 0.3, true_scene.sh.shape), jnp.float32))
    sh0 = np.asarray(RawParams.from_scene(start).sh)

    # steps < warmup: the whole run is degree 0 — bands 1+ must be
    # bit-untouched while the DC band moves
    res0 = fit(start, cams, targets, steps=4, lr=1e-2, config=config,
               sh_warmup_every=8)
    sh_after = np.asarray(res0.raw.sh)
    np.testing.assert_array_equal(sh_after[:, 3:], sh0[:, 3:])
    assert np.abs(sh_after[:, :3] - sh0[:, :3]).max() > 0

    # a full warmup reaches degree 3 and trains the high bands too
    res = fit(start, cams, targets, steps=8, lr=1e-2, config=config,
              sh_warmup_every=2)
    assert np.isfinite(np.asarray(res.losses)).all()
    assert np.abs(np.asarray(res.raw.sh)[:, 3:] - sh0[:, 3:]).max() > 0


def test_fit_from_scratch_full_recipe():
    """The real 3DGS workflow: a RANDOM init (no knowledge of the truth)
    plus the full recipe — SH warmup, densification, positional lr decay
    — reconstructs the target views.  This is the from-scratch
    counterpart of the perturbed-recovery tests."""
    truth = _device_scene(random_scene(12, seed=3, extent=0.7,
                                       scale_range=(0.12, 0.25)))
    truth = dataclasses.replace(
        truth, opacities=jnp.clip(truth.opacities, 0.5, 0.9))
    cams = orbit_trajectory(Camera.create(h=24, w=24,
                                          position=(0.0, 0.0, 3.0)),
                            num_frames=4, yaw_sweep=1.6)
    config = RenderConfig(sh_degree=2)
    targets = jax.vmap(lambda c: render_dense(truth, c, config))(cams)

    start = _device_scene(random_scene(24, seed=100, extent=0.7,
                                       scale_range=(0.08, 0.2)))
    res = fit(start, cams, targets, steps=160, lr=2e-2, config=config,
              dssim_weight=0.2, sh_warmup_every=30, densify_every=50,
              densify_kwargs={"pad_multiple": 8},
              lr_decay={"means": 0.05})
    l0, l1 = float(res.losses[0]), res.final_loss
    assert l1 < l0 / 4, f"from-scratch fit stalled: {l0:.4f} -> {l1:.4f}"

    cam0 = jax.tree.map(lambda a: a[0], cams)
    p_start = float(psnr(render_dense(start, cam0, config), targets[0]))
    p_fit = float(psnr(render_dense(res.scene, cam0, config), targets[0]))
    assert p_fit - p_start > 5.0, (p_start, p_fit)
    assert res.densify_log, "densification never ran"


def test_fit_rejects_unknown_lr_keys():
    """A typo'd lr_scales/lr_decay key must raise, not silently disable
    the override ('opacities' is not a leaf; 'logit_opacities' is)."""
    scene = _device_scene(random_scene(4, seed=0, extent=0.5))
    cams = orbit_trajectory(Camera.create(h=8, w=8,
                                          position=(0.0, 0.0, 3.0)),
                            num_frames=1)
    config = RenderConfig(sh_degree=0)
    targets = jax.vmap(lambda c: render_dense(scene, c, config))(cams)
    with pytest.raises(ValueError, match="opacities"):
        fit(scene, cams, targets, steps=1, config=config,
            lr_decay={"opacities": 0.01})
    with pytest.raises(ValueError, match="mean"):
        fit(scene, cams, targets, steps=1, config=config,
            lr_scales={"mean": 0.1})


def test_fit_densify_reaudits_tiled_capacity():
    """Pruning shrinks k_cap (= max_dup_factor * N) while the surviving
    splats keep their footprints: fit() must re-audit at the densify
    boundary and auto-raise max_dup_factor instead of silently
    truncating every subsequent gradient."""
    import pytest
    from splat_tpu.render.api import pair_stats
    n = 64
    scene = random_scene(n, seed=6)
    # 16 big opaque splats at the image center (4 tile pairs each at
    # 64x64 / tile 32: the center is the corner of all four tiles) + 48
    # nearly-transparent ones placed INSIDE tile (0,0) — offset so they
    # cost 1 pair each, not 4 (the round-4 version of this fixture put
    # them on the tile corner too, and the INITIAL audit rejected it
    # before densification ever ran).
    means = np.zeros((n, 3), np.float32)
    means[:, 2] = np.linspace(-0.2, 0.2, n)
    means[16:, 0] = -1.8   # ~px 17 at focal 32 / depth ~4: mid-tile
    means[16:, 1] = -1.8
    opac = np.full((n,), 0.004, np.float32)   # < min_opacity -> pruned
    opac[:16] = 0.95
    scales = np.full((n, 3), 0.02, np.float32)
    scales[:16] = 1.2
    scene = dataclasses.replace(
        scene, means=means, opacities=opac, scales=scales)
    cams = orbit_trajectory(Camera.create(h=64, w=64,
                                          position=(0.0, 0.0, 4.0)),
                            num_frames=1)
    cam0 = jax.tree.map(lambda a: a[0], cams,
                        is_leaf=lambda a: hasattr(a, "shape"))
    targets = jnp.zeros((1, 64, 64, 3))
    config = RenderConfig(max_dup_factor=2.0, sh_degree=0, tile_px=32)
    # Author the capacity arithmetic from the binning stage itself, not
    # hand geometry: the INITIAL audit must pass (demand*1.05 <= 2.0*64)
    # and the POST-PRUNE demand (16 survivors) must exceed 2.0*16.
    demand0 = pair_stats(scene, cam0, config)["slots"]
    surviving = dataclasses.replace(
        scene, means=means[:16], quats=np.asarray(scene.quats)[:16],
        scales=scales[:16], opacities=opac[:16],
        sh=np.asarray(scene.sh)[:16])
    demand1 = pair_stats(surviving, cam0, config)["slots"]
    assert demand0 * 1.05 <= 2.0 * n, demand0      # initial audit passes
    assert demand1 * 1.05 > 2.0 * 16, demand1      # re-audit must trip
    with pytest.warns(UserWarning, match="max_dup_factor"):
        res = fit(scene, cams, targets, steps=2, method="tiled",
                  config=config, densify_every=1,
                  densify_kwargs=dict(grad_threshold=1e9,
                                      min_opacity=0.005,
                                      pad_multiple=1))
    assert res.densify_log and res.densify_log[0]["pruned"] == 48
    assert res.raw.means.shape[0] == 16
    assert np.isfinite(np.asarray(res.losses)).all()
    # Truncation WOULD have occurred without the auto-raise: the fitted
    # parameters must match an amply-provisioned run exactly (the only
    # difference is k_cap padding, which must not change any gradient).
    ample = fit(scene, cams, targets, steps=2, method="tiled",
                config=dataclasses.replace(config, max_dup_factor=8.0),
                densify_every=1,
                densify_kwargs=dict(grad_threshold=1e9,
                                    min_opacity=0.005, pad_multiple=1))
    for k in ("means", "quats", "log_scales", "logit_opacities", "sh"):
        np.testing.assert_allclose(
            np.asarray(getattr(res.raw, k)),
            np.asarray(getattr(ample.raw, k)), rtol=0, atol=1e-6,
            err_msg=f"auto-raised run diverged from ample run on {k}")


def test_fit_tiled_detects_midsegment_capacity_drift():
    """The up-front audit's +5% margin is a heuristic: within a jitted
    segment the optimizer can grow footprints past it.  fit() monitors
    the per-step slot demand inside the scan and must warn (and raise
    capacity) at the segment boundary instead of staying silent."""
    import pytest
    n = 8
    scene = random_scene(n, seed=7)
    # small splats mid-tile (1 pair each): initial demand n, margin OK
    means = np.full((n, 3), 0.0, np.float32)
    means[:, 0] = -1.8
    means[:, 1] = -1.8
    means[:, 2] = np.linspace(-0.1, 0.1, n)
    scene = dataclasses.replace(
        scene, means=means,
        scales=np.full((n, 3), 0.05, np.float32),
        opacities=np.full((n,), 0.8, np.float32))
    cams = orbit_trajectory(Camera.create(h=64, w=64,
                                          position=(0.0, 0.0, 4.0)),
                            num_frames=1)
    # white target + huge scale lr: footprints blow up within steps
    targets = jnp.ones((1, 64, 64, 3))
    config = RenderConfig(max_dup_factor=1.25, sh_degree=0, tile_px=32)
    with pytest.warns(UserWarning, match="mid-segment"):
        fit(scene, cams, targets, steps=8, method="tiled", lr=0.5,
            lr_scales={"log_scales": 10.0}, config=config)
