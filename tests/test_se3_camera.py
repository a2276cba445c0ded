"""SE(3) camera: arbitrary world-to-camera poses + COLMAP intrinsics.

The reference camera is orbit-only (src/camera.rs:4-127); real 3DGS
datasets carry COLMAP extrinsics (+ fx != fy / off-center principal
points) that an orbit cannot express.  SE3Camera (camera.py) extends the
engine to those poses; these tests pin:

* protocol parity — an orbit pose converted via to_se3() renders the
  same image on every path;
* oracle parity at a NON-orbit pose (rolled up-vector, fx != fy,
  off-center principal point);
* the COLMAP convention flip (y-down/z-forward -> look_at frame);
* training against SE(3)-posed targets end to end;
* the camera JSON spec round-trip (cli._load_camera_path).
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from splat_tpu.camera import Camera, SE3Camera, look_at, stack_cameras
from splat_tpu.config import RenderConfig
from splat_tpu.render.dense import render_dense
from splat_tpu.render.oracle import render_oracle
from splat_tpu.render.tiled import render_tiled
from splat_tpu.utils.fixtures import naive_gaussians, random_scene
from splat_tpu.utils.image import psnr


def _rolled_se3_camera(h=96, w=128, fx=80.0, fy=64.0, cx=70.0, cy=40.0):
    """A pose no orbit Camera can express: tilted (rolled) up vector,
    anisotropic focal, off-center principal point."""
    eye = jnp.asarray([1.0, 1.5, 3.0])
    tgt = jnp.asarray([0.2, -0.1, 0.0])
    up = jnp.asarray([0.3, -0.9, 0.1])
    return SE3Camera.create(h=h, w=w, view=look_at(eye, tgt, up),
                            fx=fx, fy=fy, cx=cx, cy=cy)


def test_to_se3_matches_orbit_everywhere():
    scene = naive_gaussians()
    cam = Camera.create(h=64, w=64,
                        position=(-0.57651054, 2.99040512, -0.03924271),
                        yaw=0.3, pitch=-0.2)
    se3 = cam.to_se3()
    np.testing.assert_allclose(np.asarray(se3.eye()),
                               np.asarray(cam.eye()), atol=1e-5)
    np.testing.assert_allclose(np.asarray(se3.view_matrix()),
                               np.asarray(cam.view_matrix()), atol=1e-6)
    cfg = RenderConfig(max_dup_factor=16.0)
    a = np.asarray(render_dense(scene, cam, cfg))
    b = np.asarray(render_dense(scene, se3, cfg))
    assert float(psnr(a, b)) > 55.0
    at = np.asarray(render_tiled(scene, cam, cfg))
    bt = np.asarray(render_tiled(scene, se3, cfg))
    assert float(psnr(at, bt)) > 55.0
    # oracle accepts both parameterizations
    oa = render_oracle(scene, cam, cfg)
    ob = render_oracle(scene, se3, cfg)
    assert float(psnr(oa, ob)) > 55.0


def test_se3_nonorbit_pose_oracle_parity():
    """Dense and tiled vs the NumPy oracle at a rolled pose with
    fx != fy and an off-center principal point (>= 45 dB — the suite's
    parity bar)."""
    scene = random_scene(300, seed=3)
    cam = _rolled_se3_camera()
    cfg = RenderConfig(max_dup_factor=16.0)
    ref = render_oracle(scene, cam, cfg)
    assert ref.std() > 0.01, "degenerate fixture: blank oracle frame"
    d = np.asarray(render_dense(scene, cam, cfg))
    assert float(psnr(d, ref)) >= 45.0
    t = np.asarray(render_tiled(scene, cam, cfg))
    assert float(psnr(t, ref)) >= 45.0


def test_se3_supersample_scales_intrinsics():
    cam = _rolled_se3_camera()
    s = cam.scaled(2)
    assert (s.h, s.w) == (cam.h * 2, cam.w * 2)
    np.testing.assert_allclose(float(s.fx), float(cam.fx) * 2)
    np.testing.assert_allclose(float(s.cy), float(cam.cy) * 2)
    # supersampled render stays close to the 1x render (same fov)
    scene = random_scene(100, seed=5)
    cfg = RenderConfig(max_dup_factor=16.0)
    a = np.asarray(render_tiled(scene, cam, cfg))
    b = np.asarray(render_tiled(scene, cam,
                                dataclasses.replace(cfg, supersample=2)))
    assert float(psnr(a, b)) > 28.0  # AA changes edges, not content


def test_from_colmap_identity_convention():
    """COLMAP identity pose: camera at origin, x right, y DOWN, z
    FORWARD.  A world point at (x, y, z>0) must land at
    (cx + fx x/z, cy + fy y/z) — and the converted view matrix is the
    y/z row flip."""
    cam = SE3Camera.from_colmap(qvec=(1.0, 0.0, 0.0, 0.0),
                                tvec=(0.0, 0.0, 0.0),
                                fx=100.0, fy=120.0, cx=64.0, cy=48.0,
                                h=96, w=128)
    v = np.asarray(cam.view)
    np.testing.assert_allclose(
        v, np.diag([1.0, -1.0, -1.0, 1.0]).astype(np.float32), atol=1e-6)
    np.testing.assert_allclose(np.asarray(cam.eye()), np.zeros(3),
                               atol=1e-6)
    # project a point through the engine's pinhole mapping
    p = np.array([0.1, 0.2, 1.0])
    pos_cam = v[:3, :3] @ p + v[:3, 3]
    x_px = float(cam.cx) + float(cam.fx) * pos_cam[0] / -pos_cam[2]
    y_px = float(cam.cy) - float(cam.fy) * pos_cam[1] / -pos_cam[2]
    np.testing.assert_allclose(x_px, 64.0 + 100.0 * 0.1, atol=1e-4)
    np.testing.assert_allclose(y_px, 48.0 + 120.0 * 0.2, atol=1e-4)


def test_from_colmap_matches_lookat_pose():
    """A COLMAP record built FROM a look_at view must reproduce it."""
    eye = jnp.asarray([0.5, -1.0, 2.5])
    tgt = jnp.asarray([0.0, 0.0, 0.0])
    up = jnp.asarray([0.0, -1.0, 0.0])
    view = np.asarray(look_at(eye, tgt, up), np.float64)
    # engine -> COLMAP: flip rows 1, 2 of [R|t]
    flip = np.diag([1.0, -1.0, -1.0])
    r_cm = flip @ view[:3, :3]
    t_cm = flip @ view[:3, 3]
    # rotation matrix -> scalar-first quaternion
    tr = np.trace(r_cm)
    qw = np.sqrt(max(tr + 1.0, 0.0)) / 2
    qx = (r_cm[2, 1] - r_cm[1, 2]) / (4 * qw)
    qy = (r_cm[0, 2] - r_cm[2, 0]) / (4 * qw)
    qz = (r_cm[1, 0] - r_cm[0, 1]) / (4 * qw)
    cam = SE3Camera.from_colmap((qw, qx, qy, qz), t_cm, 100.0, 100.0,
                                32.0, 32.0, h=64, w=64)
    np.testing.assert_allclose(np.asarray(cam.view), view.astype(np.float32),
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(cam.eye()), np.asarray(eye),
                               atol=1e-5)


def test_se3_pose_is_traced_not_static():
    """Pose changes must never recompile: view/intrinsics are traced
    leaves (CLAUDE.md rule 6)."""
    scene = random_scene(50, seed=1)
    cfg = RenderConfig(max_dup_factor=16.0)
    traces = []

    @jax.jit
    def render(s, c):
        traces.append(1)
        return render_dense(s, c, cfg)

    cam1 = _rolled_se3_camera()
    cam2 = dataclasses.replace(
        cam1, view=jnp.asarray(look_at(jnp.asarray([0.0, 0.5, 4.0]),
                                       jnp.zeros(3),
                                       jnp.asarray([0.0, -1.0, 0.0]))),
        fx=cam1.fx * 1.1, cx=cam1.cx + 3.0)
    render(scene, cam1)
    render(scene, cam2)
    assert len(traces) == 1, "pose/intrinsics change retraced the render"


def test_fit_against_se3_posed_targets():
    """End-to-end: targets rendered from NON-orbit poses, fit recovers a
    perturbed scene (the COLMAP-dataset training workflow)."""
    from splat_tpu.train import fit
    scene = jax.tree.map(jnp.asarray,
                         random_scene(12, seed=6, extent=0.8,
                                      scale_range=(0.12, 0.25)))
    ups = [(0.3, -0.9, 0.1), (-0.2, -0.95, 0.0),
           (0.1, -0.8, 0.3), (0.0, -1.0, 0.05)]
    eyes = [(1.0, 1.5, 3.0), (-1.5, 0.5, 3.0),
            (0.5, -1.0, 3.2), (0.0, 2.0, 2.5)]
    cl = [SE3Camera.create(
        h=24, w=24, view=look_at(jnp.asarray(e), jnp.zeros(3),
                                 jnp.asarray(u)),
        fx=14.0, fy=12.0, cx=13.0, cy=11.0)
        for e, u in zip(eyes, ups)]
    cams = stack_cameras(cl)
    config = RenderConfig(sh_degree=0)
    targets = jax.vmap(lambda c: render_dense(scene, c, config))(cams)
    start = dataclasses.replace(scene, sh=scene.sh * 0.5)
    res = fit(start, cams, targets, steps=30, lr=2e-2, config=config)
    assert res.final_loss < float(res.losses[0]) / 3


def test_stack_cameras_validation():
    c1 = _rolled_se3_camera(h=32, w=32)
    c2 = _rolled_se3_camera(h=64, w=32)
    with pytest.raises(ValueError, match="h, w"):
        stack_cameras([c1, c2])
    with pytest.raises(ValueError, match="empty"):
        stack_cameras([])
    batched = stack_cameras([c1, c1])
    assert np.asarray(batched.view).shape == (2, 4, 4)


def test_camera_json_se3_views(tmp_path):
    from splat_tpu.cli import _load_camera_path
    view = np.asarray(look_at(jnp.asarray([0.0, 0.0, 4.0]), jnp.zeros(3),
                              jnp.asarray([0.0, -1.0, 0.0])))
    spec = {"h": 48, "w": 64, "fx": 40.0, "views": [
        {"view_matrix": view.tolist(), "fy": 36.0, "cx": 30.0},
        {"qvec": [1.0, 0.0, 0.0, 0.0], "tvec": [0.0, 0.0, -4.0]},
    ]}
    p = tmp_path / "cams.json"
    p.write_text(json.dumps(spec))
    cams, h, w = _load_camera_path(str(p), "64x48", 90.0)
    assert (h, w) == (48, 64)
    assert all(isinstance(c, SE3Camera) for c in cams)
    assert float(cams[0].fy) == 36.0 and float(cams[0].cx) == 30.0
    assert float(cams[1].fx) == 40.0 and float(cams[1].fy) == 40.0
    # defaulted principal point = image center
    assert float(cams[1].cx) == 32.0 and float(cams[1].cy) == 24.0

    # mixing orbit and SE(3) views is an error
    spec_mixed = {"views": [{"position": [0, 0, 4]},
                            {"qvec": [1, 0, 0, 0], "tvec": [0, 0, 0]}]}
    p2 = tmp_path / "mixed.json"
    p2.write_text(json.dumps(spec_mixed))
    with pytest.raises(SystemExit, match="mix"):
        _load_camera_path(str(p2), "64x48", 90.0)

    # interp needs orbit views
    spec_i = {"views": [{"qvec": [1, 0, 0, 0], "tvec": [0, 0, 0]},
                        {"qvec": [1, 0, 0, 0], "tvec": [0, 0, -1]}]}
    p3 = tmp_path / "interp.json"
    p3.write_text(json.dumps(spec_i))
    with pytest.raises(SystemExit, match="interp"):
        _load_camera_path(str(p3), "64x48", 90.0, interp=4)


def test_se3_camera_pose_gradients_flow():
    """jax.grad w.r.t. the view matrix and intrinsics is finite and
    nonzero — pose refinement (a standard 3DGS extension) comes free
    with the traced parameterization."""
    scene = jax.tree.map(jnp.asarray, random_scene(20, seed=2))
    cam = _rolled_se3_camera(h=32, w=32, fx=24.0, fy=24.0,
                             cx=16.0, cy=16.0)
    cfg = RenderConfig(sh_degree=0)
    target = render_dense(scene, cam, cfg)

    def loss(view, fx):
        c = dataclasses.replace(cam, view=view, fx=fx)
        img = render_dense(scene, c, cfg)
        return jnp.mean((img - target * 0.9) ** 2)

    g_view, g_fx = jax.grad(loss, argnums=(0, 1))(cam.view, cam.fx)
    assert np.isfinite(np.asarray(g_view)).all()
    assert np.abs(np.asarray(g_view)).max() > 0
    assert np.isfinite(float(g_fx)) and abs(float(g_fx)) > 0
