"""Ladder-2 parity on the committed trained-like PLY fixture.

The reference's own golden output is a pretrained-model render
(src/main.rs:19 loads notes/point_cloud.ply; README.md:6 records
notes/screenshot.png as the expected image), but that .ply is gitignored
in the reference repo.  tests/data/surface_5k.ply is the stand-in: 5k
splats on blobby surfaces with trained-scene statistics (tangent
-anisotropic scales, high opacity), written by save_ply and committed.
"""

import os

import numpy as np

from splat_tpu.camera import Camera
from splat_tpu.config import RenderConfig
from splat_tpu.io.ply import load_ply
from splat_tpu.render.oracle import render_oracle
from splat_tpu.render.tiled import render_tiled
from splat_tpu.utils.image import psnr

FIXTURE = os.path.join(os.path.dirname(__file__), "data", "surface_5k.ply")


def test_fixture_roundtrip_stats():
    scene = load_ply(FIXTURE, center=False)
    assert scene.num_gaussians == 5000
    d = scene.to_numpy()
    # trained-like statistics: anisotropic scales, high opacity
    aniso = d["scales"].max(1) / d["scales"].min(1)
    assert np.median(aniso) > 3.0
    assert np.median(d["opacities"]) > 0.5


def test_fixture_full_scene_parity_tiled():
    """Ladder 2 shape: full scene, single frame, 4:3 viewport, tiled path
    (interpret mode on CPU)."""
    scene = load_ply(FIXTURE, center=False)
    cam = Camera.create(h=300, w=400, position=(0.0, -1.0, 3.5))
    config = RenderConfig()
    img = np.asarray(render_tiled(scene, cam, config))
    gold = render_oracle(scene, cam, config)
    p = psnr(img, gold)
    assert p >= 45.0, f"fixture-scene PSNR {p:.2f} dB"
    assert gold.max() > 0.3  # actually renders content
