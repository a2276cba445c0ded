"""The Triton-route Pallas kernels (interpret mode on the CPU) against
their plain jax.numpy references, plus the route and compile-cache
rules.

Tolerances: kernel and reference compute the same float32 walk and
differ only in the order of operations (the kernel multiplies the
transmittance pair by pair, the reference takes a cumulative product per
batch), so colours agree to ~1e-6 absolute and per-pair gradients to
~1e-5 relative.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from splat_tpu.camera import Camera
from splat_tpu.config import RenderConfig
from splat_tpu.ops.projection import project_gaussians
from splat_tpu.render import diff as D
from splat_tpu.render import kernels as K
from splat_tpu.render.binning import build_tile_bins
from splat_tpu.utils.fixtures import random_scene

# colour/logT agreement, absolute: f32 reassociation of a <= 1 sum
ATOL = 1e-5
# per-pair gradient agreement, relative to each row's largest magnitude
GRAD_RTOL = 1e-4


def _bins(scene, cam, cfg):
    proj = project_gaussians(scene, cam, cfg)
    return build_tile_bins(proj, cam.h, cam.w, cfg)


def _opaque(n=400, seed=9):
    """Opaque splats filling a 64x64 view from z=1.5: tiles saturate."""
    scene = random_scene(n, seed=seed, extent=1.0, scale_range=(0.3, 0.6))
    return dataclasses.replace(
        scene, opacities=np.full(n, 0.99, np.float32))


CASES = {
    "basic": dict(scene=lambda: random_scene(
        512, seed=7, extent=2.0, scale_range=(0.02, 0.12)),
        h=96, w=160, cfg={}),
    "nondivisible": dict(scene=lambda: random_scene(
        300, seed=3, extent=2.0, scale_range=(0.02, 0.12)),
        h=70, w=90, cfg={}),
    "alpha_channel": dict(scene=lambda: random_scene(
        300, seed=4, extent=2.0, scale_range=(0.02, 0.12)),
        h=64, w=96, cfg=dict(alpha_channel=True, background=(0.2, 0.3, 0.4))),
    "saturation": dict(scene=_opaque, h=64, w=64, z=1.5,
                       cfg=dict(chunk=8, max_dup_factor=8.0)),
    "empty_tiles": dict(scene=lambda: random_scene(
        40, seed=5, extent=0.3, scale_range=(0.01, 0.03)),
        h=96, w=128, cfg={}),
}


@pytest.mark.parametrize("tile", [16, 32])
@pytest.mark.parametrize("case", sorted(CASES))
def test_composite_kernel_matches_reference(case, tile):
    spec = CASES[case]
    cam = Camera.create(h=spec["h"], w=spec["w"],
                        position=(0.0, 0.0, spec.get("z", 3.5)))
    cfg = RenderConfig(tile_px=tile, **{"chunk": 16, **spec["cfg"]})
    bins = _bins(spec["scene"](), cam, cfg)
    occ = np.asarray(bins.tile_end) - np.asarray(bins.tile_start)
    if case == "empty_tiles":
        assert (occ == 0).any() and (occ > 0).any()
    got = np.asarray(K.composite_tiles(bins, cfg))
    want = np.asarray(K.composite_reference(bins, cfg))
    assert got.shape == want.shape
    assert got.shape[-1] == (4 if cfg.alpha_channel else 3)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    img = np.asarray(K.rasterize_tiles(bins, cam.h, cam.w, cfg))
    assert img.shape == (cam.h, cam.w, got.shape[-1])


def test_saturation_exit_engages_identically():
    """The exit fires at batch granularity in both implementations: with
    opaque splats, tiles stop early, and kernel and reference agree on
    where (the training mode reports the walked count)."""
    cam = Camera.create(h=64, w=64, position=(0.0, 0.0, 1.5))
    cfg = RenderConfig(chunk=8, train_sat_exit=True, max_dup_factor=8.0)
    bins = _bins(_opaque(), cam, cfg)
    _, cut = K.composite_tiles(bins, cfg, train=True)
    _, cut_ref = K.composite_reference(bins, cfg, train=True)
    occ = np.asarray(bins.tile_end) - np.asarray(bins.tile_start)
    np.testing.assert_array_equal(np.asarray(cut), np.asarray(cut_ref))
    assert (np.asarray(cut) < occ).any(), "exit never engaged"


@pytest.mark.parametrize("sat_exit", [False, True])
def test_train_forward_matches_reference(sat_exit):
    scene = random_scene(400, seed=11, extent=2.0, scale_range=(0.05, 0.2))
    cam = Camera.create(h=64, w=96, position=(0.0, 0.0, 3.5))
    cfg = RenderConfig(chunk=16, max_dup_factor=8.0,
                       train_sat_exit=sat_exit)
    bins = _bins(scene, cam, cfg)
    planes, cut = D._fwd_raster(bins, cfg)
    ref, cut_ref = K.composite_reference(bins, cfg, train=True,
                                         sat_cut_log=D.SAT_CUT_LOG)
    np.testing.assert_allclose(np.asarray(planes)[..., :3],
                               np.asarray(ref)[..., :3], atol=ATOL, rtol=0)
    np.testing.assert_allclose(np.asarray(planes)[..., 3],
                               np.asarray(ref)[..., 3], atol=1e-4, rtol=1e-5)
    np.testing.assert_array_equal(np.asarray(cut), np.asarray(cut_ref))


@pytest.mark.parametrize("tile", [16, 32])
def test_backward_kernel_matches_reference_vjp(tile):
    """Per-pair gradients of the backward kernel == jax.vjp of the plain
    reference with respect to the decoded pair fields."""
    scene = random_scene(300, seed=2, extent=2.0, scale_range=(0.05, 0.2))
    cam = Camera.create(h=48, w=80, position=(0.0, 0.0, 3.5))
    cfg = RenderConfig(tile_px=tile, chunk=16, max_dup_factor=8.0)
    bins = _bins(scene, cam, cfg)
    rng = np.random.default_rng(0)
    g_c = jnp.asarray(rng.normal(size=(cam.h, cam.w, 3)), jnp.float32)
    g_lt = jnp.asarray(0.1 * rng.normal(size=(cam.h, cam.w)), jnp.float32)
    planes, cut = D._fwd_raster(bins, cfg)
    grads = np.asarray(D._bwd_raster(bins, g_c, g_lt, planes[..., 3], cut,
                                     cfg))
    occ = np.asarray(bins.tile_end) - np.asarray(bins.tile_start)
    nb = int(-(-occ.max() // cfg.chunk))

    def f(fields):
        out, _ = K.composite_reference(bins, cfg, train=True,
                                       sat_cut_log=D.SAT_CUT_LOG,
                                       fields=fields, num_batches=nb)
        return out[:cam.h, :cam.w, :3], out[:cam.h, :cam.w, 3]

    _, vjp = jax.vjp(f, K.decode_pairs(bins, cfg))
    (gf,) = vjp((g_c, g_lt))
    want = np.stack([np.asarray(gf[k]) for k in K.PAIR_FIELDS])
    n_real = int(np.asarray(bins.tile_end)[-1])
    assert n_real > 0
    for r, name in enumerate(K.PAIR_FIELDS):
        a, b = grads[r, :n_real], want[r, :n_real]
        scale = np.abs(b).max() + 1e-20
        assert np.abs(a - b).max() / scale < GRAD_RTOL, name
    assert np.all(grads[:, n_real:] == 0.0)


def test_reference_scan_matches_while_loop():
    """The differentiable (scan) and the early-exit (while) walks of the
    reference are the same function."""
    cam = Camera.create(h=64, w=64, position=(0.0, 0.0, 1.5))
    cfg = RenderConfig(chunk=8, max_dup_factor=8.0)
    bins = _bins(_opaque(), cam, cfg)
    occ = np.asarray(bins.tile_end) - np.asarray(bins.tile_start)
    a = np.asarray(K.composite_reference(bins, cfg))
    b = np.asarray(K.composite_reference(
        bins, cfg, num_batches=int(-(-occ.max() // cfg.chunk))))
    np.testing.assert_array_equal(a, b)


# --------------------------------------------------------------------------
# Route and configuration rules
# --------------------------------------------------------------------------

def test_route_cpu_interprets_triton():
    from splat_tpu.render.route import kernel_route
    r = kernel_route(platform="cpu")
    assert r == {"backend": "triton", "interpret": True}


def test_route_gpu_compiles_triton():
    from jax.experimental.pallas import triton as pl_triton
    from splat_tpu.render.route import kernel_route
    r = kernel_route(num_warps=8, platform="gpu")
    assert r["backend"] == "triton" and r["interpret"] is False
    assert isinstance(r["compiler_params"], pl_triton.CompilerParams)
    assert r["compiler_params"].num_warps == 8


@pytest.mark.parametrize("platform", ["cuda", "rocm", "metal"])
def test_route_unknown_platform_raises(platform):
    from splat_tpu.render.route import kernel_route
    with pytest.raises(RuntimeError, match="no kernel route"):
        kernel_route(platform=platform)


@pytest.mark.parametrize("tile,tpy,ok", [(32, 0, True), (16, 0, True),
                                         (32, 16, True), (8, 0, True),
                                         (24, 0, False), (32, 24, False)])
def test_tile_pixel_count_power_of_two(tile, tpy, ok):
    if ok:
        RenderConfig(tile_px=tile, tile_py=tpy)
    else:
        with pytest.raises(ValueError, match="power of two"):
            RenderConfig(tile_px=tile, tile_py=tpy)


def test_compile_cache_uses_env_dir(monkeypatch, tmp_path):
    from splat_tpu.utils import compilecache
    calls = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.__setitem__(k, v))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compilecache.enable_persistent_cache() == str(tmp_path)
    # JAX reads the variable itself: no other directory is set in code
    assert "jax_compilation_cache_dir" not in calls


def test_compile_cache_defaults_inside_checkout(monkeypatch):
    from splat_tpu.utils import compilecache
    calls = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.__setitem__(k, v))
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compilecache.enable_persistent_cache()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert path == os.path.join(repo, ".jax_cache")
    assert calls["jax_compilation_cache_dir"] == path
    with open(os.path.join(repo, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


# --------------------------------------------------------------------------
# On the card (skipped on the CPU)
# --------------------------------------------------------------------------

@pytest.mark.chip
def test_compiled_kernels_match_reference_on_chip(chip):
    """The compiled Triton kernels against the plain references at a
    moderate size (chip_smoke.py runs the full-size comparison)."""
    from splat_tpu.utils.fixtures import surface_scene
    scene = surface_scene(50_000, seed=0).pack_device()
    cam = Camera.create(h=360, w=640, position=(0.0, 0.0, 4.0))
    cfg = RenderConfig(max_dup_factor=3.0)
    bins = jax.jit(lambda s, c: _bins(s, c, cfg))(scene, cam)
    got = K.composite_tiles(bins, cfg)
    want = K.composite_reference(bins, cfg)
    assert float(jnp.max(jnp.abs(got - want))) < ATOL
