"""Differentiable rendering through the dense path.

The reference is a feed-forward viewer; differentiability is an
extension that falls out of the functional design: ``render_dense`` is
pure JAX (sort + gather + masked compositing are all differentiable or
piecewise-constant), so ``jax.grad`` flows from pixels back to every
scene parameter (means, quats, scales, opacities, sh).  That is the
building block 3DGS training pipelines need.  The tiled Pallas path has
no VJP — the dense renderer is the documented differentiable surface.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from splat_tpu.camera import Camera
from splat_tpu.config import RenderConfig
from splat_tpu.render.dense import render_dense
from splat_tpu.scene import GaussianScene
from splat_tpu.utils.fixtures import random_scene


def _device_scene(scene: GaussianScene) -> GaussianScene:
    return jax.tree.map(jnp.asarray, scene)


def _loss_fn(camera, config):
    def loss(scene):
        img = render_dense(scene, camera, config)
        return jnp.mean(img)
    return loss


def test_grad_matches_finite_difference():
    """d loss / d (opacity, sh_dc) vs central differences.

    These parameters are smooth (no dependence of the bbox/visibility
    masks on them at interior points), so FD agrees tightly.
    """
    scene = _device_scene(random_scene(8, seed=3, extent=1.0,
                                       scale_range=(0.1, 0.25)))
    # keep every splat away from the alpha clamp so min() is inactive
    scene = dataclasses.replace(
        scene, opacities=jnp.full_like(scene.opacities, 0.5))
    cam = Camera.create(h=32, w=32, position=(0.0, 0.0, 4.0))
    loss = _loss_fn(cam, RenderConfig())
    g = jax.grad(loss)(scene)

    eps = 1e-3
    for field, idx in [("opacities", (2,)), ("sh", (1, 0, 1))]:
        arr = getattr(scene, field)
        up = arr.at[idx].add(eps)
        dn = arr.at[idx].add(-eps)
        fd = (loss(dataclasses.replace(scene, **{field: up}))
              - loss(dataclasses.replace(scene, **{field: dn}))) / (2 * eps)
        an = getattr(g, field)[idx]
        np.testing.assert_allclose(an, fd, rtol=2e-2, atol=1e-5,
                                   err_msg=f"grad mismatch on {field}{idx}")


def test_grad_flows_to_all_params():
    """Every scene leaf gets a finite gradient, and the geometric ones
    (means, scales, quats) are nonzero somewhere."""
    scene = _device_scene(random_scene(16, seed=5, extent=1.0,
                                       scale_range=(0.08, 0.2)))
    cam = Camera.create(h=32, w=32, position=(0.0, 0.0, 4.0))
    g = jax.grad(_loss_fn(cam, RenderConfig()))(scene)
    for f in dataclasses.fields(scene):
        ga = np.asarray(getattr(g, f.name))
        assert np.all(np.isfinite(ga)), f"non-finite grad in {f.name}"
    assert np.abs(np.asarray(g.means)).max() > 0
    assert np.abs(np.asarray(g.scales)).max() > 0
    assert np.abs(np.asarray(g.opacities)).max() > 0


def test_fit_scene_to_target():
    """Optimization smoke test: recover perturbed colors/opacities by
    gradient descent on the photometric loss against a rendered target."""
    import optax

    true_scene = _device_scene(random_scene(6, seed=9, extent=0.8,
                                            scale_range=(0.15, 0.3)))
    cam = Camera.create(h=32, w=32, position=(0.0, 0.0, 3.0))
    config = RenderConfig(sh_degree=0)
    target = render_dense(true_scene, cam, config)

    rng = np.random.default_rng(0)
    start = dataclasses.replace(
        true_scene,
        sh=true_scene.sh + jnp.asarray(
            rng.normal(0, 0.4, true_scene.sh.shape), jnp.float32),
        opacities=jnp.clip(
            true_scene.opacities + jnp.asarray(
                rng.normal(0, 0.2, true_scene.opacities.shape),
                jnp.float32), 0.05, 0.95))

    def loss(params):
        scene = dataclasses.replace(true_scene, sh=params["sh"],
                                    opacities=params["opacities"])
        return jnp.mean((render_dense(scene, cam, config) - target) ** 2)

    params = {"sh": start.sh, "opacities": start.opacities}
    opt = optax.adam(2e-2)
    state = opt.init(params)

    @jax.jit
    def step(params, state):
        l, g = jax.value_and_grad(loss)(params)
        updates, state = opt.update(g, state)
        return optax.apply_updates(params, updates), state, l

    l0 = float(loss(params))
    for _ in range(80):
        params, state, l = step(params, state)
    l1 = float(l)
    assert l0 > 1e-5, "perturbation produced no initial error"
    assert l1 < l0 / 5, f"loss {l0:.2e} -> {l1:.2e}: optimization stalled"
