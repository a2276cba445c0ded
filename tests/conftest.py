"""Test harness configuration.

Tests run on the CPU (``JAX_PLATFORMS=cpu``) with 8 virtual host devices
(``--xla_force_host_platform_device_count=8``), so sharding logic is
exercised without several cards and every Pallas kernel runs in
interpret mode (render/route.py).  The flag must reach XLA before JAX
initializes a backend, hence it is set here at import.

Tests marked ``chip`` need the GPU; they skip on the CPU.  Run them on
the card with ``SPLAT_TEST_BACKEND=gpu python -m pytest -m chip tests/``.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

if os.environ.get("SPLAT_TEST_BACKEND", "cpu") == "cpu":
    jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs the GPU; skips on any other backend")


@pytest.fixture
def chip():
    """Skip unless JAX runs on the GPU (decided at run time, never at
    import, so every xdist worker collects the same tests)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs the GPU (run with SPLAT_TEST_BACKEND=gpu on "
                    "the card)")
    return jax.devices()[0]


@pytest.fixture(scope="session")
def naive_scene():
    from splat_tpu.utils.fixtures import naive_gaussians
    return naive_gaussians()


@pytest.fixture(scope="session")
def demo_camera():
    """The reference demo camera (src/bin/01_naive_gaussian.rs:6-8): 1280x720
    at the fixed position, scaled down to 256x144 for test speed."""
    from splat_tpu.camera import Camera
    return Camera.create(h=144, w=256,
                         position=(-0.57651054, 2.99040512, -0.03924271))


@pytest.fixture(scope="session")
def small_random_scene():
    from splat_tpu.utils.fixtures import random_scene
    return random_scene(512, seed=7, extent=2.0,
                        scale_range=(0.02, 0.12))
