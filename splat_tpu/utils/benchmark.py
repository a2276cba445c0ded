"""Device-chained benchmark harness shared by bench.py and the CLI.

One implementation of the timing + audit protocol: F frames rendered
inside one jitted lax.scan with a data dependency between frames (so
per-call dispatch amortizes and the host clock brackets device work that
ends in a fetch), followed by a capacity audit over the SAME camera
sweep, because a frame that overflows the duplication buffer silently
drops its deepest pairs and a capacity regression would otherwise LOOK
like a speedup.

Measurements name their device: :func:`device_info` reports the
platform, kind, count, card name and power limit, and
:func:`require_gpu` fails on any platform other than the GPU — a timing
taken elsewhere is not a number of this system.
"""

from __future__ import annotations

import dataclasses
import time


def chained_bench(scene, camera, config, frames: int) -> dict:
    """Compile + time a device-chained yaw sweep; audit its pair load.

    Returns a dict with ms_per_frame, fps, compile_s, mean_pixel, the
    sweep-max overflow / num_pairs / visible, and the device
    (:func:`device_info`).  The fps number is only honest when
    overflow == 0 (callers decide how to surface that).  Fails unless
    JAX runs on the GPU.
    """
    import jax
    import jax.numpy as jnp

    device = require_gpu()

    from splat_tpu.render.tiled import render_tiled

    def chained(scene, cam):
        def step(carry, i):
            c = dataclasses.replace(
                cam, yaw=cam.yaw + 0.01 * i.astype(jnp.float32)
                + carry * 1e-20)
            img = render_tiled(scene, c, config)
            return jnp.mean(img), jnp.mean(img)
        return jax.lax.scan(step, jnp.float32(0.0), jnp.arange(frames))

    def audit(scene, cam):
        def step(_, i):
            c = dataclasses.replace(
                cam, yaw=cam.yaw + 0.01 * i.astype(jnp.float32))
            _, stats = render_tiled(scene, c, config, return_stats=True)
            return 0.0, (stats["overflow"], stats["num_pairs"],
                         stats["visible"])
        _, out = jax.lax.scan(step, jnp.float32(0.0), jnp.arange(frames))
        return jax.tree.map(jnp.max, out)

    f = jax.jit(chained)
    t0 = time.time()
    jax.device_get(f(scene, camera))
    compile_s = time.time() - t0
    t0 = time.time()
    _, means = jax.device_get(f(scene, camera))
    dt = (time.time() - t0) / frames
    overflow, num_pairs, visible = (
        int(x) for x in jax.device_get(jax.jit(audit)(scene, camera)))
    return {
        "ms_per_frame": dt * 1e3,
        "fps": 1.0 / dt,
        "compile_s": compile_s,
        "mean_pixel": float(means.mean()),
        "overflow": overflow,
        "num_pairs": num_pairs,
        "visible": visible,
        "device": device,
    }


def device_info() -> dict:
    """The device a measurement ran on: JAX's platform, kind and count,
    plus the card's name and power limit as nvidia-smi reports them
    (None where nvidia-smi is absent)."""
    import shutil
    import subprocess

    import jax

    dev = jax.devices()[0]
    info = {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices()), "nvidia_smi": None}
    if shutil.which("nvidia-smi"):
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60)
        info["nvidia_smi"] = out.stdout.strip().splitlines()[0]
    return info


def require_gpu() -> dict:
    """Fail unless JAX runs on the GPU; returns :func:`device_info`."""
    info = device_info()
    if info["platform"] != "gpu":
        raise RuntimeError(
            f"benchmarks run on the GPU only; JAX found "
            f"{info['platform']!r} ({info['kind']})")
    return info
