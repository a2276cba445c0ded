"""BASELINE.md config-ladder benchmark suite.

Runs the five baseline configurations (BASELINE.json / SURVEY §6) with
synthetic stand-ins sized like the named scenes (the pretrained
plush_sledge / Mip-NeRF-360 models are multi-hundred-MB downloads this
environment cannot fetch), reports device-chained ms/frame and PSNR vs the
NumPy oracle where feasible, and writes a JSON report.

Runs on the GPU only (a timing taken elsewhere is not this system's).

Usage: python scripts/bench_suite.py [--out bench_suite.json] [--quick]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def device_ms_per_frame(render_fn, scene, cam, frames=10):
    import jax
    import jax.numpy as jnp

    def chained(scene, cam):
        def step(carry, i):
            c = dataclasses.replace(
                cam, yaw=cam.yaw + 0.01 * i.astype(jnp.float32)
                + carry * 1e-20)
            img = render_fn(scene, c)
            return jnp.mean(img), 0.0
        c2, _ = jax.lax.scan(step, jnp.float32(0.0), jnp.arange(frames))
        return c2

    f = jax.jit(chained)
    jax.device_get(f(scene, cam))
    t0 = time.time()
    jax.device_get(f(scene, cam))
    return (time.time() - t0) / frames * 1e3


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="bench_suite.json")
    ap.add_argument("--quick", action="store_true",
                    help="shrink scenes 10x for a fast smoke run")
    args = ap.parse_args()

    import numpy as np

    import splat_tpu as st
    from splat_tpu.config import RenderConfig
    from splat_tpu.render.oracle import render_oracle
    from splat_tpu.render.tiled import render_tiled
    from splat_tpu.utils.benchmark import require_gpu
    from splat_tpu.utils.compilecache import enable_persistent_cache
    from splat_tpu.utils.image import psnr

    device = require_gpu()
    enable_persistent_cache()

    div = 10 if args.quick else 1
    results = []

    def run(name, n, h, w, config, *, parity_n=None, frames=10):
        scene = st.random_scene(max(n // div, 256), seed=0, extent=3.0,
                                scale_range=(0.004, 0.03)).to_device()
        cam = st.Camera.create(h=h, w=w, position=(0.0, 0.0, 4.0))
        ms = device_ms_per_frame(
            lambda s, c: render_tiled(s, c, config), scene, cam,
            frames=frames)
        entry = {"config": name, "n": scene.num_gaussians,
                 "resolution": f"{w}x{h}", "ms_per_frame": round(ms, 2),
                 "fps": round(1e3 / ms, 2)}
        if parity_n:
            small = st.random_scene(parity_n, seed=1, extent=2.0,
                                    scale_range=(0.02, 0.1))
            pcam = st.Camera.create(h=min(h, 256), w=min(w, 256),
                                    position=(0.0, 0.0, 4.0))
            import jax
            img = np.asarray(jax.jit(
                lambda s, c: render_tiled(s, c, config))(small.to_device(),
                                                         pcam))
            gold = render_oracle(small, pcam, config)
            entry["psnr_vs_oracle_db"] = round(psnr(img, gold), 2)
        results.append(entry)
        print(json.dumps(entry), file=sys.stderr)

    # Ladder (BASELINE.json); DC-only ~= sh_degree 0.
    run("1_notebook_prototype_10k_256", 10_000, 256, 256,
        RenderConfig(sh_degree=0), parity_n=512)
    run("2_plush_sledge_800x600_parity", 200_000, 600, 800,
        RenderConfig(), parity_n=512)
    run("3_sh3_multi_pose_720p", 400_000, 720, 1280, RenderConfig())
    run("4_mipnerf360_1080p", 1_000_000, 1080, 1920, RenderConfig())
    run("5_orbit_120f_1080p", 1_000_000, 1080, 1920, RenderConfig(),
        frames=120 // div if not args.quick else 12)
    # Extended rows (BASELINE.md ladder 4+): resolution and
    # gaussian-count scale, with capacities sized to their pair loads.
    run("4b_1440p", 1_000_000, 1440, 2560,
        RenderConfig(max_dup_factor=2.7))
    run("4c_4k_tile64", 1_000_000, 2160, 3840,
        RenderConfig(tile_px=64, max_dup_factor=2.05))
    run("4d_3M_1080p", 3_000_000, 1080, 1920,
        RenderConfig(max_dup_factor=2.1))
    run("4e_6M_1080p", 6_000_000, 1080, 1920,
        RenderConfig(max_dup_factor=2.2))

    with open(args.out, "w") as f:
        json.dump({"device": device, "results": results}, f, indent=2)
    print(json.dumps({"suite": "baseline_ladder", "device": device,
                      "results": results}))


if __name__ == "__main__":
    main()
