"""Randomized parity fuzzer: tiled renderer vs the NumPy oracle.

Draws random scenes, cameras, and RenderConfigs (tile shapes, chunk,
capacity, sh degree, culling, binning key) and asserts PSNR >= 45 dB
plus overflow-count consistency.  Runs on the CPU (interpret-mode
Pallas) for bug hunting:

    python scripts/fuzz_parity.py [--cases N] [--seed S]

Any failing case prints its full recipe so it can be distilled into a
regression test.

--sharded additionally runs each case through the multi-chip tiled path
(render_sharded_tiled) on a virtual CPU mesh, over both routing modes;
launch with XLA_FLAGS=--xla_force_host_platform_device_count=8.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cases", type=int, default=40)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--min-psnr", type=float, default=45.0)
    ap.add_argument("--sharded", action="store_true")
    args = ap.parse_args()

    import jax
    # pin the CPU backend before any backend is initialized
    jax.config.update("jax_platforms", "cpu")
    import numpy as np
    import splat_tpu as st
    from splat_tpu.config import RenderConfig
    from splat_tpu.render.oracle import render_oracle
    from splat_tpu.render.tiled import render_tiled
    from splat_tpu.utils.image import psnr

    if args.sharded:
        from splat_tpu.parallel.sharding import (make_mesh,
                                                 render_sharded_tiled)
        n_dev = len(jax.devices())
        if n_dev < 8:
            sys.exit("--sharded needs XLA_FLAGS="
                     "--xla_force_host_platform_device_count=8")

    rng = np.random.default_rng(args.seed)
    failures = 0
    for case in range(args.cases):
        n = int(rng.choice([1, 7, 64, 300, 1500]))
        kind = rng.choice(["random", "surface"])
        if kind == "surface":
            scene = st.surface_scene(max(n, 50), seed=int(rng.integers(1e6)))
        else:
            scene = st.random_scene(
                n, seed=int(rng.integers(1e6)),
                extent=float(rng.uniform(0.5, 4.0)),
                scale_range=(float(rng.uniform(0.002, 0.02)),
                             float(rng.uniform(0.03, 0.3))))
        h = int(rng.choice([16, 40, 96, 130, 256]))
        w = int(rng.choice([16, 48, 100, 160, 250]))
        # powers of two, as the compositing kernel requires
        tile = int(rng.choice([8, 16, 32]))
        tile_y = int(rng.choice([0, 8, 16]))
        if args.sharded:
            n_g = int(rng.choice([2, 4, 8]))
            route = str(rng.choice(["a2a", "gather"]))
            cap = float(rng.choice([0.0, 1.0]))  # 0 -> default cap
            h = -(-h // n_g) * n_g
        cam = st.Camera.create(
            h=h, w=w,
            position=tuple(rng.uniform(-1, 1, 3) * [2, 2, 1] + [0, 0, 3.5]),
            yaw=float(rng.uniform(-0.5, 0.5)),
            pitch=float(rng.uniform(-0.5, 0.5)))
        # inf = truncation-free mode (kernel skips its bbox compares);
        # it requires tight_radius, which is otherwise drawn freely
        sigma_cutoff = float(rng.choice([3.0, 3.0, 3.0, float("inf")]))
        render_mode = str(rng.choice(["color", "color", "color", "depth"]))
        depth_range = None
        if render_mode == "depth" and (args.sharded or rng.random() < 0.5):
            # sharded depth mode REQUIRES an explicit range (auto would be
            # per-shard); single-chip draws it half the time
            lo = float(rng.uniform(0.5, 3.0))
            depth_range = (lo, lo + float(rng.uniform(1.0, 6.0)))
        config = RenderConfig(
            render_mode=render_mode, depth_range=depth_range,
            tile_px=tile, tile_py=tile_y,
            chunk=int(rng.choice([8, 32, 64])),
            # 0.9999999 exercises the kernel's alpha_clamp~1 log1p guard
            # (the only compiled branch the default 0.99 never takes)
            alpha_clamp=float(rng.choice([0.99, 0.99, 0.9999999])),
            alpha_min=float(rng.choice([1 / 255.0, 1 / 255.0, 0.01])),
            max_dup_factor=float(rng.uniform(4.0, 9.0)),
            sh_degree=int(rng.choice([0, 1, 2, 3])),
            cull_pairs=bool(rng.random() < 0.3),
            alpha_channel=bool(rng.random() < 0.25),
            sigma_cutoff=sigma_cutoff,
            tight_radius=(True if sigma_cutoff == float("inf")
                          else bool(rng.random() < 0.8)),
            binning_key=str(rng.choice(["rank", "depth"])),
            background=tuple(rng.uniform(0, 1, 3)))
        recipe = (f"case {case}: kind={kind} n={scene.num_gaussians} "
                  f"h={h} w={w} cfg={config}"
                  + (f" n_g={n_g} route={route} cap={cap}"
                     if args.sharded else ""))
        try:
            if args.sharded:
                mesh = make_mesh(n_data=1, n_gaussian=n_g,
                                 devices=jax.devices()[:n_g])
                sc = scene.pad_to(
                    -(-scene.num_gaussians // n_g) * n_g) \
                    if scene.num_gaussians % n_g else scene
                img, overflow = render_sharded_tiled(
                    sc, cam, mesh, config, route=route,
                    slab_cap_factor=cap or None)
                img = np.asarray(img)
                overflow = int(overflow)
            else:
                img, stats = render_tiled(scene.pack_device(), cam, config,
                                          return_stats=True)
                img = np.asarray(img)
                overflow = int(stats["overflow"])
            gold = render_oracle(scene, cam, config)
            if overflow > 0:
                print(f"SKIP (overflow {overflow}) {recipe}")
                continue
            p = psnr(img, gold)
            ok = p >= args.min_psnr and np.isfinite(img).all()
            tag = "ok  " if ok else "FAIL"
            print(f"{tag} psnr={p:6.2f} {recipe}")
            if not ok:
                failures += 1
        except Exception as e:  # noqa: BLE001 — fuzzer: report and go on
            print(f"CRASH {type(e).__name__}: {e}\n  {recipe}")
            failures += 1
    print(f"\n{failures} failures / {args.cases} cases")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
