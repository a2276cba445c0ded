"""Produce the committed fitted-scene golden artifact.

The reference's de-facto golden artifact is a pretrained scene rendered
from a pinned camera (notes/point_cloud.ply at 800x600 —
/root/reference/src/main.rs:19, README.md:6, notes/screenshot.png).
That model is gitignored upstream and this environment has no network,
so the closest honest substitute is a scene OUR OWN optimizer fitted:

1. truth = surface_scene(20k) (trained-scene-like statistics);
2. targets = NumPy-ORACLE renders (the suite's golden-image source) from
   four poses;
3. init = truth heavily perturbed (positions jittered, SH dimmed,
   opacities shifted) — fit() must genuinely recover structure;
4. optimize with the production tiled custom-VJP path and the full 3DGS
   loss recipe (L2 + L1 + D-SSIM);
5. save via save_ply -> tests/data/fitted_20k.ply, plus a JSON sidecar
   recording the achieved reconstruction PSNR that the golden test
   gates against.

Deterministic given seeds; re-running regenerates an equivalent (not
bit-identical across backends) artifact.  Run on the GPU for speed:

    python scripts/make_fitted_scene.py [--steps 300]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

SEED = 0
N = 20_000
H, W = 300, 400
POSES = 4


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--lr", type=float, default=5e-3)
    ap.add_argument("--out", default=os.path.join(
        os.path.dirname(__file__), "..", "tests", "data",
        "fitted_20k.ply"))
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend (slow; for regeneration "
                         "without a GPU)")
    args = ap.parse_args()

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from splat_tpu.utils.compilecache import enable_persistent_cache
    enable_persistent_cache()

    import jax.numpy as jnp
    import numpy as np

    import splat_tpu as st
    from splat_tpu.camera import orbit_trajectory
    from splat_tpu.config import RenderConfig
    from splat_tpu.render.oracle import render_oracle
    from splat_tpu.train import fit
    from splat_tpu.utils.image import psnr

    truth = jax.tree.map(jnp.asarray, st.surface_scene(N, seed=SEED))
    cams = orbit_trajectory(
        st.Camera.create(h=H, w=W, position=(0.0, -1.0, 3.5)),
        num_frames=POSES, yaw_sweep=0.8, pitch_sweep=0.2)
    cfg = RenderConfig(max_dup_factor=3.0)

    print(f"rendering {POSES} oracle targets at {W}x{H}...", flush=True)
    t0 = time.time()
    cam_list = [jax.tree.map(lambda a: a[i], cams) for i in range(POSES)]
    targets = jnp.stack([
        jnp.asarray(render_oracle(truth, c, cfg)) for c in cam_list])
    print(f"targets in {time.time() - t0:.0f}s", flush=True)

    rng = np.random.default_rng(SEED + 1)
    start = dataclasses.replace(
        truth,
        means=truth.means + jnp.asarray(
            rng.normal(0.0, 0.02, (N, 3)).astype(np.float32)),
        sh=truth.sh * 0.6,
        opacities=jnp.clip(truth.opacities * 0.8, 0.01, 0.99),
    )

    def recon_psnr(scene):
        return float(np.mean([
            psnr(np.asarray(st.render(scene, c, cfg, method="tiled",
                                      check_overflow=False)),
                 np.asarray(t))
            for c, t in zip(cam_list, list(targets))]))

    print(f"fitting {N} splats, {args.steps} steps (tiled VJP, "
          f"L2+L1+D-SSIM)...", flush=True)
    t0 = time.time()
    res = fit(start, cams, targets, steps=args.steps, lr=args.lr,
              config=cfg, method="tiled", l1_weight=0.2,
              dssim_weight=0.2)
    print(f"fit in {time.time() - t0:.0f}s: loss {float(res.losses[0]):.5f}"
          f" -> {float(res.losses[-1]):.5f}", flush=True)

    p_start = recon_psnr(start)
    p_fit = recon_psnr(res.scene)
    print(f"recon PSNR vs oracle targets: start {p_start:.2f} dB -> "
          f"fitted {p_fit:.2f} dB", flush=True)

    scene_np = jax.tree.map(np.asarray, res.scene)
    st.save_ply(args.out, scene_np)
    side = {
        "n": N, "h": H, "w": W, "poses": POSES, "seed": SEED,
        "steps": args.steps,
        "psnr_start": round(p_start, 2), "psnr_fitted": round(p_fit, 2),
        "loss_first": float(res.losses[0]),
        "loss_last": float(res.losses[-1]),
    }
    with open(args.out.replace(".ply", ".json"), "w") as f:
        json.dump(side, f, indent=1)
    print(f"wrote {args.out} (+ sidecar)", flush=True)


if __name__ == "__main__":
    main()
