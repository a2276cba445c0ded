"""Decompose the cold-start time of the first render into its parts:

  transfer   host->device scene transfer (~236 MB at 1M gaussians)
  lower      jax tracing + StableHLO lowering (host-side, pure Python)
  compile    backend compilation proper (XLA + the Triton kernels)
  execute    first post-compile execution

bench.py's 'compile' stamp is trace+compile+transfer+first-exec fused —
this separates them so the ledger can say what a first-frame user
actually pays and which part is attackable.

Runs on the GPU (fails elsewhere).

Usage: python scripts/compileprobe.py [--n 1000000] [--cold]
  --cold  leave the persistent compile cache off for this run
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--h", type=int, default=1080)
    ap.add_argument("--w", type=int, default=1920)
    ap.add_argument("--dup", type=float, default=2.2)
    ap.add_argument("--cold", action="store_true")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import splat_tpu as st
    from splat_tpu.config import RenderConfig
    from splat_tpu.render.tiled import render_tiled
    from splat_tpu.utils.benchmark import require_gpu
    from splat_tpu.utils.compilecache import enable_persistent_cache

    require_gpu()
    if not args.cold:
        enable_persistent_cache()

    t0 = time.time()
    scene = st.surface_scene(args.n, seed=0)
    t_build = time.time() - t0

    t0 = time.time()
    dscene = scene.pack_device()
    dscene = jax.block_until_ready(jax.tree.map(jnp.asarray, dscene))
    t_transfer = time.time() - t0

    cam = st.Camera.create(h=args.h, w=args.w, position=(0.0, 0.0, 4.0))
    config = RenderConfig(max_dup_factor=args.dup)

    def frame(s, c):
        return jnp.mean(render_tiled(s, c, config))

    f = jax.jit(frame)
    t0 = time.time()
    lowered = f.lower(dscene, cam)
    t_lower = time.time() - t0

    t0 = time.time()
    compiled = lowered.compile()
    t_compile = time.time() - t0

    t0 = time.time()
    jax.block_until_ready(compiled(dscene, cam))
    t_exec1 = time.time() - t0

    t0 = time.time()
    jax.block_until_ready(compiled(dscene, cam))
    t_exec2 = time.time() - t0

    print(f"n={args.n} {args.w}x{args.h} dup={args.dup} "
          f"cold={args.cold} backend={jax.default_backend()} | "
          f"build={t_build:.1f}s transfer={t_transfer:.1f}s "
          f"lower={t_lower:.1f}s compile={t_compile:.1f}s "
          f"exec1={t_exec1:.1f}s exec2={t_exec2:.2f}s")


if __name__ == "__main__":
    main()
