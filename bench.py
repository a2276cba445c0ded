"""Benchmark harness.  Prints ONE JSON line:
{"metric": ..., "value": N, "unit": ..., "vs_baseline": N, "scenes": {...}}

Headline metric: 1080p frames/sec on a 1M-gaussian random scene (the
reference publishes no numbers — BASELINE.md; the north-star target is 30
FPS at 1080p on one chip, so vs_baseline = fps / 30).  The "scenes" field
additionally records the trained-like surface scene — the distribution
BASELINE.md ladder 4 actually names (silhouette tiles with concentrated
pair loads), tracked round-over-round since round 3.

Timing + overflow audit live in splat_tpu/utils/benchmark.py (shared with
`python -m splat_tpu bench`).  Extra detail, including the device (JAX
platform, kind and count, card name and power limit), goes to stderr so
the one-line stdout contract holds.  Runs on the GPU only: on any other
platform it fails before printing a result.
"""

from __future__ import annotations

import json
import os
import sys


def run_scene(kind: str, n: int, h: int, w: int, frames: int,
              dup: float) -> dict:
    import splat_tpu as st
    from splat_tpu.config import RenderConfig
    from splat_tpu.utils.benchmark import chained_bench

    # Tuned per-scene capacity: every K-sized binning op scales with
    # k_cap, and the audit PROVES no frame of the sweep overflowed (the
    # score is zeroed otherwise, so a too-tight setting can never fake a
    # speedup).  At 16-px tiles: random ~3.46 pairs/gaussian; surface
    # ~1.70 (opaque surface splats are small on screen).
    config = RenderConfig(max_dup_factor=dup)
    if kind == "surface":
        scene = st.surface_scene(n, seed=0).pack_device()
    else:
        scene = st.random_scene(n, seed=0, extent=3.0,
                                scale_range=(0.004, 0.03)).pack_device()
    camera = st.Camera.create(h=h, w=w, position=(0.0, 0.0, 4.0))
    r = chained_bench(scene, camera, config, frames)
    print(f"[bench] {kind}: {n} gaussians @ {w}x{h}: "
          f"{r['ms_per_frame']:.2f} ms/frame ({r['fps']:.2f} FPS, "
          f"device-chained x{frames}, compile {r['compile_s']:.0f}s); "
          f"mean pixel {r['mean_pixel']:.4f}; visible={r['visible']} "
          f"pairs={r['num_pairs']} overflow={r['overflow']}",
          file=sys.stderr)
    if r["overflow"] > 0:
        print(f"[bench] WARNING: {kind}: duplication-buffer overflow "
              f"({r['overflow']} pairs dropped) — FPS measures a truncated "
              f"render; raise max_dup_factor", file=sys.stderr)
    return {
        "fps": round(r["fps"], 3) if r["overflow"] == 0 else 0.0,
        "ms_per_frame": round(r["ms_per_frame"], 2),
        "overflow": r["overflow"],
        "num_pairs": r["num_pairs"],
        "visible": r["visible"],
    }


def main() -> None:
    from splat_tpu.utils.benchmark import require_gpu
    from splat_tpu.utils.compilecache import enable_persistent_cache

    device = require_gpu()
    print(f"[bench] device: {device['platform']} {device['kind']} "
          f"x{device['count']}; {device['nvidia_smi']}", file=sys.stderr)
    enable_persistent_cache()
    n = int(os.environ.get("SPLAT_BENCH_N", 1_000_000))
    h = int(os.environ.get("SPLAT_BENCH_H", 1080))
    w = int(os.environ.get("SPLAT_BENCH_W", 1920))
    # 60 device-chained frames: long enough that per-call dispatch and
    # scan setup amortize to the sustained throughput.
    frames = int(os.environ.get("SPLAT_BENCH_FRAMES", 60))
    dup = float(os.environ.get("SPLAT_BENCH_DUP", 3.7))
    # the audit zeroes the score if any frame of the sweep overflows
    dup_surface = float(os.environ.get("SPLAT_BENCH_DUP_SURFACE", 2.0))

    # SPLAT_BENCH_SCENE picks the headline scene and skips the other;
    # unset, both run (random is the headline, surface is recorded).
    # Unknown values must not skip BOTH (a later KeyError would break the
    # one-JSON-line stdout contract) — warn and run both.
    only = os.environ.get("SPLAT_BENCH_SCENE")
    if only not in (None, "", "random", "surface"):
        print(f"unknown SPLAT_BENCH_SCENE={only!r}; running both scenes",
              file=sys.stderr)
        only = None
    scenes = {}
    try:
        if only in (None, "", "random"):
            scenes["random"] = run_scene("random", n, h, w, frames, dup)
        if only in (None, "", "surface"):
            scenes["surface"] = run_scene("surface", n, h, w, frames,
                                          dup_surface)
    except Exception as e:  # pragma: no cover — report failure explicitly
        print(f"bench failed: {type(e).__name__}: {e}", file=sys.stderr)
        print(json.dumps({"metric": f"{h}p_fps_{n}_gaussians",
                          "value": 0.0, "unit": "frames/sec",
                          "vs_baseline": 0.0}))
        return

    head = scenes.get("random") or scenes["surface"]
    print(json.dumps({
        "metric": f"{h}p_fps_{n}_gaussians",
        "value": head["fps"],
        "unit": "frames/sec",
        # north star: 30 FPS at 1080p on one chip (BASELINE.md)
        "vs_baseline": round(head["fps"] / 30.0, 3),
        "overflow": head["overflow"],
        "num_pairs": head["num_pairs"],
        "visible": head["visible"],
        "scenes": scenes,
        "device": {k: device[k] for k in ("platform", "kind", "count")},
    }))


if __name__ == "__main__":
    main()
