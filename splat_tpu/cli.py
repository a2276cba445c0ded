"""Command-line interface.

Covers the reference's binaries (SURVEY §2.1):
  render  — single frame from a pose          (02_ply_demo.rs / 01_naive...)
  orbit   — camera trajectory -> PNG frames   (the interactive viewer's
            yaw/pitch loop, src/main.rs:42-80, minus the OS window)
  trim    — cut a PLY down to a tiny fixture  (00_ply_load.rs)
  info    — scene statistics
  bench   — timing on a scene or synthetic load
  fit     — optimize a scene against target images (beyond reference:
            distillation/compression of an existing model, or fitting a
            PNG + camera-JSON dataset, through the tiled custom VJP)
Every magic number of the reference is a flag with its default.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time


def _add_render_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--size", default="800x600",
                   help="WxH (reference viewer default 800x600, "
                        "src/main.rs:9-10)")
    p.add_argument("--pos", default="0,0,5",
                   help="camera position (reference src/main.rs:13)")
    p.add_argument("--target", default="0,0,0")
    p.add_argument("--yaw", type=float, default=0.0)
    p.add_argument("--pitch", type=float, default=0.0)
    p.add_argument("--fovy-deg", type=float, default=90.0)
    p.add_argument("--sh-degree", type=int, default=3)
    p.add_argument("--lowpass", type=float, default=0.3)
    p.add_argument("--tile", type=int, default=32,
                   help="tile width in pixels (and height unless --tile-y)")
    p.add_argument("--tile-y", type=int, default=0,
                   help="tile height in pixels (0 = square tiles)")
    p.add_argument("--dup-factor", default="auto",
                   help="duplication-buffer capacity as a multiple of N. "
                        "Default 'auto': measure the scene's pair load at "
                        "the given pose (one cheap jit) and add 25%% "
                        "headroom — every K-sized binning op scales with "
                        "capacity, so this is ~2x the throughput of the "
                        "conservative fixed default on typical scenes. "
                        "Fractional explicit values are fine; raise on "
                        "overflow warnings (overflow is always detected, "
                        "never silent)")
    p.add_argument("--background", default="0,0,0")
    p.add_argument("--alpha", action="store_true",
                   help="output RGBA: the alpha channel is the accumulated "
                        "per-pixel coverage 1 - T (PNGs are written as "
                        "color-type-6 RGBA)")
    p.add_argument("--render-mode", choices=["color", "depth"],
                   default="color",
                   help="what the composited channels carry: 'color' "
                        "(SH RGB) or 'depth' (alpha-weighted expected "
                        "view depth as a grayscale map; pair with "
                        "--alpha to recover mean depth)")
    p.add_argument("--depth-range", default=None, metavar="NEAR,FAR",
                   help="view-depth range mapped to [0,1] in depth mode "
                        "(default: each frame's visible min/max — pin an "
                        "explicit range for stable orbits)")
    p.add_argument("--supersample", type=int, default=1, metavar="K",
                   help="anti-aliasing: render at KxK the resolution and "
                        "box-filter down (the notebook prototype's "
                        "supersampled target); cost scales ~K^2")
    p.add_argument("--sigma-cutoff", default="3.0",
                   help="bbox radius in standard deviations (reference: "
                        "3-sigma quads); 'inf' = truncation-free mode "
                        "(requires tight radii; the raster kernel "
                        "statically drops its bbox compares)")
    p.add_argument("--binning-key", choices=["rank", "depth"],
                   default=None,
                   help="pair sort-key low bits (default: the "
                        "RenderConfig default): 'depth' skips the N-side "
                        "depth argsort/gather (quantized-depth keys, "
                        "index payload); 'rank' keeps exact depth-rank "
                        "tie-breaking")
    p.add_argument("--method", choices=["auto", "dense", "tiled"],
                   default="auto")
    p.add_argument("--profile", metavar="LOGDIR", default=None,
                   help="capture a TensorBoard device profile of the render")
    p.add_argument("--no-center", action="store_true",
                   help="skip mean-centering positions at load")
    p.add_argument("--naive", action="store_true",
                   help="use the built-in 4-gaussian fixture instead of a "
                        "PLY (reference 01_naive_gaussian.rs)")


def _parse_vec(s: str, n: int) -> tuple[float, ...]:
    v = tuple(float(x) for x in s.split(","))
    if len(v) != n:
        raise SystemExit(f"expected {n} comma-separated floats, got {s!r}")
    return v


def _load(args):
    import splat_tpu as st

    if args.naive:
        return st.naive_gaussians()
    if not args.scene:
        raise SystemExit("a scene .ply is required (or pass --naive)")
    from splat_tpu.io.cache import load_scene_cached
    return load_scene_cached(args.scene, center=not args.no_center)


def _camera(args):
    import numpy as np
    import splat_tpu as st

    w, h = (int(x) for x in args.size.split("x"))
    return st.Camera.create(
        h=h, w=w, position=_parse_vec(args.pos, 3),
        target=_parse_vec(args.target, 3), yaw=args.yaw, pitch=args.pitch,
        fovy=float(np.deg2rad(args.fovy_deg)))


def _load_camera_path(path: str, size: str, fovy_deg: float,
                      interp: int = 1):
    """Camera list from the JSON spec shared by `fit` and `orbit --path`:

      {"h": 300, "w": 400, "fovy_deg": 90.0, "views": [
         {"position": [x,y,z], "target": [0,0,0],
          "yaw": 0.0, "pitch": 0.0}, ...]}

    or, for arbitrary SE(3) poses (COLMAP-style datasets the orbit
    parameterization cannot express — real 3DGS captures), views of
    either form

      {"view_matrix": [[...4 rows of 4...]], "fx": F, "fy": F,
       "cx": C, "cy": C}                       # engine look_at frame
      {"qvec": [w,x,y,z], "tvec": [x,y,z], "fx": ..., ...}  # COLMAP w2c

    (fx/fy/cx/cy may also be given once at the top level; they default
    to the fovy-derived focal and the image center).  Orbit and SE(3)
    views cannot be mixed in one file.

    Returns (cam_list, h, w).  interp > 1 linearly interpolates that many
    frames between consecutive waypoints (position/target/yaw/pitch),
    turning a handful of keyframes into a smooth flythrough — the export
    counterpart of the reference viewer's freeform navigation
    (src/main.rs:42-80).  Orbit views only: there is no canonical linear
    interpolation on SE(3) poses."""
    import numpy as np

    import splat_tpu as st

    with open(path) as f:
        spec = json.load(f)
    w, h = (int(x) for x in size.split("x"))
    h, w = int(spec.get("h", h)), int(spec.get("w", w))
    fovy = float(np.deg2rad(spec.get("fovy_deg", fovy_deg)))
    vs = spec["views"]
    if not vs:
        raise SystemExit(f"{path}: empty views list")
    se3 = [("view_matrix" in v) or ("qvec" in v) for v in vs]
    if any(se3):
        if not all(se3):
            raise SystemExit(f"{path}: cannot mix orbit views and "
                             f"view_matrix/qvec views in one file")
        if interp > 1:
            raise SystemExit("--interp needs orbit views (no canonical "
                             "lerp on SE(3) poses)")
        focal_default = h / (2.0 * np.tan(fovy / 2))

        def intr(v):
            fx = float(v.get("fx", spec.get("fx", focal_default)))
            fy = float(v.get("fy", spec.get("fy", fx)))
            cx = float(v.get("cx", spec.get("cx", w / 2)))
            cy = float(v.get("cy", spec.get("cy", h / 2)))
            return fx, fy, cx, cy

        cams = []
        for v in vs:
            fx, fy, cx, cy = intr(v)
            if "view_matrix" in v:
                m = np.asarray(v["view_matrix"], np.float32)
                if m.shape != (4, 4):
                    raise SystemExit(f"{path}: view_matrix must be 4x4, "
                                     f"got {m.shape}")
                cams.append(st.SE3Camera.create(h=h, w=w, view=m, fx=fx,
                                                fy=fy, cx=cx, cy=cy))
            else:
                cams.append(st.SE3Camera.from_colmap(
                    v["qvec"], v["tvec"], fx, fy, cx, cy, h, w))
        return cams, h, w
    pos = np.asarray([v["position"] for v in vs], np.float32)
    tgt = np.asarray([v.get("target", (0.0, 0.0, 0.0)) for v in vs],
                     np.float32)
    yaw = np.asarray([v.get("yaw", 0.0) for v in vs], np.float32)
    pitch = np.asarray([v.get("pitch", 0.0) for v in vs], np.float32)
    if interp > 1 and len(vs) > 1:
        t = np.arange(len(vs), dtype=np.float32)
        tq = np.linspace(0.0, len(vs) - 1.0,
                         (len(vs) - 1) * interp + 1).astype(np.float32)

        def lerp(a):
            if a.ndim == 2:
                return np.stack([np.interp(tq, t, a[:, i])
                                 for i in range(a.shape[1])],
                                axis=-1).astype(np.float32)
            return np.interp(tq, t, a).astype(np.float32)

        pos, tgt, yaw, pitch = lerp(pos), lerp(tgt), lerp(yaw), lerp(pitch)
    cams = [st.Camera.create(h=h, w=w, position=tuple(p), target=tuple(g),
                             yaw=float(y), pitch=float(q), fovy=fovy)
            for p, g, y, q in zip(pos, tgt, yaw, pitch)]
    return cams, h, w


def _config(args, scene=None, cam=None):
    from splat_tpu.config import RenderConfig

    sigma = float(getattr(args, "sigma_cutoff", "3.0"))  # 'inf' parses
    bkey = (getattr(args, "binning_key", None)
            or RenderConfig.binning_key)
    mode = getattr(args, "render_mode", "color")
    drange = getattr(args, "depth_range", None)
    drange = _parse_vec(drange, 2) if drange else None
    dup = getattr(args, "dup_factor", "auto")
    if dup == "auto":
        if scene is None or cam is None:
            raise SystemExit("--dup-factor auto needs a scene and pose")
        from splat_tpu.render.api import pair_stats, resolve_method
        if resolve_method(getattr(args, "method", "auto"), scene) == "dense":
            return RenderConfig(  # dense path has no duplication buffer
                sh_degree=args.sh_degree, lowpass=args.lowpass,
                tile_px=args.tile, tile_py=args.tile_y,
                sigma_cutoff=sigma, binning_key=bkey,
                alpha_channel=getattr(args, "alpha", False),
                supersample=getattr(args, "supersample", 1),
                render_mode=mode, depth_range=drange,
                background=_parse_vec(args.background, 3))
        base = RenderConfig(sh_degree=args.sh_degree, lowpass=args.lowpass,
                            tile_px=args.tile, tile_py=args.tile_y,
                            sigma_cutoff=sigma, binning_key=bkey,
                            supersample=getattr(args, "supersample", 1),
                            background=_parse_vec(args.background, 3))
        stats = pair_stats(scene, cam, base)
        dup = stats["suggested_dup_factor"]
        print(f"auto dup-factor: {stats['num_pairs']} pairs "
              f"({stats['pairs_per_gaussian']:.2f}/gaussian) -> "
              f"max_dup_factor={dup}")
    return RenderConfig(sh_degree=args.sh_degree, lowpass=args.lowpass,
                        tile_px=args.tile, tile_py=args.tile_y,
                        max_dup_factor=float(dup), sigma_cutoff=sigma,
                        alpha_channel=getattr(args, "alpha", False),
                        binning_key=bkey,
                        supersample=getattr(args, "supersample", 1),
                        render_mode=mode, depth_range=drange,
                        background=_parse_vec(args.background, 3))


def cmd_render(args) -> int:
    import numpy as np

    from splat_tpu.render.api import render
    from splat_tpu.utils.image import write_png

    scene = _load(args)
    cam = _camera(args)
    config = _config(args, scene, cam)
    scene = scene.pack_device()   # feature-major hot-path layout
    t0 = time.time()
    if args.profile:
        from splat_tpu.utils.diagnostics import profile_trace
        import contextlib
        ctx = profile_trace(args.profile)
    else:
        import contextlib
        ctx = contextlib.nullcontext()
    with ctx:
        img = np.asarray(render(scene, cam, config, method=args.method))
    # The reference prints per-frame timing (src/main.rs:77).
    print(f"Rendering took {(time.time() - t0) * 1e3:.1f} ms "
          f"(N={scene.num_gaussians}, {cam.w}x{cam.h}, incl. compile)")
    if getattr(args, "stats", False):
        from splat_tpu.render.api import resolve_method
        if resolve_method(args.method, scene) == "tiled":
            from splat_tpu.utils.diagnostics import frame_report
            print(json.dumps(frame_report(scene, cam, config)),
                  file=sys.stderr)
        else:
            print("--stats: dense path has no binning stats",
                  file=sys.stderr)
    write_png(args.out, img)
    print(f"wrote {args.out}")
    return 0


def cmd_orbit(args) -> int:
    import jax
    import numpy as np

    from splat_tpu.camera import orbit_trajectory
    from splat_tpu.render.api import render_fn
    from splat_tpu.utils.image import write_png

    from splat_tpu.render.api import resolve_method

    scene = _load(args)
    cam_path = None
    if args.path:
        cam_path, _, _ = _load_camera_path(args.path, args.size,
                                           args.fovy_deg,
                                           interp=args.interp)
        cam = cam_path[0]
        n_frames = len(cam_path)
    else:
        cam = _camera(args)
        n_frames = args.frames
    os.makedirs(args.out_dir, exist_ok=True)
    config = _config(args, scene, cam)
    scene = scene.pack_device()   # feature-major hot-path layout
    method = resolve_method(args.method, scene)
    if method == "tiled":
        # Track duplication-buffer overflow across the trajectory so a
        # truncated render never goes unreported (config.py contract).
        from splat_tpu.render.tiled import render_tiled
        f_stats = jax.jit(
            lambda s, c: render_tiled(s, c, config, return_stats=True))
        f = None
    else:
        f = render_fn(method, config)
        f_stats = None
    overflows = []
    gif_frames = [] if args.gif else None
    if cam_path is None:
        cams = orbit_trajectory(
            cam, n_frames,
            yaw_sweep=float(np.deg2rad(args.yaw_sweep)),
            pitch_sweep=float(np.deg2rad(args.pitch_sweep)))
    t0 = time.time()
    for i in range(n_frames):
        if cam_path is not None:
            c = cam_path[i]
        else:
            c = jax.tree.map(lambda a: a[i], cams,
                             is_leaf=lambda a: hasattr(a, "shape"))
        if f_stats is not None:
            img, stats = f_stats(scene, c)
            # keep the scalar on device; one fetch after the loop instead
            # of a host round-trip per frame
            overflows.append(stats["overflow"])
        else:
            img = f(scene, c)
        img = np.asarray(img)
        write_png(os.path.join(args.out_dir, f"frame_{i:04d}.png"), img,
                  level=args.png_level)
        if gif_frames is not None:
            gif_frames.append(img)
        if i == 0:
            t0 = time.time()  # exclude compile from FPS
    steady = n_frames - 1
    if steady > 0:
        dt = (time.time() - t0) / steady
        print(f"{steady} frames: {dt * 1e3:.1f} ms/frame "
              f"({1.0 / dt:.1f} FPS incl. host I/O)")
    if overflows:
        import jax.numpy as jnp
        overflow_max = int(jnp.max(jnp.stack(overflows)))
        if overflow_max > 0:
            print(f"WARNING: duplication-buffer overflow ({overflow_max} "
                  f"pairs dropped in the worst frame) — frames are "
                  f"truncated; raise --dup-factor", file=sys.stderr)
    if gif_frames is not None:
        from splat_tpu.utils.gif import write_gif
        write_gif(args.gif, gif_frames, fps=args.gif_fps)
        print(f"wrote {args.gif}")
    print(f"wrote {n_frames} frames to {args.out_dir}/")
    return 0


def cmd_trim(args) -> int:
    from splat_tpu.io.ply import trim_ply

    n = trim_ply(args.scene, args.out, count=args.count)
    print(f"wrote {n} splats to {args.out}")
    return 0


def _sh_nonzero_bands(sh) -> int:
    """Highest SH band with any nonzero rest coefficient.

    Rest slots 0-2 are band 1, 3-7 band 2, 8-14 band 3 (coefficient-major
    (N, 16, 3) layout; slot 0 of the 16 is the DC term, not a rest slot).
    """
    import numpy as np

    rest_nonzero = (sh[:, 1:, :] != 0).any(axis=(0, 2))      # (15,)
    if not rest_nonzero.any():
        return 0
    k = int(np.flatnonzero(rest_nonzero)[-1])
    return 1 if k < 3 else 2 if k < 8 else 3


def cmd_info(args) -> int:
    import numpy as np

    scene = _load(args)
    d = scene.to_numpy()
    if scene.num_gaussians == 0:   # reductions below have no identity
        stats = {"num_gaussians": 0,
                 "memory_mb": round(sum(a.nbytes
                                        for a in d.values()) / 2 ** 20, 1)}
        print(json.dumps(stats, indent=2))
        return 0
    stats = {
        "num_gaussians": int(scene.num_gaussians),
        "extent": {
            "min": d["means"].min(0).tolist(),
            "max": d["means"].max(0).tolist(),
        },
        "scales": {"mean": float(d["scales"].mean()),
                   "p50": float(np.median(d["scales"])),
                   "max": float(d["scales"].max())},
        "opacity": {"mean": float(d["opacities"].mean()),
                    "p50": float(np.median(d["opacities"]))},
        "sh_nonzero_bands": _sh_nonzero_bands(d["sh"]),
        "memory_mb": round(sum(a.nbytes for a in d.values()) / 2 ** 20, 1),
    }
    print(json.dumps(stats, indent=2))
    return 0


def cmd_bench(args) -> int:
    from splat_tpu.utils.benchmark import chained_bench

    if args.naive or args.scene:
        scene = _load(args)
    else:
        import splat_tpu as st
        scene = st.random_scene(args.n, seed=0)
        print(f"synthetic scene: N={args.n}")
    cam = _camera(args)
    config = _config(args, scene, cam)
    r = chained_bench(scene.pack_device(), cam, config, args.frames)
    d = r["device"]
    print(f"device: {d['platform']} {d['kind']} x{d['count']}; "
          f"{d['nvidia_smi']}")
    print(f"compile: {r['compile_s']:.1f}s")
    print(f"{args.frames} frames (device-chained, yaw sweep): "
          f"{r['ms_per_frame']:.2f} ms/frame ({r['fps']:.1f} FPS)")
    per = r["num_pairs"] / max(scene.num_gaussians, 1)
    print(f"pairs={r['num_pairs']} visible={r['visible']} "
          f"overflow={r['overflow']} pairs/gaussian={per:.2f} "
          f"(suggested --dup-factor {max(1.25, round(per * 1.25, 2))})")
    if r["overflow"] > 0:
        print("WARNING: overflow > 0 — the timing above measures a "
              "truncated render; raise --dup-factor", file=sys.stderr)
    return 0


def cmd_fit(args) -> int:
    """Optimize a scene against target images (training as a CLI citizen).

    Two target sources:
      --distill REF.ply : render the targets from an existing model over
        an orbit (scene compression / distillation — fit a smaller model
        to reproduce a big one);
      --targets DIR --cameras FILE.json : fit to a directory of PNG
        images with poses from a JSON camera spec:
        {"h": 300, "w": 400, "fovy_deg": 90.0, "views": [
           {"position": [x,y,z], "target": [0,0,0],
            "yaw": 0.0, "pitch": 0.0}, ...]}
        (views pair with the directory's *.png sorted by name).

    The reference has no training at all; this wraps train.fit (adam,
    L2+L1+D-SSIM, tiled custom-VJP path, optional densification) the way
    `render` wraps the forward path.
    """
    import dataclasses

    import numpy as np

    import jax
    import jax.numpy as jnp
    import splat_tpu as st
    from splat_tpu.camera import Camera, orbit_trajectory
    from splat_tpu.config import RenderConfig
    from splat_tpu.io.cache import load_scene_cached
    from splat_tpu.train import fit
    from splat_tpu.utils.image import psnr, read_png

    w, h = (int(x) for x in args.size.split("x"))
    fovy = float(np.deg2rad(args.fovy_deg))
    cfg = RenderConfig(max_dup_factor=float(args.dup_factor),
                       sh_degree=args.sh_degree)

    # ---- targets + cameras ------------------------------------------------
    ref = None
    if args.distill:
        # center=False: the fitted scene must live in REF's coordinates
        ref = load_scene_cached(args.distill, center=False)
        # pack once when the tiled path will render the targets:
        # render() would otherwise re-pack the big REF per view (the
        # dense path takes the GaussianScene as-is)
        from splat_tpu.render.api import resolve_method
        ref_render = (ref.pack_device()
                      if resolve_method(args.method, ref) == "tiled"
                      else ref)
        base = Camera.create(h=h, w=w, position=_parse_vec(args.pos, 3),
                             target=_parse_vec(args.target, 3), fovy=fovy)
        cams = orbit_trajectory(base, num_frames=args.views,
                                yaw_sweep=float(np.deg2rad(args.yaw_sweep)),
                                pitch_sweep=float(
                                    np.deg2rad(args.pitch_sweep)))
        cam_list = [jax.tree.map(lambda a, i=i: a[i], cams)
                    for i in range(args.views)]
        print(f"rendering {args.views} target views from "
              f"{args.distill} at {w}x{h}...")
        targets = jnp.stack([
            jnp.asarray(st.render(ref_render, c, method=args.method))
            for c in cam_list])
    elif args.targets:
        if not args.cameras:
            raise SystemExit("--targets needs --cameras FILE.json")
        cl, h, w = _load_camera_path(args.cameras, args.size,
                                     args.fovy_deg)
        files = sorted(
            os.path.join(args.targets, n) for n in os.listdir(args.targets)
            if n.lower().endswith(".png"))
        if len(files) != len(cl):
            raise SystemExit(f"{len(files)} PNGs in {args.targets} but "
                             f"{len(cl)} views in {args.cameras}")
        imgs = []
        for p in files:
            img = read_png(p)[:, :, :3].astype(np.float32) / 255.0
            if img.shape[:2] != (h, w):
                raise SystemExit(f"{p} is {img.shape[1]}x{img.shape[0]}, "
                                 f"cameras say {w}x{h}")
            imgs.append(img)
        targets = jnp.asarray(np.stack(imgs))
        from splat_tpu.camera import stack_cameras
        cams = stack_cameras(cl)
        cam_list = cl
    else:
        raise SystemExit("pass --distill REF.ply or --targets DIR")

    # ---- initialization ---------------------------------------------------
    if args.init:
        start = load_scene_cached(args.init, center=False)
    else:
        start = st.random_scene(args.init_n, seed=args.seed, extent=1.0)
        if ref is not None:  # place the random ball over REF's extent
            means = np.asarray(ref.means)
            center = means.mean(axis=0)
            extent = float(np.percentile(
                np.linalg.norm(means - center, axis=1), 95))
            start = dataclasses.replace(
                start,
                means=start.means * extent + center[None, :],
                scales=start.scales * extent)
        start = jax.tree.map(jnp.asarray, start)

    # ---- optimize ---------------------------------------------------------
    n0 = start.num_gaussians
    print(f"fitting {n0} splats to {targets.shape[0]} views "
          f"({w}x{h}), {args.steps} steps, method={args.fit_method}, "
          f"l1={args.l1}, dssim={args.dssim}"
          + (f", densify every {args.densify_every}"
             if args.densify_every else ""))
    t0 = time.time()
    res = fit(start, cams, targets, steps=args.steps, lr=args.lr,
              config=cfg, method=args.fit_method, l1_weight=args.l1,
              dssim_weight=args.dssim,
              lr_decay=({"means": args.means_lr_decay}
                        if args.means_lr_decay != 1.0 else None),
              densify_every=args.densify_every,
              opacity_reset_every=args.opacity_reset_every,
              sh_warmup_every=args.sh_warmup_every,
              progress_cb=lambda s, l, n: print(
                  f"  step {s}/{args.steps}: loss {l:.5f} "
                  f"({n} gaussians)", flush=True))
    dt = time.time() - t0
    print(f"fit in {dt:.0f}s: loss {float(res.losses[0]):.5f} -> "
          f"{float(res.losses[-1]):.5f} "
          f"({float(res.losses[0]) / max(float(res.losses[-1]), 1e-12):.1f}x)")
    for rnd in res.densify_log:
        print(f"  densify: {rnd}")

    scene_np = jax.tree.map(np.asarray, res.scene)
    ps = [float(psnr(np.asarray(st.render(res.scene, c, method=args.method,
                                          check_overflow=False)),
                     np.asarray(t)))
          for c, t in zip(cam_list, list(targets))]
    print(f"reconstruction PSNR vs targets: mean {np.mean(ps):.2f} dB "
          f"(per view: {', '.join(f'{p:.1f}' for p in ps)})")
    st.save_ply(args.out, scene_np)
    print(f"wrote {args.out} ({scene_np.num_gaussians} gaussians)")
    return 0


def cmd_psnr(args) -> int:
    """Compare two PNGs (e.g. a render against a golden image): prints a
    JSON line with psnr/mse/max-abs — the suite's parity metric as a
    shell tool."""
    import numpy as np

    from splat_tpu.utils.image import psnr, read_png

    a = read_png(args.a).astype(np.float32) / 255.0
    b = read_png(args.b).astype(np.float32) / 255.0
    if a.shape[-1] != b.shape[-1]:  # RGB vs RGBA: compare color planes
        a, b = a[..., :3], b[..., :3]
    if a.shape != b.shape:
        raise SystemExit(f"shape mismatch: {args.a} {a.shape} vs "
                         f"{args.b} {b.shape}")
    diff = np.abs(a - b)
    p = float(psnr(a, b))
    print(json.dumps({
        # exact matches clamp to 999.0: float('inf') would serialize as
        # the bare token `Infinity`, which strict JSON parsers (jq,
        # JSON.parse) reject
        "psnr_db": round(p, 3) if math.isfinite(p) else 999.0,
        "mse": float(np.mean(diff * diff)),
        "max_abs": float(diff.max()),
        "shape": list(a.shape),
    }))
    return 0


def cmd_serve(args) -> int:
    from splat_tpu.viewer.server import serve

    scene = _load(args)
    cam = _camera(args)
    serve(scene, cam, _config(args, scene, cam), host=args.host, port=args.port,
          method=args.method, png_level=args.png_level,
          transport=args.transport)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="splat_tpu",
        description="3D gaussian splatting renderer (JAX/Pallas)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("render", help="render one frame to a PNG")
    p.add_argument("scene", nargs="?", help="3DGS .ply")
    _add_render_flags(p)
    p.add_argument("--out", default="frame.png")
    p.add_argument("--stats", action="store_true",
                   help="print the frame report (visible/pair counts, "
                        "tile occupancy, overflow) as JSON on stderr — "
                        "deployment capacity sizing")
    p.set_defaults(fn=cmd_render)

    p = sub.add_parser("orbit", help="render an orbit trajectory")
    p.add_argument("scene", nargs="?")
    _add_render_flags(p)
    p.add_argument("--frames", type=int, default=120)
    p.add_argument("--yaw-sweep", type=float, default=360.0,
                   help="total yaw sweep in degrees")
    p.add_argument("--pitch-sweep", type=float, default=0.0)
    p.add_argument("--path", metavar="FILE.json", default=None,
                   help="render a custom camera path instead of the "
                        "yaw/pitch orbit: same JSON spec as `fit "
                        "--cameras` ({h, w, fovy_deg, views: [{position, "
                        "target, yaw, pitch}]}); overrides --frames/"
                        "--size/--pos")
    p.add_argument("--interp", type=int, default=1, metavar="K",
                   help="with --path: linearly interpolate K frames "
                        "between consecutive waypoints (keyframes -> "
                        "smooth flythrough)")
    p.add_argument("--out-dir", default="frames")
    p.add_argument("--png-level", type=int, default=6,
                   help="zlib level for frame PNGs (lower = faster export, "
                        "bigger files; 0 = stored)")
    p.add_argument("--gif", default=None,
                   help="also write an animated GIF to this path")
    p.add_argument("--gif-fps", type=float, default=20.0)
    p.set_defaults(fn=cmd_orbit)

    p = sub.add_parser("trim", help="copy the first K splats to a fixture")
    p.add_argument("scene")
    p.add_argument("out")
    p.add_argument("--count", type=int, default=3)
    p.set_defaults(fn=cmd_trim)

    p = sub.add_parser("info", help="scene statistics")
    p.add_argument("scene", nargs="?")
    p.add_argument("--naive", action="store_true")
    p.add_argument("--no-center", action="store_true")
    p.set_defaults(fn=cmd_info)

    p = sub.add_parser("serve", help="interactive browser viewer "
                       "(arrow keys / drag / wheel, like the reference "
                       "viewer)")
    p.add_argument("scene", nargs="?")
    _add_render_flags(p)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--png-level", type=int, default=0,
                   help="zlib level for served frames (0 = stored blocks: "
                        "~17 ms/1080p frame vs ~340 ms at level 3, ~3x "
                        "bytes; raise for remote viewing on thin links)")
    p.add_argument("--transport", choices=["raw", "png"], default="raw",
                   help="initial frame transport ('T' toggles in the "
                        "browser): raw RGBA into a canvas (zero "
                        "encode/decode; localhost default) or PNG at "
                        "--png-level (thin links)")
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("fit", help="optimize a scene against target "
                       "images (distill an existing model or fit a "
                       "PNG+camera dataset); training as a CLI citizen "
                       "— the reference has no training path at all")
    p.add_argument("--distill", metavar="REF.ply", default=None,
                   help="render the targets from this model over an "
                        "orbit (scene compression/distillation)")
    p.add_argument("--targets", metavar="DIR", default=None,
                   help="directory of target PNGs (sorted by name)")
    p.add_argument("--cameras", metavar="FILE.json", default=None,
                   help="camera spec for --targets: {h, w, fovy_deg, "
                        "views: [{position, target, yaw, pitch}]}")
    p.add_argument("--init", metavar="INIT.ply", default=None,
                   help="initial scene (default: random init sized to "
                        "the distill model's extent)")
    p.add_argument("--init-n", type=int, default=20_000,
                   help="random-init gaussian count (without --init)")
    p.add_argument("--out", default="fitted.ply")
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--lr", type=float, default=5e-3)
    p.add_argument("--l1", type=float, default=0.2)
    p.add_argument("--dssim", type=float, default=0.2)
    p.add_argument("--fit-method", choices=["dense", "tiled"],
                   default="tiled",
                   help="gradient path: the production tiled custom-VJP "
                        "(scales to millions of splats) or the exact "
                        "dense path (small scenes)")
    p.add_argument("--method", choices=["auto", "dense", "tiled"],
                   default="auto", help="forward path for target "
                   "rendering / PSNR reporting")
    p.add_argument("--views", type=int, default=4,
                   help="orbit views for --distill")
    p.add_argument("--yaw-sweep", type=float, default=45.0,
                   help="distill orbit yaw sweep (degrees)")
    p.add_argument("--pitch-sweep", type=float, default=10.0)
    p.add_argument("--size", default="400x300")
    p.add_argument("--pos", default="0,-1,3.5")
    p.add_argument("--target", default="0,0,0")
    p.add_argument("--fovy-deg", type=float, default=90.0)
    p.add_argument("--sh-degree", type=int, default=3)
    p.add_argument("--dup-factor", type=float, default=4.0,
                   help="duplication capacity for the tiled VJP path "
                        "(train.fit audits it against every view)")
    p.add_argument("--densify-every", type=int, default=0,
                   help="adaptive density control (clone/split/prune) "
                        "every K steps (0 = off)")
    p.add_argument("--sh-warmup-every", type=int, default=0,
                   help="INRIA recipe: start at SH degree 0 and raise "
                        "the active degree by one every K steps up to "
                        "--sh-degree (0 = no warmup)")
    p.add_argument("--opacity-reset-every", type=int, default=0,
                   help="INRIA recipe: every K steps clamp all opacities "
                        "to <= 0.01 so floaters must re-earn their alpha "
                        "(pair with --densify-every; 0 = off)")
    p.add_argument("--means-lr-decay", type=float, default=0.01,
                   help="total exponential decay of the positional lr "
                        "over the run (the INRIA recipe's position "
                        "schedule: 1.6e-4 -> 1.6e-6 is 0.01); 1.0 = "
                        "constant lr")
    p.add_argument("--seed", type=int, default=0)
    p.set_defaults(fn=cmd_fit)

    p = sub.add_parser("psnr", help="compare two PNGs (PSNR/MSE/max-abs "
                       "as one JSON line — the suite's parity metric as "
                       "a shell tool)")
    p.add_argument("a")
    p.add_argument("b")
    p.set_defaults(fn=cmd_psnr)

    p = sub.add_parser("bench", help="device-chained frame timing")
    p.add_argument("scene", nargs="?")
    _add_render_flags(p)
    p.add_argument("--n", type=int, default=100_000,
                   help="synthetic scene size when no PLY given")
    p.add_argument("--frames", type=int, default=20)
    p.set_defaults(fn=cmd_bench)

    args = ap.parse_args(argv)
    # Warm-start: persist compiled executables across processes.
    from splat_tpu.utils.compilecache import enable_persistent_cache
    enable_persistent_cache()
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
