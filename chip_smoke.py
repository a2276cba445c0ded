#!/usr/bin/env python3
"""On-card smoke test: the render, training and serving paths at full size.

    python chip_smoke.py            # one GPU: device, render, train, serve
    python chip_smoke.py --multi    # four GPUs: the sharded paths only
    python chip_smoke.py --rehearse # tiny sizes on any backend (no result)

One process drives the card(s).  Each phase prints one result line; the
script exits non-zero if any phase fails.  On success the last line of
stdout is one JSON object naming the device as JAX reports it:

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}

Phases (one card):

* device — JAX's platform, device kind and count, and nvidia-smi's card
  name and power limit; fails unless JAX runs on the GPU;
* render — ``st.render`` on both bench scenes (1M gaussians at 1920x1080,
  the scenes bench.py builds) with zero overflow; the compiled compositing
  kernel against its plain jax.numpy reference on identical TileBins
  (float32 both; they differ only in the order of operations, so the gate
  is 1e-5 absolute per channel), each timed device-chained; and a whole
  1080p frame against ``render_dense`` (>= 45 dB PSNR, the repo's gate);
* train — ``fit(method="tiled", dssim_weight=0.2)`` for 3 steps at 1M
  gaussians on 4 views at 1080p with targets rendered from the surface
  scene (finite losses, parameters move); the training forward and
  backward kernels against their references on the random bench scene
  (the backward against ``jax.vjp`` of the reference, per pair, relative
  to each gradient row's largest magnitude: 1e-4); and tiled against
  dense gradients at a
  size ``render_dense`` handles (cosine > 0.995, tests/test_diff.py);
* serve — ``viewer.server.serve`` on a free local port, three
  ``/frame.raw`` pose requests at 1080p answered with overflow 0.

With ``--multi`` (four cards): data-parallel frames
(``render_batch_sharded_tiled``), a gaussian-sharded frame
(``render_sharded_tiled`` with ``route="gather"``), and one data-parallel
and one tensor-parallel ``fit(method="tiled", mesh=...)`` step, each
compared with the one-card result.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import socket
import sys
import threading
import time
import traceback
import urllib.request

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# Kernel vs plain reference: same float32 walk, different operation order.
KERNEL_ATOL = 1e-5
# Per-pair backward gradients vs jax.vjp of the reference, relative to
# each gradient row's largest magnitude.
GRAD_RTOL = 1e-4
PSNR_GATE = 45.0
COSINE_GATE = 0.995


@dataclasses.dataclass
class Sizes:
    n: int = 1_000_000
    h: int = 1080
    w: int = 1920
    dense_n: int = 1_000_000
    train_views: int = 4
    grad_n: int = 2_000
    grad_hw: int = 256


REHEARSAL = Sizes(n=20_000, h=128, w=192, dense_n=2_000, train_views=4,
                  grad_n=200, grad_hw=64)

# The bench scenes' capacities (bench.py), sized to their pair loads.
BENCH_DUP = {"random": 3.7, "surface": 2.0}


def bench_scene(kind: str, n: int):
    import splat_tpu as st
    if kind == "surface":
        return st.surface_scene(n, seed=0)
    return st.random_scene(n, seed=0, extent=3.0, scale_range=(0.004, 0.03))


def timed_ms(fn, *args, reps: int = 5) -> tuple[float, object]:
    """Mean device-chained milliseconds of ``fn(*args)`` after a warm-up
    call: ``reps`` calls are enqueued back to back and the clock stops
    when the last result is ready."""
    import jax

    out = jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps * 1e3, out


def phase_device(rehearse: bool) -> dict:
    from splat_tpu.utils.benchmark import device_info

    info = device_info()
    print(f"[device] platform={info['platform']} kind={info['kind']} "
          f"count={info['count']}")
    print(f"[device] nvidia-smi: {info['nvidia_smi']}")
    if info["platform"] != "gpu" and not rehearse:
        raise RuntimeError(f"no GPU: JAX runs on {info['platform']!r}")
    return info


def phase_render(sz: Sizes) -> None:
    import jax
    import numpy as np

    import splat_tpu as st
    from splat_tpu.config import RenderConfig
    from splat_tpu.ops.projection import project_gaussians
    from splat_tpu.render import kernels as K
    from splat_tpu.render.binning import build_tile_bins
    from splat_tpu.render.dense import render_dense
    from splat_tpu.render.tiled import render_tiled
    from splat_tpu.utils.image import psnr

    cam = st.Camera.create(h=sz.h, w=sz.w, position=(0.0, 0.0, 4.0))
    for kind, dup in BENCH_DUP.items():
        scene = bench_scene(kind, sz.n).pack_device()
        img = np.asarray(st.render(scene, cam))     # raises on overflow
        assert img.shape == (sz.h, sz.w, 3) and np.isfinite(img).all()
        cfg = RenderConfig(max_dup_factor=dup)
        frame = jax.jit(lambda s, c: render_tiled(s, c, cfg,
                                                  return_stats=True))
        frame_ms, (img2, stats) = timed_ms(frame, scene, cam)
        overflow = int(stats["overflow"])
        assert overflow == 0, f"{kind}: overflow {overflow}"
        bins = jax.jit(lambda s, c: build_tile_bins(
            project_gaussians(s, c, cfg), sz.h, sz.w, cfg))(scene, cam)
        kern_ms, got = timed_ms(jax.jit(lambda b: K.composite_tiles(b, cfg)),
                                bins)
        ref_ms, want = timed_ms(
            jax.jit(lambda b: K.composite_reference(b, cfg)), bins, reps=2)
        err = float(jax.numpy.max(jax.numpy.abs(got - want)))
        assert err <= KERNEL_ATOL, f"{kind}: kernel vs reference {err:.2e}"
        print(f"[render] {kind}: {sz.n} gaussians {sz.w}x{sz.h} "
              f"pairs={int(stats['num_pairs'])} overflow={overflow} "
              f"max_tile_pairs={int(stats['max_tile_pairs'])} "
              f"mean_tile_pairs={float(stats['mean_tile_pairs']):.1f} "
              f"frame_ms={frame_ms:.3f} kernel_ms={kern_ms:.3f} "
              f"plain_ms={ref_ms:.3f} kernel_vs_plain_max_abs={err:.2e}")

    scene = bench_scene("random", sz.dense_n)
    img = np.asarray(st.render(scene, cam, method="tiled"))
    t0 = time.perf_counter()
    dense = np.asarray(jax.jit(lambda s, c: render_dense(s, c))(scene, cam))
    dense_s = time.perf_counter() - t0
    p = psnr(img, dense)
    assert p >= PSNR_GATE, f"tiled vs dense {p:.2f} dB"
    print(f"[render] frame vs render_dense: {sz.dense_n} gaussians "
          f"{sz.w}x{sz.h} psnr={p:.2f} dB (gate {PSNR_GATE}) "
          f"dense_s={dense_s:.1f}")


def phase_train(sz: Sizes) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    import splat_tpu as st
    from splat_tpu.camera import orbit_trajectory
    from splat_tpu.config import RenderConfig
    from splat_tpu.ops.projection import project_gaussians
    from splat_tpu.render import diff as D
    from splat_tpu.render import kernels as K
    from splat_tpu.render.binning import build_tile_bins
    from splat_tpu.render.dense import render_dense
    from splat_tpu.render.diff import render_tiled_diff
    from splat_tpu.train import fit

    # -- fit: 3 steps, 4 views, targets from the surface scene ------------
    truth = bench_scene("surface", sz.n)
    cams = orbit_trajectory(
        st.Camera.create(h=sz.h, w=sz.w, position=(0.0, 0.0, 4.0)),
        num_frames=sz.train_views, yaw_sweep=0.6)
    cfg = RenderConfig(max_dup_factor=BENCH_DUP["surface"])
    tdev = truth.pack_device()
    targets = jax.jit(jax.vmap(
        lambda s, c: render_tiled_diff(s, c, cfg),
        in_axes=(None, 0)))(tdev, cams)
    rng = np.random.default_rng(0)
    start = dataclasses.replace(
        truth, means=truth.means + rng.normal(
            0.0, 0.01, truth.means.shape).astype(np.float32))
    t0 = time.perf_counter()
    res = fit(start, cams, targets, steps=3, lr=1e-3, method="tiled",
              dssim_weight=0.2, config=cfg)
    fit_s = time.perf_counter() - t0
    losses = np.asarray(res.losses)
    moved = float(np.abs(np.asarray(res.scene.means)
                         - np.asarray(start.means)).max())
    assert np.isfinite(losses).all(), losses
    assert moved > 0.0, "parameters did not move"
    print(f"[train] fit tiled: {sz.n} gaussians, {sz.train_views} views "
          f"{sz.w}x{sz.h}, 3 steps: losses={losses.tolist()} "
          f"max_mean_move={moved:.2e} wall_s={fit_s:.1f}")

    # -- training kernels vs references: random bench scene, view 0 --------
    cam = jax.tree.map(lambda a: a[0], cams)
    scene = bench_scene("random", sz.n).pack_device()
    cfg = RenderConfig(max_dup_factor=BENCH_DUP["random"])
    bins = jax.jit(lambda s, c: build_tile_bins(
        project_gaussians(s, c, cfg), sz.h, sz.w, cfg))(scene, cam)
    fwd_ms, (planes, cut) = timed_ms(jax.jit(lambda b: D._fwd_raster(b, cfg)),
                                     bins)
    fref_ms, (rplanes, rcut) = timed_ms(jax.jit(
        lambda b: K.composite_reference(b, cfg, train=True,
                                        sat_cut_log=D.SAT_CUT_LOG)),
        bins, reps=1)
    c_err = float(jnp.max(jnp.abs(planes[..., :3] - rplanes[..., :3])))
    assert c_err <= KERNEL_ATOL, f"train forward C {c_err:.2e}"
    lt_rel = float(jnp.max(jnp.abs(planes[..., 3] - rplanes[..., 3])
                           / (1.0 + jnp.abs(rplanes[..., 3]))))
    assert lt_rel <= KERNEL_ATOL, f"train forward logT {lt_rel:.2e}"
    key = jax.random.PRNGKey(0)
    g_c = jax.random.normal(key, (sz.h, sz.w, 3))
    g_lt = 0.1 * jax.random.normal(jax.random.PRNGKey(1), (sz.h, sz.w))
    bwd_ms, grads = timed_ms(jax.jit(
        lambda b, p, c, a, l: D._bwd_raster(b, a, l, p[..., 3], c, cfg)),
        bins, planes, cut, g_c, g_lt)
    occ = np.asarray(bins.tile_end - bins.tile_start)
    nb = int(-(-occ.max() // cfg.chunk))

    def ref_pair_grads(b, a, l):
        def f(fields):
            out, _ = K.composite_reference(
                b, cfg, train=True, sat_cut_log=D.SAT_CUT_LOG,
                fields=fields, num_batches=nb)
            return out[:sz.h, :sz.w, :3], out[:sz.h, :sz.w, 3]
        _, vjp = jax.vjp(f, K.decode_pairs(b, cfg))
        (gf,) = vjp((a, l))
        return jnp.stack([gf[k] for k in K.PAIR_FIELDS])

    bref_ms, want = timed_ms(jax.jit(ref_pair_grads), bins, g_c, g_lt,
                             reps=1)
    n_real = int(bins.tile_end[-1])
    a, b = np.asarray(grads)[:, :n_real], np.asarray(want)[:, :n_real]
    rel = max(float(np.abs(a[r] - b[r]).max() / (np.abs(b[r]).max() + 1e-30))
              for r in range(a.shape[0]))
    assert rel <= GRAD_RTOL, f"backward vs reference vjp rel {rel:.2e}"
    print(f"[train] kernels, random scene view 0: fwd_ms={fwd_ms:.3f} "
          f"fwd_plain_ms={fref_ms:.3f} fwd_C_max_abs={c_err:.2e} "
          f"fwd_logT_rel={lt_rel:.2e} cut_mismatch_tiles="
          f"{int(jnp.sum(cut != rcut))} bwd_ms={bwd_ms:.3f} "
          f"bwd_plain_vjp_ms={bref_ms:.3f} bwd_rel={rel:.2e}")

    # -- tiled vs dense gradients (tests/test_diff.py thresholds) ----------
    small = jax.tree.map(jnp.asarray,
                         st.random_scene(sz.grad_n, seed=3, extent=2.0,
                                         scale_range=(0.02, 0.12)))
    gcam = st.Camera.create(h=sz.grad_hw, w=sz.grad_hw,
                            position=(0.0, 0.0, 4.0))
    gcfg = RenderConfig(max_dup_factor=8.0)
    tgt = jnp.full((sz.grad_hw, sz.grad_hw, 3), 0.25)
    gt = jax.jit(jax.grad(lambda s: jnp.mean(
        (render_tiled_diff(s, gcam, gcfg) - tgt) ** 2)))(small)
    gd = jax.jit(jax.grad(lambda s: jnp.mean(
        (render_dense(s, gcam, gcfg) - tgt) ** 2)))(small)
    cosines = {}
    for name in ("means", "quats", "scales", "opacities", "sh"):
        x = np.asarray(getattr(gt, name)).ravel()
        y = np.asarray(getattr(gd, name)).ravel()
        cosines[name] = float(x @ y / np.sqrt((x @ x) * (y @ y) + 1e-30))
    worst = min(cosines.values())
    assert worst > COSINE_GATE, cosines
    print(f"[train] tiled vs dense grads: {sz.grad_n} gaussians "
          f"{sz.grad_hw}x{sz.grad_hw} cosine_min={worst:.5f} "
          f"(gate {COSINE_GATE})")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_serve(sz: Sizes) -> None:
    import splat_tpu as st
    from splat_tpu.config import RenderConfig
    from splat_tpu.viewer.server import serve

    scene = bench_scene("random", sz.n)
    cam = st.Camera.create(h=sz.h, w=sz.w, position=(0.0, 0.0, 4.0))
    port = _free_port()
    threading.Thread(
        target=serve, args=(scene, cam, RenderConfig(max_dup_factor=3.9)),
        kwargs=dict(port=port, method="tiled"), daemon=True).start()
    base = f"http://127.0.0.1:{port}"
    deadline = time.time() + 120
    while True:                                     # wait for the socket
        try:
            with socket.create_connection(("127.0.0.1", port), timeout=1):
                break
        except OSError:
            if time.time() > deadline:
                raise
            time.sleep(0.2)
    times = []
    for yaw, pitch in ((0.0, 0.0), (0.2, 0.05), (-0.3, -0.1)):
        t0 = time.perf_counter()
        with urllib.request.urlopen(
                f"{base}/frame.raw?yaw={yaw}&pitch={pitch}",
                timeout=900) as r:
            body = r.read()
            hdr = r.headers
        times.append((time.perf_counter() - t0) * 1e3)
        assert r.status == 200, r.status
        assert hdr["X-Splat-Overflow"] == "0", hdr["X-Splat-Overflow"]
        assert (int(hdr["X-Splat-W"]), int(hdr["X-Splat-H"])) == (sz.w, sz.h)
        assert len(body) == sz.w * sz.h * 4, len(body)
    print(f"[serve] 3 /frame.raw poses at {sz.w}x{sz.h}: overflow 0, "
          f"request_ms={[round(t, 1) for t in times]} (first compiles)")


def phase_multi(sz: Sizes) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    import splat_tpu as st
    from splat_tpu.camera import orbit_trajectory
    from splat_tpu.config import RenderConfig
    from splat_tpu.parallel.sharding import (make_mesh,
                                             render_batch_sharded_tiled,
                                             render_sharded_tiled)
    from splat_tpu.render.tiled import render_tiled
    from splat_tpu.train import fit
    from splat_tpu.utils.image import psnr

    ndev = len(jax.devices())
    assert ndev == 4, f"--multi needs 4 devices, found {ndev}"
    cfg = RenderConfig(max_dup_factor=BENCH_DUP["random"])
    scene = bench_scene("random", sz.n).pack_device()
    cam = st.Camera.create(h=sz.h, w=sz.w, position=(0.0, 0.0, 4.0))
    cams = orbit_trajectory(cam, num_frames=4, yaw_sweep=0.4)
    one = jax.jit(lambda s, c: render_tiled(s, c, cfg))
    ref = np.stack([np.asarray(one(scene, jax.tree.map(lambda a: a[i],
                                                       cams)))
                    for i in range(4)])

    mesh_d = make_mesh(n_data=4, n_gaussian=1)
    imgs, ov = jax.jit(lambda s, c: render_batch_sharded_tiled(
        s, c, mesh_d, cfg))(scene, cams)
    err = float(np.abs(np.asarray(imgs) - ref).max())
    assert int(ov) == 0 and err <= KERNEL_ATOL, (int(ov), err)
    print(f"[multi] render_batch_sharded_tiled d=4: 4 frames {sz.w}x{sz.h}, "
          f"overflow 0, max_abs_vs_one_card={err:.2e}")

    mesh_g = make_mesh(n_data=1, n_gaussian=4)
    img, ov = jax.jit(lambda s, c: render_sharded_tiled(
        s, c, mesh_g, cfg, route="gather"))(scene, cam)
    p = psnr(np.asarray(img), ref[0])
    assert int(ov) == 0 and p >= PSNR_GATE, (int(ov), p)
    print(f"[multi] render_sharded_tiled g=4 route=gather: overflow 0, "
          f"psnr_vs_one_card={p:.2f} dB (row slabs re-tile the frame)")

    truth = bench_scene("surface", sz.n)
    tcfg = RenderConfig(max_dup_factor=BENCH_DUP["surface"])
    tdev = truth.pack_device()
    one_t = jax.jit(lambda s, c: render_tiled(s, c, tcfg))
    targets = jnp.stack([one_t(tdev, jax.tree.map(lambda a: a[i], cams))
                         for i in range(4)])
    rng = np.random.default_rng(0)
    start = dataclasses.replace(
        truth, means=truth.means + rng.normal(
            0.0, 0.01, truth.means.shape).astype(np.float32))
    kw = dict(steps=2, lr=1e-3, method="tiled", config=tcfg)
    base = np.asarray(fit(start, cams, targets, **kw).losses)
    for name, mesh in (("data-parallel d=4", mesh_d),
                       ("tensor-parallel g=4", mesh_g)):
        got = np.asarray(fit(start, cams, targets, mesh=mesh, **kw).losses)
        rel = float(np.abs(got - base).max() / np.abs(base).max())
        assert np.isfinite(got).all() and rel <= 1e-3, (name, got, base)
        print(f"[multi] fit tiled {name}: 1 update, losses={got.tolist()} "
              f"one_card={base.tolist()} rel={rel:.2e}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help="four cards: the sharded paths only")
    ap.add_argument("--rehearse", action="store_true",
                    help="tiny sizes on any backend; prints no result")
    args = ap.parse_args()

    import jax

    from splat_tpu.utils.compilecache import enable_persistent_cache

    enable_persistent_cache()
    sz = REHEARSAL if args.rehearse else Sizes()
    info = phase_device(args.rehearse)
    phases = ([("multi", phase_multi)] if args.multi else
              [("render", phase_render), ("train", phase_train),
               ("serve", phase_serve)])
    failed = []
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            fn(sz)
        except Exception:
            traceback.print_exc()
            failed.append(name)
            print(f"[{name}] FAILED after {time.perf_counter() - t0:.1f} s",
                  flush=True)
            continue
        print(f"[{name}] ok in {time.perf_counter() - t0:.1f} s", flush=True)
    if failed:
        print(f"chip_smoke: failed phases: {', '.join(failed)}")
        return 1
    if args.rehearse:
        print("chip_smoke: rehearsal passed (no device result)")
        return 0
    print(json.dumps({"ok": True, "device": {
        "platform": info["platform"], "kind": info["kind"],
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
