"""Differentiable scene fitting (the 3DGS optimization setup).

The reference is feed-forward inference only — no training, autograd, or
optimizer anywhere (SURVEY §1: "renderer, not trainer").  Differentiability
is the dividend of the functional design: :func:`render_dense`
is pure JAX, so ``jax.grad`` flows from pixels back to every scene
parameter.  This module packages that into the standard gaussian-splatting
optimization loop:

* **Unconstrained raw parameters** — the inverses of the load-time
  activations the reference applies (exp on scales, sigmoid on opacity,
  quaternion normalization; reference src/gaussians.rs:265-272,
  notes/util_gau.py:98-105): we optimize ``log_scales`` and
  ``logit_opacities`` so plain gradient steps can never leave the valid
  domain, and leave quaternions unnormalized (the ops normalize on use,
  ops/transforms.py:21-29) so their gradient lives on the full R^4.
* **A jitted multi-view update step** — one ``optax`` update over the mean
  photometric loss across a batch of views (cameras batched on a leading
  axis, as produced by :func:`splat_tpu.camera.orbit_trajectory`).
* **fit()** — the batteries-included loop: adam, per-parameter learning-rate
  scaling (positions want far smaller steps than colors — the standard 3DGS
  recipe), loss history out.

Two differentiable surfaces: the dense renderer (exact autodiff,
O(N·H·W) — small/medium scenes) and, since round 4, the production
tiled pipeline via its custom VJP (render/diff.py: a reverse-walk
Pallas backward kernel over the same per-tile pair ranges) — pass
``method="tiled"`` to train production-scale scenes.  D-SSIM
(``dssim_weight``) completes the standard 3DGS loss recipe.
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from functools import partial
from typing import Callable

import jax
import jax.numpy as jnp

from splat_tpu.camera import Camera
from splat_tpu.config import RenderConfig
from splat_tpu.render.dense import render_dense
from splat_tpu.scene import GaussianScene


@partial(jax.tree_util.register_dataclass,
         data_fields=["means", "quats", "log_scales", "logit_opacities",
                      "sh"],
         meta_fields=[])
@dataclasses.dataclass(frozen=True)
class RawParams:
    """Unconstrained scene parameterization (a pytree of optimizable leaves).

    ``to_scene`` applies exactly the activations the loaders apply to PLY
    fields (io/ply.py; reference src/gaussians.rs:265-268), so a fitted
    ``RawParams`` round-trips through :func:`splat_tpu.io.ply.save_ply`
    like any loaded model.
    """

    means: jax.Array             # (N, 3) world centers (identity activation)
    quats: jax.Array             # (N, 4) UNnormalized; ops normalize on use
    log_scales: jax.Array        # (N, 3) pre-exp
    logit_opacities: jax.Array   # (N,)   pre-sigmoid
    sh: jax.Array                # (N, 16, 3)

    @classmethod
    def from_scene(cls, scene: GaussianScene,
                   eps: float = 1e-5) -> "RawParams":
        """Invert the activations. Opacities are clamped into
        [eps, 1-eps] first so the logit is finite."""
        op = jnp.clip(jnp.asarray(scene.opacities, jnp.float32),
                      eps, 1.0 - eps)
        return cls(
            means=jnp.asarray(scene.means, jnp.float32),
            quats=jnp.asarray(scene.quats, jnp.float32),
            log_scales=jnp.log(jnp.maximum(
                jnp.asarray(scene.scales, jnp.float32), 1e-12)),
            logit_opacities=jnp.log(op) - jnp.log1p(-op),
            sh=jnp.asarray(scene.sh, jnp.float32))

    def to_scene(self) -> GaussianScene:
        return GaussianScene(
            means=self.means,
            quats=self.quats,  # normalized inside quat_to_rotmat
            scales=jnp.exp(self.log_scales),
            opacities=jax.nn.sigmoid(self.logit_opacities),
            sh=self.sh)


def save_raw_params(path, raw: RawParams) -> None:
    """Checkpoint the UNCONSTRAINED training parameters exactly (npz).

    ``save_ply`` checkpoints the activated scene (the deployment
    artifact, loadable by any 3DGS tool); this saves the raw
    pre-activation leaves bit-exactly so a resumed fit continues from
    precisely where it stopped (log/logit round-trips through PLY lose
    a few ulps at the activation boundaries).
    """
    import numpy as np

    np.savez(path, **{k: np.asarray(getattr(raw, k))
                      for k in ("means", "quats", "log_scales",
                                "logit_opacities", "sh")})


def load_raw_params(path) -> RawParams:
    """Inverse of :func:`save_raw_params`."""
    import numpy as np

    with np.load(path) as z:
        return RawParams(**{k: jnp.asarray(z[k])
                            for k in ("means", "quats", "log_scales",
                                      "logit_opacities", "sh")})


def psnr(img: jax.Array, ref: jax.Array, peak: float = 1.0) -> jax.Array:
    """Peak signal-to-noise ratio in dB (the parity metric of the suite)."""
    mse = jnp.mean((img - ref) ** 2)
    return 10.0 * jnp.log10(peak * peak / jnp.maximum(mse, 1e-20))


def ssim(a: jax.Array, b: jax.Array, *, window: int = 11,
         sigma: float = 1.5, c1: float = 0.01 ** 2,
         c2: float = 0.03 ** 2) -> jax.Array:
    """Mean structural similarity over (H, W, C) images in [0, 1].

    The standard gaussian-windowed SSIM (the 3DGS training recipe's
    second loss term).  Implemented as two separable depthwise
    convolutions per moment — the XLA-friendly formulation (a 2D conv
    would work too; separable halves the FLOPs and fuses cleanly).
    Differentiable; used via the D-SSIM loss 1 - ssim.
    """
    r = window // 2
    x = jnp.arange(window, dtype=jnp.float32) - r
    k = jnp.exp(-0.5 * (x / sigma) ** 2)
    k = k / jnp.sum(k)

    def blur(img):  # (H, W, C) gaussian filter, separable, SAME-padded
        c = img.shape[-1]
        kh = jnp.tile(k.reshape(1, window, 1, 1), (1, 1, 1, c))
        kv = jnp.tile(k.reshape(window, 1, 1, 1), (1, 1, 1, c))
        y = img[None]
        dn = jax.lax.conv_dimension_numbers(y.shape, kh.shape,
                                            ("NHWC", "HWIO", "NHWC"))
        y = jax.lax.conv_general_dilated(
            y, kh, (1, 1), [(0, 0), (r, r)], dimension_numbers=dn,
            feature_group_count=c, precision=jax.lax.Precision.HIGHEST)
        y = jax.lax.conv_general_dilated(
            y, kv, (1, 1), [(r, r), (0, 0)], dimension_numbers=dn,
            feature_group_count=c, precision=jax.lax.Precision.HIGHEST)
        return y[0]

    mu_a = blur(a)
    mu_b = blur(b)
    var_a = blur(a * a) - mu_a * mu_a
    var_b = blur(b * b) - mu_b * mu_b
    cov = blur(a * b) - mu_a * mu_b
    s = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)
         / ((mu_a * mu_a + mu_b * mu_b + c1) * (var_a + var_b + c2)))
    return jnp.mean(s)


def photometric_loss(raw: RawParams, cameras: Camera, targets: jax.Array,
                     config: RenderConfig, l1_weight: float = 0.2,
                     chunk: int = 16, *, dssim_weight: float = 0.0,
                     method: str = "dense") -> jax.Array:
    """Mean L2 + ``l1_weight``·L1 (+ ``dssim_weight``·(1−SSIM)) over a
    batch of views.

    ``cameras`` carries a leading view axis on its traced leaves
    (``orbit_trajectory`` shape); ``targets`` is (V, H, W, C) matching the
    renderer's output channel count.  The L1 and D-SSIM terms are the
    standard 3DGS recipe (loss = (1−λ)L1 + λ·D-SSIM with λ=0.2); the L2
    default keeps the round-3 behavior, opt into the full recipe with
    ``l1_weight``/``dssim_weight``.

    method: 'dense' (exact autodiff; O(N·H·W) — small/medium scenes) or
    'tiled' (the production pipeline's custom VJP, render/diff.py —
    production-scale scenes).
    """
    scene = raw.to_scene()

    def render_one(camera):
        if method == "tiled":
            from splat_tpu.render.diff import render_tiled_diff
            return render_tiled_diff(scene, camera, config)
        return render_dense(scene, camera, config, chunk=chunk)

    def one_view(camera, target):
        img = render_one(camera)
        err = img - target
        loss = jnp.mean(err * err) + l1_weight * jnp.mean(jnp.abs(err))
        if dssim_weight:
            loss = loss + dssim_weight * (1.0 - ssim(img, target))
        return loss

    if method == "tiled":
        # vmap over a Pallas custom-vjp pair is not batchable; a lax.map
        # keeps one compiled instance and loops views sequentially.
        cams_and_targets = (cameras, targets)
        losses = jax.lax.map(
            lambda ct: one_view(ct[0], ct[1]), cams_and_targets)
    else:
        losses = jax.vmap(one_view)(cameras, targets)
    return jnp.mean(losses)


# Per-leaf learning-rate scale relative to the base lr: positions and
# geometry move on the scene's metric scale; colors/opacities are O(1).
DEFAULT_LR_SCALES = {
    "means": 0.05,
    "quats": 0.25,
    "log_scales": 1.0,
    "logit_opacities": 2.5,
    "sh": 1.0,
}


def _required_dup_factor(scene, cameras, config: RenderConfig) -> float:
    """Measured max_dup_factor the training poses need (+5% margin for
    pose/footprint drift between audits): worst slot demand over every
    view, from the binning stage's own count arithmetic."""
    from splat_tpu.render.api import pair_stats

    n_views = _num_views(cameras)
    n = max(scene.num_gaussians, 1)
    worst = 0
    for i in range(n_views):
        cam = jax.tree.map(lambda a: a[i], cameras,
                           is_leaf=lambda a: hasattr(a, "shape"))
        worst = max(worst, pair_stats(scene, cam, config)["slots"])
    return worst * 1.05 / n


def _num_views(cameras) -> int:
    """Leading view-axis length of a batched camera pytree (works for
    both the orbit Camera and SE3Camera — every traced leaf carries the
    same leading axis)."""
    import numpy as _np

    return int(_np.shape(jax.tree.leaves(cameras)[0])[0])


def _slot_demand_fn(cameras, config: RenderConfig):
    """Traced max pair-slot demand over all views as a function of the
    raw params — the in-scan overflow monitor.

    The up-front audit (+5% margin) is a heuristic, not a bound: within
    a long jitted segment the optimizer can grow splat footprints past
    the margin and silently truncate the forward.  This closure runs
    INSIDE the training scan (one extra projection pass per view per
    step, O(N) — noise next to the O(pairs) forward+backward), max-
    reduces across steps, and fit() checks the segment max host-side at
    every segment boundary so truncation is detected (and capacity
    auto-raised) rather than silent."""
    from splat_tpu.ops.projection import project_gaussians
    from splat_tpu.render.binning import count_pairs

    if config.supersample > 1:
        cameras = cameras.scaled(config.supersample)

    def demand(raw: "RawParams"):
        scene = raw.to_scene()

        def one(cam):
            visible, pairs = count_pairs(
                project_gaussians(scene, cam, config), cam.h, cam.w,
                config)
            sentinels = (scene.num_gaussians - visible
                         if config.binning_key == "depth" else 0)
            return pairs + sentinels

        return jnp.max(jax.vmap(one)(cameras))

    return demand


def _check_tiled_capacity(scene, cameras, config: RenderConfig) -> None:
    """A silently-truncated TRAINING forward would bias every gradient;
    render_tiled_diff is jit-traced and cannot host-sync an overflow
    check per step, so fit() audits the capacity up front, monitors the
    per-step demand inside every jitted segment (``_slot_demand_fn``),
    and re-audits at every densification boundary (where the topology
    change can shrink k_cap below the surviving splats' demand — see
    fit()).  Same no-silent-truncation contract as every public render
    path (config.py)."""
    need = _required_dup_factor(scene, cameras, config)
    if config.max_dup_factor < need:
        n = max(scene.num_gaussians, 1)
        raise ValueError(
            f"fit(method='tiled'): max_dup_factor={config.max_dup_factor} "
            f"gives {int(config.max_dup_factor * n)} pair slots but the "
            f"training poses need up to {int(need * n)} (incl. 5% "
            f"margin) — a truncated forward would silently bias every "
            f"gradient; raise RenderConfig.max_dup_factor to at least "
            f"{need:.2f}")


@dataclasses.dataclass(frozen=True)
class FitResult:
    scene: GaussianScene        # fitted scene (activated)
    raw: RawParams              # fitted raw parameters
    losses: jax.Array           # (steps,) loss history
    final_loss: float
    densify_log: tuple = ()     # per-round dicts when densification ran


def _np_quat_rotmat(q):
    """(N, 4) scalar-first quaternions -> (N, 3, 3) rotations (NumPy)."""
    import numpy as np
    q = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-12)
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                  2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                  2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                  1 - 2 * (x * x + y * y)], -1),
    ], axis=1)


def densify_and_prune(raw: RawParams, grad_mean, *,
                      grad_threshold: float = 5e-5,
                      split_scale_threshold: float | None = None,
                      min_opacity: float = 0.005,
                      split_factor: float = 1.6,
                      max_gaussians: int | None = None,
                      pad_multiple: int = 256,
                      seed: int = 0) -> tuple[RawParams, dict]:
    """Adaptive density control (the INRIA 3DGS recipe, host-side).

    Per densification round: splats whose accumulated mean positional
    gradient exceeds ``grad_threshold`` are under-reconstructing —
    CLONE the small ones (max world scale below
    ``split_scale_threshold``; default 1% of the scene extent) and
    SPLIT the large ones into two samples drawn from the gaussian with
    scales shrunk by ``split_factor``.  Splats with opacity below
    ``min_opacity`` are PRUNED.  (The reference renders pretrained
    models only; this is the training-side capability its ecosystem's
    models were made with.  Criterion deviation, documented: the
    original thresholds view-space NDC gradients per densify interval;
    here the world-space mean-gradient norm plays that role — same
    signal up to the projection scale.)

    Static-shape discipline: the result is padded up to a multiple
    of ``pad_multiple`` with DEAD splats (opacity ~3e-7 — culled by
    visibility, zero gradients, one sentinel binning slot each), so
    repeated rounds hit a few bucketed compile shapes instead of one
    per round; the persistent compilation cache makes revisited buckets
    free.  Runs on the host (NumPy): topology changes are control
    decisions, not device math.
    """
    import numpy as np

    d = {k: np.asarray(getattr(raw, k))
         for k in ("means", "quats", "log_scales", "logit_opacities",
                   "sh")}
    g = np.asarray(grad_mean)
    opac = 1.0 / (1.0 + np.exp(-d["logit_opacities"]))
    scales = np.exp(d["log_scales"])
    alive = opac > min_opacity
    if split_scale_threshold is None:
        live_means = d["means"][alive] if alive.any() else d["means"]
        extent = float(np.linalg.norm(
            live_means.max(0) - live_means.min(0))) if len(live_means) \
            else 1.0
        split_scale_threshold = 0.01 * max(extent, 1e-6)

    needs = alive & (g > grad_threshold)
    big = scales.max(axis=1) > split_scale_threshold
    clone_idx = np.flatnonzero(needs & ~big)
    split_idx = np.flatnonzero(needs & big)
    keep_idx = np.flatnonzero(alive & ~(needs & big))

    parts = {k: [v[keep_idx], v[clone_idx]] for k, v in d.items()}
    if len(split_idx):
        rng = np.random.default_rng(seed)
        rot = _np_quat_rotmat(d["quats"][split_idx])         # (S, 3, 3)
        for _ in range(2):
            eps = rng.normal(size=(len(split_idx), 3)).astype(np.float32)
            offset = np.einsum("nij,nj->ni", rot,
                               scales[split_idx] * eps)
            for k, v in d.items():
                if k == "means":
                    parts[k].append(v[split_idx] + offset)
                elif k == "log_scales":
                    parts[k].append(v[split_idx]
                                    - np.log(split_factor))
                else:
                    parts[k].append(v[split_idx])
    new = {k: np.concatenate(v, axis=0) for k, v in parts.items()}
    n = len(new["means"])
    if max_gaussians is not None and n > max_gaussians:
        op_new = 1.0 / (1.0 + np.exp(-new["logit_opacities"]))
        order = np.argsort(-op_new)[:max_gaussians]
        new = {k: v[order] for k, v in new.items()}
        n = max_gaussians
    n_pad = (-n) % pad_multiple
    if n_pad:
        dead = {
            "means": np.zeros((n_pad, 3), np.float32),
            "quats": np.tile(np.array([[1, 0, 0, 0]], np.float32),
                             (n_pad, 1)),
            "log_scales": np.full((n_pad, 3), -12.0, np.float32),
            "logit_opacities": np.full((n_pad,), -15.0, np.float32),
            "sh": np.zeros((n_pad, 16, 3), np.float32),
        }
        new = {k: np.concatenate([v, dead[k]], axis=0)
               for k, v in new.items()}
    stats = {"kept": len(keep_idx), "cloned": len(clone_idx),
             "split": len(split_idx), "pruned": int((~alive).sum()),
             "padded": n_pad, "n": n + n_pad}
    return RawParams(**{k: jnp.asarray(v) for k, v in new.items()}), stats


def fit(scene: GaussianScene, cameras: Camera, targets,
        *, steps: int = 200, lr: float = 1e-2,
        lr_scales: dict | None = None, lr_decay: dict | None = None,
        config: RenderConfig | None = None,
        l1_weight: float = 0.2, chunk: int = 16,
        dssim_weight: float = 0.0, method: str = "dense",
        densify_every: int = 0, densify_kwargs: dict | None = None,
        opacity_reset_every: int = 0, opacity_reset_to: float = 0.01,
        sh_warmup_every: int = 0,
        mesh=None, loss_fn: Callable | None = None,
        progress_cb: Callable | None = None) -> FitResult:
    """Fit ``scene`` to ``targets`` rendered from ``cameras``.

    Args:
      scene: initialization (e.g. a perturbed model, or ``random_scene``).
      cameras: batched Camera (leading view axis on traced leaves).
      targets: (V, H, W, C) float32 ground-truth images in [0, 1].
      steps: optimizer steps; each step sees ALL views (full-batch).
      lr: base adam learning rate, scaled per-leaf by ``lr_scales``.
      lr_decay: per-leaf exponential lr decay over the whole run, e.g.
        ``{"means": 0.01}`` takes the means lr from ``lr * scale`` down
        to 1% of it by the final step — the INRIA recipe's positional
        schedule (its 1.6e-4 -> 1.6e-6 position lr is exactly a 0.01
        total decay).  The decay follows the GLOBAL step, so it does
        not restart when densification re-initializes the adam moments.
      mesh: optional ``jax.sharding.Mesh`` with a ``"d"`` axis —
        DATA-PARALLEL training: the views (cameras/targets leading axis,
        which must divide the axis size) shard across chips, each chip
        computes its shard's loss, and the gradient psum rides the
        shard_map transpose automatically (scene parameters are
        replicated).  The multi-chip training counterpart of
        parallel/sharding.py's inference DP axis.
      densify_every: when > 0, run :func:`densify_and_prune` every that
        many steps (mean positional-gradient norms are accumulated per
        segment; the optimizer state re-initializes after a topology
        change, as in the original recipe).  Segment boundaries change
        the gaussian count, so each visited padded shape compiles once
        (bucketed by densify_and_prune's pad_multiple; the persistent
        cache remembers buckets across runs).  On the tiled path the
        capacity audit re-runs after every round, auto-raising
        ``max_dup_factor`` (with a warning) if pruning left it below
        the measured slot demand.
      opacity_reset_every: when > 0, every that many steps clamp every
        opacity to at most ``opacity_reset_to`` (INRIA recipe's periodic
        opacity reset: floaters must re-earn their alpha or be pruned by
        the next densification round).  The opacity group's adam moments
        reset surgically; other leaves keep their state.
      sh_warmup_every: when > 0, start optimizing with SH degree 0 (DC
        color only) and raise the active degree by one every that many
        steps up to ``config.sh_degree`` — the INRIA recipe's SH warmup
        (low-frequency color stabilizes geometry before view-dependent
        terms join).  Each degree compiles its own segment; higher-order
        coefficients hold their init until activated (zero gradient).
      loss_fn: optional ``loss_fn(raw) -> scalar`` override; default is
        :func:`photometric_loss` over all views.
      progress_cb: optional ``cb(step, loss, num_gaussians)`` called
        after every segment (host-side, between the jitted scans) —
        progress reporting for long densify/warmup runs.

    Returns a :class:`FitResult`; ``losses[0]`` is the pre-step loss so
    ``losses[0] / final_loss`` measures convergence, and
    ``densify_log`` records each round's clone/split/prune counts.
    """
    import optax

    config = config or RenderConfig()
    scales = dict(DEFAULT_LR_SCALES)
    for name, d in (("lr_scales", lr_scales), ("lr_decay", lr_decay)):
        bad = set(d or {}) - set(scales)
        if bad:
            raise ValueError(
                f"{name} keys {sorted(bad)} are not RawParams leaves "
                f"{sorted(scales)} — a typo here would silently disable "
                f"the override")
    scales.update(lr_scales or {})
    targets = jnp.asarray(targets, jnp.float32)

    raw = RawParams.from_scene(scene)
    if loss_fn is not None and sh_warmup_every:
        raise ValueError("sh_warmup_every needs the built-in loss "
                         "(drives config.sh_degree); drop loss_fn")

    def _build_loss(cfg):
        if mesh is not None:
            from jax.sharding import PartitionSpec as P

            n_d = mesh.shape["d"]
            n_g = dict(mesh.shape).get("g", 1)
            n_views = _num_views(cameras)
            if n_views % n_d:
                raise ValueError(f"{n_views} views not divisible by "
                                 f"mesh 'd' axis {n_d}")
            cam_specs = jax.tree.map(lambda _: P("d"), cameras)
            tp = n_g > 1 and method == "tiled" and loss_fn is None

            if tp:
                # TENSOR-PARALLEL training (gaussian axis "g"): scene
                # parameters, gradients, and adam state shard over "g";
                # each chip projects its own shard, the projected
                # fields all_gather, each chip rasterizes its row slab
                # through the custom-VJP core, and the all_gather
                # transpose (psum-scatter) routes pixel-side cotangents
                # back to the owning shard — the >HBM-scene training
                # plan (SURVEY §2.3 TP row extended to training).
                from splat_tpu.parallel.sharding import (
                    render_slab_tiled_diff)

                def shard_loss_tp(r, cams_l, targets_l):
                    def one_view(ct):
                        cam_l, tgt = ct
                        img = render_slab_tiled_diff(r.to_scene(), cam_l,
                                                     cfg)
                        err = img - tgt
                        l = (jnp.mean(err * err)
                             + l1_weight * jnp.mean(jnp.abs(err)))
                        if dssim_weight:
                            l = l + dssim_weight * (1.0 - ssim(img, tgt))
                        return l
                    losses = jax.lax.map(one_view, (cams_l, targets_l))
                    l = jnp.mean(losses)
                    return jax.lax.pmean(jax.lax.pmean(l, "d"), "g")

                mapped = jax.shard_map(
                    shard_loss_tp, mesh=mesh,
                    in_specs=(jax.tree.map(lambda _: P("g"), raw),
                              cam_specs, P("d")),
                    out_specs=P(), check_vma=False)
                return lambda r: mapped(r, cameras, targets)

            def shard_loss(r, cams_l, targets_l):
                l = photometric_loss(r, cams_l, targets_l, cfg,
                                     l1_weight, chunk,
                                     dssim_weight=dssim_weight,
                                     method=method)
                return jax.lax.pmean(l, "d")

            mapped = jax.shard_map(
                shard_loss, mesh=mesh,
                in_specs=(jax.tree.map(lambda _: P(), raw), cam_specs,
                          P("d")),
                out_specs=P(), check_vma=False)
            return lambda r: mapped(r, cameras, targets)
        return lambda r: photometric_loss(
            r, cameras, targets, cfg, l1_weight, chunk,
            dssim_weight=dssim_weight, method=method)

    _loss_cache: dict = {}

    def _loss_for_degree(deg):
        if loss_fn is not None:
            return loss_fn
        if deg not in _loss_cache:
            _loss_cache[deg] = _build_loss(
                dataclasses.replace(config, sh_degree=deg))
        return _loss_cache[deg]

    if loss_fn is None and method == "tiled":
        _check_tiled_capacity(scene, cameras, config)

    _tp_g = (dict(mesh.shape).get("g", 1)
             if mesh is not None and method == "tiled" and loss_fn is None
             else 1)

    def _check_tp_divisibility(n):
        if _tp_g > 1 and n % _tp_g:
            raise ValueError(
                f"TP training shards the {n} gaussians over the mesh "
                f"'g' axis ({_tp_g}): N must be divisible (pad the "
                f"scene, or set densify pad_multiple to a multiple of "
                f"{_tp_g})")

    _check_tp_divisibility(scene.num_gaussians)
    if _tp_g > 1 and densify_every:
        pm = (densify_kwargs or {}).get("pad_multiple", 256)
        if pm % _tp_g:
            raise ValueError(
                f"TP training with densification needs densify "
                f"pad_multiple ({pm}) divisible by the 'g' axis "
                f"({_tp_g}) so every topology keeps N % g == 0")

    label_tree = RawParams(means="means", quats="quats",
                           log_scales="log_scales",
                           logit_opacities="logit_opacities", sh="sh")
    decay = {k: 1.0 for k in scales}
    decay.update(lr_decay or {})
    # scale_by_adam + an explicit per-leaf -lr multiply == optax.adam,
    # but lets the lr follow a TRACED global step (the decay schedule
    # survives the per-segment opt-state re-init densification forces).
    opt = optax.multi_transform(
        {k: optax.scale_by_adam() for k in scales}, label_tree)

    def _lr_tree(gstep):
        frac = gstep / jnp.float32(max(steps - 1, 1))
        return jax.tree.map(
            lambda name: -lr * scales[name]
            * jnp.exp(frac * jnp.float32(math.log(decay[name]))),
            label_tree)

    @partial(jax.jit, static_argnames=("length", "seg_loss", "demand_fn"))
    def run_segment(raw, opt_state, step0, length, seg_loss,
                    demand_fn=None):
        def body(carry, i):
            raw, opt_state, gsum, dmax = carry
            loss, grads = jax.value_and_grad(seg_loss)(raw)
            gnorm = jnp.linalg.norm(grads.means, axis=1)
            if demand_fn is not None:
                # demand of the state the gradient was computed AT
                dmax = jnp.maximum(dmax, demand_fn(raw))
            updates, opt_state = opt.update(grads, opt_state)
            updates = jax.tree.map(
                lambda u, s: u * s, updates,
                _lr_tree(step0 + i.astype(jnp.float32)))
            raw = optax.apply_updates(raw, updates)
            return (raw, opt_state, gsum + gnorm, dmax), loss

        gsum0 = jnp.zeros(raw.means.shape[0], jnp.float32)
        (raw, opt_state, gsum, dmax), losses = jax.lax.scan(
            body, (raw, opt_state, gsum0, jnp.int32(0)),
            jnp.arange(length))
        return raw, opt_state, gsum, dmax, losses

    # Segment boundaries: the union of densification, opacity-reset, and
    # SH-warmup events (each segment is one jitted lax.scan; events are
    # host-side python between segments — the classic phase structure).
    bounds: set[int] = set()
    for k in (densify_every, opacity_reset_every):
        if k and k > 0:
            bounds.update(range(k, steps, k))
    if sh_warmup_every and sh_warmup_every > 0:
        bounds.update(range(sh_warmup_every,
                            min(config.sh_degree * sh_warmup_every + 1,
                                steps),
                            sh_warmup_every))
    edges = [0] + sorted(bounds) + [steps]

    def _degree_at(step):
        if not sh_warmup_every:
            return config.sh_degree
        return min(config.sh_degree, step // sh_warmup_every)

    all_losses = []
    densify_log = []
    opt_state = opt.init(raw)
    monitor = (_slot_demand_fn(cameras, config)
               if loss_fn is None and method == "tiled" else None)

    def _capacity_margin_check(dmax_val, n):
        """Host-side per-segment-boundary capacity check against the
        IN-SEGMENT measured demand (the 5% up-front margin is a
        heuristic; footprints drift during optimization)."""
        nonlocal config
        k_cap = int(config.max_dup_factor * n)
        if dmax_val > k_cap:
            # truncation DID occur inside this segment
            new_dup = math.ceil(dmax_val * 1.05 / n * 20) / 20
            warnings.warn(
                f"fit: splat footprints grew past the capacity margin "
                f"mid-segment (peak demand {dmax_val} slots > k_cap "
                f"{k_cap}); that segment's gradients were computed on a "
                f"truncated forward — raising max_dup_factor to "
                f"{new_dup} for the remaining steps", stacklevel=2)
        elif dmax_val * 1.05 > k_cap:
            # approaching the ceiling: raise preemptively (free here —
            # the boundary is already a host sync point)
            new_dup = math.ceil(dmax_val * 1.10 / n * 20) / 20
        else:
            return
        config = dataclasses.replace(config, max_dup_factor=new_dup)
        _loss_cache.clear()
    # Positional-gradient statistic for densification accumulates over
    # the FULL window since the last densification (the recipe's
    # definition), even when warmup/opacity-reset boundaries split that
    # window into several jitted segments.
    gsum_acc, gsteps = None, 0
    for i in range(len(edges) - 1):
        b0, b1 = edges[i], edges[i + 1]
        seg = b1 - b0
        raw, opt_state, gsum, dmax, losses = run_segment(
            raw, opt_state, jnp.float32(b0), length=seg,
            seg_loss=_loss_for_degree(_degree_at(b0)),
            demand_fn=monitor)
        all_losses.append(losses)
        gsum_acc = gsum if gsum_acc is None else gsum_acc + gsum
        gsteps += seg
        if progress_cb is not None:
            progress_cb(b1, float(losses[-1]), raw.means.shape[0])
        if monitor is not None:
            _capacity_margin_check(int(dmax), raw.means.shape[0])
        if b1 == steps:
            break
        if densify_every and b1 % densify_every == 0:
            raw, stats = densify_and_prune(
                raw, jnp.asarray(gsum_acc) / gsteps,
                **(densify_kwargs or {}))
            densify_log.append(stats)
            _check_tp_divisibility(raw.means.shape[0])
            opt_state = opt.init(raw)  # topology changed
            gsum_acc, gsteps = None, 0  # stats window restarts
            if loss_fn is None and method == "tiled":
                # Re-audit the capacity: pruning shrinks k_cap
                # (= max_dup_factor * N) while the surviving splats keep
                # their footprints, so a config that fit the INITIAL
                # scene can silently truncate after a topology change.
                # Auto-raise (with a warning) instead of killing a long
                # run mid-flight — the bump takes effect with the re-jit
                # the new N forces anyway.
                need = _required_dup_factor(raw.to_scene(), cameras,
                                            config)
                if config.max_dup_factor < need:
                    new_dup = math.ceil(need * 20) / 20
                    warnings.warn(
                        f"fit: densification left max_dup_factor="
                        f"{config.max_dup_factor} below the measured "
                        f"slot demand ({need:.2f}); raising it to "
                        f"{new_dup} — a truncated forward would bias "
                        f"every gradient", stacklevel=2)
                    config = dataclasses.replace(
                        config, max_dup_factor=new_dup)
                    _loss_cache.clear()
        if opacity_reset_every and b1 % opacity_reset_every == 0:
            # INRIA recipe: clamp every opacity down to a small value so
            # floaters must re-earn their alpha; the opacity group's adam
            # moments reset surgically (stale momentum would instantly
            # undo the clamp), everything else keeps its state.
            cap = math.log(opacity_reset_to / (1.0 - opacity_reset_to))
            raw = dataclasses.replace(
                raw, logit_opacities=jnp.minimum(
                    raw.logit_opacities, jnp.float32(cap)))
            fresh = opt.init(raw)
            opt_state = opt_state._replace(inner_states={
                **opt_state.inner_states,
                "logit_opacities":
                    fresh.inner_states["logit_opacities"]})

    losses = jnp.concatenate(all_losses)
    final = float(losses[-1])
    return FitResult(scene=raw.to_scene(), raw=raw, losses=losses,
                     final_loss=final, densify_log=tuple(densify_log))
