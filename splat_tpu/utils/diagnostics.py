"""Observability: profiling hooks, scene health checks, frame stats.

The reference's entire observability story is one wall-clock print
(reference: src/main.rs:71-77).  Here (SURVEY §5):

* :func:`profile_trace` — TensorBoard/XPlane trace of a render via
  ``jax.profiler`` (the ``--profile`` flag story);
* :func:`scene_health` — NaN/Inf/range audit of a loaded scene (the
  "sanitizer" role; XLA has no UB to race-detect, bad *data* is the actual
  failure mode: corrupted PLYs, over-trained exploding gaussians);
* :func:`frame_report` — per-frame render statistics (visible count, pair
  count, tile occupancy, overflow) from the tiled renderer's stats output;
* :class:`StageTimer` — coarse host-side stage timing with device fences.
"""

from __future__ import annotations

import contextlib
import time
from typing import Iterator

import numpy as np


@contextlib.contextmanager
def profile_trace(logdir: str) -> Iterator[None]:
    """Capture a device profile of the enclosed block into ``logdir``.

    View with TensorBoard's profile plugin, or read the ``.xplane.pb``
    with ``jax.profiler.ProfileData``.  A profiler failure raises.
    """
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def scene_health(scene) -> dict:
    """Audit a scene for data problems.  Host-side, no device work.

    Returns a dict with per-field nan/inf counts and suspicious-value
    statistics; ``ok`` is True when the scene is renderable as-is.
    """
    d = scene.to_numpy()
    report: dict = {"ok": True, "num_gaussians": int(scene.num_gaussians)}
    for name, arr in d.items():
        nan = int(np.isnan(arr).sum())
        inf = int(np.isinf(arr).sum())
        entry = {"nan": nan, "inf": inf}
        if nan or inf:
            report["ok"] = False
        report[name] = entry
    if scene.num_gaussians:
        report["scales"]["huge"] = int((d["scales"] > 1e3).sum())
        report["opacities"]["out_of_range"] = int(
            ((d["opacities"] < 0) | (d["opacities"] > 1)).sum())
        qn = np.linalg.norm(d["quats"], axis=1)
        report["quats"]["unnormalized"] = int(
            (np.abs(qn - 1.0) > 1e-3).sum())
        if (report["opacities"]["out_of_range"]
                or report["quats"]["unnormalized"]):
            report["ok"] = False
    return report


def frame_report(scene, camera, config=None) -> dict:
    """Render one frame with stats and return a host-side report."""
    import jax

    from splat_tpu.render.tiled import render_tiled

    img, stats = jax.jit(
        lambda s, c: render_tiled(s, c, config, return_stats=True))(
            scene, camera)
    stats = {k: float(v) for k, v in jax.device_get(stats).items()}
    img = np.asarray(img)
    stats.update({
        "height": img.shape[0], "width": img.shape[1],
        "mean_pixel": float(img.mean()),
        "nonzero_pixel_frac": float((img.max(-1) > 0).mean()),
    })
    return stats


class StageTimer:
    """Host-side stage timing with an explicit device fence per stage.

    Useful for coarse breakdowns; for per-op device timing use
    :func:`profile_trace`.
    """

    def __init__(self):
        self.times: dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        import jax

        t0 = time.perf_counter()
        yield
        # fence: cheap sync point
        jax.device_get(jax.numpy.zeros(()))
        self.times[name] = self.times.get(name, 0.0) + (
            time.perf_counter() - t0)

    def summary(self) -> str:
        total = sum(self.times.values()) or 1.0
        lines = [f"{k:>12}: {v * 1e3:8.2f} ms ({v / total * 100:4.1f}%)"
                 for k, v in self.times.items()]
        return "\n".join(lines)
