"""Render configuration.

The reference hard-codes every knob as a compile-time constant (resolution at
src/main.rs:9-10, sh_dim=15 at src/pipelines.rs:100,189, the low-pass filter
values at src/gaussians.rs:156-157 and :517-518, fovy/znear/zfar at
src/camera.rs:24-28).  Here each one is a named, documented field.

All fields are *static* with respect to jit: a new config triggers a
recompile, which is the intended usage (configs change rarely; camera pose
changes every frame and is a traced input).
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static configuration for the renderer.

    Attributes:
      sh_degree: spherical-harmonics degree used for view-dependent color,
        0..3.  The reference renderer evaluates only degrees 0-2 because both
        pipelines pass ``sh_dim=15`` (src/pipelines.rs:100,189) even though
        all 48 coefficients are loaded; we default to the full degree 3 like
        the notebook prototype, and ``sh_degree=2`` reproduces the Rust
        behavior.
      lowpass: value added to the diagonal of the projected 2D covariance so
        every splat is at least ~1 px wide.  The reference is internally
        inconsistent: 0.01 in the AoS path (src/gaussians.rs:156-157) vs 0.3
        in the SoA path (src/gaussians.rs:517-518) and the notebook.  We
        default to 0.3 (the notebook/SoA convention — our parity oracle).
      alpha_clamp: upper clamp on per-splat alpha (reference:
        src/pipelines.rs:139 ``0.99f32.min(alpha * power.exp())``).
      alpha_min: splats contributing less than this alpha are skipped
        (reference: src/pipelines.rs:140-143, 1/255).
      tile_px: tile width in pixels for the tile-binned rasterizer (and
        the height too, unless tile_py is set).  The compositing kernel
        spreads a tile's pixels across one program, so the tile's pixel
        count must be a power of two.  16 (the INRIA rasterizer's tile)
        beat 32 on an H100 at 1M gaussians, 1080p: 1.920 vs 2.055
        ms/frame on the random scene and 3.626 vs 12.985 on the surface
        scene, whose longest tile range fell from 43.5k to 19.2k pairs
        (PERF.md).
      max_dup_factor: capacity of the (gaussian, tile) duplication buffer as
        a multiple of N.  The INRIA-style binning produces a data-dependent
        number of pairs; XLA needs a static bound.  Overflow is detected and
        reported (never silently truncated).
      chunk: pairs the compositing kernel walks between two checks of
        the tile's saturation exit (the reference walks batches of the
        same size, so both exit at the same pair).
      background: color composited under the accumulated transmittance
        (reference clears to black, src/main.rs:73).
    """

    sh_degree: int = 3
    lowpass: float = 0.3
    alpha_clamp: float = 0.99
    alpha_min: float = 1.0 / 255.0
    # Training-path (render_tiled_diff) saturation exit at the INFERENCE
    # threshold: once every pixel of a tile has transmittance < alpha_min
    # the forward walk stops and the backward walks only the composited
    # prefix.  An INRIA-inspired whole-tile exit at alpha_min, checked
    # every `chunk` pairs — the inference path's exit (INRIA stops each
    # pixel at T < 1e-4) — and the custom VJP stays EXACT for the truncated
    # function it actually computes — the approximation is only vs the
    # full walk, bounded by the < alpha_min residual transmittance.
    # Default off: the default diff forward composites every pair and
    # cuts only at the f32-exact exp-underflow point (diff.SAT_CUT_LOG).
    train_sat_exit: bool = False
    tile_px: int = 16
    # Tile height in pixels; 0 means square tiles (= tile_px).  Rectangular
    # tiles trade pair count against per-pair pixel work: a splat's tile
    # span grows on the short axis but each pair covers fewer pixels.
    tile_py: int = 0
    # Duplication capacity as a multiple of N.  Every K-sized binning op
    # (expansion, sort, feature gather) scales with it, so TUNE IT DOWN
    # for throughput (the bench sizes it per scene, guarded by its
    # overflow audit; pair_stats() suggests a capacity for any
    # scene+pose).  The default stays
    # conservative because the raw render_fn path has no overflow check;
    # render()/CLI/bench all detect and surface overflow.
    max_dup_factor: float = 4.0
    chunk: int = 32
    # Drop (gaussian, tile) pairs whose best-case alpha anywhere in the tile
    # is below alpha_min (lossless: the kernel's per-pixel cutoff would zero
    # them anyway).  Default off: it costs extra K-sized passes in binning.
    cull_pairs: bool = False
    # Low bits of the packed per-pair sort key (binning.py step 3/4):
    #   "depth" (default): (tile ‖ quantized depth), with the gaussian
    #     index riding the sort as ONE int32 payload operand.  Skips the
    #     whole N-side depth machinery (the argsort AND the 8-row gather
    #     into depth order) for one payload operand through the sort.
    #     Front-to-back order within a tile is exact up to the
    #     quantization: depth ties at min(24, 32 - tile_bits) >= ~18
    #     bits per frame-depth-range composite in arbitrary order (the
    #     reference CPU sort breaks such ties by original index).  The
    #     key always fits 32 bits.
    #   "rank": (tile ‖ depth rank) single-array key — exact tie-breaking
    #     (matches the reference's stable CPU sort bit-for-bit), at the
    #     cost of the N-side argsort + depth-order gather.
    binning_key: str = "depth"
    background: tuple[float, float, float] = (0.0, 0.0, 0.0)
    # Output an RGBA image: the fourth channel is the ACCUMULATED coverage
    # 1 - T (T = per-pixel transmittance after all splats), for compositing
    # renders over other content.  The reference's framebuffer alpha byte
    # stores only the LAST fragment's alpha (src/pipelines.rs:162-167, a
    # bug its own notebook fixes by accumulating); this is the notebook's
    # correct semantics.  RGB channels are unchanged (still blended over
    # config.background).
    alpha_channel: bool = False
    # What the composited channels CARRY.  "color" (default): SH-evaluated
    # RGB.  "depth": every channel is the splat's normalized view depth, so
    # the composite is the alpha-weighted expected depth sum(alpha_i T_i
    # d_i) — a grayscale depth map (near = dark, far = bright).  Pair with
    # alpha_channel=True and divide by the coverage channel for mean depth
    # on partially-covered pixels.  Binning, the compositing kernel, and the
    # sharded paths are untouched — only the per-gaussian color rows change
    # (ops/projection.encode_depth_color).  The reference has no depth
    # output; this is the 3DGS ecosystem's "expected depth" mode.
    render_mode: str = "color"
    # (near, far) view-depth range mapped to [0, 1] in depth mode.  None =
    # auto: the frame's visible depth min/max (per frame — an orbit's
    # mapping can shift between frames; pin an explicit range for stable
    # animations and metric use).  Ignored in color mode.
    depth_range: tuple[float, float] | None = None
    # Supersampled anti-aliasing: render at supersample x (H, W) and
    # box-filter down.  The reference's notebook cell 3 renders a
    # supersampled 2560x1440 target from a 1280x720 camera (SURVEY §2.1)
    # — same idea, as a config knob.  The camera's field of view is
    # unchanged (focal scales with resolution); cost scales ~k^2 in the
    # pixel stages and in pair count.  Applied by render_dense /
    # render_tiled (hence every public path) and mirrored by the oracle;
    # the sharded slab renderers ignore it (slab decomposition happens at
    # native resolution).
    supersample: int = 1
    # Radius of the splat bounding box in standard deviations.  The reference
    # uses 3-sigma quads (src/pipelines.rs:27).  ``math.inf`` selects
    # truncation-free rendering: with tight_radius (required), every bbox
    # becomes exactly the opacity-aware kill radius, which makes the raster
    # kernel's bbox compares redundant (the alpha_min test subsumes them —
    # marginal bound, ops/projection.py) so the kernel statically drops
    # them; the trade is slightly larger
    # bboxes (hence pairs) for high-opacity splats, up to
    # sqrt(2 ln(opacity/alpha_min)) ~ 3.33 sigma at opacity 0.99.
    sigma_cutoff: float = 3.0
    # Shrink each splat's bbox to the opacity-aware radius
    # sqrt(2·ln(opacity/alpha_min))·sigma when that is tighter than
    # sigma_cutoff.  Lossless: pixels outside it fail the kernel's alpha_min
    # cutoff anyway (marginal bound, see ops/projection.py); cuts
    # (gaussian, tile) pair counts for low-opacity splats.
    tight_radius: bool = True
    # Quirk-reproduction flags (PARITY.md): the reference's two stacks
    # disagree in places where one side is a plain bug; the defaults
    # follow the correct behavior and these opt-ins reproduce the buggy
    # one bit-for-bit for side-by-side comparisons against the reference.
    #
    # cov3d_transpose: build Sigma_3D as R^T diag(s^2) R — the notebook
    # prototype's transposed ordering (notes/00_Gaussian_Projection.ipynb
    # cell 1 computes M = S·R, Sigma = M^T·M), vs the active Rust
    # renderer's R diag(s^2) R^T (src/gaussians.rs:111, the default
    # here).  Implemented as quaternion conjugation: R(q*)=R(q)^T.
    cov3d_transpose: bool = False
    # sh_stale_eye: evaluate SH ray directions from the UN-ORBITED base
    # camera position.  The Rust viewer reads `camera.position` for SH
    # rays (src/pipelines.rs:99) but `compute_matrices` rotates a local
    # copy and never writes it back (src/camera.rs:41-68), so its
    # view-dependent color ignores orbiting.  Identity at yaw=pitch=0
    # and for SE3 cameras (no orbit state to go stale).
    sh_stale_eye: bool = False

    def __post_init__(self):
        if not (0 <= self.sh_degree <= 3):
            raise ValueError(f"sh_degree must be in [0,3], got {self.sh_degree}")
        if self.tile_px <= 0 or self.tile_py < 0:
            raise ValueError(f"tile sizes must be positive, got "
                             f"{self.tile_px}x{self.tile_py}")
        npix = self.tile_w * self.tile_h
        if npix & (npix - 1):
            raise ValueError(
                f"tile {self.tile_w}x{self.tile_h} has {npix} pixels; the "
                "compositing kernel needs a power of two")
        if self.chunk <= 0:
            raise ValueError(f"chunk must be positive, got {self.chunk}")
        if self.binning_key not in ("rank", "depth"):
            raise ValueError(f"binning_key must be 'rank' or 'depth', "
                             f"got {self.binning_key!r}")
        if not (isinstance(self.supersample, int) and self.supersample >= 1):
            raise ValueError(f"supersample must be an int >= 1, "
                             f"got {self.supersample!r}")
        if self.render_mode not in ("color", "depth"):
            raise ValueError(f"render_mode must be 'color' or 'depth', "
                             f"got {self.render_mode!r}")
        if self.depth_range is not None:
            lo, hi = self.depth_range
            if not (math.isfinite(lo) and math.isfinite(hi) and lo < hi):
                raise ValueError(f"depth_range must be finite (near, far) "
                                 f"with near < far, got {self.depth_range}")
        if not math.isfinite(self.sigma_cutoff) and not self.tight_radius:
            raise ValueError(
                "sigma_cutoff=inf requires tight_radius=True: without the "
                "opacity-aware radius every bbox covers the whole screen "
                "(pair count = N x tiles)")

    @property
    def tile_w(self) -> int:
        """Tile width in pixels."""
        return self.tile_px

    @property
    def tile_h(self) -> int:
        """Tile height in pixels (tile_py, defaulting to square tiles)."""
        return self.tile_py or self.tile_px
