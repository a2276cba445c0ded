"""Kernel route: how every Pallas kernel of the renderer is compiled.

One function decides it for all of them, from the platform JAX runs on:

* ``gpu``: compiled Pallas through Triton (``backend="triton"``);
* ``cpu`` (the test backend): the same kernel in interpret mode;
* anything else: an error.  There is no quiet fallback to interpret mode
  or to a reference implementation on an accelerator.
"""

from __future__ import annotations

import jax
from jax.experimental.pallas import triton as pl_triton


def kernel_route(num_warps: int = 4, platform: str | None = None) -> dict:
    """Keyword arguments for ``pl.pallas_call`` on this platform.

    ``num_warps`` is the Triton block's warp count (ignored when
    interpreting).  ``platform`` defaults to ``jax.default_backend()``.
    """
    platform = platform or jax.default_backend()
    if platform == "gpu":
        return {"backend": "triton", "interpret": False,
                "compiler_params": pl_triton.CompilerParams(
                    num_warps=num_warps, num_stages=1)}
    if platform == "cpu":
        return {"backend": "triton", "interpret": True}
    raise RuntimeError(
        f"no kernel route for platform {platform!r}: the tiled renderer "
        "runs compiled on 'gpu' and interpreted on 'cpu'")
