"""Launch plumbing shared by the Monte Carlo Pallas kernels.

The kernels (:mod:`.ia_pallas`, :mod:`.bd_pallas`,
:mod:`.alamouti_pallas`) are Pallas programs for the Triton route. Each
program simulates one block of independent realizations of one
repetition and writes its own
output element; this module holds what they share around that: the
backend rule, the Triton compiler parameters and the absolute element
index of a block. The split of the repetition axis over a mesh is
:func:`pyphysim_tpu.parallel.shard_reps`.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.experimental.pallas import triton

__all__ = ["require_kernel_backend", "TRITON_PARAMS", "check_block",
           "block_elements"]


def require_kernel_backend(interpret: bool) -> None:
    """A compiled kernel needs a GPU: without one, building it raises
    unless ``interpret=True`` asks for the Pallas interpreter."""
    if not interpret and jax.default_backend() != "gpu":
        raise RuntimeError(
            "this Pallas kernel is compiled for the GPU (Triton); the "
            f"default backend is {jax.default_backend()!r}. Pass "
            "interpret=True to run it under the Pallas interpreter.")


# 4 warps, no software pipelining: the kernels keep one realization per
# thread in registers and load nothing in a loop (best of the block and
# warp configurations measured on an H100, PERF.md)
TRITON_PARAMS = triton.CompilerParams(num_warps=4, num_stages=1)


def check_block(tile: int, lane: int) -> None:
    """Triton blocks are powers of two."""
    for name, v in (("tile", tile), ("lane", lane)):
        if v < 1 or v & (v - 1):
            raise ValueError(f"{name} must be a power of two, got {v}")


def block_elements(s, tile: int, lane: int):
    """Absolute element indices ``(tile, lane)`` (uint32) of block ``s``
    of a repetition laid out as ``num_tiles`` blocks of tile x lane."""
    row = s * tile + jax.lax.broadcasted_iota(jnp.int32, (tile, lane), 0)
    col = jax.lax.broadcasted_iota(jnp.int32, (tile, lane), 1)
    return (row * lane + col).astype(jnp.uint32)
