"""Counter-based random bits for the Monte Carlo kernels.

Threefry-2x32 (Salmon et al., "Parallel random numbers: as easy as 1, 2,
3", SC 2011; 20 rounds, the same function as
``jax.extend.random.threefry_2x32``) written once in plain ``uint32``
``jax.numpy`` operations: adds, xors and shifts, no 64-bit arithmetic.
The identical code therefore runs

* inside a Pallas kernel compiled for the GPU (Triton lowers every
  operation used here),
* inside the same kernel under the Pallas interpreter on the CPU, and
* in the plain XLA references the kernels are checked against,

and all three draw the SAME bits for the same coordinates.

Stream contract shared by the kernels (``ops/ia_pallas.py``,
``ops/bd_pallas.py``, ``ops/alamouti_pallas.py``): the key is
``(seed, absolute attempt index)`` and the counter is
``(element index, stream salt)``, where the element index is absolute
within the attempt. A word depends only on those coordinates, never on
the block size, the chunk of attempts a call covers or the device that
computes it, so results are chunk-size invariant, resumable, and
bit-identical between sharded and unsharded runs.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["threefry2x32", "random_bits", "channel_planes", "u11",
           "gauss_half"]

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
# largest float32 below 1: the two-sided clamp that keeps erf_inv finite
_CLIP = 0.99999994


def _u32(x):
    x = jnp.asarray(x)
    return x if x.dtype == jnp.uint32 else x.astype(jnp.uint32)


def _rotl(x, r: int):
    return (x << r) | (x >> (32 - r))


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 block function: key ``(k0, k1)``, counter
    ``(x0, x1)`` (uint32, broadcastable) -> two uint32 words."""
    k0, k1, x0, x1 = _u32(k0), _u32(k1), _u32(x0), _u32(x1)
    ks = (k0, k1, k0 ^ k1 ^ jnp.uint32(_PARITY))
    x0 = x0 + ks[0]
    x1 = x1 + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r)
            x1 = x1 ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + jnp.uint32(i + 1)
    return x0, x1


def random_bits(seed, attempt, index, stream: int):
    """Two independent uint32 words for element ``index`` of stream
    ``stream`` of attempt ``attempt`` under ``seed``."""
    return threefry2x32(seed, attempt, index, jnp.uint32(stream))


def channel_planes(seed, attempt, index, n_entries: int):
    """``2 * n_entries`` uint32 bit planes: the (re, im) words of
    complex entry ``q`` are the two words of stream ``q``."""
    planes = []
    for q in range(n_entries):
        planes.extend(random_bits(seed, attempt, index, q))
    return planes


def u11(bits):
    """uint32 bits -> float32 uniform on [-1, 1] (the top 64 words
    round to exactly 1.0, see :func:`gauss_half`): one multiply on the
    signed-int32 view."""
    i32 = bits if bits.dtype == jnp.int32 else bits.astype(jnp.int32)
    return i32.astype(jnp.float32) * jnp.float32(2.0 ** -31)


def gauss_half(bits):
    """uint32 bits -> N(0, 1/2) by the inverse CDF, ``erf_inv(u)``.

    Both tails are clamped: the int32 -> float32 cast in :func:`u11`
    rounds the 64 largest int32 values to exactly 1.0, and
    ``erf_inv(1.0) = inf`` would poison every decision it reaches
    (at ~1e10 draws per second that is a spurious error floor near
    1e-8). The clamp limits a draw to about 3.9 standard deviations,
    the same reach as ``jax.random.normal`` in float32."""
    z = jnp.clip(u11(bits), jnp.float32(-_CLIP), jnp.float32(_CLIP))
    return jax.lax.erf_inv(z)
