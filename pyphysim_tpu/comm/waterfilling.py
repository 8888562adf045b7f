"""Water-filling power allocation.

Behavioral counterpart of ``pyphysim/comm/waterfilling.py:15-90``:
iteratively raise the water level, dropping channels whose required power
is negative, until the total power constraint is met. Host path is plain
numpy; :func:`doWF_jit` is a fixed-iteration jittable variant (the
data-dependent channel-dropping loop becomes a masked scan) for use inside
compiled Monte Carlo kernels.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["doWF", "doWF_jit"]


def doWF(vtChannels: np.ndarray, dPt: float, noiseVar: float = 1.0,
         Es: float = 1.0) -> Tuple[np.ndarray, float]:
    """Classic water-filling over parallel channel POWER gains.

    Returns ``(optimum_powers, water_level)``.

    >>> import numpy as np
    >>> p, mu = doWF(np.array([0.5, 1.0, 2.0]), dPt=10.0)
    >>> p.round(4), round(mu, 4)
    (array([2.5, 3.5, 4. ]), 4.5)
    >>> float(p.sum())           # total power constraint holds
    10.0
    >>> p, _ = doWF(np.array([0.1, 10.0]), dPt=1.0)
    >>> p                        # bad channel dropped entirely
    array([0., 1.])
    """
    vtChannels = np.asarray(vtChannels, dtype=float)
    n = vtChannels.size
    order = np.argsort(vtChannels)[::-1]
    g_sorted = vtChannels[order]

    remove = 0
    while True:
        kept = n - remove
        # water level touching the worst kept channel
        min_mu = noiseVar / (Es * g_sorted[kept - 1])
        powers = min_mu - noiseVar / (Es * g_sorted[:kept])
        if powers.sum() <= dPt or remove >= n - 1:
            break
        remove += 1

    kept = n - remove
    powers = powers + (dPt - powers.sum()) / kept
    opt = np.zeros(n)
    opt[order[:kept]] = powers
    mu = powers[0] + noiseVar / g_sorted[0]
    return opt, float(mu)


def doWF_jit(gains: jnp.ndarray, total_power: float,
             noise_var: float = 1.0) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Jittable water-filling with a fixed number of iterations.

    Same solution as :func:`doWF` expressed branch-free: for each possible
    number of kept channels compute the water level in closed form, then
    select the largest kept-count whose powers are all nonnegative.
    Batched over leading dims of ``gains``.
    """
    gains = jnp.asarray(gains)
    n = gains.shape[-1]
    inv = noise_var / gains                             # (..., n)
    # Stable ascending RANK of each 1/gain via pairwise comparisons
    # (ties broken by index): no sort, no argsort, no take_along_axis —
    # gathers vectorize poorly on accelerators, and for the n <= ~16 stream
    # counts here the O(n^2) comparison mask is a handful of elementwise ops.
    idx = jnp.arange(n)
    lt = inv[..., None, :] < inv[..., :, None]          # inv_j < inv_i
    tie = (inv[..., None, :] == inv[..., :, None]) & (idx < idx[:, None])
    rank = jnp.sum(lt | tie, axis=-1)                   # (..., n) 0..n-1
    # keeping the k+1 best channels (smallest 1/gain):
    keep = rank[..., None, :] <= idx[:, None]           # (..., k, i)
    cum_inv = jnp.sum(jnp.where(keep, inv[..., None, :], 0.0), axis=-1)
    at_k = rank[..., None, :] == idx[:, None]
    worst_inv = jnp.sum(jnp.where(at_k, inv[..., None, :], 0.0), axis=-1)
    # water level if the k+1 best channels are kept:
    mu_k = (total_power + cum_inv) / (idx + 1.0)        # (..., n)
    # feasible if the worst kept channel still gets nonnegative power
    feasible = mu_k >= worst_inv
    # the optimum keeps as many channels as possible
    kept = jnp.sum(feasible, axis=-1)                   # (...,)
    mu = jnp.sum(mu_k * jax.nn.one_hot(kept - 1, n, dtype=mu_k.dtype),
                 axis=-1)
    # powers come straight from the water level — no unsort needed
    powers = jnp.maximum(mu[..., None] - inv, 0.0)
    return powers, mu
