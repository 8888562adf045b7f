"""DFT as a matmul: matmul-based FFT for real-pair complex tensors.

Device-native replacement for ``np.fft.fft/ifft`` in the OFDM chain (reference:
pyphysim/modulators/ofdm.py:370-429 uses numpy FFT row-wise). On an accelerator the
systolic array makes an O(N^2) DFT *matmul* faster than a butterfly network
for the OFDM-sized transforms used here (N = 64..4096), because the matmul
runs at matrix-unit speed while a radix butterfly is a long dependency chain of
vector shuffles. Two modes:

  * direct:    X = x @ W          — one complex (N, N) matmul
                                    (3 real matmuls via the Gauss trick)
  * four-step: N = N1 * N2        — two skinny matmuls + a twiddle,
                                    O(N (N1 + N2)) work; picked automatically
                                    for N >= FOUR_STEP_MIN when N factors
                                    nicely. (Bailey's algorithm.)

DFT matrices are built once on host in float64 and cached per (N, dtype).
Transforms apply over the LAST axis and batch over all leading axes — the
batch dimension becomes the matmul M dimension, which is exactly what keeps
the matrix units full at Monte Carlo batch sizes.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .cplx import CArray

__all__ = ["fft", "ifft", "dft_matrix", "fftshift_indexes"]

FOUR_STEP_MIN = 256  # direct matmul below this size


@functools.lru_cache(maxsize=64)
def _dft_mats(n: int, sign: int, dtype_name: str) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side (cos, sin) parts of the DFT matrix W[a, b] =
    exp(sign * 2j pi a b / n). Cached; cast to the requested dtype."""
    a = np.arange(n)
    # exponent mod n in int space avoids float64 rounding of huge products
    phase = (2.0 * np.pi / n) * np.outer(a, a % n)
    re = np.cos(phase)
    im = np.sin(phase) * sign
    dt = np.dtype(dtype_name)
    return re.astype(dt), im.astype(dt)


def dft_matrix(n: int, inverse: bool = False,
               dtype=jnp.float32) -> CArray:
    """The (N, N) DFT matrix as a CArray (no normalization)."""
    sign = 1 if inverse else -1
    re, im = _dft_mats(n, sign, np.dtype(dtype).name)
    return CArray(jnp.asarray(re), jnp.asarray(im))


def _apply_dft(x: CArray, w: CArray, precision) -> CArray:
    """(... , N) @ (N, N) complex matmul via 3 real matmuls."""
    t1 = jnp.matmul(x.re, w.re, precision=precision)
    t2 = jnp.matmul(x.im, w.im, precision=precision)
    t3 = jnp.matmul(x.re + x.im, w.re + w.im, precision=precision)
    return CArray(t1 - t2, t3 - t1 - t2)


def _best_factorization(n: int) -> Optional[Tuple[int, int]]:
    """Most-square factorization n = n1 * n2 with n1 <= n2; None if prime."""
    best = None
    f = int(math.isqrt(n))
    while f >= 2:
        if n % f == 0:
            best = (f, n // f)
            break
        f -= 1
    return best


@functools.lru_cache(maxsize=64)
def _twiddle(n1: int, n2: int, sign: int,
             dtype_name: str) -> Tuple[np.ndarray, np.ndarray]:
    """Four-step twiddle T[k1, n2] = exp(sign * 2j pi k1 n2 / (n1 n2))."""
    phase = (2.0 * np.pi / (n1 * n2)) * np.outer(np.arange(n1), np.arange(n2))
    dt = np.dtype(dtype_name)
    return np.cos(phase).astype(dt), (np.sin(phase) * sign).astype(dt)


def _fft_impl(x: CArray, inverse: bool, precision) -> CArray:
    n = x.shape[-1]
    sign = 1 if inverse else -1
    fac = _best_factorization(n) if n >= FOUR_STEP_MIN else None
    if fac is None:
        out = _apply_dft(x, dft_matrix(n, inverse, x.dtype), precision)
    else:
        n1, n2 = fac
        batch = x.shape[:-1]
        # A[..., n1, n2] with flat index n = n1*n2_len + n2
        a = x.reshape(batch + (n1, n2))
        # Step 1: DFT size n1 over axis -2  ==  (W_N1 @ A) via transpose
        w1 = dft_matrix(n1, inverse, x.dtype)
        b = _apply_dft(a.swapaxes(-1, -2), w1, precision).swapaxes(-1, -2)
        # Step 2: twiddle
        tr, ti = _twiddle(n1, n2, sign, np.dtype(x.dtype).name)
        tw = CArray(jnp.asarray(tr), jnp.asarray(ti))
        c = CArray(b.re * tw.re - b.im * tw.im,
                   b.re * tw.im + b.im * tw.re)
        # Step 3: DFT size n2 over last axis
        w2 = dft_matrix(n2, inverse, x.dtype)
        d = _apply_dft(c, w2, precision)
        # Output index k = k2 * n1 + k1  ->  transpose (k1, k2) and flatten
        out = d.swapaxes(-1, -2).reshape(batch + (n,))
    if inverse:
        out = CArray(out.re / n, out.im / n)
    return out


def fft(x: CArray, n: Optional[int] = None,
        precision=jax.lax.Precision.HIGHEST) -> CArray:
    """DFT over the last axis (batched over leading axes), numpy ``fft``
    convention (no normalization).

    ``precision`` controls the matmul accumulation mode: the device default
    (bf16 inputs) gives ~0.4% relative error, visible in equalization —
    so this defaults to HIGHEST (true fp32). Pass
    ``jax.lax.Precision.DEFAULT`` to trade accuracy for throughput.
    """
    if n is not None and n != x.shape[-1]:
        x = _pad_last(x, n)
    return _fft_impl(x, inverse=False, precision=precision)


def ifft(x: CArray, n: Optional[int] = None,
         precision=jax.lax.Precision.HIGHEST) -> CArray:
    """Inverse DFT over the last axis, numpy ``ifft`` convention (1/N)."""
    if n is not None and n != x.shape[-1]:
        x = _pad_last(x, n)
    return _fft_impl(x, inverse=True, precision=precision)


def _pad_last(x: CArray, n: int) -> CArray:
    cur = x.shape[-1]
    if n < cur:
        return x[..., :n]
    pad = [(0, 0)] * (x.ndim - 1) + [(0, n - cur)]
    return CArray(jnp.pad(x.re, pad), jnp.pad(x.im, pad))


def fftshift_indexes(n: int) -> np.ndarray:
    """Host-side index permutation equivalent to ``np.fft.fftshift``."""
    return np.concatenate([np.arange((n + 1) // 2, n), np.arange((n + 1) // 2)])
