"""Real-pair complex arithmetic — the foundation of the device compute path.

The original accelerator backend had no native complex dtype
support; XLA complex lowering is unavailable on this target (probed
empirically: any ``complex64`` op raises UNIMPLEMENTED). Instead of
translating the reference's numpy-complex code, every on-device complex
tensor in this framework is a :class:`CArray` — a pytree of two real arrays
``(re, im)`` — and complex arithmetic is built explicitly from real ops:

  * elementwise ops run on float32/bfloat16 lanes,
  * complex matmul lowers to THREE real matmuls (Gauss/Karatsuba trick)
    instead of four,
  * FFTs become DFT-matrix matmuls (`pyphysim_tpu.ops.fft`) that run on the
    matrix units — faster than a butterfly network of gathers,
  * complex linear solves / eigendecompositions lower to real operations on
    the standard 2Nx2N isomorphic embedding ``[[Ar, -Ai], [Ai, Ar]]``.

CArray is a NamedTuple, hence automatically a pytree: it vmaps, scans,
jits, shards and pytree-flattens with zero glue. Host boundaries convert
to/from numpy complex with :func:`from_numpy` / :meth:`CArray.to_numpy`.

This file replaces nothing in the reference (pyphysim is numpy-complex
throughout); it exists because the real-pair design demands it.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Union

import jax
import jax.numpy as jnp
import numpy as np

Scalar = Union[int, float, complex]

__all__ = [
    "CArray", "carray", "from_numpy", "to_numpy", "zeros", "ones", "full",
    "eye", "cexp", "exp", "csqrt", "matmul", "solve", "inv", "eigh", "ceig",
    "svd", "qr", "where", "sum", "mean", "stack", "concatenate", "outer",
    "einsum",
]


class CArray(NamedTuple):
    """A complex tensor as a pair of real arrays (re, im).

    Being a NamedTuple it is a pytree; all jax transforms apply. Methods
    mirror the ndarray surface the simulation code needs. Binary ops accept
    CArray, real jnp arrays, and python/numpy scalars (incl. complex).
    """

    re: jnp.ndarray
    im: jnp.ndarray

    # -- basic metadata ----------------------------------------------------

    @property
    def shape(self):
        return jnp.shape(self.re)

    @property
    def ndim(self):
        return jnp.ndim(self.re)

    @property
    def dtype(self):
        return jnp.asarray(self.re).dtype

    @property
    def size(self):
        return jnp.size(self.re)

    # -- conversion --------------------------------------------------------

    def to_numpy(self) -> np.ndarray:
        """Materialize as a host numpy complex array."""
        return np.asarray(self.re) + 1j * np.asarray(self.im)

    def astype(self, dtype) -> "CArray":
        return CArray(self.re.astype(dtype), self.im.astype(dtype))

    # -- unary -------------------------------------------------------------

    def conj(self) -> "CArray":
        return CArray(self.re, -self.im)

    def abs2(self) -> jnp.ndarray:
        """|x|^2 as a real array (avoids the sqrt of abs)."""
        return self.re * self.re + self.im * self.im

    def abs(self) -> jnp.ndarray:
        return jnp.sqrt(self.abs2())

    def angle(self) -> jnp.ndarray:
        return jnp.arctan2(self.im, self.re)

    @property
    def real(self) -> jnp.ndarray:
        return self.re

    @property
    def imag(self) -> jnp.ndarray:
        return self.im

    def __neg__(self) -> "CArray":
        return CArray(-self.re, -self.im)

    # -- binary ------------------------------------------------------------

    def __add__(self, other) -> "CArray":
        o = _coerce(other)
        return CArray(self.re + o.re, self.im + o.im)

    __radd__ = __add__

    def __sub__(self, other) -> "CArray":
        o = _coerce(other)
        return CArray(self.re - o.re, self.im - o.im)

    def __rsub__(self, other) -> "CArray":
        o = _coerce(other)
        return CArray(o.re - self.re, o.im - self.im)

    def __mul__(self, other) -> "CArray":
        if _is_real(other):
            return CArray(self.re * other, self.im * other)
        o = _coerce(other)
        return CArray(self.re * o.re - self.im * o.im,
                      self.re * o.im + self.im * o.re)

    __rmul__ = __mul__

    def __truediv__(self, other) -> "CArray":
        if _is_real(other):
            return CArray(self.re / other, self.im / other)
        o = _coerce(other)
        d = o.abs2()
        return CArray((self.re * o.re + self.im * o.im) / d,
                      (self.im * o.re - self.re * o.im) / d)

    def __rtruediv__(self, other) -> "CArray":
        o = _coerce(other)
        return o.__truediv__(self)

    def __matmul__(self, other) -> "CArray":
        return matmul(self, other)

    # -- shape ops ---------------------------------------------------------

    def reshape(self, *shape) -> "CArray":
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        return CArray(self.re.reshape(shape), self.im.reshape(shape))

    def ravel(self) -> "CArray":
        return CArray(self.re.ravel(), self.im.ravel())

    def transpose(self, *axes) -> "CArray":
        if len(axes) == 1 and isinstance(axes[0], (tuple, list)):
            axes = tuple(axes[0])
        axes = axes or None
        return CArray(jnp.transpose(self.re, axes), jnp.transpose(self.im, axes))

    def swapaxes(self, a: int, b: int) -> "CArray":
        return CArray(jnp.swapaxes(self.re, a, b), jnp.swapaxes(self.im, a, b))

    @property
    def mT(self) -> "CArray":
        """Matrix transpose of the trailing two axes."""
        return self.swapaxes(-1, -2)

    @property
    def mH(self) -> "CArray":
        """Conjugate (Hermitian) transpose of the trailing two axes."""
        return CArray(jnp.swapaxes(self.re, -1, -2),
                      -jnp.swapaxes(self.im, -1, -2))

    def __getitem__(self, idx) -> "CArray":
        return CArray(self.re[idx], self.im[idx])

    def at_set(self, idx, value) -> "CArray":
        v = _coerce(value)
        return CArray(self.re.at[idx].set(v.re), self.im.at[idx].set(v.im))

    def at_add(self, idx, value) -> "CArray":
        v = _coerce(value)
        return CArray(self.re.at[idx].add(v.re), self.im.at[idx].add(v.im))

    # -- reductions (see also module-level sum/mean) -----------------------

    def sum(self, axis=None, keepdims=False) -> "CArray":
        return CArray(jnp.sum(self.re, axis=axis, keepdims=keepdims),
                      jnp.sum(self.im, axis=axis, keepdims=keepdims))

    def mean(self, axis=None, keepdims=False) -> "CArray":
        return CArray(jnp.mean(self.re, axis=axis, keepdims=keepdims),
                      jnp.mean(self.im, axis=axis, keepdims=keepdims))


# ---------------------------------------------------------------------------
# Construction
# ---------------------------------------------------------------------------


def carray(re, im=None) -> CArray:
    """Build a CArray from real/imag parts (or a numpy complex array)."""
    if im is None:
        if isinstance(re, CArray):
            return re
        if isinstance(re, (np.ndarray, np.generic)) and np.iscomplexobj(re):
            return from_numpy(re)
        if isinstance(re, complex):
            return CArray(jnp.asarray(re.real, jnp.float32),
                          jnp.asarray(re.imag, jnp.float32))
        re = jnp.asarray(re)
        return CArray(re, jnp.zeros_like(re))
    return CArray(jnp.asarray(re), jnp.asarray(im))


def from_numpy(x, dtype=jnp.float32) -> CArray:
    """Convert a host numpy (complex or real) array to an on-device CArray."""
    x = np.asarray(x)
    return CArray(jnp.asarray(x.real.astype(np.float64), dtype=dtype),
                  jnp.asarray(x.imag.astype(np.float64), dtype=dtype)
                  if np.iscomplexobj(x) else jnp.zeros(x.shape, dtype))


def to_numpy(x: CArray) -> np.ndarray:
    return x.to_numpy()


def to_host_like(out, like):
    """Mirror the host boundary: when ``like`` (the user's input) was a
    host numpy array, convert ``out`` (CArray or nested list of CArrays)
    to numpy complex; device inputs keep device outputs. Used by the
    stateful convenience forms of the channel classes so that
    reference-style numpy-in/numpy-out code works unchanged."""
    if not isinstance(like, CArray) and isinstance(like, (list, tuple)):
        like = like[0] if len(like) else None
    if not isinstance(like, np.ndarray):
        return out
    if isinstance(out, CArray):
        return out.to_numpy()
    if isinstance(out, (list, tuple)):
        return [to_host_like(o, like) for o in out]
    return out


def zeros(shape, dtype=jnp.float32) -> CArray:
    return CArray(jnp.zeros(shape, dtype), jnp.zeros(shape, dtype))


def ones(shape, dtype=jnp.float32) -> CArray:
    return CArray(jnp.ones(shape, dtype), jnp.zeros(shape, dtype))


def full(shape, value: Scalar, dtype=jnp.float32) -> CArray:
    value = complex(value)
    return CArray(jnp.full(shape, value.real, dtype),
                  jnp.full(shape, value.imag, dtype))


def eye(n: int, dtype=jnp.float32) -> CArray:
    return CArray(jnp.eye(n, dtype=dtype), jnp.zeros((n, n), dtype))


def cexp(theta: jnp.ndarray) -> CArray:
    """``exp(j * theta)`` for real ``theta`` — the workhorse of Jakes
    fading generation and constellation construction."""
    return CArray(jnp.cos(theta), jnp.sin(theta))


def exp(x: CArray) -> CArray:
    """Complex exponential ``exp(re) * exp(j im)``."""
    m = jnp.exp(x.re)
    return CArray(m * jnp.cos(x.im), m * jnp.sin(x.im))


# ---------------------------------------------------------------------------
# Matmul & einsum
# ---------------------------------------------------------------------------


def matmul(a, b, *, precision=None) -> CArray:
    """Complex matrix multiply via the 3-real-matmul Gauss trick.

    ``(Ar + jAi)(Br + jBi)``: with ``t1 = Ar Br``, ``t2 = Ai Bi`` and
    ``t3 = (Ar + Ai)(Br + Bi)``, the result is ``(t1 - t2) + j(t3 - t1 - t2)``
    — 25% fewer matmul FLOPs than the naive four-matmul form.
    """
    a = _coerce(a)
    b = _coerce(b)
    t1 = jnp.matmul(a.re, b.re, precision=precision)
    t2 = jnp.matmul(a.im, b.im, precision=precision)
    t3 = jnp.matmul(a.re + a.im, b.re + b.im, precision=precision)
    return CArray(t1 - t2, t3 - t1 - t2)


def einsum(subscripts: str, a, b, *, precision=None) -> CArray:
    """Two-operand complex einsum via the same 3-contraction Gauss trick."""
    a = _coerce(a)
    b = _coerce(b)
    t1 = jnp.einsum(subscripts, a.re, b.re, precision=precision)
    t2 = jnp.einsum(subscripts, a.im, b.im, precision=precision)
    t3 = jnp.einsum(subscripts, a.re + a.im, b.re + b.im, precision=precision)
    return CArray(t1 - t2, t3 - t1 - t2)


def outer(a: CArray, b: CArray) -> CArray:
    """Complex outer product ``a b^T`` of 1-D inputs (batched on leading
    dims): shape (..., n, m)."""
    a = _coerce(a)
    b = _coerce(b)
    ar, ai = a.re[..., :, None], a.im[..., :, None]
    br, bi = b.re[..., None, :], b.im[..., None, :]
    return CArray(ar * br - ai * bi, ar * bi + ai * br)


# ---------------------------------------------------------------------------
# Linear algebra via the real 2Nx2N embedding
# ---------------------------------------------------------------------------


def _embed(a: CArray) -> jnp.ndarray:
    """Isomorphic real embedding of a complex matrix:
    ``A = Ar + jAi  ->  [[Ar, -Ai], [Ai, Ar]]`` (batched)."""
    top = jnp.concatenate([a.re, -a.im], axis=-1)
    bot = jnp.concatenate([a.im, a.re], axis=-1)
    return jnp.concatenate([top, bot], axis=-2)


def _inv2x2(a: CArray) -> CArray:
    """Closed-form 2x2 complex inverse (adjugate / determinant):
    pure elementwise arithmetic. The general path's real-embedded LU
    is a long serial chain of tiny kernels — for the 2x2 matrices that
    dominate the IA/MIMO hot loops the adjugate is ~an order of
    magnitude faster on device and exact in the same f32 model."""
    # Scale-normalize by the max |entry| (same scheme as _eigh2x2) so
    # the singularity guard below is scale-RELATIVE: the comp_BD-style
    # scenarios run at ~1e-4 channel scales, where an absolute floor
    # would silently zero out perfectly regular inverses (and at the
    # other end, ~1e19-scale entries would overflow det).
    amax = jnp.max(jnp.maximum(jnp.abs(a.re), jnp.abs(a.im)),
                   axis=(-2, -1))
    sc = (1.0 / jnp.maximum(amax, 1e-30))[..., None, None]
    an = CArray(a.re * sc, a.im * sc)
    a00, a01 = an[..., 0, 0], an[..., 0, 1]
    a10, a11 = an[..., 1, 0], an[..., 1, 1]
    det = a00 * a11 - a01 * a10
    d2 = det.abs2()
    # 1/det = conj(det)/|det|^2. A normalized matrix numerically
    # singular in f32 (relative det below ~1e-6, i.e. condition beyond
    # what an f32 adjugate can resolve) gets an INF reciprocal so the
    # non-finite result propagates — matching the real-embedded LU,
    # whose singular draws come out inf/nan and are caught by the
    # isfinite-based ``__valid__`` masks downstream.
    inv_mag = jnp.where(d2 > 1e-12, 1.0 / jnp.maximum(d2, 1e-30), jnp.inf)
    inv_det = CArray(det.re * inv_mag, -det.im * inv_mag)
    row0 = stack([a11 * inv_det, -a01 * inv_det], axis=-1)
    row1 = stack([-a10 * inv_det, a00 * inv_det], axis=-1)
    out = stack([row0, row1], axis=-2)
    # inv(a) = inv(a_normalized) / amax
    return CArray(out.re * sc, out.im * sc)


def solve(a: CArray, b: CArray) -> CArray:
    """Solve ``A x = b`` for complex A, b.

    ``n <= 2`` uses the closed-form adjugate inverse (elementwise
    work — the small-matrix hot path of the IA solvers); larger systems
    go through the real embedding and LU. Batched over leading dims.
    ``b`` may be a matrix (..., n, k) or a vector (..., n).
    """
    a = _coerce(a)
    b = _coerce(b)
    vec = b.ndim == a.ndim - 1
    if vec:
        b = CArray(b.re[..., None], b.im[..., None])
    n = a.shape[-1]
    if n == 1:
        d2 = a.abs2()                              # (..., 1, 1)
        # a == 0 -> inf, so finiteness-based validity masks catch it.
        im = jnp.where(d2 > 0.0, 1.0 / jnp.maximum(d2, 1e-30), jnp.inf)
        x = CArray((b.re * a.re + b.im * a.im) * im,
                   (b.im * a.re - b.re * a.im) * im)
    elif n == 2:
        x = matmul(_inv2x2(a), b)
    else:
        rhs = jnp.concatenate([b.re, b.im], axis=-2)
        sol = jnp.linalg.solve(_embed(a), rhs)
        x = CArray(sol[..., :n, :], sol[..., n:, :])
    if vec:
        x = CArray(x.re[..., 0], x.im[..., 0])
    return x


def inv(a: CArray) -> CArray:
    """Complex matrix inverse: closed-form adjugate for ``n <= 2``
    (see :func:`solve`), real-embedded LU otherwise."""
    a = _coerce(a)
    n = a.shape[-1]
    if n == 1:
        d2 = a.abs2()
        im = jnp.where(d2 > 0.0, 1.0 / jnp.maximum(d2, 1e-30), jnp.inf)
        return CArray(a.re * im, -a.im * im)
    if n == 2:
        return _inv2x2(a)
    m = jnp.linalg.inv(_embed(a))
    return CArray(m[..., :n, :n], m[..., n:, :n])


def hpd_inv(a: CArray) -> CArray:
    """Inverse of a Hermitian POSITIVE-DEFINITE matrix via recursive
    2x2-block Schur complements.

    ``[[A, B], [B^H, D]]^-1 = [[Ai + AiB S^-1 AiB^H, -AiB S^-1],
    [-S^-1 AiB^H, S^-1]]`` with ``Ai = A^-1``, ``AiB = Ai B`` and the
    Schur complement ``S = D - B^H AiB`` (itself HPD), recursing until
    the closed-form ``n <= 2`` adjugate. Everything is batched matmuls
    and elementwise arithmetic — no LU pivoting chain, no eigh
    sweeps — which is why the BD hot path uses it to invert the
    ``tilde_H tilde_H^H`` Gram instead of a full-matrices SVD
    (reference blockdiagonalization.py:272-363 takes the SVD route).
    Only valid for HPD input: an indefinite matrix can have a singular
    leading block even when invertible.
    """
    a = _coerce(a)
    n = a.shape[-1]
    if n <= 2:
        return inv(a)
    m = n // 2
    A = a[..., :m, :m]
    B = a[..., :m, m:]
    D = a[..., m:, m:]
    Ai = hpd_inv(A)
    AiB = matmul(Ai, B)
    S = D - matmul(B.mH, AiB)
    Si = hpd_inv(S)
    TR = -matmul(AiB, Si)                      # top-right block
    TL = Ai - matmul(TR, AiB.mH)               # Ai + AiB Si AiB^H
    top = concatenate([TL, TR], axis=-1)
    bot = concatenate([TR.mH, Si], axis=-1)
    return concatenate([top, bot], axis=-2)


def pinv(a: CArray, rcond: float = 1e-3, refine: int = 2) -> CArray:
    """Moore-Penrose pseudo-inverse via the complex SVD.

    The Gram-route SVD squares the condition number, with two
    consequences handled here:

    * a RANK-DEFICIENT input's zero singular values come back as noise
      of order ``sqrt(eps_f32) * s_max ~ 3e-4 * s_max`` — the truncation
      cutoff must sit ABOVE that floor or garbage ``1/s`` enters, hence
      the 1e-3 default (matrices conditioned worse than 1e3 should not
      go through a f32 Gram-route pseudo-inverse anyway);
    * the raw ``V s^-1 U^H`` carries O(eps * cond^2) error; ``refine``
      Newton-Schulz steps ``W <- W (2I - A W)`` square that residual
      away (two steps take a 1e-2 residual to ~1e-7) for two small
      matmuls each. Refinement preserves the truncated subspace."""
    u, s, vh = svd(a, full_matrices=False)
    cutoff = rcond * jnp.max(s, axis=-1, keepdims=True)
    s_inv = jnp.where(s > cutoff, 1.0 / jnp.maximum(s, 1e-30), 0.0)
    # pinv = V s^-1 U^H
    v = vh.mH
    w = matmul(CArray(v.re * s_inv[..., None, :],
                      v.im * s_inv[..., None, :]), u.mH)
    for _ in range(refine):
        aw = matmul(a, w)
        two_i = CArray(2.0 * eye(aw.shape[-1], dtype=aw.re.dtype).re
                       - aw.re, -aw.im)
        w = matmul(w, two_i)
    return w


def _eigh2x2(a: CArray):
    """Closed-form 2x2 Hermitian eigendecomposition (ascending order):
    pure elementwise arithmetic, replacing the real-embedded 4x4
    LAPACK eigh on the 2x2 matrices that dominate the small-solver hot
    paths (Bkl covariances, whitening, 2x2 Gram SVDs). The second
    eigenvector is the EXACT orthogonal complement of the first, so V
    stays unitary even for (near-)degenerate spectra; the fully
    degenerate ``A = c I`` case deterministically returns the identity
    basis (the general path's tie-break contract)."""
    # normalize by the max |entry| first: the formulas below SQUARE
    # entries, so extreme-scale inputs (>= ~2e19 or <= ~1e-19 in f32)
    # would overflow/flush without it — the general LAPACK path scales
    # internally, and this branch must not narrow the supported range
    amax = jnp.max(jnp.maximum(jnp.abs(a.re), jnp.abs(a.im)),
                   axis=(-2, -1))
    sc = 1.0 / jnp.maximum(amax, 1e-30)
    ar = a.re[..., 0, 0] * sc
    cr = a.re[..., 1, 1] * sc
    br = a.re[..., 0, 1] * sc
    bi = a.im[..., 0, 1] * sc
    zero = jnp.zeros_like(ar)
    half = 0.5 * (ar + cr)
    delta = 0.5 * (ar - cr)
    rad = jnp.sqrt(delta * delta + br * br + bi * bi)
    w0 = (half - rad) * amax
    w1 = (half + rad) * amax
    w0s = half - rad                    # scaled eigenvalue, for vectors
    # (A - w0 I) v = 0 -> v = [b, w0 - a00] or [w0 - a11, b*]; keep the
    # larger-norm construction (covers b -> 0 with distinct diagonal)
    c1_re = jnp.stack([br, w0s - ar], axis=-1)
    c1_im = jnp.stack([bi, zero], axis=-1)
    c2_re = jnp.stack([w0s - cr, br], axis=-1)
    c2_im = jnp.stack([zero, -bi], axis=-1)
    n1 = jnp.sum(c1_re ** 2 + c1_im ** 2, axis=-1, keepdims=True)
    n2 = jnp.sum(c2_re ** 2 + c2_im ** 2, axis=-1, keepdims=True)
    use1 = n1 >= n2
    v_re = jnp.where(use1, c1_re, c2_re)
    v_im = jnp.where(use1, c1_im, c2_im)
    nrm2 = jnp.sum(v_re ** 2 + v_im ** 2, axis=-1, keepdims=True)
    scale2 = (ar * ar + cr * cr +
              2.0 * (br * br + bi * bi))[..., None]   # ||A||_F^2
    degen = nrm2 <= 1e-12 * (scale2 + 1e-30)
    inv_nrm = 1.0 / jnp.sqrt(jnp.maximum(nrm2, 1e-30))
    e0 = jnp.stack([jnp.ones_like(ar), zero], axis=-1)
    v_re = jnp.where(degen, e0, v_re * inv_nrm)
    v_im = jnp.where(degen, 0.0, v_im * inv_nrm)
    # exact orthogonal complement: u = [-conj(v_y), conj(v_x)]
    u_re = jnp.stack([-v_re[..., 1], v_re[..., 0]], axis=-1)
    u_im = jnp.stack([v_im[..., 1], -v_im[..., 0]], axis=-1)
    V = CArray(jnp.stack([v_re, u_re], axis=-1),
               jnp.stack([v_im, u_im], axis=-1))
    return jnp.stack([w0, w1], axis=-1), V


def _round_robin_pairs(n: int):
    """Rounds of DISJOINT index pairs covering every (p, q) once per
    sweep (the circle-method tournament schedule): the disjoint
    rotations of one round commute, so each round is ONE unitary."""
    m = n + (n % 2)
    idx = list(range(m))
    rounds = []
    for _ in range(m - 1):
        pairs = []
        for i in range(m // 2):
            x, y = idx[i], idx[m - 1 - i]
            if x < n and y < n:
                pairs.append((min(x, y), max(x, y)))
        rounds.append(tuple(pairs))
        idx = [idx[0]] + [idx[-1]] + idx[1:-1]
    return tuple(rounds)


def _eigh_jacobi(a: CArray, sweeps: int = 8):
    """Batched cyclic Jacobi eigendecomposition for small Hermitian
    matrices (3 <= n <= 8), ascending eigenvalues.

    XLA's general eigh (QDWH + spectral divide and conquer on the real
    embedding) is a very long serial chain of kernels — the latency
    bound of the BD null-space pipeline. One round-robin ROUND here
    applies all n/2 disjoint 2x2 rotations as a single n x n unitary
    (three batched small matmuls), so a full sweep is ~n-1 short steps
    of elementwise rotation math + matmuls; quadratic convergence makes
    ``sweeps=8`` machine-precision for n <= 8 (prototype-verified at
    1e-15 in f64; f32 lands at its own eps)."""
    n = a.shape[-1]
    dt = a.re.dtype
    batch = a.re.shape[:-2]
    # normalize by the max |entry| (see _eigh2x2): the rotation math
    # squares off-diagonals, so tiny-scale inputs would flush to zero
    # and silently skip every rotation
    amax = jnp.max(jnp.maximum(jnp.abs(a.re), jnp.abs(a.im)),
                   axis=(-2, -1))
    sc = (1.0 / jnp.maximum(amax, 1e-30))[..., None, None]
    a = CArray(a.re * sc, a.im * sc)
    eye_n = jnp.broadcast_to(jnp.eye(n, dtype=dt), batch + (n, n))

    def sweep(carry, _):
        A, V = carry
        for pairs in _round_robin_pairs(n):
            g_re = eye_n
            g_im = jnp.zeros_like(eye_n)
            for p, q in pairs:
                app = A.re[..., p, p]
                aqq = A.re[..., q, q]
                pr, pi = A.re[..., p, q], A.im[..., p, q]
                m = jnp.sqrt(pr * pr + pi * pi)
                # guards must stay in the NORMAL f32 range: XLA CPU
                # flushes subnormals (a 1e-38 floor becomes 0 and the
                # phase ratio overflows to inf, NaN-ing s * ph)
                m_safe = jnp.maximum(m, 1e-30)
                live = m > 1e-30 * (jnp.abs(app) + jnp.abs(aqq) + m)
                ph_re = jnp.where(live, pr / m_safe, 0.0)
                ph_im = jnp.where(live, pi / m_safe, 0.0)
                tau = (aqq - app) / (2.0 * m_safe)
                sgn = jnp.where(tau >= 0, 1.0, -1.0).astype(dt)
                t = sgn / (jnp.abs(tau) + jnp.sqrt(1.0 + tau * tau))
                c = 1.0 / jnp.sqrt(1.0 + t * t)
                s = t * c
                c = jnp.where(live, c, 1.0)
                s = jnp.where(live, s, 0.0)
                g_re = g_re.at[..., p, p].set(c)
                g_re = g_re.at[..., q, q].set(c)
                g_re = g_re.at[..., p, q].set(s * ph_re)
                g_im = g_im.at[..., p, q].set(s * ph_im)
                g_re = g_re.at[..., q, p].set(-s * ph_re)
                g_im = g_im.at[..., q, p].set(s * ph_im)
            G = CArray(g_re, g_im)
            A = matmul(G.mH, matmul(A, G))
            V = matmul(V, G)
        # re-Hermitize: f32 drift off the Hermitian manifold slows the
        # quadratic convergence
        A = CArray(0.5 * (A.re + jnp.swapaxes(A.re, -1, -2)),
                   0.5 * (A.im - jnp.swapaxes(A.im, -1, -2)))
        return (A, V), 0

    # scan over sweeps: the body is identical each iteration, so this
    # traces/compiles ONE sweep instead of `sweeps` copies — the
    # unrolled version dominated test-suite compile times
    (A, V), _ = jax.lax.scan(
        sweep, (a, CArray(eye_n, jnp.zeros_like(eye_n))),
        jnp.arange(sweeps))
    w = _diagonal(A.re) * amax[..., None]
    order = jnp.argsort(w, axis=-1)
    w = jnp.take_along_axis(w, order, axis=-1)
    V = CArray(jnp.take_along_axis(V.re, order[..., None, :], axis=-1),
               jnp.take_along_axis(V.im, order[..., None, :], axis=-1))
    return w, V


def eigh(a: CArray, *, tie_break: bool = True):
    """Eigendecomposition of a (batched) Hermitian complex matrix.

    ``n == 2`` uses a closed form (see :func:`_eigh2x2`); ``3 <= n <= 8``
    a batched round-robin Jacobi iteration (:func:`_eigh_jacobi`) —
    both replace the very long serial kernel chain XLA's general eigh
    lowers to for tiny matrices. Larger matrices use ``eigh`` of the
    symmetric real embedding; each complex eigenvalue appears twice
    with real eigenvectors spanning ``{v, jv}``. We take one
    representative of each pair (every other ascending eigenvalue) and
    read the complex eigenvector off its top/bottom halves.

    Degenerate eigenvalues of ``A`` itself would make that selection
    ambiguous (for ``A = I`` the picks can be ``v`` and ``jv`` — the same
    complex direction). Since ANY orthonormal basis of a degenerate
    eigenspace is a valid answer, we break ties with a tiny graded real
    diagonal perturbation that makes the complex spectrum simple; the
    selected basis is then well-defined. The returned eigenvalues are
    recomputed from the unperturbed matrix via the Rayleigh quotient.

    Returns ``(w, V)`` with eigenvalues ascending, like ``jnp.linalg.eigh``.
    """
    a = _coerce(a)
    n = a.shape[-1]
    if n == 1:
        return a.re[..., 0, :], ones(a.shape, a.dtype)
    if n == 2:
        return _eigh2x2(a)
    if n <= 8:
        return _eigh_jacobi(a)
    work = a
    if tie_break and n > 1:
        # RELATIVE perturbation scale: an absolute floor here silently
        # destroys the eigenvectors of small-normed matrices (a Gram
        # matrix of a ~1e-7-scale channel has norm ~1e-13, far below any
        # absolute epsilon). The Frobenius term covers zero-diagonal
        # Hermitian matrices; 1e-30 only guards the all-zero matrix.
        mag = jnp.mean(jnp.abs(_diagonal(a.re)), axis=-1, keepdims=True)
        fro = jnp.sqrt(jnp.mean(a.re ** 2 + a.im ** 2,
                                axis=(-2, -1)))[..., None]
        scale = mag + fro + 1e-30
        grade = jnp.arange(n, dtype=a.re.dtype) * (1e-4 / n)
        work = CArray(a.re + _diag_embed(scale * grade), a.im)
    _, v2 = jnp.linalg.eigh(_embed(work))
    vr = v2[..., :n, ::2]
    vi = v2[..., n:, ::2]
    v = CArray(vr, vi)
    nrm = jnp.sqrt(jnp.sum(v.abs2(), axis=-2, keepdims=True))
    v = CArray(v.re / nrm, v.im / nrm)
    # Rayleigh quotient w_k = v_k^H A v_k on the ORIGINAL matrix.
    av = matmul(a, v)
    w = jnp.sum(v.re * av.re + v.im * av.im, axis=-2)
    # eigh of the perturbed embedding is ascending, but the Rayleigh
    # quotients on the original A may be infinitesimally out of order;
    # re-sorting keeps the ascending contract exactly.
    order = jnp.argsort(w, axis=-1)
    w = jnp.take_along_axis(w, order, axis=-1)
    v = CArray(jnp.take_along_axis(v.re, order[..., None, :], axis=-1),
               jnp.take_along_axis(v.im, order[..., None, :], axis=-1))
    return w, v


def csqrt(z: CArray) -> CArray:
    """Principal complex square root, elementwise:
    ``sqrt(r) * exp(j*theta/2)`` — pure elementwise work (abs/atan2/cos/sin)."""
    z = _coerce(z)
    r = jnp.sqrt(z.abs())
    half = 0.5 * z.angle()
    return CArray(r * jnp.cos(half), r * jnp.sin(half))


def _eig2x2(a: CArray):
    """Analytic eigendecomposition of a (batched) GENERAL complex 2x2
    matrix via the characteristic polynomial. Eigenvectors are read off
    the rows of ``A - lambda I`` (the two candidate constructions are
    blended by whichever has the larger norm, so defective directions
    never divide by ~0)."""
    a00, a01 = a[..., 0, 0], a[..., 0, 1]
    a10, a11 = a[..., 1, 0], a[..., 1, 1]
    tr = a00 + a11
    det = a00 * a11 - a01 * a10
    disc = csqrt(tr * tr - 4.0 * det)
    lam1 = (tr + disc) * 0.5
    lam2 = (tr - disc) * 0.5

    def vec_for(lam: CArray) -> CArray:
        # (A - lam I) v = 0: v = [a01, lam - a00] or [lam - a11, a10]
        c1 = stack([a01, lam - a00], axis=-1)
        c2 = stack([lam - a11, a10], axis=-1)
        use1 = (jnp.sum(c1.abs2(), axis=-1, keepdims=True) >=
                jnp.sum(c2.abs2(), axis=-1, keepdims=True))
        v = where(use1, c1, c2)
        nrm = jnp.sqrt(jnp.sum(v.abs2(), axis=-1, keepdims=True)) + 1e-30
        return CArray(v.re / nrm, v.im / nrm)

    w = stack([lam1, lam2], axis=-1)
    v = stack([vec_for(lam1), vec_for(lam2)], axis=-1)
    return w, v


def ceig(a: CArray, qr_iters: int = 60, inv_iters: int = 4):
    """Eigendecomposition of a GENERAL (non-Hermitian) complex matrix.

    ``jnp.linalg.eig`` is CPU-only in JAX — there is no accelerator lowering for
    the general eigenproblem — so this builds one from ops that DO run on
    the device: the analytic 2x2 formula when ``n == 2`` (the common case
    for the 3-user IA closed form, reference algorithms.py:42-265), and
    for larger ``n`` a fixed-iteration unshifted QR iteration for the
    Schur values followed by inverse iteration for each eigenvector.
    Intended for the SMALL matrices of transceiver algorithms (n <= ~6);
    eigenvalues of generic (simple-spectrum) matrices only.

    Returns ``(w, V)`` with eigenvector COLUMNS, like ``np.linalg.eig``
    (no ordering guarantee).
    """
    a = _coerce(a)
    n = a.shape[-1]
    if n == 1:
        return a[..., 0, :], ones(a.shape, a.dtype)
    if n == 2:
        return _eig2x2(a)

    # The shifted-QR sweep is precision-critical: the accelerator's default
    # bf16 passes (~0.4% rel error) swamp the shift-offset margin of the
    # Cholesky-QR and produce NaNs. These matrices are tiny — full f32
    # multiplies cost nothing.
    with jax.default_matmul_precision("highest"):
        return _ceig_qr(a, qr_iters, inv_iters)


def _ceig_qr(a: CArray, qr_iters: int, inv_iters: int):
    n = a.shape[-1]

    # Corner-shifted QR with STATIC deflation: for each trailing position
    # run a fixed number of shifted QR steps (shift = bottom-right entry;
    # near-cubic convergence of the last subdiagonal), record the corner
    # eigenvalue, then truncate to the leading block — all shapes static,
    # so the whole spectral sweep jits. Unshifted QR needs O(1/log(ratio))
    # iterations and stalls on close-magnitude eigenvalues; the shifted
    # form needs a handful per eigenvalue.
    fro = jnp.sqrt(jnp.mean(a.re ** 2 + a.im ** 2,
                            axis=(-2, -1))) + 1e-30

    def shifted_steps(s: CArray, m: int) -> CArray:
        k = s.shape[-1]
        eyek = jnp.eye(k, dtype=s.re.dtype)
        # The shift is OFFSET from the corner entry by ~1e-3 of the matrix
        # scale: as the corner converges to an eigenvalue, an exact shift
        # would make the QR input singular (the Cholesky-QR underneath
        # needs full column rank and squares the condition number, so the
        # margin must stay well above f32 eps). The offset caps the
        # condition number while barely slowing convergence, and does not
        # bias the converged corner value.
        off = (1e-2 * fro)[..., None, None] * eyek

        def step(cur, _):
            mu_re = cur.re[..., -1:, -1:] * eyek + off
            mu_im = cur.im[..., -1:, -1:] * eyek
            shifted = CArray(cur.re - mu_re, cur.im - mu_im)
            q, r = qr(shifted)
            nxt = matmul(r, q)
            return CArray(nxt.re + mu_re, nxt.im + mu_im), 0

        out, _ = jax.lax.scan(step, s, jnp.arange(m))
        return out

    per_stage = min(max(qr_iters // max(n - 1, 1), 8), 16)
    s = a
    vals = []
    for size in range(n, 1, -1):
        s = shifted_steps(s, per_stage)
        vals.append(CArray(s.re[..., -1, -1], s.im[..., -1, -1]))
        s = s[..., : size - 1, : size - 1]
    vals.append(CArray(s.re[..., 0, 0], s.im[..., 0, 0]))
    w = stack(vals[::-1], axis=-1)  # (..., n)

    # inverse iteration per eigenvalue: v <- (A - (lam + delta) I)^-1 v
    scale = jnp.sqrt(jnp.mean(a.re ** 2 + a.im ** 2,
                              axis=(-2, -1))) + 1e-30
    eyec = eye(n, a.dtype)

    def vec_for(lam: CArray) -> CArray:
        shift = CArray((lam.re + 1e-5 * scale)[..., None, None]
                       * eyec.re,
                       lam.im[..., None, None] * eyec.re)
        m = a - shift
        v = ones(a.shape[:-2] + (n, 1), a.dtype)
        for _ in range(inv_iters):
            v = solve(m, v)
            nrm = jnp.sqrt(jnp.sum(v.abs2(), axis=(-2, -1),
                                   keepdims=True)) + 1e-30
            v = CArray(v.re / nrm, v.im / nrm)
        return v[..., :, 0]

    cols = [vec_for(CArray(w.re[..., i], w.im[..., i])) for i in range(n)]
    return w, stack(cols, axis=-1)


def _diagonal(m: jnp.ndarray) -> jnp.ndarray:
    return jnp.diagonal(m, axis1=-2, axis2=-1)


def _diag_embed(d: jnp.ndarray) -> jnp.ndarray:
    return d[..., None, :] * jnp.eye(d.shape[-1], dtype=d.dtype)


def cholesky(a: CArray) -> CArray:
    """Complex Cholesky factor (lower) of a Hermitian PSD matrix.

    Column-by-column Cholesky-Crout with the column loop unrolled at trace
    time (n is static and small in this framework's workloads). Batched
    over leading dims.
    """
    a = _coerce(a)
    n = a.shape[-1]
    cols = []
    for j in range(n):
        # residual column j: A[:, j] - sum_{k<j} L[:, k] conj(L[j, k])
        col = a[..., :, j]
        for k in range(j):
            lk = cols[k]                       # (..., n)
            cr = lk.re[..., j][..., None]      # conj(L[j, k]) broadcast
            ci = -lk.im[..., j][..., None]
            col = col - CArray(lk.re * cr - lk.im * ci,
                               lk.re * ci + lk.im * cr)
        djj = jnp.sqrt(jnp.clip(col.re[..., j], 1e-30))
        mask = (jnp.arange(n) >= j).astype(a.re.dtype)
        col = CArray(col.re * mask / djj[..., None],
                     col.im * mask / djj[..., None])
        # exact real diagonal
        col = CArray(col.re.at[..., j].set(djj), col.im.at[..., j].set(0.0))
        cols.append(col)
    return stack(cols, axis=-1)


def svd(a: CArray, full_matrices: bool = False):
    """Complex SVD via eigh of ``A^H A`` (Gram route, batched).

    Returns ``(U, s, V^H)`` with singular values DESCENDING like
    ``jnp.linalg.svd``. The Gram route squares the condition number —
    fine for the simulation workloads here (small well-conditioned channel
    matrices); it avoids doubled-singular-value bookkeeping of the real
    embedding SVD.

    For m < n matrices the Gram matrix of the adjoint is used. With
    ``full_matrices=True`` on a rectangular input the short basis is
    completed with an orthonormal basis of the orthogonal complement
    (eigenvectors of the projector ``I - U U^H`` at eigenvalue 1); the
    order and phase of those null-space columns is arbitrary, as in
    LAPACK.
    """
    a = _coerce(a)
    m, n = a.shape[-2], a.shape[-1]
    if m >= n:
        g = matmul(a.mH, a)                      # (n, n) Hermitian PSD
        w, v = eigh(g)                           # ascending
        w = w[..., ::-1]
        v = v[..., ::-1]
        s = jnp.sqrt(jnp.clip(w, 0.0))
        u = matmul(a, v)                         # A v_k = s_k u_k
        s_safe = jnp.maximum(s, 1e-30)
        u = CArray(u.re / s_safe[..., None, :], u.im / s_safe[..., None, :])
        if full_matrices and m > n:
            u = _complete_columns(u, s, m)
        return u, s, v.mH
    g = matmul(a, a.mH)                          # (m, m)
    w, u = eigh(g)
    w = w[..., ::-1]
    u = u[..., ::-1]
    s = jnp.sqrt(jnp.clip(w, 0.0))
    v = matmul(a.mH, u)                          # A^H u_k = s_k v_k
    s_safe = jnp.maximum(s, 1e-30)
    v = CArray(v.re / s_safe[..., None, :], v.im / s_safe[..., None, :])
    if full_matrices:
        v = _complete_columns(v, s, n)
    return u, s, v.mH


def _complete_columns(u: CArray, s: jnp.ndarray, m: int) -> CArray:
    """Extend the thin factor ``u`` (..., m, k) to a full unitary
    ``(..., m, m)`` basis, repairing near-zero-singular-value columns.

    The Gram route leaves ``u``'s column ``l`` meaningless when
    ``s_l ~ 0`` (it is ``A v_l / max(s_l, eps)``). Those columns and the
    ``m - k`` missing ones are all filled from the eigenvalue-1
    eigenvectors of the projector ``P = I - u_valid u_valid^H``: with
    ascending ``eigh``, eigenvalue 0 occupies the first ``rank``
    positions, so position ``j >= rank`` holds a complement vector —
    exactly the positions needing fill (zero singular values sort last).
    The per-column select is static-shape; rank never needs to be known
    at trace time. A final QR polish removes the O(1e-3) f32 cross-terms
    of eigh's degeneracy tie-break.
    """
    k = u.shape[-1]
    s_max = jnp.max(s, axis=-1, keepdims=True)
    valid = s > s_max * 1e-4                     # (..., k)
    um = CArray(u.re * valid[..., None, :], u.im * valid[..., None, :])
    p = eye(m, dtype=u.re.dtype) - matmul(um, um.mH)
    _, vecs = eigh(p)                            # ascending eigenvalues
    pad = m - k
    if pad:
        z = jnp.zeros(um.re.shape[:-1] + (pad,), um.re.dtype)
        um = CArray(jnp.concatenate([um.re, z], axis=-1),
                    jnp.concatenate([um.im, z], axis=-1))
        valid = jnp.concatenate(
            [valid, jnp.zeros(valid.shape[:-1] + (pad,), bool)], axis=-1)
    out = where(valid[..., None, :], um, vecs)
    q, _ = qr(out)
    return q


def qr(a: CArray):
    """Complex (thin) QR via Cholesky of the Gram matrix.

    ``R = chol(A^H A)^H`` (upper triangular), ``Q = A R^{-1}`` — valid for
    full-column-rank A, batched, and entirely real-arithmetic underneath.
    """
    a = _coerce(a)
    r = cholesky(matmul(a.mH, a)).mH             # upper triangular
    q = solve(r.mT, a.mT).mT                     # Q = A R^-1
    return q, r


# ---------------------------------------------------------------------------
# Elementwise helpers
# ---------------------------------------------------------------------------


def where(cond: jnp.ndarray, a, b) -> CArray:
    a = _coerce(a)
    b = _coerce(b)
    return CArray(jnp.where(cond, a.re, b.re), jnp.where(cond, a.im, b.im))


def sum(x: CArray, axis=None, keepdims=False) -> CArray:  # noqa: A001
    return x.sum(axis=axis, keepdims=keepdims)


def mean(x: CArray, axis=None, keepdims=False) -> CArray:
    return x.mean(axis=axis, keepdims=keepdims)


def stack(xs: Sequence[CArray], axis=0) -> CArray:
    return CArray(jnp.stack([x.re for x in xs], axis=axis),
                  jnp.stack([x.im for x in xs], axis=axis))


def concatenate(xs: Sequence[CArray], axis=0) -> CArray:
    return CArray(jnp.concatenate([x.re for x in xs], axis=axis),
                  jnp.concatenate([x.im for x in xs], axis=axis))


# ---------------------------------------------------------------------------


def _is_real(x) -> bool:
    if isinstance(x, CArray):
        return False
    if isinstance(x, complex):
        return False
    if isinstance(x, (np.ndarray, np.generic)) and np.iscomplexobj(x):
        return False
    return True


def _coerce(x) -> CArray:
    if isinstance(x, CArray):
        return x
    if isinstance(x, complex):
        return CArray(jnp.asarray(x.real, jnp.float32),
                      jnp.asarray(x.imag, jnp.float32))
    if isinstance(x, (np.ndarray, np.generic)) and np.iscomplexobj(x):
        return CArray(jnp.asarray(x.real, jnp.float32),
                      jnp.asarray(x.imag, jnp.float32))
    x = jnp.asarray(x)
    return CArray(x, jnp.zeros_like(x))
