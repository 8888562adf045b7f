"""Monolithic Max-SINR interference-alignment Monte-Carlo Pallas kernel.

Register-resident counterpart of the batched IA sweep
(``ia/batched.max_sinr_solve`` + ``calc_sinrs`` + ``sum_capacity`` —
reference ``apps/ia/simulate_ia.py`` / ``algorithms.MaxSinrIASolver``,
algorithms.py:1243-1852) for the 2x2, Ns=1 scenario family the bench
and apps sweep, geometry-general over the user count ``K`` (the bench
point is K=3): each (row, lane) element of a grid block is one
independent Monte Carlo realization — the KxKx2x2 channel is drawn from the
in-kernel counter-based generator (:mod:`.counter_rng`), the
deterministic 'svd' initialization, the fixed-iteration forward/reverse
Max-SINR recursion and the final SINR/capacity reduction all run in
registers as pure plane arithmetic (closed-form 2x2 Hermitian solves —
no LAPACK, no gathers), and the only device-memory traffic is one f32
capacity sum per program.

The XLA path (``ia/batched.py``) stays the general-geometry tool; this
kernel is the fast instance of its hottest configuration, pinned
against it per-realization in tests (:meth:`MonteCarloMaxSinr.reference_caps`
draws the same channels from the same generator). All the per-element
math mirrors ``max_sinr_solve`` exactly:

* svd init: F_k = dominant right singular vector of H_kk, here the
  closed-form dominant eigenvector of the 2x2 Hermitian Gram
  (ia/batched.py:139-152; capacity is invariant to the phase
  convention difference vs the LAPACK/QR route),
* forward/reverse filter updates: ``u = normalize(Bkl^{-1} H_kk f)``
  with ``Bkl = noise I + sum_j P (H_kj f_j)(H_kj f_j)^H - P d d^H``
  (Cadambe eq. 28; ia/batched.py:85-137), the reverse network using
  ``H_rev[k, j] = H[j, k]^H`` and power P/Ns (ia/batched.py:168-196),
* SINR: ``P |u^H d|^2 / re(u^H Bkl u)`` and capacity
  ``sum_k log2(1 + sinr_k)`` (ia/batched.py:556-581).

Randomness: the key is (seed, absolute repetition index) and the
counter (absolute element index within the repetition, channel entry):
each call yields the (re, im) bits of one complex channel entry, so the
draws do not depend on the block shape, the chunking of repetitions or
the device. ``interpret=True`` runs the identical kernel under the
Pallas interpreter on the CPU.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from ..parallel.mesh import shard_reps
from .counter_rng import channel_planes, gauss_half
from .pallas_common import (TRITON_PARAMS, block_elements,
                            check_block, require_kernel_backend)
from .pallas_planes import (EPS as _EPS, cabs2 as _cabs2, cadd as _cadd,
                            cmul as _cmul, cmulc as _cmulc,
                            cscale as _cscale, csub as _csub)

__all__ = ["MonteCarloMaxSinr", "CH_PLANES"]

# bit planes of the DEFAULT (bench) geometry K=3, N=2 — kept for
# callers sizing buffers for the default; the contract for any
# geometry is the instance property ``MonteCarloMaxSinr.num_planes``
# (= K*K*N*N*2)
CH_PLANES = 3 * 3 * 4 * 2   # 72: (k, j, entry, re/im)


def _matvec(M, v):
    """M (2x2 complex as ((m00,m01),(m10,m11))) @ v ((v0, v1))."""
    return (_cadd(_cmul(M[0][0], v[0]), _cmul(M[0][1], v[1])),
            _cadd(_cmul(M[1][0], v[0]), _cmul(M[1][1], v[1])))


def _mat_H(M):
    """Conjugate transpose of a 2x2 complex matrix of planes."""
    c = lambda a: (a[0], -a[1])  # noqa: E731
    return ((c(M[0][0]), c(M[1][0])), (c(M[0][1]), c(M[1][1])))


def _vnormalize(v):
    n = jnp.sqrt(_cabs2(v[0]) + _cabs2(v[1]))
    inv = 1.0 / jnp.maximum(n, _EPS)
    return (_cscale(v[0], inv), _cscale(v[1], inv))


def _herm_add_outer(B, v, scale):
    """B += scale * v v^H for Hermitian B = (p, q, r); p/r real planes,
    q complex."""
    p, q, r = B
    return (p + scale * _cabs2(v[0]),
            _cadd(q, _cscale(_cmulc(v[0], v[1]), scale)),
            r + scale * _cabs2(v[1]))


def _herm_solve(B, v):
    """B^{-1} v for Hermitian positive-definite B = (p, q, r): the 2x2
    adjugate route (same closed form as ops/cplx.solve at n=2; the
    result is normalized right after, so the det scale cancels)."""
    p, q, r = B
    det = jnp.maximum(p * r - _cabs2(q), _EPS)
    inv = 1.0 / det
    x0 = _csub(_cscale(v[0], r), _cmul(q, v[1]))
    # adjugate row 2: p v1 - conj(q) v0, with conj(q) v0 = v0 conj(q)
    x1 = _csub(_cscale(v[1], p), _cmulc(v[0], q))
    return (_cscale(x0, inv), _cscale(x1, inv))


def _herm_quad(B, v):
    """re(v^H B v) for Hermitian B (real plane)."""
    p, q, r = B
    cross = _cmulc(v[1], v[0])  # v1 * conj(v0)
    return (p * _cabs2(v[0]) + r * _cabs2(v[1]) +
            2.0 * (q[0] * cross[0] - q[1] * cross[1]))


# ---- general-N plane-vector helpers (lists of complex plane tuples) ----

def _gmatvec(M, v):
    """(N, N) plane matrix @ length-N plane vector."""
    out = []
    for i in range(len(M)):
        acc = _cmul(M[i][0], v[0])
        for j in range(1, len(v)):
            acc = _cadd(acc, _cmul(M[i][j], v[j]))
        out.append(acc)
    return out


def _gdotc(a, b):
    """a^H b = sum_i conj(a_i) b_i."""
    acc = _cmulc(b[0], a[0])
    for i in range(1, len(a)):
        acc = _cadd(acc, _cmulc(b[i], a[i]))
    return acc


def _gnorm2(v):
    acc = _cabs2(v[0])
    for i in range(1, len(v)):
        acc = acc + _cabs2(v[i])
    return acc


def _gscale(v, s):
    return [_cscale(x, s) for x in v]


def _gnormalize(v):
    inv = 1.0 / jnp.maximum(jnp.sqrt(_gnorm2(v)), _EPS)
    return _gscale(v, inv)


def _mgs(cols):
    """Modified Gram-Schmidt orthonormalization of a list of length-N
    plane vectors (in order)."""
    out = []
    for v in cols:
        for q in out:
            proj = _gdotc(q, v)          # q^H v
            v = [_csub(x, _cmul(proj, qx)) for x, qx in zip(v, q)]
        out.append(_gnormalize(v))
    return out


def _orth_iter_init(Hkk, Ns, iters):
    """Fixed-iteration orthogonal (power) iteration on G = Hkk^H Hkk:
    converges to the Ns dominant right singular vectors — the
    general-N form of the closed-form 2x2 'svd' init (the parity tests
    feed the SAME iterated init to the XLA solver via init='fix', so
    the recursion is pinned exactly regardless of convergence)."""
    from .pallas_planes import mat_H, mat_mul
    G = mat_mul(mat_H(Hkk), Hkk)
    N = len(G)
    cols = []
    for l in range(Ns):
        z = jnp.zeros_like(G[0][0][0])
        one = jnp.ones_like(z)
        cols.append([((one if i == l else z), z) for i in range(N)])
    for _ in range(iters):
        cols = _mgs([_gmatvec(G, v) for v in cols])
    return cols


def _herm_full_eye(N, nv, like):
    """nv * I as a full N x N complex plane matrix."""
    z = jnp.zeros_like(like)
    d = jnp.full_like(like, nv) if not hasattr(nv, "shape") else \
        jnp.broadcast_to(nv, like.shape).astype(like.dtype)
    out = [[((d if i == j else z), z) for j in range(N)]
           for i in range(N)]
    return out


def _herm_full_add_outer(B, v, scale):
    """B += scale * v v^H (full-matrix Hermitian accumulation)."""
    N = len(v)
    out = [[None] * N for _ in range(N)]
    for i in range(N):
        for j in range(N):
            out[i][j] = _cadd(B[i][j],
                              _cscale(_cmulc(v[i], v[j]), scale))
    return out


def _dominant_right_singular(M):
    """Dominant right singular vector of a 2x2 complex M: closed-form
    top eigenvector of G = M^H M (phase convention differs from LAPACK;
    Max-SINR capacity is invariant to it)."""
    m00, m01 = M[0]
    m10, m11 = M[1]
    p = _cabs2(m00) + _cabs2(m10)
    r = _cabs2(m01) + _cabs2(m11)
    q = _cadd(_cmulc(m01, m00), _cmulc(m11, m10))  # conj(m00) m01 + ...
    half = 0.5 * (p - r)
    lam = 0.5 * (p + r) + jnp.sqrt(half * half + _cabs2(q))
    v = (q, (lam - p, jnp.zeros_like(p)))
    n2 = _cabs2(v[0]) + _cabs2(v[1])
    # q ~ 0 and lam ~ p: already diagonal — pick the dominant axis
    ok = n2 > 1e-12 * jnp.maximum(lam * lam, _EPS)
    e0 = jnp.where(p >= r, 1.0, 0.0)
    z = jnp.zeros_like(p)
    v = ((jnp.where(ok, v[0][0], e0), jnp.where(ok, v[0][1], z)),
         (jnp.where(ok, v[1][0], 1.0 - e0), jnp.where(ok, v[1][1], z)))
    return _vnormalize(v)


class MonteCarloMaxSinr:
    """Builder for the single-kernel Max-SINR IA Monte Carlo sweep
    ('svd'-style init; the geometry menu covers the reference's
    shape-general solver surface, algorithms.py:1243-1504, at kernel
    speed: ``K`` users, square ``N = Nr = Nt`` antennas, ``Ns``
    streams/user). The (N, Ns) = (2, 1) point keeps the hand-tuned
    closed-form path (the bench configuration); other points run the
    general plane program (full-matrix Bkl, unrolled LDL^H solves,
    orthogonal-iteration init).

    ``tile`` rows x ``lane`` lanes of independent realizations per
    program (powers of two; one realization per thread keeps the whole
    recursion in registers); ``num_tiles`` programs per repetition.
    Solves per call: ``reps * num_tiles * tile * lane``.
    """

    def __init__(self, tile: int = 1, lane: int = 128,
                 iterations: int = 10, P: float = 1.0,
                 K: int = 3, N: int = 2, Ns: int = 1,
                 init_iters: int = 10) -> None:
        check_block(tile, lane)
        if K < 2:
            raise ValueError("K must be >= 2")
        if N < 2:
            raise ValueError("N must be >= 2")
        if not 1 <= Ns <= N:
            raise ValueError("need 1 <= Ns <= N")
        self._tile = int(tile)
        self._lane = int(lane)
        self._iters = int(iterations)
        self._P = float(P)
        self._K = int(K)
        self._N = int(N)
        self._Ns = int(Ns)
        self._init_iters = int(init_iters)

    @property
    def num_planes(self) -> int:
        """Channel bit planes consumed per block: K*K NxN complex
        matrices = K*K*N*N*2 (re/im) planes."""
        return self._K * self._K * self._N * self._N * 2

    # ------------------------------------------------------------------

    def _solve_block(self, planes, noise_var):
        """planes: list of ``num_planes`` (tile, lane) uint32/int32 bit
        planes -> (tile, lane) f32 sum capacity per element."""
        if (self._N, self._Ns) != (2, 1):
            return self._solve_block_general(planes, noise_var)
        K = self._K
        P = jnp.float32(self._P)
        nv = noise_var

        # channel components ~ N(0, 1/2) per part
        gauss = gauss_half

        # H[k][j] = 2x2 complex matrix of planes
        H = [[None] * K for _ in range(K)]
        idx = 0
        for k in range(K):
            for j in range(K):
                comps = []
                for _ in range(4):
                    re = gauss(planes[idx])
                    im = gauss(planes[idx + 1])
                    idx += 2
                    comps.append((re, im))
                H[k][j] = ((comps[0], comps[1]), (comps[2], comps[3]))
        Hrev = [[_mat_H(H[j][k]) for j in range(K)] for k in range(K)]

        F = [_dominant_right_singular(H[k][k]) for k in range(K)]

        def update(ch, F_cur):
            """One direction of the Max-SINR update over channel ch."""
            out = []
            for k in range(K):
                p0 = jnp.full_like(F_cur[0][0][0], nv)
                B = (p0, (jnp.zeros_like(p0), jnp.zeros_like(p0)),
                     jnp.full_like(p0, nv))
                for j in range(K):
                    t = _matvec(ch[k][j], F_cur[j])
                    B = _herm_add_outer(B, t, P)
                d = _matvec(ch[k][k], F_cur[k])
                Bkl = (B[0] - P * _cabs2(d[0]),
                       _csub(B[1], _cscale(_cmulc(d[0], d[1]), P)),
                       B[2] - P * _cabs2(d[1]))
                out.append(_vnormalize(_herm_solve(Bkl, d)))
            return out

        for _ in range(self._iters):
            U = update(H, F)
            F = update(Hrev, U)
        U = update(H, F)

        cap = None
        for k in range(K):
            B = (jnp.full_like(F[0][0][0], nv),
                 (jnp.zeros_like(F[0][0][0]),
                  jnp.zeros_like(F[0][0][0])),
                 jnp.full_like(F[0][0][0], nv))
            for j in range(K):
                t = _matvec(H[k][j], F[j])
                B = _herm_add_outer(B, t, P)
            d = _matvec(H[k][k], F[k])
            Bkl = (B[0] - P * _cabs2(d[0]),
                   _csub(B[1], _cscale(_cmulc(d[0], d[1]), P)),
                   B[2] - P * _cabs2(d[1]))
            u = U[k]
            num = P * _cabs2(_cadd(_cmulc(d[0], u[0]),
                                   _cmulc(d[1], u[1])))
            den = jnp.maximum(jnp.abs(_herm_quad(Bkl, u)), _EPS)
            sinr = num / den
            c = jnp.log2(1.0 + sinr)
            cap = c if cap is None else cap + c
        # degenerate draws (singular Bkl etc.) must not poison the sum:
        # the runner-path __valid__ semantics, inlined (bench.py bd_step)
        return jnp.sum(jnp.where(jnp.isfinite(cap), cap, 0.0))

    def _solve_block_general(self, planes, noise_var):
        """General (K, N, Ns) plane program, mirroring
        ``ia/batched.max_sinr_solve`` exactly: forward Bkl at total
        user power P over unit-Frobenius precoders, reverse network on
        the fro-normalized filters at power P/Ns (the reference's
        asymmetric convention), per-stream LDL^H solves, and the
        calc_sinrs SINR/capacity reduction. Init is a fixed-iteration
        orthogonal iteration toward the 'svd' init; parity tests feed
        the SAME init to the XLA solver via init='fix'."""
        import math

        from .pallas_planes import herm_solve_cols_ldl
        from .pallas_planes import mat_H as _pmat_H
        K, N, Ns = self._K, self._N, self._Ns
        P = jnp.float32(self._P)
        nv = noise_var
        inv_sqrt_ns = jnp.float32(1.0 / math.sqrt(Ns))

        gauss = gauss_half

        H = [[None] * K for _ in range(K)]
        idx = 0
        for k in range(K):
            for j in range(K):
                rows = []
                for _r in range(N):
                    row = []
                    for _c in range(N):
                        row.append((gauss(planes[idx]),
                                    gauss(planes[idx + 1])))
                        idx += 2
                    rows.append(row)
                H[k][j] = rows
        Hrev = [[_pmat_H(H[j][k]) for j in range(K)] for k in range(K)]

        F = []
        for k in range(K):
            cols = _orth_iter_init(H[k][k], Ns, self._init_iters)
            F.append([_gscale(v, inv_sqrt_ns) for v in cols])
        like = F[0][0][0][0]

        def update(ch, F_cur, p):
            out = []
            for k in range(K):
                first = _herm_full_eye(N, nv, like)
                for j in range(K):
                    for l in range(Ns):
                        t = _gmatvec(ch[k][j], F_cur[j][l])
                        first = _herm_full_add_outer(first, t, p)
                cols = []
                for l in range(Ns):
                    d = _gmatvec(ch[k][k], F_cur[k][l])
                    Bkl = _herm_full_add_outer(first, d, -p)
                    x = herm_solve_cols_ldl(Bkl, [[di] for di in d])
                    cols.append(_gnormalize([row[0] for row in x]))
                out.append([_gscale(u, inv_sqrt_ns) for u in cols])
            return out

        p_rev = P / jnp.float32(Ns)
        for _ in range(self._iters):
            U = update(H, F, P)
            F = update(Hrev, U, p_rev)
        U = update(H, F, P)

        cap = None
        for k in range(K):
            first = _herm_full_eye(N, nv, like)
            for j in range(K):
                for l in range(Ns):
                    t = _gmatvec(H[k][j], F[j][l])
                    first = _herm_full_add_outer(first, t, P)
            for l in range(Ns):
                d = _gmatvec(H[k][k], F[k][l])
                Bkl = _herm_full_add_outer(first, d, -P)
                u = U[k][l]
                num = P * _cabs2(_gdotc(u, d))
                w = _gmatvec(Bkl, u)
                den = jnp.maximum(jnp.abs(_gdotc(u, w)[0]), _EPS)
                c = jnp.log2(1.0 + num / den)
                cap = c if cap is None else cap + c
        return jnp.sum(jnp.where(jnp.isfinite(cap), cap, 0.0))

    # ------------------------------------------------------------------

    def build(self, reps: int, num_tiles: int, mesh=None,
              axis: str = "mc", interpret: bool = False):
        """Jitted ``(seed:int32, noise_var[, start]) ->
        (reps, num_tiles) f32`` per-tile sum-capacity; channels drawn
        on device with streams keyed by the ABSOLUTE repetition index
        (runner bulk-path contract).

        ``mesh``: shard the rep axis over ``mesh.shape[axis]`` devices
        with :func:`shard_map` — each device runs the same kernel over
        its contiguous rep slice with ``start`` advanced by
        ``device_index * reps_local``, so the result is BIT-IDENTICAL
        to the unsharded call (the absolute-index stream contract of
        :func:`~pyphysim_tpu.parallel.shard_reps`).

        ``interpret``: run the kernel under the Pallas interpreter
        (any backend). Without it, a backend other than the GPU raises.
        """
        require_kernel_backend(interpret)

        def prologue(seed, noise_var, start=0):
            seeds = jnp.stack([jnp.asarray(seed, jnp.int32),
                               jnp.asarray(start, jnp.int32)])
            return seeds, jnp.reshape(
                jnp.asarray(noise_var, jnp.float32), (1,))

        return shard_reps(
            lambda n: self._make_call(n, num_tiles, interpret), prologue,
            reps, mesh, axis)

    def _make_call(self, reps: int, num_tiles: int, interpret: bool):
        """The pallas_call over a (reps, num_tiles) grid;
        ``seeds = [seed, start]`` keys every stream by the ABSOLUTE
        repetition index ``start + r``."""
        tile, lane = self._tile, self._lane
        n_entries = self.num_planes // 2

        def kernel(seed_ref, nv_ref, out_ref):
            r = pl.program_id(0)
            s = pl.program_id(1)
            attempt = (seed_ref[1] + r).astype(jnp.uint32)
            planes = channel_planes(seed_ref[0].astype(jnp.uint32),
                                    attempt, block_elements(s, tile, lane),
                                    n_entries)
            out_ref[...] = self._solve_block(planes, nv_ref[0])

        return pl.pallas_call(
            kernel,
            grid=(reps, num_tiles),
            out_shape=jax.ShapeDtypeStruct((reps, num_tiles),
                                           jnp.float32),
            in_specs=[pl.BlockSpec((2,), lambda r, s: (0,)),
                      pl.BlockSpec((1,), lambda r, s: (0,))],
            out_specs=pl.BlockSpec((None, None), lambda r, s: (r, s)),
            backend="triton",
            compiler_params=TRITON_PARAMS,
            interpret=interpret,
            name="ia_max_sinr",
        )

    def reference_caps(self, reps: int, num_tiles: int, seed, noise_var,
                       start=0):
        """``(reps, num_tiles)`` capacity sums of the same repetitions
        as :meth:`build` from the XLA solver ``ia.batched.max_sinr_solve``
        (init 'svd', float32 products at ``highest`` precision), fed the
        same channels drawn from the same generator. For (N, Ns) = (2, 1)
        the kernel's closed-form init IS the dominant right singular
        vector, so the two recursions agree to rounding."""
        from ..ia.batched import calc_sinrs, max_sinr_solve, sum_capacity
        from .cplx import CArray

        K, N, Ns = self._K, self._N, self._Ns
        n = num_tiles * self._tile * self._lane
        elem = jnp.arange(n, dtype=jnp.uint32)
        seed = jnp.asarray(seed, jnp.int32).astype(jnp.uint32)
        nv = jnp.asarray(noise_var, jnp.float32)

        def solve(h):
            F, U = max_sinr_solve(h, jax.random.PRNGKey(0), Ns=Ns,
                                  P=self._P, noise_var=nv,
                                  iterations=self._iters, init="svd")
            return sum_capacity(calc_sinrs(h, F, U, nv, self._P, Ns=Ns))

        def one(attempt):
            planes = channel_planes(seed, attempt.astype(jnp.uint32), elem,
                                    self.num_planes // 2)
            re = jnp.stack([gauss_half(b) for b in planes[0::2]], -1)
            im = jnp.stack([gauss_half(b) for b in planes[1::2]], -1)
            H = CArray(re.reshape(n, K, K, N, N), im.reshape(n, K, K, N, N))
            with jax.default_matmul_precision("highest"):
                caps = jax.vmap(solve)(H)
            caps = jnp.where(jnp.isfinite(caps), caps, 0.0)
            return jnp.sum(caps.reshape(num_tiles, -1), axis=-1)

        attempts = jnp.asarray(start, jnp.int32) + jnp.arange(reps)
        return jax.lax.map(one, attempts)

    # ------------------------------------------------------------------

    @property
    def solves_per_grid_step(self) -> int:
        return self._tile * self._lane
