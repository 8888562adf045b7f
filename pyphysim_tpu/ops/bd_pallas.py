"""Monolithic BD CoMP capacity Monte-Carlo Pallas kernel.

Register-resident counterpart of the batched Block Diagonalization sweep
(``comm/batched.bd_precoders_batched`` + normalized water-filling +
sum capacity — reference ``comm/blockdiagonalization.py:181-663`` /
the comp_BD app family), geometry-general over ``K`` users with
``Nr_u`` receive antennas each and a square joint transmitter
``Nt_total = K * Nr_u`` (the reference solver's shape-general surface,
``blockdiagonalization.py:272-401``, at kernel speed for
K in {2, 3, 4, ...} x Nr_u in {1, 2}): each (row, lane) element draws
its own Nt x Nt joint channel from the in-kernel counter-based
generator (:mod:`.counter_rng`) and runs the
ENTIRE solve as pure plane arithmetic (:mod:`.pallas_planes`) — the
projector-route null space via an unrolled LDL^H solve of the
(K-1)*Nr_u Hermitian Gram system, closed-form 1x1/2x2 Hermitian
eigenvalues, the rank-based branch-free water-filling of
:func:`~..comm.waterfilling.doWF_jit`, and the per-BS normalization —
with one f32 capacity sum per program as the only device-memory
traffic.

Two algebraic collapses make the kernel far smaller than the XLA
chain it mirrors:

* only the per-user effective singular VALUES are needed for
  capacity: the stream-aligned null-space basis ``V = T^H U / s`` has
  orthonormal columns, so the per-stream transmit powers after
  water-filling and per-BS rescaling are the water-filling powers
  themselves — ``V`` (and the Nt x Nt precoder matrix) is never formed;
* the null-space system ``B X = tilde_H`` with ``B = tilde_H
  tilde_H^H`` Hermitian positive-definite is solved by a square-root-
  free LDL^H factorization unrolled at trace time
  (:func:`~.pallas_planes.herm_solve_cols_ldl`) — the plane-arithmetic
  instance of :func:`~.cplx.hpd_inv`'s recursion, for any block size.

The math is pinned per-batch against the XLA chain on identical
channel realizations across the geometry menu (tests/test_bd_pallas.py;
:meth:`MonteCarloBD.reference_caps` draws the same channels from the
same generator); the XLA path (``comm/batched.py``) remains the
fully-general (non-square, ragged) tool. Streams are keyed as in
:mod:`.ia_pallas`: (seed, absolute repetition) and (absolute element,
channel entry). ``interpret=True`` runs the identical kernel under the
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
from .pallas_planes import (EPS, cabs2, gram_full, gram_rows,
                            herm2_eigvals, herm_solve_cols_ldl, mat_H,
                            mat_mul, mat_sub)

__all__ = ["MonteCarloBD", "CH_PLANES"]

# bit planes of the DEFAULT (bench) geometry K=3 users x 2 rx
# antennas, Nt_total=6 — the contract for any geometry is the instance
# property ``MonteCarloBD.num_planes`` (= (K*Nr_u)^2 * 2)
CH_PLANES = 6 * 6 * 2            # 72


class MonteCarloBD:
    """Builder for the single-kernel BD CoMP capacity sweep over the
    square geometry ``(K, Nr_u, Nt_total = K * Nr_u)`` with normalized
    water-filling (the comp_BD scenario family; bench.py's ``bd_step``
    is the K=3, Nr_u=2 point).

    ``tile`` rows x ``lane`` lanes of independent realizations per
    program (powers of two); ``num_tiles`` programs per repetition.
    Solves per call: ``reps * num_tiles * tile * lane``.
    """

    def __init__(self, tile: int = 1, lane: int = 128,
                 iPu: float = 10.0 / 3, noise_var: float = 1.0,
                 K: int = 3, Nr_u: int = 2,
                 mode: str = "normalized") -> None:
        check_block(tile, lane)
        if K < 2:
            raise ValueError("K must be >= 2")
        if Nr_u not in (1, 2):
            raise ValueError("Nr_u must be 1 or 2 (closed-form "
                             "per-user eigenvalues)")
        if mode not in ("normalized", "global", "none"):
            raise ValueError(f"Unknown mode: {mode!r}")
        self._tile = int(tile)
        self._lane = int(lane)
        self._iPu = float(iPu)
        self._nv = float(noise_var)
        self._K = int(K)
        self._NR = int(Nr_u)
        self._mode = mode

    @property
    def num_planes(self) -> int:
        """Channel bit planes per block: Nt*Nt complex entries x 2."""
        nt = self._K * self._NR
        return nt * nt * 2

    # ------------------------------------------------------------------

    def _solve_block(self, planes, noise_var=None, iPu=None):
        """planes: num_planes (tile, lane) bit planes -> (tile, lane)
        f32 capacity (0 for degenerate/invalid draws). ``noise_var`` /
        ``iPu`` override the constructor values with traced scalars
        (used by the test harness to share one compiled program)."""
        K, NR = self._K, self._NR
        NT = K * NR

        gauss = gauss_half
        # H as an (NT, NT) plane matrix; components ~ N(0, 1/2) per part
        H = []
        idx = 0
        for i in range(NT):
            row = []
            for j in range(NT):
                row.append((gauss(planes[idx]), gauss(planes[idx + 1])))
                idx += 2
            H.append(row)

        gains = []
        for k in range(K):
            others = [i for i in range(NT) if i // NR != k]
            tilde = [H[i] for i in others]            # (m, NT)
            Hk = [H[NR * k + t] for t in range(NR)]   # (NR, NT)
            # null-space projector route: B = tilde tilde^H (HPD),
            # T = Hk (I - tilde^H B^{-1} tilde). Solving W = B^{-1} Y^H
            # (NR columns) instead of B^{-1} tilde (NT columns) does
            # the same projection with NT/NR x fewer substitution
            # columns: T = Hk - (Y B^{-1}) tilde = Hk - W^H tilde.
            B = gram_full(tilde)
            Y = mat_mul(Hk, mat_H(tilde))             # (NR, m)
            W = herm_solve_cols_ldl(B, mat_H(Y))      # (m, NR)
            T = mat_sub(Hk, mat_mul(mat_H(W), tilde))  # (NR, NT)
            if NR == 1:
                g = cabs2(T[0][0])
                for j in range(1, NT):
                    g = g + cabs2(T[0][j])
                gains.append(jnp.maximum(g, 0.0))     # sigma^2
            else:
                l0, l1 = herm2_eigvals(gram_rows(T))
                gains.append(jnp.maximum(l0, 0.0))    # sigma^2, desc
                gains.append(jnp.maximum(l1, 0.0))

        nv = (jnp.float32(self._nv) if noise_var is None
              else jnp.asarray(noise_var, jnp.float32))
        ipu = (jnp.float32(self._iPu) if iPu is None
               else jnp.asarray(iPu, jnp.float32))
        if self._mode == "none":
            # equal per-BS power, no water-filling
            # (block_diagonalize_no_waterfilling): the stream basis
            # columns are orthonormal, so sqrt(iPu)/||block|| scaling
            # puts exactly iPu / Nr_u on every stream
            p_eq = ipu / jnp.float32(NR)
            inv_nv = 1.0 / nv
            cap = None
            for g in gains:
                c = jnp.log2(1.0 + p_eq * g * inv_nv)
                cap = c if cap is None else cap + c
            return self._guarded(cap, gains)

        # branch-free water-filling over the K*NR stream gains — the
        # plane-arithmetic instance of comm/waterfilling.doWF_jit
        total_power = jnp.float32(K) * ipu
        inv = [nv / jnp.maximum(g, EPS) for g in gains]
        n = len(inv)
        rank = []
        for i in range(n):
            r_i = jnp.zeros_like(inv[0])
            for j in range(n):
                if j == i:
                    continue
                lt = (inv[j] < inv[i]).astype(jnp.float32)
                tie = ((inv[j] == inv[i]) &
                       (j < i)).astype(jnp.float32)
                r_i = r_i + lt + tie
            rank.append(r_i)
        mu_ks, feas = [], []
        for kk in range(n):
            sel = [(rank[i] <= kk).astype(jnp.float32) for i in range(n)]
            cum_inv = sum(s * v for s, v in zip(sel, inv))
            at_k = [(rank[i] == kk).astype(jnp.float32)
                    for i in range(n)]
            worst = sum(a * v for a, v in zip(at_k, inv))
            mu_k = (total_power + cum_inv) / jnp.float32(kk + 1)
            mu_ks.append(mu_k)
            feas.append((mu_k >= worst).astype(jnp.float32))
        kept = sum(feas)                        # the optimum keeps the
        mu = sum(m * (kept == jnp.float32(kk + 1)).astype(jnp.float32)
                 for kk, m in enumerate(mu_ks))  # most channels
        powers = [jnp.maximum(mu - v, 0.0) for v in inv]

        if self._mode == "global":
            scale2 = jnp.float32(1.0)  # WF powers used as-is
        else:
            # per-BS normalization (blockdiagonalization.py:403-464):
            # the stream basis columns are orthonormal, so the per-user
            # block power is just the sum of its stream powers
            user_p = [sum(powers[NR * k + t] for t in range(NR))
                      for k in range(K)]
            max_p = user_p[0]
            for up in user_p[1:]:
                max_p = jnp.maximum(max_p, up)
            scale2 = ipu / jnp.maximum(max_p, EPS)

        # per-stream SNR = p * scale2 * g / nv (the noise_var knob
        # applies to the capacity term too, not only the water level)
        inv_nv = 1.0 / nv
        cap = None
        for p, g in zip(powers, gains):
            c = jnp.log2(1.0 + p * scale2 * g * inv_nv)
            cap = c if cap is None else cap + c
        return self._guarded(cap, gains)

    @staticmethod
    def _guarded(cap, gains):
        """Zero out degenerate draws — scale-relative, as in bench.py
        bd_step and comm/batched._bd_conditioning_ok."""
        smax = gains[0]
        smin = gains[0]
        for g in gains[1:]:
            smax = jnp.maximum(smax, g)
            smin = jnp.minimum(smin, g)
        ok = jnp.sqrt(smin) > 1e-6 * jnp.sqrt(smax)
        return jnp.where(jnp.isfinite(cap) & ok, cap, 0.0)

    # ------------------------------------------------------------------

    def build(self, reps: int, num_tiles: int, mesh=None,
              axis: str = "mc", interpret: bool = False):
        """Jitted ``(seed:int32[, start]) -> (reps, num_tiles) f32``
        per-tile capacity sums; channels drawn on device with streams
        keyed by the ABSOLUTE repetition index.

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

        def prologue(seed, start=0):
            return (jnp.stack([jnp.asarray(seed, jnp.int32),
                               jnp.asarray(start, jnp.int32)]),)

        return shard_reps(
            lambda n: self._make_call(n, num_tiles, interpret), prologue,
            reps, mesh, axis)

    def _make_call(self, reps: int, num_tiles: int, interpret: bool):
        """The pallas_call over a (reps, num_tiles) grid;
        ``seeds = [seed, start]`` keys every stream by the ABSOLUTE
        repetition index ``start + r``."""
        tile, lane = self._tile, self._lane
        n_entries = self.num_planes // 2

        def kernel(seed_ref, out_ref):
            r = pl.program_id(0)
            s = pl.program_id(1)
            attempt = (seed_ref[1] + r).astype(jnp.uint32)
            planes = channel_planes(seed_ref[0].astype(jnp.uint32),
                                    attempt, block_elements(s, tile, lane),
                                    n_entries)
            out_ref[...] = jnp.sum(self._solve_block(planes))

        return pl.pallas_call(
            kernel,
            grid=(reps, num_tiles),
            out_shape=jax.ShapeDtypeStruct((reps, num_tiles),
                                           jnp.float32),
            in_specs=[pl.BlockSpec((2,), lambda r, s: (0,))],
            out_specs=pl.BlockSpec((None, None), lambda r, s: (r, s)),
            backend="triton",
            compiler_params=TRITON_PARAMS,
            interpret=interpret,
            name="bd_capacity",
        )

    def reference_caps(self, reps: int, num_tiles: int, seed, start=0):
        """``(reps, num_tiles)`` capacity sums of the same repetitions
        as :meth:`build` from the XLA chain
        ``comm.batched.bd_precoders_batched`` (float32 products at
        ``highest`` precision) on the same channels drawn from the same
        generator, with the same scale-relative degeneracy guard."""
        from ..comm.batched import bd_precoders_batched
        from .cplx import CArray

        K, NT = self._K, self._K * self._NR
        n = num_tiles * self._tile * self._lane
        elem = jnp.arange(n, dtype=jnp.uint32)
        seed = jnp.asarray(seed, jnp.int32).astype(jnp.uint32)
        nv, ipu, mode = self._nv, self._iPu, self._mode

        def solve(h):
            _, Ms, Sigma = bd_precoders_batched(h, K, ipu, nv, mode)
            p = jnp.sum(Ms.re ** 2 + Ms.im ** 2, axis=-2)
            cap = jnp.sum(jnp.log2(1.0 + p * Sigma ** 2 / nv))
            ok = jnp.min(Sigma) > 1e-6 * jnp.max(Sigma)
            return jnp.where(jnp.isfinite(cap) & ok, cap, 0.0)

        def one(attempt):
            planes = channel_planes(seed, attempt.astype(jnp.uint32), elem,
                                    self.num_planes // 2)
            re = jnp.stack([gauss_half(b) for b in planes[0::2]], -1)
            im = jnp.stack([gauss_half(b) for b in planes[1::2]], -1)
            H = CArray(re.reshape(n, NT, NT), im.reshape(n, NT, NT))
            with jax.default_matmul_precision("highest"):
                caps = jax.vmap(solve)(H)
            return jnp.sum(caps.reshape(num_tiles, -1), axis=-1)

        attempts = jnp.asarray(start, jnp.int32) + jnp.arange(reps)
        return jax.lax.map(one, attempts)

    # ------------------------------------------------------------------

    @property
    def solves_per_grid_step(self) -> int:
        return self._tile * self._lane
