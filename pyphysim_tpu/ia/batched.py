"""Batched, jittable interference alignment (Max-SINR family).

The host-side solvers in :mod:`.algorithms` mirror the reference's
object API with data-dependent convergence. For Monte Carlo at accelerator scale
a different shape wins: FIXED-iteration Max-SINR expressed entirely on
:class:`~pyphysim_tpu.ops.cplx.CArray` tensors, vmappable over thousands
of channel realizations and runnable inside one jitted sweep program.

Channel layout: dense ``H`` of shape ``(K, K, Nr, Nt)`` (receiver k,
transmitter l) — the device-native form of the reference's
matrix-of-matrices (SURVEY §7). All K/Ns loops unroll at trace time
(K and Ns are small and static).

Algorithm parity: [Cadambe2008] max-SINR iteration exactly as the
reference's MaxSinrIASolver (algorithms.py:1243-1504) — per-stream
filters ``U_kl = B_kl^-1 H_kk V_kl`` in the forward network and the same
in the reverse network (``H_rev_kl = H_lk^H``) for the precoders —
but with a fixed iteration count instead of a convergence test
(bounded-iteration jittable form, SURVEY §7 'hard parts').
"""

from __future__ import annotations

import itertools
import math
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ..ops import cplx
from ..ops.cplx import CArray

__all__ = ["max_sinr_solve", "min_leakage_solve", "mmse_solve",
           "alt_min_solve", "alt_min_cost", "closed_form_solve",
           "brute_force_stream_solve", "greedy_stream_solve",
           "stream_combinations", "svd_init_precoders", "calc_sinrs",
           "sum_capacity", "calc_leakage", "random_unit_precoders"]


def _normalize_fro(f: CArray) -> CArray:
    nrm = jnp.sqrt(jnp.sum(f.abs2(), axis=(-2, -1), keepdims=True))
    return CArray(f.re / nrm, f.im / nrm)


def random_unit_precoders(key: jax.Array, K: int, Nt: int,
                          Ns) -> CArray:
    """Random unit-Frobenius-norm precoders, shape (K, Nt, ns_max);
    ``Ns`` may be an int or a per-user tuple (zero columns beyond each
    user's count)."""
    from ..utils.misc import randn_c
    ns = _as_ns(Ns, K)
    ns_max = max(ns)
    f = randn_c(key, K, Nt, ns_max)
    if len(set(ns)) > 1:
        mask = jnp.asarray([[1.0] * n + [0.0] * (ns_max - n) for n in ns],
                           f.re.dtype)[:, None, :]
        f = CArray(f.re * mask, f.im * mask)
    return _normalize_fro(f)


def _as_ns(Ns, K: int) -> Tuple[int, ...]:
    """Per-user stream counts as a static tuple. An int means uniform.

    Per-user counts support the stream-search meta-algorithms
    (reference BruteForceStreamIASolver, algorithms.py:2057-2234):
    tensors stay RECTANGULAR at the maximum count and users with fewer
    streams carry zero precoder/filter columns — zero columns contribute
    nothing to any gram/covariance, and the per-stream loops are static,
    so masked entries are simply never computed."""
    if isinstance(Ns, (int,)):
        return (int(Ns),) * K
    return tuple(int(n) for n in Ns)


def _pad_cols(x: CArray, total: int) -> CArray:
    """Zero-pad the last axis (stream columns) to ``total``."""
    missing = total - x.shape[-1]
    if missing == 0:
        return x
    pad = cplx.zeros(x.shape[:-1] + (missing,), x.re.dtype)
    return cplx.concatenate([x, pad], axis=-1)


def _bkl_covariances(H: CArray, F: CArray, k: int, noise_var,
                     P, Ns) -> list:
    """Bkl (eq. 28) for the ACTIVE streams of user k. ``F``: (K, Nt,
    ns_max) unit-Frobenius-norm precoders (zero columns beyond each
    user's count); powers P (K,).

    Power convention matches the reference's ``full_F = sqrt(P) * F``
    (iabase.py): the TOTAL power of user j is P[j]; per-stream power is
    whatever F's column norms carry (1/Ns each for a balanced
    unit-Frobenius F). The gram scale is therefore P[j], NOT P[j]/Ns —
    dividing by Ns on top of the column norms would double-count it
    (invisible at Ns=1, wrong for Ns>1)."""
    K = H.shape[0]
    ns = _as_ns(Ns, K)
    Nr = H.shape[2]
    eye = cplx.eye(Nr)
    first = CArray(noise_var * eye.re, eye.im * 0.0)
    for j in range(K):
        scale = P[j]
        hf = cplx.matmul(H[k, j], F[j])          # (Nr, ns_max)
        gram = cplx.matmul(hf, hf.mH)
        first = first + CArray(gram.re * scale, gram.im * scale)
    out = []
    hkk_f = cplx.matmul(H[k, k], F[k])           # (Nr, ns_max)
    for l in range(ns[k]):
        v = hkk_f[..., :, l:l + 1]
        second = cplx.matmul(v, v.mH)
        scale = P[k]
        out.append(first - CArray(second.re * scale, second.im * scale))
    return out


def _update_filters(H: CArray, F: CArray, noise_var, P, Ns) -> CArray:
    """Per-stream max-SINR receive filters U (K, Nr, ns_max); inactive
    stream columns stay zero."""
    K = H.shape[0]
    ns = _as_ns(Ns, K)
    ns_max = max(ns)
    us = []
    for k in range(K):
        bkls = _bkl_covariances(H, F, k, noise_var, P, ns)
        cols = []
        hkk_f = cplx.matmul(H[k, k], F[k])
        for l in range(ns[k]):
            rhs = hkk_f[..., :, l:l + 1]
            ukl = cplx.solve(bkls[l], rhs)
            nrm = jnp.sqrt(jnp.sum(ukl.abs2(), axis=(-2, -1),
                                   keepdims=True))
            cols.append(CArray(ukl.re / nrm, ukl.im / nrm))
        uk = _pad_cols(cplx.concatenate(cols, axis=-1), ns_max)
        us.append(_normalize_fro(uk))
    return cplx.stack(us, axis=0)


def svd_init_precoders(H: CArray, Ns) -> CArray:
    """Deterministic 'svd' initialization: F_k = the ns_k dominant right
    singular vectors of the direct channel H_kk, unit Frobenius norm
    (reference ``_initialize_F_with_svd_and_find_W``,
    algorithms.py:183-197). Zero-padded to the maximum stream count."""
    K = H.shape[0]
    ns = _as_ns(Ns, K)
    ns_max = max(ns)
    fs = []
    for k in range(K):
        _, _, vh = cplx.svd(H[k, k])
        f = vh.mH[..., :, :ns[k]]
        fs.append(_pad_cols(_normalize_fro(f), ns_max))
    return cplx.stack(fs, axis=0)


def max_sinr_solve(H: CArray, key: jax.Array, Ns=1,
                   P: float = 1.0, noise_var: float = 0.1,
                   iterations: int = 20,
                   init: str = "random", F0: CArray = None
                   ) -> Tuple[CArray, CArray]:
    """Fixed-iteration Max-SINR IA.

    ``H``: (K, K, Nr, Nt) CArray. ``Ns``: int or per-user tuple of
    stream counts (tensors padded to the max; see :func:`_as_ns`).
    ``init``: 'random' (key-seeded), 'svd' (deterministic, the
    reference's brute-force-search initialization) or 'fix' (start
    from the caller-supplied ``F0`` — the reference's 'fix' option,
    algorithms.py:347-368; ``F0`` must be (K, Nt, ns_max)
    unit-Frobenius precoders). Returns ``(F, U)`` with F
    (K, Nt, ns_max) normalized precoders and U (K, Nr, ns_max)
    receive filters. vmap over leading axes of H/key for Monte Carlo
    batches.
    """
    K = H.shape[0]
    ns = _as_ns(Ns, K)
    # Power scales follow the reference EXACTLY, which is asymmetric for
    # Ns > 1: the FORWARD Bkl builds on full_F = sqrt(P) * F (scale
    # P[j]; iabase._calc_Bkl_cov_matrix_first_part), while the REVERSE
    # network treats the fro-normalized receive filters W as precoders
    # with per-stream power P[j]/Ns[j]
    # (algorithms.MaxSinrIASolver._calc_Bkl_cov_matrix_first_part_rev).
    p_fwd = jnp.full((K,), P)
    p_rev = p_fwd / jnp.asarray(ns, p_fwd.dtype)
    if init == "fix":
        if F0 is None:
            raise ValueError("init='fix' requires F0")
        F = F0
    elif init == "svd":
        F = svd_init_precoders(H, ns)
    else:
        F = random_unit_precoders(key, K, int(H.shape[3]), ns)
    # reverse network channel: H_rev[k, l] = H[l, k]^H
    Hrev = cplx.stack([
        cplx.stack([H[l, k].mH for l in range(K)], axis=0)
        for k in range(K)], axis=0)

    def body(carry, _):
        F_cur = carry
        U = _update_filters(H, F_cur, noise_var, p_fwd, ns)
        F_new = _update_filters(Hrev, U, noise_var, p_rev, ns)
        return F_new, 0

    F, _ = jax.lax.scan(body, F, jnp.arange(iterations))
    U = _update_filters(H, F, noise_var, p_fwd, ns)
    return F, U


def _interference_covariances(H: CArray, F: CArray, P, Ns: int) -> CArray:
    """Qk = sum_{j != k} P_j H_kj F_j F_j^H H_kj^H, stacked (K, Nr, Nr).

    The reference's ``IASolverBaseClass.calc_Q`` (iabase.py) — interference
    covariance seen at each receiver, excluding the own-signal term.
    Same ``full_F = sqrt(P) * F`` power convention as
    :func:`_bkl_covariances` (total user power P[j]).
    """
    K = H.shape[0]
    qs = []
    for k in range(K):
        Nr = H.shape[2]
        q = cplx.zeros((Nr, Nr), dtype=H.re.dtype)
        for j in range(K):
            if j == k:
                continue
            hf = cplx.matmul(H[k, j], F[j])
            gram = cplx.matmul(hf, hf.mH)
            scale = P[j]
            q = q + CArray(gram.re * scale, gram.im * scale)
        qs.append(q)
    return cplx.stack(qs, axis=0)


def calc_leakage(H: CArray, F: CArray, U: CArray,
                 P: float = 1.0) -> jnp.ndarray:
    """Total interference leakage ``sum_k tr(U_k^H Q_k U_k)`` (real).

    The cost minimized by the reference's MinLeakageIASolver
    (algorithms.py:1132-1241, ``get_cost``)."""
    K = H.shape[0]
    Ns = F.shape[-1]
    p_vec = jnp.full((K,), P)
    Q = _interference_covariances(H, F, p_vec, Ns)
    total = 0.0
    for k in range(K):
        m = cplx.matmul(U[k].mH, cplx.matmul(Q[k], U[k]))
        total = total + jnp.trace(m.re, axis1=-2, axis2=-1)
    return total


def min_leakage_solve(H: CArray, key: jax.Array, Ns: int = 1,
                      P: float = 1.0,
                      iterations: int = 20) -> Tuple[CArray, CArray]:
    """Fixed-iteration Min-Leakage IA ([Cadambe2008] alg. 1).

    Behavioral counterpart of the reference's MinLeakageIASolver
    (algorithms.py:1132-1241): receive filters are the ``Ns`` least
    dominant eigenvectors of the interference covariance ``Q_k``;
    precoders come from the same update in the reverse network
    (``H_rev[k, l] = H[l, k]^H``). Noise does not enter the cost.

    ``H``: (K, K, Nr, Nt) CArray. Returns ``(F, U)`` like
    :func:`max_sinr_solve`; vmap over leading axes for batches.
    """
    K = H.shape[0]
    p_vec = jnp.full((K,), P)
    F = random_unit_precoders(key, K, int(H.shape[3]), Ns)
    Hrev = cplx.stack([
        cplx.stack([H[l, k].mH for l in range(K)], axis=0)
        for k in range(K)], axis=0)

    def least_eigvecs(Hdir: CArray, F_cur: CArray) -> CArray:
        Q = _interference_covariances(Hdir, F_cur, p_vec, Ns)
        us = []
        for k in range(K):
            _, v = cplx.eigh(Q[k])               # ascending eigenvalues
            us.append(_normalize_fro(v[..., :Ns]))
        return cplx.stack(us, axis=0)

    def body(carry, _):
        F_cur = carry
        U = least_eigvecs(H, F_cur)
        F_new = least_eigvecs(Hrev, U)
        return F_new, 0

    F, _ = jax.lax.scan(body, F, jnp.arange(iterations))
    U = least_eigvecs(H, F)
    return F, U


def _mmse_precoder(A: CArray, rhs: CArray, P,
                   bisect_iters: int = 40) -> CArray:
    """``V = (A + mu I)^-1 rhs`` with the smallest ``mu >= 0`` such that
    ``||V||_F^2 <= P`` ([Peters2011] power-constrained MMSE precoder,
    reference algorithms.py:1660-1825 ``_calc_Vi``).

    The reference finds ``mu`` with scipy Newton; here the Hermitian PSD
    ``A = Q diag(lam) Q^H`` is eigendecomposed once, so
    ``||V(mu)||^2 = sum |b_ns|^2 / (lam_n + mu)^2`` with ``b = Q^H rhs``
    is an explicit monotone-decreasing scalar function and a
    fixed-iteration bisection is exact to machine precision — fully
    jittable, no data-dependent control flow.
    """
    lam, q = cplx.eigh(A)                        # ascending, (N,), (N, N)
    b = cplx.matmul(q.mH, rhs)                   # (N, Ns)
    b2 = b.abs2()                                # |b|^2, (N, Ns)
    lam = jnp.clip(lam, 0.0)

    def norm2(mu):
        d = (lam + mu)[..., :, None]
        return jnp.sum(b2 / (d * d), axis=(-2, -1))

    # ||V(mu)||^2 <= sum(b2)/mu^2, so this mu_hi guarantees norm2 <= P
    mu_hi = jnp.sqrt(jnp.sum(b2, axis=(-2, -1)) / P) + 1e-12
    mu_lo = jnp.zeros_like(mu_hi)

    def bisect(carry, _):
        lo, hi = carry
        mid = 0.5 * (lo + hi)
        too_big = norm2(mid) > P
        return (jnp.where(too_big, mid, lo), jnp.where(too_big, hi, mid)), 0

    (_, mu), _ = jax.lax.scan(bisect, (mu_lo, mu_hi),
                              jnp.arange(bisect_iters))
    # mu = 0 when the unconstrained solution already satisfies the power
    mu = jnp.where(norm2(0.0) <= P, 0.0, mu)
    d = 1.0 / (lam + mu)[..., :, None]
    return cplx.matmul(q, CArray(b.re * d, b.im * d))


def mmse_solve(H: CArray, key: jax.Array, Ns: int = 1, P: float = 1.0,
               noise_var: float = 0.1,
               iterations: int = 20) -> Tuple[CArray, CArray]:
    """Fixed-iteration MMSE interference alignment ([Peters2011]).

    Behavioral counterpart of the reference's MMSEIASolver
    (algorithms.py:1510-1847): receive filters
    ``U_k = (sum_i H_ki V_i V_i^H H_ki^H + noise I)^-1 H_kk V_k`` and
    power-constrained MMSE precoders
    ``V_i = (sum_k H_ki^H U_k U_k^H H_ki + mu_i I)^-1 H_ii^H U_i``.

    ``H``: (K, K, Nr, Nt) CArray. Returns ``(F, U)`` where ``F`` is the
    FULL (power-scaled, ||F_i||^2 <= P) precoder and ``U`` the MMSE
    receive filter (not normalized — it includes the MMSE scaling).
    vmap over leading axes for Monte Carlo batches.
    """
    K = H.shape[0]
    Nr, Nt = int(H.shape[2]), int(H.shape[3])
    F0 = random_unit_precoders(key, K, Nt, Ns)
    F = CArray(F0.re * jnp.sqrt(P), F0.im * jnp.sqrt(P))  # full precoders

    eye_nr = cplx.eye(Nr)

    def update_U(F_cur: CArray) -> CArray:
        us = []
        for k in range(K):
            cov = CArray(noise_var * eye_nr.re, eye_nr.im * 0.0)
            for i in range(K):
                hv = cplx.matmul(H[k, i], F_cur[i])
                cov = cov + cplx.matmul(hv, hv.mH)
            us.append(cplx.solve(cov, cplx.matmul(H[k, k], F_cur[k])))
        return cplx.stack(us, axis=0)

    def update_F(U: CArray) -> CArray:
        vs = []
        for i in range(K):
            a = cplx.zeros((Nt, Nt), dtype=H.re.dtype)
            for k in range(K):
                hu = cplx.matmul(H[k, i].mH, U[k])
                a = a + cplx.matmul(hu, hu.mH)
            rhs = cplx.matmul(H[i, i].mH, U[i])
            vs.append(_mmse_precoder(a, rhs, P))
        return cplx.stack(vs, axis=0)

    def body(carry, _):
        F_cur = carry
        U = update_U(F_cur)
        return update_F(U), 0

    F, _ = jax.lax.scan(body, F, jnp.arange(iterations))
    U = update_U(F)
    return F, U


def _alt_min_update_C(H: CArray, F: CArray, p_vec, Ns: int) -> CArray:
    """Interference subspaces: C_k = dominant Nr-Ns eigenvectors of the
    interference covariance Q_k (reference AlternatingMinIASolver._updateC,
    algorithms.py:1016-1040). Stacked (K, Nr, Nr-Ns)."""
    K, Nr = H.shape[0], int(H.shape[2])
    Ni = Nr - Ns
    Q = _interference_covariances(H, F, p_vec, Ns)
    cs = []
    for k in range(K):
        _, v = cplx.eigh(Q[k])                   # ascending
        cs.append(v[..., Nr - Ni:])              # dominant Ni
    return cplx.stack(cs, axis=0)


def _alt_min_update_F(H: CArray, C: CArray, Ns: int) -> CArray:
    """F_l = least Ns eigenvectors of sum_{k != l} H_kl^H Y_k H_kl with
    Y_k = I - C_k C_k^H (algorithms.py:1042-1095), unit Frobenius norm."""
    K, Nr, Nt = H.shape[0], int(H.shape[2]), int(H.shape[3])
    eye = cplx.eye(Nr, H.re.dtype)
    Ys = [eye - cplx.matmul(C[k], C[k].mH) for k in range(K)]
    fs = []
    for l in range(K):
        m = cplx.zeros((Nt, Nt), dtype=H.re.dtype)
        for k in range(K):
            if k == l:
                continue
            hkl = H[k, l]
            m = m + cplx.matmul(hkl.mH, cplx.matmul(Ys[k], hkl))
        _, v = cplx.eigh(m)
        fs.append(_normalize_fro(v[..., :Ns]))
    return cplx.stack(fs, axis=0)


def _alt_min_update_U(H: CArray, F: CArray, C: CArray, Ns: int) -> CArray:
    """ZF receive filters: rows of inv([H_kk F_k, C_k]) — returned as
    column filters U = W_H^H (algorithms.py:1097-1126)."""
    K = H.shape[0]
    us = []
    for k in range(K):
        tilde = cplx.concatenate(
            [cplx.matmul(H[k, k], F[k]), C[k]], axis=-1)  # (Nr, Nr)
        w_h = cplx.inv(tilde)[..., :Ns, :]
        us.append(w_h.mH)
    return cplx.stack(us, axis=0)


def alt_min_solve(H: CArray, key, Ns: int = 1, P: float = 1.0,
                  iterations: int = 20,
                  F0: CArray = None) -> Tuple[CArray, CArray]:
    """Fixed-iteration alternating minimization IA
    ([PetersHeathAltMin2009]).

    Behavioral counterpart of the reference's AlternatingMinIASolver
    (algorithms.py:885-1126): alternate C (interference subspace,
    dominant eigenvectors of Q_k), F (least eigenvectors of the
    out-of-subspace interference operator), and the ZF receive filter
    from ``[H_kk F_k, C_k]^-1``. Update order matches the host solver's
    ``_step`` exactly (C from the previous F, W from the NEW F and the
    SAME C), so with a shared ``F0`` the two track each other
    iteration-for-iteration up to per-column eigenvector phases.

    ``H``: (K, K, Nr, Nt) CArray. Returns ``(F, U)`` with U = W_H^H.
    vmap over leading axes for Monte Carlo batches. Pass ``F0`` (K, Nt,
    Ns) to fix the initialization (the host solver's 'fix' mode).
    """
    K, Nt = H.shape[0], int(H.shape[3])
    p_vec = jnp.full((K,), P)
    F = F0 if F0 is not None else random_unit_precoders(key, K, Nt, Ns)
    C = _alt_min_update_C(H, F, p_vec, Ns)

    def body(carry, _):
        F_cur, _C_prev = carry
        C_new = _alt_min_update_C(H, F_cur, p_vec, Ns)
        F_new = _alt_min_update_F(H, C_new, Ns)
        return (F_new, C_new), 0

    (F, C), _ = jax.lax.scan(body, (F, C), jnp.arange(iterations))
    U = _alt_min_update_U(H, F, C, Ns)
    return F, U


def alt_min_cost(H: CArray, F: CArray, P: float = 1.0) -> jnp.ndarray:
    """Interference energy OUTSIDE the interference subspaces:
    ``sum_{k != l} ||(I - C_k C_k^H) H_kl sqrt(P) F_l||_F^2`` with C
    recomputed from F — the cost the reference's
    AlternatingMinIASolver.get_cost reports (algorithms.py:937-963)."""
    K, Nr = H.shape[0], int(H.shape[2])
    Ns = F.shape[-1]
    p_vec = jnp.full((K,), P)
    C = _alt_min_update_C(H, F, p_vec, Ns)
    eye = cplx.eye(Nr, H.re.dtype)
    cost = 0.0
    for k in range(K):
        y = eye - cplx.matmul(C[k], C[k].mH)
        for l in range(K):
            if l == k:
                continue
            hf = cplx.matmul(H[k, l], F[l]) * math.sqrt(P)
            out = cplx.matmul(y, hf)
            cost = cost + jnp.sum(out.abs2(), axis=(-2, -1))
    return cost


def closed_form_solve(H: CArray, Ns: int = 1, P: float = 1.0,
                      noise_var: float = 0.1,
                      use_best_init: bool = True) -> Tuple[CArray, CArray]:
    """3-user closed-form IA [CadambeDoF2008] on the device.

    Behavioral counterpart of the reference's ClosedFormIASolver
    (algorithms.py:42-265): ``E = H31^-1 H32 H12^-1 H13 H23^-1 H21``;
    F0 spans ``Ns`` eigenvectors of E (every static subset is evaluated
    when ``use_best_init`` and the best sum capacity kept — a static
    unrolled search with an argmax select, fully jittable); F1/F2 derive
    from F0 through the cross links; W_k are the least eigenvectors of
    the residual interference Gram matrices. The general complex
    eigendecomposition uses :func:`pyphysim_tpu.ops.cplx.ceig` (analytic
    2x2 / shifted-QR) because ``jnp.linalg.eig`` has no accelerator lowering.

    ``H``: (3, 3, Nr, Nt) CArray (square per-link blocks). Returns
    ``(F, U)`` stacked (3, Nt, Ns) / (3, Nr, Ns); vmap over leading axes.
    """
    if H.shape[0] != 3 or H.shape[1] != 3:
        raise AssertionError(
            "The closed form IA solution only works in a MIMO-IC "
            "scenario with 3 users.")
    Nt = int(H.shape[3])

    # E = solve(H31, H32) @ solve(H12, H13) @ solve(H23, H21)
    e = cplx.matmul(
        cplx.solve(H[2, 0], H[2, 1]),
        cplx.matmul(cplx.solve(H[0, 1], H[0, 2]),
                    cplx.solve(H[1, 2], H[1, 0])))
    _, eigvecs = cplx.ceig(e)

    def candidate(cols) -> Tuple[CArray, CArray, jnp.ndarray]:
        f0 = _normalize_fro(
            cplx.concatenate([eigvecs[..., :, c:c + 1] for c in cols],
                             axis=-1))
        f1 = _normalize_fro(cplx.solve(H[2, 1], cplx.matmul(H[2, 0], f0)))
        f2 = _normalize_fro(cplx.solve(H[1, 2], cplx.matmul(H[1, 0], f0)))
        F = cplx.stack([f0, f1, f2], axis=0)
        # W_k = least Ns eigvecs of (H_k,src F_src)(H_k,src F_src)^H with
        # src the dominant interferer the reference picks
        # (algorithms.py:87-95): src = 1 for k = 0, else 0
        ws = []
        for k, src in enumerate((1, 0, 0)):
            aa = cplx.matmul(H[k, src], F[src])
            gram = cplx.matmul(aa, aa.mH)
            _, v = cplx.eigh(gram)
            ws.append(v[..., :Ns])
        U = cplx.stack(ws, axis=0)
        cap = sum_capacity(calc_sinrs(H, F, U, noise_var, P))
        return F, U, cap

    if not use_best_init:
        F, U, _ = candidate(tuple(range(Ns)))
        return F, U

    combos = list(itertools.combinations(range(Nt), Ns))
    Fs, Us, caps = [], [], []
    for cols in combos:
        F, U, cap = candidate(cols)
        Fs.append(F)
        Us.append(U)
        caps.append(cap)
    caps = jnp.stack(caps, axis=-1)              # (..., C)
    best = jnp.argmax(caps, axis=-1)
    F_all = cplx.stack(Fs, axis=0)               # (C, ..., 3, Nt, Ns)
    U_all = cplx.stack(Us, axis=0)
    # one-hot contraction instead of a dynamic gather (accelerator-friendly and
    # correct under vmap where `best` is batched)
    onehot = jax.nn.one_hot(best, len(combos), dtype=H.re.dtype)

    def select(stacked: CArray, oh) -> CArray:
        w = jnp.moveaxis(oh, -1, 0).reshape(
            (len(combos),) + oh.shape[:-1] + (1, 1, 1))
        return CArray(jnp.sum(stacked.re * w, axis=0),
                      jnp.sum(stacked.im * w, axis=0))

    return select(F_all, onehot), select(U_all, onehot)


def calc_sinrs(H: CArray, F: CArray, U: CArray, noise_var,
               P: float = 1.0, Ns=None) -> jnp.ndarray:
    """Per-stream SINRs, shape (K, ns_max) (Cadambe2008 eq. 28/29).

    ``Ns``: optional per-user stream counts (int or tuple); defaults to
    every column of F. Inactive (zero-padded) streams report SINR 0, so
    :func:`sum_capacity` adds ``log2(1) = 0`` for them."""
    K = H.shape[0]
    ns = _as_ns(F.shape[-1] if Ns is None else Ns, K)
    ns_max = F.shape[-1]
    p_vec = jnp.full((K,), P)
    rows = []
    for k in range(K):
        bkls = _bkl_covariances(H, F, k, noise_var, p_vec, ns)
        hkk_f = cplx.matmul(H[k, k], F[k])
        scale = P
        vals = []
        for l in range(ns[k]):
            ukl = U[k][..., :, l:l + 1]
            aux = cplx.matmul(ukl.mH, hkk_f[..., :, l:l + 1])
            num = scale * aux.abs2()[..., 0, 0]
            den = cplx.matmul(ukl.mH, cplx.matmul(bkls[l], ukl))
            vals.append(num / jnp.abs(den.re[..., 0, 0]))
        vals += [jnp.zeros_like(vals[0])] * (ns_max - ns[k])
        rows.append(jnp.stack(vals, axis=-1))
    return jnp.stack(rows, axis=-2)


def brute_force_stream_solve(H: CArray, key: jax.Array, max_Ns=2,
                             P: float = 1.0, noise_var: float = 0.1,
                             iterations: int = 20,
                             solver=max_sinr_solve):
    """Exhaustive per-user stream-count search, entirely on device.

    Behavioral counterpart of the reference's BruteForceStreamIASolver
    (algorithms.py:2057-2234): every combination in the cartesian
    product ``prod_k {1..max_Ns_k}`` is solved with the DETERMINISTIC
    'svd' initialization; the best sum capacity wins. The combination
    loop is static (unrolled at trace time) and the winner is selected
    with a one-hot argmax contraction, so the whole search jits and
    vmaps over channel batches — the reference runs it one numpy solve
    at a time.

    Returns ``(F, U, best_index, capacities)`` where F/U are padded to
    the global maximum stream count, ``best_index`` indexes
    ``stream_combinations(max_Ns, K)`` and ``capacities`` has one entry
    per combination (the reference's ``every_sum_capacity``).

    Deliberate delta: the reference re-scores degenerate (infeasible)
    combinations AFTER ``_solve_finalize`` drops their collapsed
    precoder dimensions (algorithms.py:247-281), which can relabel the
    winner by epsilon; here every combination scores its honest
    un-cleaned capacity. Winner capacities agree within float tolerance
    (tests pin this); winner LABELS can differ when two combinations
    are statistically equivalent.
    """
    K = H.shape[0]
    combos = stream_combinations(max_Ns, K)
    ns_glob = max(max(c) for c in combos)

    Fs, Us, caps = [], [], []
    for comb in combos:
        F, U = solver(H, key, Ns=comb, P=P, noise_var=noise_var,
                      iterations=iterations, init="svd")
        caps.append(sum_capacity(
            calc_sinrs(H, F, U, noise_var, P, Ns=comb)))
        Fs.append(_pad_cols(F, ns_glob))
        Us.append(_pad_cols(U, ns_glob))

    caps = jnp.stack(caps, axis=-1)              # (..., C)
    best = jnp.argmax(caps, axis=-1)
    onehot = jax.nn.one_hot(best, len(combos), dtype=H.re.dtype)
    F_all = cplx.stack(Fs, axis=0)               # (C, ..., K, Nt, ns)
    U_all = cplx.stack(Us, axis=0)

    def select(stacked: CArray) -> CArray:
        w = jnp.moveaxis(onehot, -1, 0).reshape(
            (len(combos),) + onehot.shape[:-1] + (1, 1, 1))
        return CArray(jnp.sum(stacked.re * w, axis=0),
                      jnp.sum(stacked.im * w, axis=0))

    return select(F_all), select(U_all), best, caps


def stream_combinations(max_Ns, K: int) -> Tuple[Tuple[int, ...], ...]:
    """The static candidate list of :func:`brute_force_stream_solve`:
    cartesian product of per-user stream counts ``1..max_Ns_k``
    (reference algorithms.py:2100-2105)."""
    per_user = [range(1, n + 1) for n in _as_ns(max_Ns, K)]
    return tuple(itertools.product(*per_user))


def sum_capacity(sinrs: jnp.ndarray) -> jnp.ndarray:
    """``sum log2(1 + sinr)`` over streams and users."""
    return jnp.sum(jnp.log2(1.0 + sinrs), axis=(-2, -1))


# ---------------------------------------------------------------------------
# Greedy stream search (device)
# ---------------------------------------------------------------------------

def _bkl_first_part(H: CArray, F: CArray, k: int, noise_var,
                    P_vec) -> CArray:
    """``noise_var I + sum_j P_j H_kj F_j F_j^H H_kj^H`` — the
    stream-independent part of Cadambe eq. 28. Zero (deleted) precoder
    columns contribute nothing, so this is mask-agnostic."""
    Nr = H.shape[2]
    eye = cplx.eye(Nr)
    first = CArray(noise_var * eye.re, eye.im * 0.0)
    for j in range(H.shape[0]):
        hf = cplx.matmul(H[k, j], F[j])
        gram = cplx.matmul(hf, hf.mH)
        first = first + CArray(gram.re * P_vec[j], gram.im * P_vec[j])
    return first


def _masked_update_filters(H: CArray, F: CArray, noise_var,
                           P_vec) -> CArray:
    """Column-count-agnostic :func:`_update_filters`: iterates ALL
    ``ns_max`` columns; a deleted stream is carried purely as a zero
    precoder column, which propagates to a zero filter column through
    the guarded normalization (``H F_col = 0 -> B^-1 0 = 0``). This is
    what lets the greedy search's DATA-DEPENDENT stream deletions stay
    shape-static. ``P_vec`` entries may be traced (the greedy reverse
    network divides by the surviving stream counts)."""
    K = H.shape[0]
    ns_max = F.shape[-1]
    us = []
    for k in range(K):
        first = _bkl_first_part(H, F, k, noise_var, P_vec)
        hkk_f = cplx.matmul(H[k, k], F[k])
        cols = []
        for l in range(ns_max):
            v = hkk_f[..., :, l:l + 1]
            second = cplx.matmul(v, v.mH)
            bkl = first - CArray(second.re * P_vec[k],
                                 second.im * P_vec[k])
            ukl = cplx.solve(bkl, v)
            nrm = jnp.sqrt(jnp.sum(ukl.abs2(), axis=(-2, -1),
                                   keepdims=True))
            safe = jnp.maximum(nrm, jnp.asarray(1e-30, nrm.dtype))
            dead = nrm <= 0
            cols.append(CArray(jnp.where(dead, 0.0, ukl.re / safe),
                               jnp.where(dead, 0.0, ukl.im / safe)))
        us.append(_normalize_fro(cplx.concatenate(cols, axis=-1)))
    return cplx.stack(us, axis=0)


def _masked_sinrs(H: CArray, F: CArray, U: CArray, noise_var,
                  P: float = 1.0) -> jnp.ndarray:
    """Per-stream SINRs over ALL ``ns_max`` columns, 0 for deleted
    (zero-column) streams — the guard-divided form of
    :func:`calc_sinrs` the greedy search needs when the active set is
    data-dependent."""
    K = H.shape[0]
    ns_max = F.shape[-1]
    p_vec = jnp.full((K,), P)
    rows = []
    for k in range(K):
        first = _bkl_first_part(H, F, k, noise_var, p_vec)
        hkk_f = cplx.matmul(H[k, k], F[k])
        vals = []
        for l in range(ns_max):
            v = hkk_f[..., :, l:l + 1]
            second = cplx.matmul(v, v.mH)
            bkl = first - CArray(second.re * P, second.im * P)
            ukl = U[k][..., :, l:l + 1]
            aux = cplx.matmul(ukl.mH, v)
            num = P * aux.abs2()[..., 0, 0]
            den = cplx.matmul(ukl.mH, cplx.matmul(bkl, ukl))
            den = jnp.maximum(jnp.abs(den.re[..., 0, 0]), 1e-30)
            active = jnp.sum(F[k][..., :, l].abs2(), axis=-1) > 0
            vals.append(jnp.where(active, num / den, 0.0))
        rows.append(jnp.stack(vals, axis=-1))
    return jnp.stack(rows, axis=-2)


def greedy_stream_solve(H: CArray, key: jax.Array, Ns=2,
                        P: float = 1.0, noise_var: float = 0.1,
                        iterations: int = 20, init: str = "svd",
                        candidate_init: str = "fix"):
    """Greedy worst-stream deletion, entirely on device.

    Behavioral counterpart of the reference's GreedStreamIASolver
    (algorithms.py:1853-2051): solve at the full stream allocation,
    then repeatedly delete the worst-SINR stream among users that still
    have more than one (algorithms.py:2014-2051 valid_users_idx) and
    re-solve with the 'fix' initialization (the surviving precoders,
    deleted column zeroed) while the sum capacity does not decrease;
    stop on the first strictly-worse deletion (which is rolled back,
    algorithms.py:1988-2005) or when every user is down to one stream.
    The deletion loop is a STATIC unroll of
    ``sum(Ns) - K`` steps whose state advances through ``where``
    selects gated by a keep-going flag, so the data-dependent search
    jits and vmaps over channel batches — the reference runs one numpy
    re-solve per deletion.

    ``candidate_init`` selects the optimizer policy for each deletion
    candidate:

    * ``"fix"`` (default, reference parity): warm re-solve from the
      surviving precoders with the deleted column zeroed — the
      reference's ``initialize_with = 'fix'`` (algorithms.py:1977-1981).
      Warm starts can converge FURTHER than the brute-force search's
      cold svd starts within a fixed iteration budget, so greedy can
      beat brute force under this policy.
    * ``"svd"``: cold re-solve from the svd initialization at the
      candidate's CANONICAL stream allocation (leading columns per
      user). Every candidate is then EXACTLY the solve
      :func:`brute_force_stream_solve` performs for that combination
      (the masked updates reproduce the static-shape solver for prefix
      masks — tests pin this), so greedy <= brute force holds by
      construction: one optimizer policy for both meta-solvers.

    Returns ``(F, U, mask, capacities)``: the best precoders/filters
    found, the (K, ns_max) 0/1 mask of surviving streams, and the
    capacity trajectory (base solve + one entry per unrolled step;
    frozen steps repeat the previous value — the reference's
    ``every_sum_capacity`` analog). The ACHIEVED capacity is
    ``capacities.max(-1)``: when the search terminates on a rejected
    deletion (the common case) the trajectory's last entry is the
    rejected, rolled-back value, not the best.
    """
    K = H.shape[0]
    ns = _as_ns(Ns, K)
    ns_max = max(ns)
    dt = H.re.dtype

    F, U = max_sinr_solve(H, key, ns, P=P, noise_var=noise_var,
                          iterations=iterations, init=init)
    mask = jnp.broadcast_to(
        jnp.asarray([[1.0] * n + [0.0] * (ns_max - n) for n in ns], dt),
        F.re.shape[:-3] + (K, ns_max))
    cap = sum_capacity(_masked_sinrs(H, F, U, noise_var, P))
    caps = [cap]
    bF, bU, bmask, bcap = F, U, mask, cap
    keep = jnp.ones(cap.shape, bool)
    p_fwd = jnp.full((K,), P)

    Hrev = cplx.stack([
        cplx.stack([H[l, k].mH for l in range(K)], axis=0)
        for k in range(K)], axis=0)

    if candidate_init not in ("fix", "svd"):
        raise ValueError(f"unknown candidate_init {candidate_init!r}")
    F_svd = svd_init_precoders(H, ns) if candidate_init == "svd" else None
    iota = jnp.arange(ns_max)

    def _sel(cond, a, b):
        c = cond[..., None, None, None] if a.re.ndim == cond.ndim + 3 \
            else cond
        return CArray(jnp.where(c, a.re, b.re), jnp.where(c, a.im, b.im))

    for _ in range(sum(ns) - K):
        sinr = _masked_sinrs(H, F, U, noise_var, P)
        counts = jnp.sum(mask, axis=-1)                     # (..., K)
        # Only users with more than one stream can lose one: the argmin
        # is masked to DELETABLE streams, so the search keeps going even
        # when the globally worst stream belongs to a single-stream user
        # (reference _find_index_stream_with_worst_sinr's
        # valid_users_idx filtering, algorithms.py:2014-2051).
        deletable = counts > 1                              # (..., K)
        flat = jnp.where((mask > 0) & deletable[..., :, None], sinr,
                         jnp.inf).reshape(
            sinr.shape[:-2] + (K * ns_max,))
        idx = jnp.argmin(flat, axis=-1)
        can = jnp.any(deletable, axis=-1)
        if candidate_init == "svd":
            # cold candidate at the CANONICAL allocation (leading
            # columns of the per-user svd init): identical to the
            # brute-force search's solve for the same stream counts
            k_star = idx // ns_max
            user_oh = jax.nn.one_hot(k_star, K, dtype=dt)
            canon_counts = jnp.maximum(counts - user_oh, 1.0)
            new_mask = (iota < canon_counts[..., :, None]).astype(dt)
            m = new_mask[..., :, None, :]
            F0 = _normalize_fro(CArray(F_svd.re * m, F_svd.im * m))
        else:
            del_oh = jax.nn.one_hot(idx, K * ns_max, dtype=dt).reshape(
                mask.shape)
            new_mask = mask * (1.0 - del_oh)
            m = new_mask[..., :, None, :]
            F0 = CArray(F.re * m, F.im * m)                 # 'fix' init
        new_counts = jnp.sum(new_mask, axis=-1)
        p_rev = p_fwd / jnp.maximum(new_counts, 1.0)

        def body(carry, _):
            Uc = _masked_update_filters(H, carry, noise_var, p_fwd)
            Fn = _masked_update_filters(Hrev, Uc, noise_var, p_rev)
            return Fn, 0

        F2, _ = jax.lax.scan(body, F0, jnp.arange(iterations))
        U2 = _masked_update_filters(H, F2, noise_var, p_fwd)
        cap2 = sum_capacity(_masked_sinrs(H, F2, U2, noise_var, P))

        go = keep & can
        # the reference restores only when STRICTLY worse
        # (old_sum_capacity > new_sum_capacity, algorithms.py:1988-2005),
        # i.e. a tie keeps deleting
        improved = cap2 >= cap
        accept = go & improved
        bF = _sel(accept, F2, bF)
        bU = _sel(accept, U2, bU)
        bmask = jnp.where(accept[..., None, None], new_mask, bmask)
        bcap = jnp.where(accept, cap2, bcap)
        F = _sel(go, F2, F)
        U = _sel(go, U2, U)
        mask = jnp.where(go[..., None, None], new_mask, mask)
        cap = jnp.where(go, cap2, cap)
        caps.append(cap)
        keep = accept
    return bF, bU, bmask, jnp.stack(caps, axis=-1)
