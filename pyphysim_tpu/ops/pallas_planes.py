"""Complex "plane arithmetic" helpers for Pallas Monte Carlo kernels.

Inside a Monte Carlo kernel the natural data layout is one (rows,
lanes) f32 plane per real scalar, one independent realization per
element: a complex number is a (re, im) tuple of planes, a matrix a
nested list of complex tuples. Everything below is pure elementwise
arithmetic — no gathers, no lax.linalg — shared by the
Max-SINR IA kernel (:mod:`.ia_pallas`) and the BD CoMP kernel
(:mod:`.bd_pallas`).

2x2 Hermitian matrices are ``(p, q, r)`` triples with real planes
``p, r`` on the diagonal and complex ``q`` above it.
"""

from __future__ import annotations

import jax.numpy as jnp

EPS = 1e-30


# ---- complex scalars -----------------------------------------------------

def cmul(a, b):
    return (a[0] * b[0] - a[1] * b[1], a[0] * b[1] + a[1] * b[0])


def cmulc(a, b):
    """a * conj(b)."""
    return (a[0] * b[0] + a[1] * b[1], a[1] * b[0] - a[0] * b[1])


def cadd(a, b):
    return (a[0] + b[0], a[1] + b[1])


def csub(a, b):
    return (a[0] - b[0], a[1] - b[1])


def cscale(a, s):
    return (a[0] * s, a[1] * s)


def cconj(a):
    return (a[0], -a[1])


def cabs2(a):
    return a[0] * a[0] + a[1] * a[1]


def czero_like(x):
    z = jnp.zeros_like(x[0])
    return (z, z)


# ---- generic complex matrices (lists of lists of complex tuples) ---------

def mat_H(M):
    """Conjugate transpose."""
    rows, cols = len(M), len(M[0])
    return [[cconj(M[i][j]) for i in range(rows)] for j in range(cols)]


def mat_mul(A, B):
    """Complex matmul of plane matrices: (m, k) x (k, n)."""
    m, k, n = len(A), len(B), len(B[0])
    out = []
    for i in range(m):
        row = []
        for j in range(n):
            acc = cmul(A[i][0], B[0][j])
            for t in range(1, k):
                acc = cadd(acc, cmul(A[i][t], B[t][j]))
            row.append(acc)
        out.append(row)
    return out


def mat_sub(A, B):
    return [[csub(a, b) for a, b in zip(ra, rb)]
            for ra, rb in zip(A, B)]


def gram_rows(M):
    """M M^H of an (2, n) plane matrix as a 2x2 Hermitian (p, q, r)."""
    p = cabs2(M[0][0])
    r = cabs2(M[1][0])
    q = cmulc(M[0][0], M[1][0])
    for j in range(1, len(M[0])):
        p = p + cabs2(M[0][j])
        r = r + cabs2(M[1][j])
        q = cadd(q, cmulc(M[0][j], M[1][j]))
    return (p, q, r)


def gram_full(M):
    """M M^H of an (m, n) plane matrix as a full m x m complex plane
    matrix (Hermitian; both triangles materialized)."""
    m = len(M)
    out = [[None] * m for _ in range(m)]
    for i in range(m):
        for j in range(i, m):
            acc = cmulc(M[i][0], M[j][0])
            for t in range(1, len(M[0])):
                acc = cadd(acc, cmulc(M[i][t], M[j][t]))
            out[i][j] = acc
            if i != j:
                out[j][i] = cconj(acc)
    return out


def herm_solve_cols_ldl(B, M):
    """B^{-1} M for Hermitian positive-definite n x n B (full complex
    plane matrix) and an (n, c) plane matrix M, via an unrolled LDL^H
    factorization — no square roots, n reciprocals, everything else
    mul/add, and n is a small Python int so the whole solve is
    straight-line elementwise arithmetic (the geometry-general replacement for
    the fixed 2x2-block Schur route). Degenerate pivots are floored at
    EPS only to keep the arithmetic finite; callers guard validity with
    their own SCALE-RELATIVE tests (library convention, CLAUDE.md)."""
    n = len(B)
    c = len(M[0])
    L = [[None] * n for _ in range(n)]
    D = [None] * n
    Dinv = [None] * n
    for j in range(n):
        d = B[j][j][0]
        for k in range(j):
            d = d - cabs2(L[j][k]) * D[k]
        d = jnp.maximum(d, EPS)
        D[j] = d
        Dinv[j] = 1.0 / d
        for i in range(j + 1, n):
            acc = B[i][j]
            for k in range(j):
                acc = csub(acc, cscale(cmulc(L[i][k], L[j][k]), D[k]))
            L[i][j] = cscale(acc, Dinv[j])
    X = [list(row) for row in M]
    # forward substitution: L z = M (unit diagonal)
    for i in range(n):
        for j in range(i):
            for t in range(c):
                X[i][t] = csub(X[i][t], cmul(L[i][j], X[j][t]))
    # diagonal scale
    for i in range(n):
        for t in range(c):
            X[i][t] = cscale(X[i][t], Dinv[i])
    # back substitution: L^H x = z, (L^H)[i][j>i] = conj(L[j][i])
    for i in range(n - 1, -1, -1):
        for j in range(i + 1, n):
            for t in range(c):
                X[i][t] = csub(X[i][t], cmulc(X[j][t], L[j][i]))
    return X


# ---- 2x2 Hermitian closed forms ------------------------------------------

def herm2_solve_cols(B, M):
    """B^{-1} M for Hermitian 2x2 B = (p, q, r) and a (2, n) plane
    matrix M — the adjugate route of ops/cplx.solve at n=2 (callers
    either normalize the result or fold the det into a later scale)."""
    p, q, r = B
    det = p * r - cabs2(q)
    inv = 1.0 / jnp.where(jnp.abs(det) > EPS, det,
                          jnp.where(det >= 0, EPS, -EPS))
    out = []
    n = len(M[0])
    top, bot = [], []
    for j in range(n):
        v0, v1 = M[0][j], M[1][j]
        top.append(cscale(csub(cscale(v0, r), cmul(q, v1)), inv))
        bot.append(cscale(csub(cscale(v1, p), cmulc(v0, q)), inv))
    out.append(top)
    out.append(bot)
    return out


def herm2_eigvals(B):
    """Both eigenvalues of Hermitian 2x2 (p, q, r), (max, min)."""
    p, q, r = B
    mid = 0.5 * (p + r)
    h = 0.5 * (p - r)
    root = jnp.sqrt(h * h + cabs2(q))
    return mid + root, mid - root
