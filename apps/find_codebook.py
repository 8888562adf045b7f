#!/usr/bin/env python
"""Grassmannian codebook search by random sampling, device-native.

Counterpart of the reference's ``apps/find_codebook.py`` (CodebookFinder,
``find_codebook``): find the set of K precoders in G(Nt, Ns) maximizing the
minimum pairwise chordal distance.

Device redesign: the reference scores ONE random codebook per iteration with a
Python loop over all K(K-1)/2 pairs, each pair paying a QR + SVD
(find_codebook.py:152-196), and scales with one process per CPU core. Here a
whole BATCH of candidate codebooks is scored per device dispatch:

- batched QR orthonormalizes all B*K precoders at once,
- the full K x K pairwise chordal-distance matrix comes from ONE real
  einsum, using ``d_ij^2 = Ns - tr(P_i P_j)`` with projector
  ``P = Q Q^H`` (the Frobenius inner product of Hermitian projectors — no
  per-pair SVDs),
- a ``lax.scan`` keeps the running best codebook on device, so ``rep_max``
  candidates cost a single dispatch.

Run: python apps/find_codebook.py --Nt 3 --Ns 1 -K 16 --rep_max 100000
"""

import argparse
import math
import os
import sys

sys.path.insert(0, ".")

import jax
import jax.numpy as jnp
import numpy as np

from pyphysim_tpu.ops import cplx
from pyphysim_tpu.ops.cplx import CArray
from pyphysim_tpu.subspace import (
    calc_chordal_distance_from_principal_angles, calc_principal_angles)

(COMPLEX, REAL, COMPLEX_QEGT) = range(3)
_TYPE_NAMES = {COMPLEX: "Complex", REAL: "Real", COMPLEX_QEGT: "Complex QEG"}


def _generate_random_codebooks(key, batch, K, Nt, Ns, codebook_type):
    """(batch, K, Nt, Ns) random codebooks of the requested type
    (find_codebook.py:73-131), each precoder unit-Frobenius-norm (QEGT
    keeps the reference's un-normalized equal-gain entries — the chordal
    distance only sees the column space anyway)."""
    shape = (batch, K, Nt, Ns)
    if codebook_type == COMPLEX:
        c = CArray(jax.random.normal(key, shape),
                   jax.random.normal(jax.random.fold_in(key, 1), shape))
    elif codebook_type == REAL:
        c = CArray(jax.random.normal(key, shape), jnp.zeros(shape))
    elif codebook_type == COMPLEX_QEGT:
        phases = jax.random.uniform(key, shape, maxval=jnp.pi)
        c = cplx.cexp(phases)
    else:
        raise ValueError(f"unknown codebook type {codebook_type}")
    if codebook_type != COMPLEX_QEGT:
        norm = jnp.sqrt(jnp.sum(c.abs2(), axis=(-2, -1), keepdims=True))
        c = CArray(c.re / norm, c.im / norm)
    return c


def min_chordal_dist_sq(codebooks):
    """Minimum squared pairwise chordal distance of each codebook.

    ``codebooks``: CArray (..., K, Nt, Ns) -> (...,) real. Uses
    ``d_ij^2 = Ns - <P_i, P_j>_F`` (one einsum for all pairs) instead of
    the reference's per-pair principal-angle SVD loop
    (find_codebook.py:152-196) — identical value, matmul-shaped.
    """
    q, _ = cplx.qr(codebooks)
    p = cplx.matmul(q, q.mH)                       # (..., K, Nt, Nt)
    gram = (jnp.einsum("...imn,...jmn->...ij", p.re, p.re) +
            jnp.einsum("...imn,...jmn->...ij", p.im, p.im))
    ns = codebooks.shape[-1]
    d2 = jnp.clip(ns - gram, 0.0)
    K = d2.shape[-1]
    offdiag = ~jnp.eye(K, dtype=bool)
    d2 = jnp.where(offdiag, d2, jnp.inf)
    return jnp.min(d2, axis=(-2, -1))


class CodebookFinder:
    """Random-search Grassmannian codebook finder
    (parity: apps/find_codebook.py:22-382, CodebookFinder class).

    The search itself runs on device; this object keeps the best codebook
    found so far across ``find_codebook`` calls, like the reference.
    """

    (COMPLEX, REAL, COMPLEX_QEGT) = (COMPLEX, REAL, COMPLEX_QEGT)

    def __init__(self, Nt, Ns, K, codebook_type=COMPLEX, prng_seed=0,
                 batch=256):
        assert Ns < Nt, "Ns must be lower than Nt"
        self._Nt, self._Ns, self._K = Nt, Ns, K
        self._codebook_type = codebook_type
        self._key = jax.random.PRNGKey(prng_seed or 0)
        self._batch = batch
        self._min_dist = 0.0
        self._best_C = None

    def __repr__(self):
        return ("CodebookFinder: {0} {1} precoders in G({2},{3}) with "
                "minimum distance {4:.4f}").format(
                    self._K, self.type, self._Nt, self._Ns, self._min_dist)

    def find_codebook(self, rep_max=100):
        """Score ``rep_max`` random codebooks (rounded up to whole device
        batches), keeping the best (find_codebook.py:198-232)."""
        steps = max(1, math.ceil(rep_max / self._batch))
        self._key, sub = jax.random.split(self._key)
        K, Nt, Ns, ctype, batch = (self._K, self._Nt, self._Ns,
                                   self._codebook_type, self._batch)

        @jax.jit
        def search(key):
            def body(carry, k):
                best_d2, best_C = carry
                cands = _generate_random_codebooks(k, batch, K, Nt, Ns,
                                                   ctype)
                d2 = min_chordal_dist_sq(cands)
                i = jnp.argmax(d2)
                better = d2[i] > best_d2
                new_C = cplx.where(better, CArray(cands.re[i], cands.im[i]),
                                   best_C)
                return (jnp.where(better, d2[i], best_d2), new_C), None

            init = (jnp.asarray(-jnp.inf),
                    cplx.zeros((K, Nt, Ns)))
            (best_d2, best_C), _ = jax.lax.scan(
                body, init, jax.random.split(key, steps))
            return best_d2, best_C

        best_d2, best_C = search(sub)
        best_dist = float(jnp.sqrt(best_d2))
        if best_dist > self._min_dist:
            self._min_dist = best_dist
            self._best_C = best_C.to_numpy()

    @staticmethod
    def calc_min_chordal_dist(codebook):
        """(min_dist, principal_angles_of_the_min_pair) of a host codebook
        (find_codebook.py:152-196)."""
        codebook = np.asarray(codebook)
        K = codebook.shape[0]
        best = (np.inf, None)
        for i in range(K):
            for j in range(i + 1, K):
                pa = calc_principal_angles(codebook[i], codebook[j])
                d = calc_chordal_distance_from_principal_angles(pa)
                if d < best[0]:
                    best = (d, pa)
        return best

    @property
    def min_dist(self):
        return self._min_dist

    @property
    def principal_angles(self):
        if self._best_C is None:
            return None
        return CodebookFinder.calc_min_chordal_dist(self._best_C)[1]

    @property
    def codebook(self):
        return self._best_C

    @property
    def type(self):
        return _TYPE_NAMES[self._codebook_type]


def find_codebook(Nt, Ns, K, rep_max, prng_seed=0, codebook_type=COMPLEX,
                  batch=256):
    """One-shot functional API (find_codebook.py:388-431)."""
    cb = CodebookFinder(Nt, Ns, K, codebook_type, prng_seed, batch)
    cb.find_codebook(rep_max)
    return cb.codebook


def _save_results(best_dist, best_codebook, principal_angles, filename):
    """npz (+ .mat when scipy is available) like find_codebook.py:348-359."""
    np.savez(filename + ".npz", best_codebook=best_codebook,
             best_dist=best_dist,
             best_principal_angles=np.asarray(principal_angles))
    try:
        import scipy.io
        scipy.io.savemat(filename, {"codebook": best_codebook,
                                    "shape": np.asarray(best_codebook.shape)},
                         oned_as="row")
    except ImportError:
        pass


def main():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--Nt", type=int, default=3)
    parser.add_argument("--Ns", type=int, default=1)
    parser.add_argument("-K", type=int, default=16)
    parser.add_argument("--rep_max", type=int, default=10000)
    parser.add_argument("--batch", type=int, default=256,
                        help="candidate codebooks per device dispatch")
    parser.add_argument("--type", choices=["complex", "real", "qegt"],
                        default="complex")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--outdir", default="codebook_results")
    args = parser.parse_args()

    ctype = {"complex": COMPLEX, "real": REAL,
             "qegt": COMPLEX_QEGT}[args.type]
    cb = CodebookFinder(args.Nt, args.Ns, args.K, ctype, args.seed,
                        args.batch)
    print(f"Scoring {args.rep_max} random codebooks "
          f"({args.K} {cb.type} precoders in G({args.Nt},{args.Ns}))...")
    cb.find_codebook(args.rep_max)
    print(repr(cb))
    pa = cb.principal_angles
    print("Principal angles (degrees):", 180 / np.pi * np.asarray(pa))

    os.makedirs(args.outdir, exist_ok=True)
    filename = os.path.join(
        args.outdir, f"codebook_{args.K}_precoders_in_G({args.Nt},{args.Ns})")
    try:
        previous = float(np.load(filename + ".npz")["best_dist"])
        print(f"Previous minimum distance: {previous}")
    except (IOError, KeyError):
        previous = 0.0
    if cb.min_dist > previous:
        print("Saving new results")
        _save_results(cb.min_dist, cb.codebook, pa, filename)
    else:
        print("Keeping previous (better) results")


if __name__ == "__main__":
    main()
