"""Tests for the real-pair complex core (ops/cplx.py, ops/fft.py) — the
foundation every other layer builds on. Checked against numpy complex
arithmetic on CPU; identical code runs on the accelerator (the device code path uses no
complex dtypes)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pyphysim_tpu.ops import cplx
from pyphysim_tpu.ops import fft as cfft
from pyphysim_tpu.ops.cplx import CArray


def rand_c(shape, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(*shape) + 1j * rng.randn(*shape)).astype(np.complex64)


def as_c(x):
    return cplx.from_numpy(x)


class TestArithmetic:
    def test_roundtrip(self):
        x = rand_c((3, 4))
        assert np.allclose(as_c(x).to_numpy(), x, atol=1e-6)

    def test_add_sub_mul_div(self):
        a, b = rand_c((2, 5), 1), rand_c((2, 5), 2)
        ca, cb = as_c(a), as_c(b)
        assert np.allclose((ca + cb).to_numpy(), a + b, atol=1e-5)
        assert np.allclose((ca - cb).to_numpy(), a - b, atol=1e-5)
        assert np.allclose((ca * cb).to_numpy(), a * b, atol=1e-4)
        assert np.allclose((ca / cb).to_numpy(), a / b, atol=1e-4)
        assert np.allclose((2.0 * ca).to_numpy(), 2 * a, atol=1e-5)
        assert np.allclose((ca * (1 - 2j)).to_numpy(), a * (1 - 2j),
                           atol=1e-4)
        assert np.allclose((1.0 / ca).to_numpy(), 1 / a, atol=1e-4)
        assert np.allclose((-ca).to_numpy(), -a, atol=1e-6)

    def test_conj_abs(self):
        a = rand_c((4,), 3)
        ca = as_c(a)
        assert np.allclose(ca.conj().to_numpy(), a.conj(), atol=1e-6)
        assert np.allclose(np.asarray(ca.abs2()), np.abs(a) ** 2, atol=1e-4)
        assert np.allclose(np.asarray(ca.abs()), np.abs(a), atol=1e-5)
        assert np.allclose(np.asarray(ca.angle()), np.angle(a), atol=1e-5)

    def test_cexp(self):
        theta = jnp.linspace(0, 2 * np.pi, 16)
        assert np.allclose(cplx.cexp(theta).to_numpy(),
                           np.exp(1j * np.asarray(theta)), atol=1e-6)

    def test_exp(self):
        a = rand_c((5,), 4) * 0.3
        assert np.allclose(cplx.exp(as_c(a)).to_numpy(), np.exp(a), atol=1e-5)

    def test_where_sum_mean_stack(self):
        a, b = rand_c((3, 4), 5), rand_c((3, 4), 6)
        mask = np.asarray(a.real > 0)
        w = cplx.where(jnp.asarray(mask), as_c(a), as_c(b))
        assert np.allclose(w.to_numpy(), np.where(mask, a, b), atol=1e-6)
        assert np.allclose(as_c(a).sum(axis=0).to_numpy(), a.sum(0),
                           atol=1e-5)
        assert np.allclose(as_c(a).mean().to_numpy(), a.mean(), atol=1e-6)
        st = cplx.stack([as_c(a), as_c(b)], axis=0)
        assert st.shape == (2, 3, 4)
        cat = cplx.concatenate([as_c(a), as_c(b)], axis=1)
        assert cat.shape == (3, 8)

    def test_getitem_at(self):
        a = rand_c((4, 4), 7)
        ca = as_c(a)
        assert np.allclose(ca[1:3, ::2].to_numpy(), a[1:3, ::2], atol=1e-6)
        updated = ca.at_set((0, 0), 5 + 5j)
        assert updated.to_numpy()[0, 0] == 5 + 5j

    def test_pytree(self):
        # CArray must flow through jit/vmap unchanged
        a = as_c(rand_c((8,), 8))

        @jax.jit
        def f(x):
            return (x * x.conj()).re

        assert np.allclose(np.asarray(f(a)), np.abs(a.to_numpy()) ** 2,
                           atol=1e-4)


class TestMatmul:
    def test_matmul(self):
        a, b = rand_c((4, 6), 1), rand_c((6, 3), 2)
        c = cplx.matmul(as_c(a), as_c(b))
        assert np.allclose(c.to_numpy(), a @ b, atol=1e-3)

    def test_matmul_batched(self):
        a, b = rand_c((5, 4, 6), 3), rand_c((5, 6, 3), 4)
        c = cplx.matmul(as_c(a), as_c(b))
        assert np.allclose(c.to_numpy(), a @ b, atol=1e-3)

    def test_mH_mT(self):
        a = rand_c((3, 5), 5)
        assert np.allclose(as_c(a).mH.to_numpy(), a.conj().T, atol=1e-6)
        assert np.allclose(as_c(a).mT.to_numpy(), a.T, atol=1e-6)

    def test_outer(self):
        a, b = rand_c((4,), 6), rand_c((3,), 7)
        assert np.allclose(cplx.outer(as_c(a), as_c(b)).to_numpy(),
                           np.outer(a, b), atol=1e-4)

    def test_einsum(self):
        a, b = rand_c((2, 4, 6), 8), rand_c((2, 6, 3), 9)
        c = cplx.einsum("bij,bjk->bik", as_c(a), as_c(b))
        assert np.allclose(c.to_numpy(), np.einsum("bij,bjk->bik", a, b),
                           atol=1e-3)


class TestLinalg:
    def test_solve(self):
        a = rand_c((4, 4), 1) + 4 * np.eye(4)
        b = rand_c((4, 2), 2)
        x = cplx.solve(as_c(a), as_c(b))
        assert np.allclose(x.to_numpy(), np.linalg.solve(a, b), atol=1e-3)

    def test_solve_vector_batched(self):
        a = rand_c((3, 4, 4), 3) + 4 * np.eye(4)
        b = rand_c((3, 4), 4)
        x = cplx.solve(as_c(a), as_c(b))
        expected = np.stack([np.linalg.solve(a[i], b[i]) for i in range(3)])
        assert np.allclose(x.to_numpy(), expected, atol=1e-3)

    def test_inv(self):
        a = rand_c((4, 4), 5) + 4 * np.eye(4)
        assert np.allclose(cplx.inv(as_c(a)).to_numpy(), np.linalg.inv(a),
                           atol=1e-3)

    def test_hpd_inv(self):
        # recursive Schur-block inverse vs numpy, odd and even sizes,
        # batched, and at a small channel scale
        for n in (1, 2, 3, 4, 5, 6, 8):
            x = rand_c((2, n, n), 20 + n)
            a = (x @ x.conj().swapaxes(-2, -1) +
                 0.5 * np.eye(n)).astype(np.complex64)
            got = cplx.hpd_inv(as_c(a)).to_numpy()
            want = np.linalg.inv(a.astype(np.complex128))
            assert np.allclose(got, want, rtol=2e-3, atol=2e-3), n
        sm = (1e-4 * (rand_c((4, 4), 31) @ rand_c((4, 4), 31).conj().T
                      + 2 * np.eye(4))).astype(np.complex64)
        got = cplx.hpd_inv(as_c(sm)).to_numpy()
        assert np.allclose(got, np.linalg.inv(sm.astype(np.complex128)),
                           rtol=2e-3)

    def test_inv2x2_scale_invariant(self):
        # The closed-form 2x2 path normalizes by the max |entry|, so
        # tiny- and huge-scale well-conditioned inputs invert exactly —
        # the comp_BD scenarios run at ~1e-4 channel scales, and an
        # absolute determinant floor would zero them out silently.
        base = rand_c((2, 2), 7) + 2 * np.eye(2)
        for scale in (1e-8, 1e-4, 1.0, 1e6, 1e12):
            a = (base * scale).astype(np.complex64)
            got = cplx.inv(as_c(a)).to_numpy()
            assert np.allclose(got, np.linalg.inv(a.astype(np.complex128)),
                               rtol=1e-3), scale

    def test_inv2x2_singular_propagates_nonfinite(self):
        # Singular (and numerically singular) 2x2 draws must come out
        # NON-finite so isfinite-based __valid__ masks catch them, like
        # the general real-embedded LU path — NOT as a finite garbage
        # inverse that silently skews Monte Carlo statistics.
        col = rand_c((2, 1), 8)
        sing = np.concatenate([col, 2.0 * col], axis=1)  # rank 1
        for scale in (1e-6, 1.0, 1e6):
            got = cplx.inv(as_c(sing * scale)).to_numpy()
            assert not np.isfinite(got).all(), scale
        # 1x1 zero likewise
        z = cplx.inv(as_c(np.zeros((1, 1), np.complex64))).to_numpy()
        assert not np.isfinite(z).all()

    def test_eigh(self):
        x = rand_c((4, 4), 6)
        h = x @ x.conj().T + np.eye(4)
        w, v = cplx.eigh(as_c(h))
        w_np = np.linalg.eigvalsh(h)
        assert np.allclose(np.asarray(w), w_np, atol=1e-2)
        # eigenvector property H v = w v
        V = v.to_numpy()
        for k in range(4):
            assert np.allclose(h @ V[:, k], w_np[k] * V[:, k], atol=2e-2)

    def test_eigh_degenerate_identity(self):
        # the classic failure mode of the naive embedding route
        w, v = cplx.eigh(cplx.eye(3))
        V = v.to_numpy()
        assert np.allclose(np.asarray(w), 1.0, atol=1e-3)
        # basis must be complex-orthonormal (full rank over C!)
        assert np.allclose(V.conj().T @ V, np.eye(3), atol=1e-3)

    def test_eigh_batched(self):
        x = rand_c((5, 3, 3), 7)
        h = x @ np.conj(np.transpose(x, (0, 2, 1))) + np.eye(3)
        w, v = cplx.eigh(as_c(h))
        for i in range(5):
            assert np.allclose(np.asarray(w)[i], np.linalg.eigvalsh(h[i]),
                               atol=1e-2)

    def test_svd(self):
        a = rand_c((6, 4), 8)
        u, s, vh = cplx.svd(as_c(a))
        s_np = np.linalg.svd(a, compute_uv=False)
        assert np.allclose(np.asarray(s), s_np, atol=1e-2)
        U, VH = u.to_numpy(), vh.to_numpy()
        assert np.allclose(U @ np.diag(np.asarray(s)) @ VH, a, atol=3e-2)
        assert np.allclose(U.conj().T @ U, np.eye(4), atol=1e-3)
        assert np.allclose(VH @ VH.conj().T, np.eye(4), atol=1e-3)

    def test_svd_wide(self):
        a = rand_c((3, 5), 9)
        u, s, vh = cplx.svd(as_c(a))
        s_np = np.linalg.svd(a, compute_uv=False)
        assert np.allclose(np.asarray(s), s_np, atol=1e-2)
        assert np.allclose(
            u.to_numpy() @ np.diag(np.asarray(s)) @ vh.to_numpy(), a,
            atol=3e-2)

    def test_svd_full_matrices_tall(self):
        a = rand_c((6, 4), 21)
        u, s, vh = cplx.svd(as_c(a), full_matrices=True)
        U, VH = u.to_numpy(), vh.to_numpy()
        assert U.shape == (6, 6) and VH.shape == (4, 4)
        # full unitary basis and exact reconstruction from the thin part
        assert np.allclose(U.conj().T @ U, np.eye(6), atol=1e-3)
        assert np.allclose(U[:, :4] @ np.diag(np.asarray(s)) @ VH, a,
                           atol=3e-2)

    def test_svd_full_matrices_wide(self):
        a = rand_c((3, 5), 22)
        u, s, vh = cplx.svd(as_c(a), full_matrices=True)
        U, VH = u.to_numpy(), vh.to_numpy()
        assert U.shape == (3, 3) and VH.shape == (5, 5)
        assert np.allclose(VH @ VH.conj().T, np.eye(5), atol=1e-3)
        assert np.allclose(U @ np.diag(np.asarray(s)) @ VH[:3], a,
                           atol=3e-2)

    def test_svd_full_matrices_batched(self):
        a = rand_c((4, 5, 2), 23)
        u, s, vh = cplx.svd(as_c(a), full_matrices=True)
        U = u.to_numpy()
        assert U.shape == (4, 5, 5)
        for i in range(4):
            assert np.allclose(U[i].conj().T @ U[i], np.eye(5), atol=1e-3)

    def test_cholesky(self):
        x = rand_c((4, 4), 10)
        h = x @ x.conj().T + 2 * np.eye(4)
        L = cplx.cholesky(as_c(h)).to_numpy()
        assert np.allclose(np.triu(L, 1), 0, atol=1e-6)
        assert np.allclose(L @ L.conj().T, h, atol=1e-2)

    def test_qr(self):
        a = rand_c((6, 4), 11)
        q, r = cplx.qr(as_c(a))
        Q, R = q.to_numpy(), r.to_numpy()
        assert np.allclose(Q @ R, a, atol=1e-2)
        assert np.allclose(Q.conj().T @ Q, np.eye(4), atol=1e-3)
        assert np.allclose(np.tril(R, -1), 0, atol=1e-5)

    def test_pinv(self):
        a = rand_c((5, 3), 12)
        p = cplx.pinv(as_c(a)).to_numpy()
        assert np.allclose(p, np.linalg.pinv(a), atol=1e-2)

    def test_pinv_scale_invariant(self):
        # regression: eigh's tie-break perturbation must scale with the
        # matrix — an absolute epsilon destroyed ~1e-7-scale channels
        a = rand_c((6, 6), 13)
        for scale in (1.0, 7.7e-7, 1e-8):
            w = cplx.pinv(as_c(a * scale)).to_numpy()
            resid = np.abs(w @ (a * scale) - np.eye(6)).max()
            assert resid < 1e-4, (scale, resid)

    def test_pinv_rank_deficient(self):
        # the Gram route's junk singular values (~sqrt(eps) s_max) must
        # be truncated, and refinement must preserve W A W = W
        b = rand_c((6, 3), 14)
        c = np.concatenate([b, b[:, :1]], axis=1)  # rank 3, 6x4
        w = cplx.pinv(as_c(c)).to_numpy()
        assert np.abs(w @ c @ w - w).max() < 1e-5
        assert np.allclose(w, np.linalg.pinv(c), atol=1e-3)


class TestFFT:
    @pytest.mark.parametrize("n", [8, 64, 52, 256, 512])
    def test_fft_matches_numpy(self, n):
        x = rand_c((5, n), seed=n)
        X = cfft.fft(as_c(x))
        assert np.allclose(X.to_numpy(), np.fft.fft(x, axis=-1),
                           atol=2e-2 * np.sqrt(n))

    @pytest.mark.parametrize("n", [8, 64, 256, 512])
    def test_ifft_matches_numpy(self, n):
        x = rand_c((3, n), seed=n + 1)
        X = cfft.ifft(as_c(x))
        assert np.allclose(X.to_numpy(), np.fft.ifft(x, axis=-1), atol=1e-4)

    def test_fft_roundtrip(self):
        x = rand_c((2, 128), 13)
        y = cfft.ifft(cfft.fft(as_c(x)))
        assert np.allclose(y.to_numpy(), x, atol=1e-4)

    def test_fft_padded(self):
        x = rand_c((4, 52), 14)
        X = cfft.fft(as_c(x), n=64)
        assert np.allclose(X.to_numpy(), np.fft.fft(x, n=64, axis=-1),
                           atol=1e-3)

    def test_fft_jit(self):
        x = as_c(rand_c((4, 64), 15))
        f = jax.jit(lambda v: cfft.fft(v))
        assert np.allclose(f(x).to_numpy(),
                           np.fft.fft(x.to_numpy(), axis=-1), atol=1e-3)

    def test_fftshift_indexes(self):
        for n in (8, 9, 64):
            assert np.array_equal(cfft.fftshift_indexes(n),
                                  np.fft.fftshift(np.arange(n)))


class TestCeigGeneral:
    """Direct coverage of the general complex eigendecomposition
    (cplx.ceig), including the shifted-QR branch for n >= 3 — the
    precision-critical path the 3-user closed-form IA rides when
    Nt >= 3 (VERDICT round-2 item 3). Residuals and eigenvalues are
    checked against numpy.linalg.eig on CPU."""

    @staticmethod
    def _unpack(w, V):
        return (np.asarray(w.re) + 1j * np.asarray(w.im),
                np.asarray(V.re) + 1j * np.asarray(V.im))

    @staticmethod
    def _max_residual(A, wn, Vn):
        """max_l ||A v_l - lambda_l v_l|| / ||A||  (unit-norm v_l)."""
        res = np.linalg.norm(A @ Vn - wn[..., None, :] * Vn, axis=-2)
        return float((res / np.linalg.norm(
            A, axis=(-2, -1))[..., None]).max())

    @staticmethod
    def _max_eigval_err(A, wn):
        """Best-assignment eigenvalue error vs numpy, relative to the
        spectral scale."""
        from scipy.optimize import linear_sum_assignment
        worst = 0.0
        for b in range(A.shape[0]):
            ref = np.linalg.eigvals(A[b])
            C = np.abs(ref[:, None] - wn[b][None, :])
            r, c = linear_sum_assignment(C)
            worst = max(worst, C[r, c].max() / np.abs(ref).max())
        return worst

    @pytest.mark.parametrize("n", [3, 4, 6])
    def test_qr_branch_random_simple_spectrum(self, n):
        rng = np.random.default_rng(n)
        A = (rng.normal(size=(8, n, n)) +
             1j * rng.normal(size=(8, n, n))).astype(np.complex64)
        w, V = cplx.ceig(as_c(A))
        wn, Vn = self._unpack(w, V)
        assert np.isfinite(wn).all() and np.isfinite(Vn).all()
        assert self._max_residual(A, wn, Vn) < 1e-4
        assert self._max_eigval_err(A, wn) < 1e-4

    def test_qr_branch_vmapped_matches_batched(self):
        n = 4
        rng = np.random.default_rng(7)
        A = (rng.normal(size=(5, n, n)) +
             1j * rng.normal(size=(5, n, n))).astype(np.complex64)
        wb, Vb = cplx.ceig(as_c(A))          # batched (leading axis)
        wv, Vv = jax.vmap(cplx.ceig)(as_c(A))  # vmapped
        np.testing.assert_allclose(np.asarray(wv.re), np.asarray(wb.re),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(np.asarray(wv.im), np.asarray(wb.im),
                                   rtol=1e-5, atol=1e-5)
        wn, Vn = self._unpack(wv, Vv)
        assert self._max_residual(A, wn, Vn) < 1e-4

    def test_qr_branch_jits(self):
        n = 3
        rng = np.random.default_rng(3)
        A = (rng.normal(size=(2, n, n)) +
             1j * rng.normal(size=(2, n, n))).astype(np.complex64)
        w, V = jax.jit(cplx.ceig)(as_c(A))
        wn, Vn = self._unpack(w, V)
        assert self._max_residual(A, wn, Vn) < 1e-4

    def test_near_degenerate_spectrum(self):
        """Two eigenvalues separated by 1e-3 of the spectral scale: the
        shifted-QR deflation must not stall or NaN, and the computed
        pairs must still satisfy the eigen-residual bound."""
        rng = np.random.default_rng(0)
        for sep in (1e-2, 1e-3, 1e-4):
            lam = np.array([1.0 + 0.5j, 1.0 + 0.5j + sep,
                            -0.7 + 0.2j, 2.0 - 1.0j])
            Vt = rng.normal(size=(4, 4)) + 1j * rng.normal(size=(4, 4))
            A = (Vt @ np.diag(lam) @ np.linalg.inv(Vt)).astype(
                np.complex64)[None]
            w, V = cplx.ceig(as_c(A))
            wn, Vn = self._unpack(w, V)
            assert np.isfinite(wn).all() and np.isfinite(Vn).all()
            assert self._max_residual(A, wn, Vn) < 1e-3
            from scipy.optimize import linear_sum_assignment
            C = np.abs(lam[:, None] - wn[0][None, :])
            r, c = linear_sum_assignment(C)
            assert C[r, c].max() < 1e-2

    def test_2x2_analytic_branch_matches_numpy(self):
        rng = np.random.default_rng(2)
        A = (rng.normal(size=(6, 2, 2)) +
             1j * rng.normal(size=(6, 2, 2))).astype(np.complex64)
        w, V = cplx.ceig(as_c(A))
        wn, Vn = self._unpack(w, V)
        assert self._max_residual(A, wn, Vn) < 1e-5
        assert self._max_eigval_err(A, wn) < 1e-5


class TestEighSmallNFastPaths:
    """The closed-form 2x2 and round-robin Jacobi (3 <= n <= 8) eigh
    branches: residual, unitarity and eigenvalues against numpy, plus
    the degenerate cases the tie-break contract covers."""

    @pytest.mark.parametrize("n", [2, 3, 4, 6, 8])
    def test_hermitian_random(self, n):
        rng = np.random.default_rng(n)
        X = rng.normal(size=(16, n, n)) + 1j * rng.normal(size=(16, n, n))
        A = (X @ np.conj(np.swapaxes(X, -1, -2))).astype(np.complex64)
        w, V = cplx.eigh(as_c(A))
        wn, Vn = np.asarray(w), V.to_numpy()
        # ascending
        assert np.all(np.diff(wn, axis=-1) >= -1e-4)
        # eigenvalues match numpy
        wr = np.linalg.eigvalsh(A)
        assert (np.abs(wn - wr) /
                np.abs(wr).max(-1, keepdims=True)).max() < 1e-5
        # eigen-residual and unitarity at f32 machine precision
        res = np.linalg.norm(A @ Vn - Vn * wn[..., None, :],
                             axis=(-2, -1))
        assert (res / np.linalg.norm(A, axis=(-2, -1))).max() < 1e-5
        VhV = np.conj(np.swapaxes(Vn, -1, -2)) @ Vn
        assert np.abs(VhV - np.eye(n)).max() < 1e-5

    @pytest.mark.parametrize("n", [2, 4, 6])
    def test_degenerate_finite_and_unitary(self, n):
        for A in (np.eye(n, dtype=np.complex64)[None],
                  np.zeros((1, n, n), np.complex64)):
            w, V = cplx.eigh(as_c(A))
            Vn = V.to_numpy()
            assert np.isfinite(np.asarray(w)).all()
            assert np.isfinite(Vn).all()
            VhV = np.conj(np.swapaxes(Vn, -1, -2)) @ Vn
            assert np.abs(VhV - np.eye(n)).max() < 1e-5

    def test_jit_vmap(self):
        n = 6
        rng = np.random.default_rng(1)
        X = rng.normal(size=(4, n, n)) + 1j * rng.normal(size=(4, n, n))
        A = (X @ np.conj(np.swapaxes(X, -1, -2))).astype(np.complex64)
        wb, _ = cplx.eigh(as_c(A))
        wv, _ = jax.jit(jax.vmap(cplx.eigh))(as_c(A))
        np.testing.assert_allclose(np.asarray(wv), np.asarray(wb),
                                   rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize("n", [2, 4])
    @pytest.mark.parametrize("scale", [1e-25, 1e18])
    def test_extreme_scales(self, n, scale):
        """The closed forms square entries, so without internal
        normalization f32 inputs at ~1e-25 (Gram of a deeply
        pathloss-scaled channel) or ~1e18 would flush/overflow."""
        rng = np.random.default_rng(0)
        X = rng.normal(size=(4, n, n)) + 1j * rng.normal(size=(4, n, n))
        A = ((X @ np.conj(np.swapaxes(X, -1, -2))) *
             scale).astype(np.complex64)
        w, V = cplx.eigh(as_c(A))
        wn = np.asarray(w).astype(np.float64)
        Vn = V.to_numpy().astype(np.complex128)
        assert np.isfinite(wn).all() and np.isfinite(Vn).all()
        A64 = A.astype(np.complex128)   # the CHECKS need f64: norms of
        # 1e-25-scale f32 arrays flush to 0 and 0/0-NaN the assertions
        wr = np.linalg.eigvalsh(A64)
        np.testing.assert_allclose(
            wn, wr, rtol=1e-4, atol=1e-5 * np.abs(wr).max())
        res = np.linalg.norm(A64 @ Vn - Vn * wn[..., None, :],
                             axis=(-2, -1))
        assert (res / np.linalg.norm(A64, axis=(-2, -1))).max() < 1e-5
