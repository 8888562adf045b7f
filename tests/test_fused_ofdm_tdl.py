"""The fused OFDM-over-TDL path must reproduce the time-domain chain
EXACTLY (noiseless): same data, same channel state -> same demodulated
receiver symbols, and after noise, statistically identical BER."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pyphysim_tpu.channels.fading import COST259_TUx, TdlChannel
from pyphysim_tpu.channels.fading_generators import JakesSampleGenerator
from pyphysim_tpu.modulators import OFDM, QAM
from pyphysim_tpu.modulators.ofdm import OfdmOneTapEqualizer
from pyphysim_tpu.ops.fused_ofdm_tdl import FusedOfdmTdl
from pyphysim_tpu.utils.misc import random_symbols


def _setup(fft_size=256, cp_size=48, num_used=192, n_sym=6):
    qam = QAM(16)
    ofdm = OFDM(fft_size, cp_size, num_used)
    ofdm.precision = jax.lax.Precision.HIGHEST
    Ts = 1.0 / 20e6
    jakes = JakesSampleGenerator(Fd=30.0, Ts=Ts, L=8)
    channel = TdlChannel(jakes, COST259_TUx, Ts=Ts)
    return qam, ofdm, channel, n_sym * num_used


class TestFusedExactness:
    @pytest.mark.parametrize("mode", ["diag", "spectrum"])
    def test_cached_constants_survive_retracing(self, mode):
        """The per-dtype transform cache holds host constants: the same
        op traced by two separate jits (one per SNR point in the runner)
        must not leak the first trace's values into the second."""
        qam, ofdm, channel, n = _setup()
        fop = FusedOfdmTdl(ofdm, channel, mode=mode)
        tx = qam.modulate(random_symbols(jax.random.PRNGKey(1), n, qam.K))
        state = channel.init_state(jax.random.PRNGKey(2))
        outs = [jax.jit(lambda t, g=g: fop.corrupt_and_demodulate(
            state, t)[0].re * g)(tx) for g in (1.0, 2.0)]
        np.testing.assert_allclose(2 * np.asarray(outs[0]),
                                   np.asarray(outs[1]), rtol=1e-6)

    def test_matches_time_domain_chain(self):
        qam, ofdm, channel, n = _setup()
        key = jax.random.PRNGKey(0)
        k1, k2 = jax.random.split(key)
        data = random_symbols(k1, n, qam.K)
        tx = qam.modulate(data)
        state = channel.init_state(k2)

        # time-domain chain (no noise)
        sig = ofdm.modulate(tx)
        rx_sig, ir_t, _ = channel.corrupt_data(
            state, sig, block_size=ofdm.samples_per_symbol)
        demod_t = ofdm.demodulate(rx_sig[..., :sig.shape[-1]])

        # fused path from the SAME state
        fop = FusedOfdmTdl(ofdm, channel)
        rx_f, ir_f, _ = fop.corrupt_and_demodulate(state, tx)

        assert np.allclose(rx_f.to_numpy(), demod_t.to_numpy(), atol=2e-4)
        assert np.allclose(ir_f.tap_values_sparse.to_numpy(),
                           ir_t.tap_values_sparse.to_numpy(), atol=1e-5)

        # equalized symbols agree too
        eq_t = OfdmOneTapEqualizer(ofdm).equalize_data(demod_t, ir_t)
        eq_f = OfdmOneTapEqualizer(ofdm).equalize_data(rx_f, ir_f)
        assert np.allclose(eq_f.to_numpy(), eq_t.to_numpy(), atol=5e-4)

    def test_diag_matches_spectrum_mode(self):
        # The diagonal collapse (per-used-bin multiply by the channel
        # frequency response) must be bit-close to the explicit
        # conv-spectrum matmul pair for the same channel state.
        qam, ofdm, channel, n = _setup()
        key = jax.random.PRNGKey(3)
        k1, k2 = jax.random.split(key)
        tx = qam.modulate(random_symbols(k1, n, qam.K))
        state = channel.init_state(k2)
        r_diag, _, _ = FusedOfdmTdl(ofdm, channel, mode="diag") \
            .corrupt_and_demodulate(state, tx)
        r_spec, _, _ = FusedOfdmTdl(ofdm, channel, mode="spectrum") \
            .corrupt_and_demodulate(state, tx)
        assert np.allclose(r_diag.to_numpy(), r_spec.to_numpy(), atol=1e-5)

    def test_rejects_short_cp(self):
        qam, ofdm, channel, _ = _setup()
        short = OFDM(256, 16, 192)  # cp < span - 1
        with pytest.raises(ValueError):
            FusedOfdmTdl(short, channel)

    def test_rejects_unknown_mode(self):
        qam, ofdm, channel, _ = _setup()
        with pytest.raises(ValueError):
            FusedOfdmTdl(ofdm, channel, mode="bogus")

    def test_noise_gain_equals_demodulated_noise_std(self):
        # the claim behind post-demod noise injection: unit-variance time
        # AWGN comes out of ofdm.demodulate as white noise of std
        # noise_gain per used bin
        from pyphysim_tpu.utils.misc import randn_c
        _, ofdm, channel, _ = _setup()
        fop = FusedOfdmTdl(ofdm, channel)
        n_sym = 200
        noise = randn_c(jax.random.PRNGKey(9),
                        n_sym * ofdm.samples_per_symbol)
        out = ofdm.demodulate(noise).to_numpy()
        assert np.isclose(np.std(np.abs(out)) * 0 +
                          np.sqrt(np.mean(np.abs(out) ** 2)),
                          fop.noise_gain, rtol=0.02)
        # whiteness: neighboring-bin correlation vanishes
        o = out.reshape(n_sym, -1)
        corr = np.mean(o[:, :-1] * np.conj(o[:, 1:]))
        assert abs(corr) < 0.02 * fop.noise_gain ** 2


class TestFusedChainBER:
    def test_ber_matches_unfused(self):
        import __graft_entry__ as g
        batch, nsym = 16, 192 * 8
        mk = lambda fused: g._make_chain_step(
            num_symbols=nsym, fft_size=256, cp_size=48,
            num_used=192, block_static=True, fused=fused)
        keys = jax.random.split(jax.random.PRNGKey(3), batch)
        snrs = jnp.full((batch,), 10 ** 1.5)
        e_f = int(jnp.sum(jax.vmap(mk(True))(keys, snrs)))
        e_t = int(jnp.sum(jax.vmap(mk(False))(keys, snrs)))
        n_bits = batch * nsym * 4
        # same physics: BERs agree within Monte Carlo tolerance
        assert abs(e_f - e_t) / n_bits < 0.004, (e_f, e_t)
