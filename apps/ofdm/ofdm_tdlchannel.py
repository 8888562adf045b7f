#!/usr/bin/env python
"""16-QAM OFDM transmission over a time-varying COST259 TDL channel.

JAX-native counterpart of the reference's ``apps/ofdm/ofdm_tdlchannel.py``
(the north-star chain): QPSK/QAM -> OFDM -> Jakes/COST259 TDL ->
one-tap equalization -> demodulation, as one jitted program vmapped over
Monte Carlo realizations.
"""

import sys

sys.path.insert(0, ".")

import jax
import jax.numpy as jnp
import numpy as np

from pyphysim_tpu.channels import (COST259_TUx, JakesSampleGenerator,
                                   TdlChannel)
from pyphysim_tpu.modulators import OFDM, QAM
from pyphysim_tpu.modulators.ofdm import OfdmOneTapEqualizer
from pyphysim_tpu.simulations import Result, SimulationRunner
from pyphysim_tpu.utils.conversion import dB2Linear
from pyphysim_tpu.utils.misc import count_bit_errors, randn_c


class OfdmTdlSimulationRunner(SimulationRunner):
    def __init__(self):
        super().__init__()
        self.params.add("SNR", np.arange(0.0, 31.0, 5.0))
        self.params.set_unpack_parameter("SNR")
        self.rep_max = 100
        self.update_progress_function_style = "text2"
        self.fft_size = 512
        self.cp_size = 52
        self.num_used = 300
        self.num_ofdm_symbols = 4
        bandwidth = 20e6
        self.qam = QAM(16)
        self.ofdm = OFDM(self.fft_size, self.cp_size, self.num_used)
        self.jakes = JakesSampleGenerator(Fd=30.0, Ts=1.0 / bandwidth, L=16)
        self.channel = TdlChannel(self.jakes, COST259_TUx)
        self.batch_result_types = {
            "bit_errors": Result.SUMTYPE,
            "ber": Result.RATIOTYPE,
        }

    def _gen_simulation_kernel(self, current_parameters):
        snr = dB2Linear(float(current_parameters["SNR"]))
        noise_scale = float(np.sqrt(1.0 / snr))
        n = self.num_used * self.num_ofdm_symbols
        qam, ofdm, channel = self.qam, self.ofdm, self.channel
        eq = OfdmOneTapEqualizer(ofdm)

        def kernel(key):
            k1, k2, k3 = jax.random.split(key, 3)
            data = jax.random.randint(k1, (n,), 0, qam.M)
            tx = ofdm.modulate(qam.modulate(data))
            state = channel.init_state(k2)
            rx, ir, _ = channel.corrupt_data(state, tx)
            rx = rx + randn_c(k3, rx.shape[-1]) * noise_scale
            demod = ofdm.demodulate(rx[..., :tx.shape[-1]])
            equalized = eq.equalize_data(demod, ir)
            decided = qam.demodulate_hard(equalized)
            bit_errors = count_bit_errors(data, decided)
            return {"bit_errors": bit_errors,
                    "ber": (bit_errors, jnp.asarray(n * qam.K))}

        return kernel


def main():
    runner = OfdmTdlSimulationRunner()
    runner.simulate()
    print("\nElapsed time:", runner.elapsed_time)
    print("SNR:", runner.results.params["SNR"])
    print("BER:", np.array(runner.results.get_result_values_list("ber")))


if __name__ == "__main__":
    main()
