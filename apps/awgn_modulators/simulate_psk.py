#!/usr/bin/env python
"""Monte Carlo BER/SER simulation of M-PSK over AWGN.

JAX-native counterpart of the reference's
``apps/awgn_modulators/simulate_psk.py``: the per-repetition chain
(modulate -> AWGN -> demodulate -> count errors) is expressed as a jitted
kernel vmapped over repetitions; the SimulationRunner sweeps SNR and
handles early stop / checkpointing / progress.

Run:  python apps/awgn_modulators/simulate_psk.py [-c config] [-i index]
"""

import sys

sys.path.insert(0, ".")

import jax
import jax.numpy as jnp
import numpy as np

from pyphysim_tpu.modulators import PSK
from pyphysim_tpu.simulations import Result, SimulationRunner, \
    simulate_do_what_i_mean
from pyphysim_tpu.utils.conversion import dB2Linear
from pyphysim_tpu.utils.misc import count_bit_errors, randn_c

CONFIG_SPEC = """
[Simulation]
SNR = real_numpy_array(min=-50, max=100, default=0:2:19)
M = integer(min=2, max=256, default=4)
NSymbs = integer(min=10, max=1000000, default=1000)
rep_max = integer(min=1, default=500)
max_bit_errors = integer(min=1, default=3000)
unpacked_parameters = string_list(default=list('SNR'))
"""


class VerySimplePskSimulationRunner(SimulationRunner):
    """BER/SER of M-PSK over AWGN (batch kernel path)."""

    def __init__(self, config_file=None):
        super().__init__(default_config_file=config_file,
                         config_spec=CONFIG_SPEC)
        if "SNR" not in self.params:
            self.params.add("SNR", np.arange(0.0, 19.0, 2.0))
            self.params.add("M", 4)
            self.params.add("NSymbs", 1000)
            self.params.add("max_bit_errors", 3000)
            self.params.set_unpack_parameter("SNR")
            self.rep_max = 500
        else:
            self.rep_max = int(self.params["rep_max"])
        self.modulator = PSK(int(self.params["M"]))
        self.progressbar_message = "{M}-PSK Simulation - SNR {SNR}"
        self.batch_result_types = {
            "symbol_errors": Result.SUMTYPE,
            "num_symbols": Result.SUMTYPE,
            "bit_errors": Result.SUMTYPE,
            "num_bits": Result.SUMTYPE,
            "ber": Result.RATIOTYPE,
            "ser": Result.RATIOTYPE,
        }

    def _gen_simulation_kernel(self, current_parameters):
        snr = dB2Linear(float(current_parameters["SNR"]))
        nsymbs = int(self.params["NSymbs"])
        mod = self.modulator
        noise_scale = float(np.sqrt(1.0 / snr))

        def kernel(key):
            k1, k2 = jax.random.split(key)
            data = jax.random.randint(k1, (nsymbs,), 0, mod.M)
            rx = mod.modulate(data) + randn_c(k2, nsymbs) * noise_scale
            decided = mod.demodulate(rx)
            symbol_errors = jnp.sum(decided != data)
            bit_errors = count_bit_errors(data, decided)
            n = jnp.asarray(nsymbs)
            nb = jnp.asarray(nsymbs * mod.K)
            return {"symbol_errors": symbol_errors, "num_symbols": n,
                    "bit_errors": bit_errors, "num_bits": nb,
                    "ber": (bit_errors, nb),
                    "ser": (symbol_errors, n)}

        return kernel

    def _keep_going(self, current_params, current_sim_results, current_rep):
        if "bit_errors" in current_sim_results and \
                current_sim_results["bit_errors"]:
            cumulated = current_sim_results["bit_errors"][-1].get_result()
            return cumulated < self.params["max_bit_errors"]
        return True

    def get_data_to_be_plotted(self):
        """(SNR, ber, ser, theoretical_ber, theoretical_ser) — the
        reference's plotting helper (apps/awgn_modulators/simulate_psk.py,
        get_data_to_be_plotted)."""
        snr = np.asarray(self.results.params["SNR"], dtype=float)
        ber = np.asarray(self.results.get_result_values_list("ber"))
        ser = np.asarray(self.results.get_result_values_list("ser"))
        theoretical_ber = self.modulator.calcTheoreticalBER(snr)
        theoretical_ser = self.modulator.calcTheoreticalSER(snr)
        return snr, ber, ser, theoretical_ber, theoretical_ser


def main():
    runner = VerySimplePskSimulationRunner()
    runner.set_results_filename("psk_results_{M}-PSK_{SNR}")
    simulate_do_what_i_mean(runner)

    print("Elapsed time:", runner.elapsed_time)
    print("SNR:", runner.results.params["SNR"])
    print("BER:", runner.results.get_result_values_list("ber"))
    print("Theory:", runner.modulator.calcTheoreticalBER(
        np.asarray(runner.results.params["SNR"])))


if __name__ == "__main__":
    main()
