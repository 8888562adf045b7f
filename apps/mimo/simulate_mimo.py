#!/usr/bin/env python
"""Monte Carlo SER/BER of MIMO schemes over flat Rayleigh fading.

JAX-native counterpart of the reference's ``apps/mimo/simulate_mimo.py``:
Alamouti 2xNr, MRC 1xNr and BLAST NxN with MMSE detection, all as jitted
batch kernels. Early stop at an accumulated bit-error budget mirrors the
reference (apps/mimo/simulate_mimo.py:145-150).
"""

import sys

sys.path.insert(0, ".")

import jax
import jax.numpy as jnp
import numpy as np

from pyphysim_tpu.mimo import MRC, Alamouti, Blast
from pyphysim_tpu.modulators import QPSK
from pyphysim_tpu.ops import cplx
from pyphysim_tpu.simulations import Result, SimulationRunner, \
    simulate_do_what_i_mean
from pyphysim_tpu.utils.conversion import dB2Linear
from pyphysim_tpu.utils.misc import count_bit_errors, randn_c


class MimoSimulationRunner(SimulationRunner):
    def __init__(self, scheme: str = "alamouti", Nr: int = 1):
        super().__init__()
        self.params.add("SNR", np.arange(0.0, 21.0, 3.0))
        self.params.set_unpack_parameter("SNR")
        self.rep_max = 1000
        self.NSymbs = 200
        self.scheme = scheme
        self.Nr = Nr
        self.modulator = QPSK()
        self.max_bit_errors = 3000
        self.progressbar_message = f"{scheme} simulation"
        self.batch_result_types = {
            "bit_errors": Result.SUMTYPE,
            "ber": Result.RATIOTYPE,
            "ser": Result.RATIOTYPE,
        }

    def _gen_simulation_kernel(self, current_parameters):
        snr = dB2Linear(float(current_parameters["SNR"]))
        noise_scale = float(np.sqrt(1.0 / snr))
        n = self.NSymbs
        mod = self.modulator
        scheme, nr = self.scheme, self.Nr

        def kernel(key):
            k1, k2, k3 = jax.random.split(key, 3)
            data = jax.random.randint(k1, (n,), 0, mod.M)
            tx = mod.modulate(data)
            if scheme == "alamouti":
                h = randn_c(k2, nr, 2)
                obj = Alamouti(h)
                rx = cplx.matmul(h, obj.encode(tx)) + \
                    randn_c(k3, nr, n) * noise_scale
                detected = obj.decode(rx)
            elif scheme == "mrc":
                h = randn_c(k2, nr)
                obj = MRC(h)
                htx = cplx.CArray(
                    h.re[:, None] * tx.re - h.im[:, None] * tx.im,
                    h.re[:, None] * tx.im + h.im[:, None] * tx.re)
                rx = htx + randn_c(k3, nr, n) * noise_scale
                detected = obj.decode(rx)
            else:  # blast NxN with MMSE
                h = randn_c(k2, nr, nr)
                obj = Blast(h)
                obj.set_noise_var(1.0 / float(snr))
                rx = cplx.matmul(h, obj.encode(tx)) + \
                    randn_c(k3, nr, n // nr) * noise_scale
                detected = obj.decode(rx)
            decided = mod.demodulate(detected)
            bit_errors = count_bit_errors(data, decided)
            sym_errors = jnp.sum(decided != data)
            return {"bit_errors": bit_errors,
                    "ber": (bit_errors, jnp.asarray(n * mod.K)),
                    "ser": (sym_errors, jnp.asarray(n))}

        return kernel

    def _keep_going(self, current_params, current_sim_results, current_rep):
        if "bit_errors" in current_sim_results and \
                current_sim_results["bit_errors"]:
            return current_sim_results["bit_errors"][-1].get_result() < \
                self.max_bit_errors
        return True


def main():
    for scheme, nr in [("alamouti", 1), ("alamouti", 2), ("mrc", 2),
                       ("blast", 2)]:
        runner = MimoSimulationRunner(scheme, nr)
        runner.set_results_filename(f"mimo_{scheme}_{nr}rx")
        simulate_do_what_i_mean(runner)
        print(f"\n{scheme} (Nr={nr}): elapsed {runner.elapsed_time}")
        print("  BER:", np.array(
            runner.results.get_result_values_list("ber")))


if __name__ == "__main__":
    main()
