#!/usr/bin/env python
"""Alamouti 2x1 QPSK BER sweep driven by the monolithic Pallas kernel.

Same simulation as the Alamouti branch of ``apps/mimo/simulate_mimo.py``
(the reference's apps/mimo/simulate_mimo.py:69-141 flat-Rayleigh chain),
but the whole Monte Carlo repetition runs inside ONE Pallas kernel
(``pyphysim_tpu/ops/alamouti_pallas.py``) plugged into
``SimulationRunner`` through the bulk-kernel extension point, exactly
like ``apps/ofdm/ofdm_mc_kernel.py``: the kernel owns its repetition
axis and draws data, channel and noise from its in-kernel
counter-based generator, while the runner provides the SNR sweep,
Result accumulation, checkpoint/resume and early stop. The kernel is
compiled for the GPU; ``interpret=True`` runs it under the Pallas
interpreter on any backend.
"""

import sys

sys.path.insert(0, ".")

import jax.numpy as jnp
import numpy as np

from pyphysim_tpu.ops.alamouti_pallas import MonteCarloAlamouti
from pyphysim_tpu.simulations import (Result, SimulationRunner,
                                      kernel_stream_seed)
from pyphysim_tpu.utils.conversion import dB2Linear


class AlamoutiMcKernelSimulationRunner(SimulationRunner):
    """QPSK / Alamouti 2x1 / iid flat Rayleigh; one repetition =
    ``num_tiles * tile * lane * 2`` symbols (lanes are independent
    virtual channel streams)."""

    def __init__(self, tile: int = 8, lane: int = 128,
                 num_tiles: int = 32, interpret: bool = False):
        super().__init__()
        self.params.add("SNR", np.arange(0.0, 21.0, 5.0))
        self.params.set_unpack_parameter("SNR")
        self.rep_max = 16
        self.batch_size = 8
        self.update_progress_function_style = "text2"
        self.num_tiles = num_tiles
        self.mc = MonteCarloAlamouti(tile=tile, lane=lane)
        self.batch_result_types = {
            "bit_errors": Result.SUMTYPE,
            "ber": Result.RATIOTYPE,
        }
        self.interpret = interpret
        self._fns = {}

    def _bits_per_rep(self) -> int:
        return self.num_tiles * self.mc.symbols_per_grid_step * 2

    def _gen_bulk_kernel(self, current_parameters):
        mc, nt = self.mc, self.num_tiles
        snr = dB2Linear(float(current_parameters["SNR"]))
        bits_per_rep = self._bits_per_rep()
        seed = kernel_stream_seed(self.base_seed,
                                  current_parameters.unpack_index)
        mesh = self.mesh

        def bulk(start, n):
            fkey = (n, mesh)
            if fkey not in self._fns:
                self._fns[fkey] = mc.build(n, nt, mesh=mesh,
                                           interpret=self.interpret)
            counts = jnp.sum(
                self._fns[fkey](jnp.int32(seed), jnp.float32(snr),
                                jnp.int32(start)), axis=1)
            return {"bit_errors": counts,
                    "ber": (counts.astype(jnp.float32),
                            np.full(n, float(bits_per_rep)))}

        return bulk


def main():
    runner = AlamoutiMcKernelSimulationRunner()
    runner.simulate()
    print("\nElapsed time:", runner.elapsed_time)
    print("SNR:", runner.results.params["SNR"])
    print("BER:", np.array(runner.results.get_result_values_list("ber")))


if __name__ == "__main__":
    main()
