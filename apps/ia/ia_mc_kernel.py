#!/usr/bin/env python
"""Max-SINR IA sum-capacity sweep driven by the monolithic Pallas
kernel.

Same simulation as the batched Max-SINR sweep of
``apps/ia/simulate_ia.py`` (the reference's apps/ia/simulate_ia.py /
``MaxSinrIASolver``, algorithms.py:1243-1504), but the whole Monte
Carlo repetition runs inside ONE Pallas kernel
(``pyphysim_tpu/ops/ia_pallas.py``) plugged into ``SimulationRunner``
through the bulk-kernel extension point, exactly like
``apps/mimo/alamouti_mc_kernel.py`` and the BD kernel runner in
``apps/comp_BD/batched_bd_capacity.py``: the kernel owns its
repetition axis and draws the channels from its in-kernel
counter-based generator, while the runner provides the SNR sweep,
Result accumulation, checkpoint/resume and early stop. ``K`` selects a
point of the kernel's user-count menu. The noise variance is a TRACED
kernel input, so one compiled program serves every SNR variation. The
kernel is compiled for the GPU; ``interpret=True`` runs it under the
Pallas interpreter on any backend.
"""

import sys

sys.path.insert(0, ".")

import jax.numpy as jnp
import numpy as np

from pyphysim_tpu.ops.ia_pallas import MonteCarloMaxSinr
from pyphysim_tpu.simulations import (Result, SimulationRunner,
                                      kernel_stream_seed)
from pyphysim_tpu.utils.conversion import dB2Linear


class IaMcKernelSimulationRunner(SimulationRunner):
    """K-user 2x2 Ns=1 Max-SINR IA sum capacity; one repetition =
    ``num_tiles * tile * lane`` independent solves (svd init, fixed
    iteration count), noise_var = 1/SNR_linear at unit power."""

    def __init__(self, K: int = 3, tile: int = 1, lane: int = 128,
                 num_tiles: int = 32, iterations: int = 10,
                 interpret: bool = False):
        super().__init__()
        self.params.add("SNR", np.array([0.0, 10.0, 20.0]))
        self.params.set_unpack_parameter("SNR")
        self.rep_max = 16
        self.batch_size = 8
        self.update_progress_function_style = "text2"
        self.num_tiles = num_tiles
        self.mc = MonteCarloMaxSinr(tile=tile, lane=lane,
                                    iterations=iterations, K=K)
        self.batch_result_types = {"sum_capacity": Result.RATIOTYPE}
        self.interpret = interpret
        self._fns = {}

    def _gen_bulk_kernel(self, current_parameters):
        mc, nt = self.mc, self.num_tiles
        noise_var = 1.0 / float(
            dB2Linear(float(current_parameters["SNR"])))
        solves_per_rep = nt * mc.solves_per_grid_step
        seed = kernel_stream_seed(self.base_seed,
                                  current_parameters.unpack_index)
        mesh = self.mesh

        def bulk(start, n):
            fkey = (n, mesh)
            if fkey not in self._fns:
                self._fns[fkey] = mc.build(n, nt, mesh=mesh,
                                           interpret=self.interpret)
            caps = jnp.sum(
                self._fns[fkey](jnp.int32(seed), jnp.float32(noise_var),
                                jnp.int32(start)), axis=1)
            return {"sum_capacity":
                    (caps, np.full(n, float(solves_per_rep)))}

        return bulk


def main():
    K = int(sys.argv[1]) if len(sys.argv) > 1 else 3
    runner = IaMcKernelSimulationRunner(K=K)
    runner.simulate()
    print("\nElapsed time:", runner.elapsed_time)
    print("SNR:", runner.results.params["SNR"])
    print("sum capacity:", np.array(
        runner.results.get_result_values_list("sum_capacity")))


if __name__ == "__main__":
    main()
