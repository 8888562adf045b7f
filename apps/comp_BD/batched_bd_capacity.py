#!/usr/bin/env python
"""CoMP Block Diagonalization sum-capacity sweep — fully on device.

Device-native extension of the reference's ``apps/comp_BD`` family: where
the reference (and the host ``EnhancedBD`` app here) computes one numpy
SVD chain per Monte Carlo repetition, this app runs the whole BD solve —
null-space projection, stream alignment, water-filling power loading and
the capacity reduction — on device, with TWO engines:

* ``BatchedBDCapacityRunner`` — the general XLA chain
  (:func:`pyphysim_tpu.comm.bd_precoders_batched`) vmapped through the
  runner's batch path; any (K, Nr_u, Nt) geometry.
* ``BDKernelCapacityRunner`` — the register-resident Pallas kernel
  (:class:`pyphysim_tpu.ops.bd_pallas.MonteCarloBD`) through the
  runner's BULK path: the kernel owns its repetition axis and draws the
  channels from its in-kernel counter-based generator; the geometry
  menu (square, K >= 2, Nr_u in {1, 2}) selects the plane program. The
  kernel is compiled for the GPU; ``interpret=True`` runs it under the
  Pallas interpreter on any backend.

Both sweep the per-BS power (in dB) and report the mean BD sum
capacity per variation.

Run:  python apps/comp_BD/batched_bd_capacity.py [K Nr_u]
"""

import sys

sys.path.insert(0, ".")

import jax.numpy as jnp
import numpy as np

from pyphysim_tpu.comm import bd_precoders_batched
from pyphysim_tpu.ops.bd_pallas import MonteCarloBD
from pyphysim_tpu.simulations import (Result, SimulationRunner,
                                      kernel_stream_seed)
from pyphysim_tpu.utils.conversion import dB2Linear
from pyphysim_tpu.utils.misc import randn_c


class BatchedBDCapacityRunner(SimulationRunner):
    """Sum capacity of [Spencer2004] BD over iid Rayleigh joint channels
    (reference blockdiagonalization.py:181-663 semantics, device batch
    execution; any square (K, Nr_u) geometry)."""

    def __init__(self, mode: str = "global", K: int = 3, nr_u: int = 2):
        super().__init__()
        self.params.add("Pu_dB", np.arange(-5.0, 21.0, 5.0))
        self.params.set_unpack_parameter("Pu_dB")
        self.rep_max = 512
        self.K, self.nr_u, self.nt_tot = K, nr_u, K * nr_u
        self.noise_var = 1.0
        self.mode = mode
        self.progressbar_message = f"BD capacity ({mode}) - Pu {{Pu_dB}}"
        self.batch_result_types = {"sum_capacity": Result.RATIOTYPE}

    def _gen_simulation_kernel(self, current_parameters):
        iPu = float(dB2Linear(float(current_parameters["Pu_dB"])))
        K, nr_u, nt_tot = self.K, self.nr_u, self.nt_tot
        nv, mode = self.noise_var, self.mode

        def kernel(key):
            H = randn_c(key, K * nr_u, nt_tot)
            _, Ms, Sigma = bd_precoders_batched(H, K, iPu, nv, mode)
            # per-stream transmit power = column power of the precoder
            p = jnp.sum(Ms.re ** 2 + Ms.im ** 2, axis=-2)
            cap = jnp.sum(jnp.log2(1.0 + p * Sigma ** 2 / nv))
            # degenerate draw (numerically singular null-space chain):
            # mark the repetition invalid — the runner excludes it and
            # retries with a fresh fold_in index, the batch-path form of
            # the reference's SkipThisOne (runner.py:151-185). The guard
            # is scale-RELATIVE (library convention, CLAUDE.md).
            valid = jnp.isfinite(cap) & \
                (jnp.min(Sigma) > 1e-6 * jnp.max(Sigma))
            return {"sum_capacity": (cap, jnp.asarray(1.0)),
                    "__valid__": valid}

        return kernel


class BDKernelCapacityRunner(SimulationRunner):
    """The same sweep riding the Pallas kernel through the
    runner's bulk path (one repetition = ``num_tiles * tile * lane``
    independent BD solves, channels from the in-kernel generator). ``K``/``nr_u`` select a point of the
    geometry menu — including non-bench points like (2, 2) or (4, 1).

    Degenerate draws are zeroed inside the kernel (the bench bd_step
    semantics) rather than retried: at ~1e-5 of draws the bias is far
    below the Monte Carlo noise at these batch sizes."""

    def __init__(self, K: int = 2, nr_u: int = 2, tile: int = 1,
                 lane: int = 128, num_tiles: int = 32,
                 interpret: bool = False):
        super().__init__()
        self.params.add("Pu_dB", np.array([-5.0, 5.0, 15.0]))
        self.params.set_unpack_parameter("Pu_dB")
        self.rep_max = 8
        self.batch_size = 4
        self.K, self.nr_u = K, nr_u
        self.tile, self.lane, self.num_tiles = tile, lane, num_tiles
        self.noise_var = 1.0
        self.progressbar_message = "BD kernel capacity - Pu {Pu_dB}"
        self.batch_result_types = {"sum_capacity": Result.RATIOTYPE}
        self.interpret = interpret
        self._fns = {}

    def _gen_bulk_kernel(self, current_parameters):
        iPu = float(dB2Linear(float(current_parameters["Pu_dB"])))
        mc = MonteCarloBD(tile=self.tile, lane=self.lane, iPu=iPu,
                          noise_var=self.noise_var, K=self.K,
                          Nr_u=self.nr_u)
        nt = self.num_tiles
        solves_per_rep = nt * mc.solves_per_grid_step
        seed = kernel_stream_seed(self.base_seed,
                                  current_parameters.unpack_index)
        mesh = self.mesh

        def bulk(start, n):
            fkey = (iPu, n, mesh)
            if fkey not in self._fns:
                self._fns[fkey] = mc.build(n, nt, mesh=mesh,
                                           interpret=self.interpret)
            caps = jnp.sum(
                self._fns[fkey](jnp.int32(seed), jnp.int32(start)), axis=1)
            return {"sum_capacity":
                    (caps, np.full(n, float(solves_per_rep)))}

        return bulk


def main():
    K, nr_u = ((int(sys.argv[1]), int(sys.argv[2]))
               if len(sys.argv) >= 3 else (3, 2))
    for mode in ("global", "none"):
        runner = BatchedBDCapacityRunner(mode, K=K, nr_u=nr_u)
        runner.simulate()
        caps = np.array(
            runner.results.get_result_values_list("sum_capacity"))
        label = {"global": "waterfilling", "none": "equal power"}[mode]
        print(f"{label:13s} ({runner.elapsed_time}): "
              + " ".join(f"{c:6.2f}" for c in caps))
    # the kernel tier at a NON-BENCH geometry point
    kr = BDKernelCapacityRunner(K=2, nr_u=2)
    kr.simulate()
    caps = np.array(kr.results.get_result_values_list("sum_capacity"))
    print(f"kernel (2,2)  ({kr.elapsed_time}): "
          + " ".join(f"{c:6.2f}" for c in caps))


if __name__ == "__main__":
    main()
