#!/usr/bin/env python
"""OFDM-over-TDL BER sweep on the runner's bulk path.

Same simulation as ``apps/ofdm/ofdm_tdlchannel.py`` (the reference's
north-star chain, apps/ofdm/ofdm_tdlchannel.py:14-120), run through
``SimulationRunner``'s bulk-kernel extension point (``_gen_bulk_kernel``):
each call simulates a whole chunk of repetitions of the fused
OFDM-over-TDL XLA chain (``ops/fused_ofdm_tdl.py``), and repetition ``a``
draws all of its randomness from ``fold_in(PRNGKey(seed), a)`` with ``a``
the ABSOLUTE attempt index. Results are therefore chunk-size invariant,
resume is exact, and under ``simulate_in_parallel`` the chunk's
repetitions split over the mesh bit-identically
(:func:`pyphysim_tpu.parallel.shard_reps`). The runner provides the
parameter sweep, Result accumulation, checkpoint/resume and early stop.

A repetition is ``ofdm_symbols`` OFDM symbols sharing one Jakes channel
realization; a chunk runs ``map_batch`` (default 64) repetitions at a
time to bound device memory.
"""

import math
import sys

sys.path.insert(0, ".")

import jax
import jax.numpy as jnp
import numpy as np

from __graft_entry__ import _make_chain_step
from pyphysim_tpu.parallel import shard_reps
from pyphysim_tpu.simulations import (Result, SimulationRunner,
                                      kernel_stream_seed)
from pyphysim_tpu.utils.conversion import dB2Linear

NUM_USED = 300


def build_bulk_chain(ofdm_symbols: int, reps: int, map_batch: int = 64,
                     mesh=None, axis: str = "mc"):
    """Jitted ``(seed:int32, snr_linear[, start]) -> (reps,) int32`` bit
    errors of ``reps`` repetitions of the fused flagship chain (16-QAM /
    OFDM(512, cp 52, 300 used) / COST259-TU with Jakes Doppler,
    block-static), repetition ``r`` keyed by attempt ``start + r``."""
    step = _make_chain_step(num_symbols=ofdm_symbols * NUM_USED,
                            fft_size=512, cp_size=52, num_used=NUM_USED,
                            block_static=True, fused=True)

    def make_call(n):
        batch = math.gcd(n, map_batch)

        def call(seeds, snr_linear):
            base = jax.random.PRNGKey(seeds[0])
            keys = jax.vmap(lambda a: jax.random.fold_in(base, a))(
                seeds[1] + jnp.arange(n))
            errs = jax.lax.map(
                lambda k: jax.vmap(step, (0, None))(k, snr_linear),
                keys.reshape((n // batch, batch) + keys.shape[1:]))
            return errs.reshape(n)

        return call

    def prologue(seed, snr_linear, start=0):
        return (jnp.stack([jnp.asarray(seed, jnp.int32),
                           jnp.asarray(start, jnp.int32)]),
                jnp.asarray(snr_linear, jnp.float32))

    return shard_reps(make_call, prologue, reps, mesh, axis)


class OfdmMcKernelSimulationRunner(SimulationRunner):
    """16-QAM / OFDM(512, cp 52, 300 used) / COST259-TU with Jakes
    Doppler, one repetition = ``ofdm_symbols`` OFDM symbols."""

    def __init__(self, ofdm_symbols: int = 256, **kwargs):
        super().__init__(**kwargs)
        self.params.add("SNR", np.arange(0.0, 31.0, 5.0))
        self.params.set_unpack_parameter("SNR")
        self.rep_max = 16
        self.batch_size = 8
        self.update_progress_function_style = "text2"
        self.ofdm_symbols = ofdm_symbols
        self.batch_result_types = {
            "bit_errors": Result.SUMTYPE,
            "ber": Result.RATIOTYPE,
        }
        self._fns = {}

    def _bits_per_rep(self) -> int:
        return self.ofdm_symbols * NUM_USED * 4

    def _gen_bulk_kernel(self, current_parameters):
        snr = dB2Linear(float(current_parameters["SNR"]))
        bits_per_rep = self._bits_per_rep()
        seed = kernel_stream_seed(self.base_seed,
                                  current_parameters.unpack_index)
        mesh = self.mesh

        def bulk(start, n):
            fkey = (n, mesh)
            if fkey not in self._fns:
                self._fns[fkey] = build_bulk_chain(
                    self.ofdm_symbols, n, mesh=mesh, axis=self.mesh_axis)
            # lazy device arrays: the runner fetches them AFTER
            # enqueueing the next chunk (double-buffered dispatch)
            counts = self._fns[fkey](jnp.int32(seed), jnp.float32(snr),
                                     jnp.int32(start))
            return {"bit_errors": counts,
                    "ber": (counts.astype(jnp.float32),
                            np.full(n, float(bits_per_rep)))}

        return bulk


def main():
    runner = OfdmMcKernelSimulationRunner()
    runner.simulate()
    print("\nElapsed time:", runner.elapsed_time)
    print("SNR:", runner.results.params["SNR"])
    print("BER:", np.array(runner.results.get_result_values_list("ber")))
    total = runner.rep_max * runner._bits_per_rep() // 4
    print(f"({len(runner.results.params['SNR'])} SNR points x "
          f"{total:,} symbols each)")


if __name__ == "__main__":
    main()
