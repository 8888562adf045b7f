#!/usr/bin/env python
"""Probe the feasibility of an IA configuration by running the solvers.

Counterpart of the reference's ``apps/ia/test_ia_feasibility.py``: for a
K=3 user 4x4 channel with Ns=2 streams (a feasible configuration by the
[CadambeDoF2008] DoF count), run AlternatingMin, MMSE and Max-SINR and
print the residual interference cost and the sum capacities — alignment is
feasible when the alternating-minimization leakage cost drops to ~0.

Run:  python apps/ia/test_ia_feasibility.py
"""

import sys

sys.path.insert(0, ".")

import jax

# host-object solvers: keep the tiny linalg ops on the host CPU
jax.config.update("jax_platforms", "cpu")

import numpy as np

from pyphysim_tpu.channels.multiuser import MultiUserChannelMatrix
from pyphysim_tpu.ia.algorithms import (AlternatingMinIASolver,
                                        MaxSinrIASolver, MMSEIASolver)
from pyphysim_tpu.utils.conversion import dB2Linear


def main():
    K = 3
    Nr = np.ones(K, dtype=int) * 4
    Nt = np.ones(K, dtype=int) * 4
    Ns = np.array([2, 2, 2])

    SNR = 40.0
    noise_var = 1 / dB2Linear(SNR)
    print(f"SNR: {SNR}")
    print(f"noise_var: {noise_var}")

    channel = MultiUserChannelMatrix()
    channel.randomize(Nr, Nt, K, key=jax.random.PRNGKey(0))
    channel.noise_var = noise_var

    alt_min = AlternatingMinIASolver(channel)
    mmse = MMSEIASolver(channel)
    max_sinr = MaxSinrIASolver(channel)

    alt_min.randomizeF(Ns)
    alt_min.max_iterations = 400
    alt_min.solve(Ns)

    mmse.randomizeF(Ns)
    mmse.max_iterations = 100
    mmse.solve(Ns)

    max_sinr.randomizeF(Ns)
    max_sinr.max_iterations = 100
    max_sinr.solve(Ns)

    print(f"Final cost (Alt Min leakage): {alt_min.get_cost()}\n")

    def sum_capacity(solver):
        return np.sum(np.log2(np.hstack(
            [1.0 + np.asarray(s) for s in solver.calc_SINR()])))

    print(f"Sum Capacity (Alt Min):  {sum_capacity(alt_min)}")
    print(f"Sum Capacity (MMSE):     {sum_capacity(mmse)}")
    print(f"Sum Capacity (Max SINR): {sum_capacity(max_sinr)}")


if __name__ == "__main__":
    main()
