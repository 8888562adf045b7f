#!/usr/bin/env python
"""CoMP transmission = simple block diagonalization of the joint channel.

JAX-native counterpart of the reference's
``apps/comp_BD/simulate_comp_simple.py``: a 3-cell cluster with one
border user per cell (ratio 0.7, angles 210/-30/90), 3GPP path loss,
(negligible) external interference, QPSK, BD precoding with per-BS
normalized power and a ZF (pinv) receive filter.

Cross-validation: running the reference's own code on this scenario
(250 reps) gives SER = 0.0078 at SNR = 15 dB; this app's seed spread at
200-400 reps is 0.008-0.011 — statistically the same physics. (The
reference script carries a stale comment claiming SER ~= 0.0177; that
predates its current geometry — its own code no longer produces it.)

Instead of the reference's per-repetition numpy loop (~2.5 min for 20k
reps), every repetition here is one lane of a vmapped jitted kernel:
channel draw, batched-SVD BD, precode, corrupt, ZF filter, demodulate
and error counting all happen on device.

Run: python apps/comp_BD/simulate_comp_simple.py [--reps N]
"""

import argparse
import os
import sys
from time import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import jax
import jax.numpy as jnp
import numpy as np

from pyphysim_tpu.cell import Grid
from pyphysim_tpu.channels import pathloss as pathloss_mod
from pyphysim_tpu.comm.batched import (bd_precoders_batched,
                                       bd_receive_filter_batched)
from pyphysim_tpu.modulators import PSK
from pyphysim_tpu.ops import cplx
from pyphysim_tpu.ops.cplx import CArray
from pyphysim_tpu.utils.conversion import dB2Linear, dBm2Linear
from pyphysim_tpu.utils.misc import count_bit_errors, pretty_time, randn_c


def build_scenario():
    """Host-side fixed geometry: per-link path loss matrices
    (reference simulate_comp_simple.py:66-93)."""
    cell_radius = 1.0
    num_cells = 3
    path_loss_obj = pathloss_mod.PathLoss3GPP1()

    grid = Grid()
    grid.create_clusters(1, num_cells, cell_radius)
    cluster0 = grid._clusters[0]
    cell_ids = np.arange(1, num_cells + 1)
    angles = np.array([210, -30, 90])
    cluster0.delete_all_users()
    cluster0.add_border_users(cell_ids, angles, 0.7)

    dists = cluster0.calc_dist_all_users_to_each_cell()
    pl = path_loss_obj.calc_path_loss(dists)                 # (K, K)
    dist_to_center = np.array(
        [cluster0.calc_dist(u) for u in cluster0.get_all_users()])
    pl_ext = path_loss_obj.calc_path_loss(
        cluster0.external_radius - dist_to_center).reshape(num_cells, 1)
    pl_border = path_loss_obj.calc_path_loss(cell_radius)
    return pl, pl_ext, pl_border


def make_kernel(pl, pl_ext, transmit_power, noise_var, pe,
                num_cells=3, Nr=2, Nt=2, NSymbs=500, ext_rank=1, M=4):
    """One Monte Carlo repetition as a pure function of the PRNG key."""
    modulator = PSK(M)
    K = num_cells
    nr_tot, nt_tot = K * Nr, K * Nt
    # per-antenna sqrt pathloss expanded from the per-cell matrices
    sqrt_pl = jnp.asarray(np.sqrt(np.kron(pl, np.ones((Nr, Nt)))),
                          jnp.float32)                     # (Krx, Ktx)
    sqrt_pl_ext = jnp.asarray(
        np.sqrt(np.kron(pl_ext, np.ones((Nr, ext_rank)))), jnp.float32)

    def kernel(key):
        k1, k2, k3, k4 = jax.random.split(key, 4)
        # joint channel with pathloss; ext-int columns appended
        # (multiuser.py big_H layout)
        h = randn_c(k1, nr_tot, nt_tot)
        H = CArray(h.re * sqrt_pl, h.im * sqrt_pl)
        he = randn_c(k2, nr_tot, ext_rank)
        He = CArray(he.re * sqrt_pl_ext, he.im * sqrt_pl_ext)

        # BD of the user part only (ext int does not participate);
        # noise_var ~ 0 reproduces the reference's doWF(…, 1e-50)
        newH, Ms, _ = bd_precoders_batched(H, K, transmit_power,
                                           noise_var=1e-50,
                                           mode="normalized")
        n_streams = Ms.shape[-1]

        data = jax.random.randint(k3, (n_streams, NSymbs), 0, M)
        symbols = modulator.modulate(data)
        precoded = cplx.matmul(Ms, symbols)                 # (Ktx, NSymbs)
        k5, k6 = jax.random.split(k4)
        ext_data = randn_c(k5, ext_rank, NSymbs) * np.sqrt(pe)
        rx = cplx.matmul(H, precoded) + cplx.matmul(He, ext_data) \
            + randn_c(k6, nr_tot, NSymbs) * np.sqrt(noise_var)

        W = bd_receive_filter_batched(newH)
        decided = modulator.demodulate(cplx.matmul(W, rx))
        sym_errors = jnp.sum(decided != data)
        bit_errors = count_bit_errors(data, decided)
        return sym_errors, bit_errors, data.size

    return kernel


def simulate(rep_max=2000, SNR_dB=15.0, N0_dBm=-116.4, Pe_dBm=-10000.0,
             batch=200, seed=1234):
    pl, pl_ext, pl_border = build_scenario()
    noise_var = dBm2Linear(N0_dBm)
    transmit_power = dB2Linear(SNR_dB) * noise_var / pl_border
    pe = dBm2Linear(Pe_dBm)
    kernel = make_kernel(pl, pl_ext, transmit_power, noise_var, pe)
    run = jax.jit(jax.vmap(kernel))

    sym_errors = bit_errors = total = 0
    base = jax.random.PRNGKey(seed)
    done = 0
    while done < rep_max:
        n = min(batch, rep_max - done)
        keys = jax.random.split(jax.random.fold_in(base, done), n)
        se, be, ns = run(keys)
        sym_errors += int(jnp.sum(se))
        bit_errors += int(jnp.sum(be))
        total += int(jnp.sum(ns))
        done += n
    return sym_errors / total, bit_errors / (2 * total), total


def main():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--reps", type=int, default=2000)
    parser.add_argument("--snr", type=float, default=15.0)
    args = parser.parse_args()

    tic = time()
    ser, ber, total = simulate(rep_max=args.reps, SNR_dB=args.snr)
    print(f"Simulated symbols: {total}")
    print(f"SER: {ser:.6f}   (reference code re-run at 15 dB: ~0.0078, "
          f"seed spread 0.008-0.011)")
    print(f"BER: {ber:.6f}")
    print(pretty_time(time() - tic))


if __name__ == "__main__":
    main()
