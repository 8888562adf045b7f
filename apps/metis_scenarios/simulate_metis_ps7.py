#!/usr/bin/env python
"""METIS PS7 indoor scenario: SINR map over a grid of square rooms.

JAX-native counterpart of the reference's ``apps/metis_scenarios``
simulators: a floor of square rooms with one access point per room,
users on a pixel grid, METIS PS7 path loss with wall counts, and the
resulting downlink SINR map (computed as one vectorized jnp program).
"""

import sys

sys.path.insert(0, ".")

import jax.numpy as jnp
import numpy as np

from pyphysim_tpu.cell import CellSquare, Cluster
from pyphysim_tpu.channels.pathloss import PathLossMetisPS7
from pyphysim_tpu.utils.conversion import dB2Linear, linear2dB


def simulate(num_rooms_per_side: int = 4, side_length: float = 10.0,
             grid_points: int = 60, tx_power_dbm: float = 20.0,
             noise_power_dbm: float = -94.0):
    num_cells = num_rooms_per_side ** 2
    cluster = Cluster(cell_radius=side_length, num_cells=num_cells,
                      cell_type="square")
    ap_positions = np.array([c.pos for c in cluster])

    # pixel grid covering the floor
    xs = np.linspace(ap_positions.real.min() - side_length / 2,
                     ap_positions.real.max() + side_length / 2, grid_points)
    ys = np.linspace(ap_positions.imag.min() - side_length / 2,
                     ap_positions.imag.max() + side_length / 2, grid_points)
    pts = (xs[None, :] + 1j * ys[:, None]).ravel()

    # distance and wall count user->AP (walls = rooms crossed, manhattan)
    d = np.abs(pts[:, None] - ap_positions[None, :])
    d = np.maximum(d, 0.1)
    walls = (np.abs(pts[:, None].real - ap_positions[None, :].real) +
             np.abs(pts[:, None].imag - ap_positions[None, :].imag)) \
        // side_length
    walls = walls.astype(int)

    pl = PathLossMetisPS7(fc=2600.0)
    pl_db = np.asarray(pl._calc_deterministic_path_loss_dB(
        jnp.asarray(d), num_walls=jnp.asarray(walls)))

    tx_pow = dB2Linear(tx_power_dbm - 30)
    noise = dB2Linear(noise_power_dbm - 30)
    rx_pow = tx_pow * dB2Linear(-pl_db)          # (points, aps)

    best = rx_pow.max(axis=1)
    interference = rx_pow.sum(axis=1) - best
    sinr_db = linear2dB(best / (interference + noise))
    return sinr_db.reshape(grid_points, grid_points), xs, ys


def main():
    sinr, xs, ys = simulate()
    print(f"SINR map {sinr.shape}: min {sinr.min():.1f} dB, "
          f"median {np.median(sinr):.1f} dB, max {sinr.max():.1f} dB")
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig, ax = plt.subplots()
        im = ax.pcolormesh(xs, ys, sinr, shading="auto")
        fig.colorbar(im, label="SINR (dB)")
        ax.set_title("METIS PS7 indoor SINR map")
        fig.savefig("metis_ps7_sinr.png", dpi=100)
        print("Saved metis_ps7_sinr.png")
    except Exception as exc:  # pragma: no cover
        print("plotting skipped:", exc)


if __name__ == "__main__":
    main()
