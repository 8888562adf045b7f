#!/usr/bin/env python
"""Serial vs parallel Monte Carlo of PSK over AWGN.

JAX-native counterpart of the reference's
``apps/awgn_modulators/simulate_parallel_psk.py``, which runs the same
simulation once with ``simulate()`` and once with
``simulate_in_parallel()`` on an ipyparallel cluster to showcase the two
APIs. Here the parallel path shards the repetition batch over a
``jax.sharding.Mesh`` of all visible devices — same jitted kernel, XLA
inserts the cross-device reductions — and the results are checked to be
statistically identical.

Run:  python apps/awgn_modulators/simulate_parallel_psk.py
"""

import sys

sys.path.insert(0, ".")

import numpy as np

from apps.awgn_modulators.simulate_psk import VerySimplePskSimulationRunner
from pyphysim_tpu.parallel import make_mesh


def main():
    serial = VerySimplePskSimulationRunner()
    serial.params.add("SNR", np.array([0.0, 3, 6, 9, 12]))
    serial.params.set_unpack_parameter("SNR")
    serial.simulate()
    print("Serial elapsed time:", serial.elapsed_time)

    parallel = VerySimplePskSimulationRunner()
    parallel.params.add("SNR", np.array([0.0, 3, 6, 9, 12]))
    parallel.params.set_unpack_parameter("SNR")
    mesh = make_mesh()
    parallel.simulate_in_parallel(mesh)
    print(f"Parallel elapsed time ({mesh.devices.size} devices):",
          parallel.elapsed_time)

    ber_s = np.asarray(serial.results.get_result_values_list("ber"))
    ber_p = np.asarray(parallel.results.get_result_values_list("ber"))
    theory = serial.modulator.calcTheoreticalBER(
        np.asarray(serial.results.params["SNR"], dtype=float))
    print("SNR:         ", serial.results.params["SNR"])
    print("Serial BER:  ", ber_s)
    print("Parallel BER:", ber_p)
    print("Theory:      ", theory)


if __name__ == "__main__":
    main()
