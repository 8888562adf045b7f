#!/usr/bin/env python
"""M-QAM over AWGN — minimal runner subclass.

JAX-native counterpart of the reference's
``apps/awgn_modulators/simulate_qam.py``: only the modulator (and the SNR
grid) change from the PSK runner.

Run:  python apps/awgn_modulators/simulate_qam.py
"""

import sys

sys.path.insert(0, ".")

import numpy as np

from apps.awgn_modulators.simulate_psk import VerySimplePskSimulationRunner
from pyphysim_tpu.modulators import QAM


class VerySimpleQamSimulationRunner(VerySimplePskSimulationRunner):
    """BER/SER of 16-QAM over AWGN; everything inherited but the
    modulator."""

    def __init__(self):
        super().__init__()
        M = 16
        self.params.add("SNR", np.array([0.0, 3, 6, 9, 12, 15, 18]))
        self.params.add("M", M)
        self.params.set_unpack_parameter("SNR")
        self.modulator = QAM(M)
        self.progressbar_message = f"{M}-QAM Simulation - SNR: {{SNR}}"


def main():
    sim = VerySimpleQamSimulationRunner()
    sim.simulate()
    snr, ber, ser, t_ber, t_ser = sim.get_data_to_be_plotted()
    print("Elapsed time:", sim.elapsed_time)
    print("SNR:", snr)
    print("BER:", ber)
    print("Theoretical BER:", t_ber)
    try:
        from matplotlib import pyplot as plt
        plt.semilogy(snr, ber, "--g*", label="BER")
        plt.semilogy(snr, ser, "--b*", label="SER")
        plt.semilogy(snr, t_ber, "-g+", label="Theoretical BER")
        plt.semilogy(snr, t_ser, "-b+", label="Theoretical SER")
        plt.xlabel("SNR")
        plt.ylabel("Error")
        plt.title(f"BER and SER for {sim.modulator.name} in AWGN channel")
        plt.legend()
        plt.grid(True, which="both", axis="both")
        plt.savefig("qam_awgn.png", dpi=120)
        print("Saved plot to qam_awgn.png")
    except ImportError:
        pass


if __name__ == "__main__":
    main()
