#!/usr/bin/env python
"""BPSK over AWGN — minimal runner subclass.

JAX-native counterpart of the reference's
``apps/awgn_modulators/simulate_bpsk.py``: only the modulator (and the SNR
grid) change from the PSK runner; the vmapped kernel, early stop,
checkpointing and progress all come from the base class.

Run:  python apps/awgn_modulators/simulate_bpsk.py
"""

import sys

sys.path.insert(0, ".")

import numpy as np

from apps.awgn_modulators.simulate_psk import VerySimplePskSimulationRunner
from pyphysim_tpu.modulators import BPSK


class VerySimpleBpskSimulationRunner(VerySimplePskSimulationRunner):
    """BER/SER of BPSK over AWGN; everything inherited but the modulator."""

    def __init__(self):
        super().__init__()
        self.params.add("SNR", np.array([0.0, 2, 4, 6, 8, 10]))
        self.params.add("M", 2)
        self.params.set_unpack_parameter("SNR")
        self.rep_max = 5000
        self.modulator = BPSK()
        self.progressbar_message = "BPSK Simulation - SNR: {SNR}"


def main():
    sim = VerySimpleBpskSimulationRunner()
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
        plt.savefig("bpsk_awgn.png", dpi=120)
        print("Saved plot to bpsk_awgn.png")
    except ImportError:
        pass


if __name__ == "__main__":
    main()
