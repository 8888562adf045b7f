#!/usr/bin/env python
"""CoMP block diagonalization with external interference: SER for each
stream-sacrifice metric.

JAX-native counterpart of the reference's ``apps/comp_BD`` simulators.
"""

import sys

sys.path.insert(0, ".")

import numpy as np

from pyphysim_tpu.channels import MultiUserChannelMatrixExtInt
from pyphysim_tpu.comm import EnhancedBD, WhiteningBD
from pyphysim_tpu.modulators import QAM
from pyphysim_tpu.simulations import (Result, SimulationResults,
                                      SimulationRunner)
from pyphysim_tpu.utils.conversion import dB2Linear


class CompBDSimulationRunner(SimulationRunner):
    def __init__(self, metric=None):
        super().__init__()
        self.params.add("Pe_dB", np.array([-10.0, 0.0, 10.0]))
        self.params.set_unpack_parameter("Pe_dB")
        self.rep_max = 20
        self.K, self.N = 2, 2
        self.NSymbs = 500
        self.noise_var = 1e-3
        self.metric = metric
        self.qam = QAM(16)
        self._seed = 0
        self.progressbar_message = f"CoMP BD metric={metric}"

    def _run_simulation(self, current_parameters):
        pe = float(dB2Linear(float(current_parameters["Pe_dB"])))
        self._seed += 1
        rng = np.random.RandomState(self._seed)
        mu = MultiUserChannelMatrixExtInt()
        mu.set_channel_seed(self._seed)
        mu.randomize(self.N, self.N, self.K, NtE=1)
        mu.noise_var = self.noise_var

        bd = EnhancedBD(self.K, 1.0, self.noise_var, pe)
        extra = None
        if self.metric in ("naive", "fixed"):
            extra = {"num_streams": 1}
        elif self.metric == "effective_throughput":
            extra = {"modulator": self.qam, "packet_length": 60}
        bd.set_ext_int_handling_metric(self.metric, extra)
        MsPk, Wk, Ns = bd.block_diagonalize_no_waterfilling(mu)

        data, tx = [], []
        for k in range(self.K):
            d = rng.randint(0, self.qam.M,
                            self.NSymbs * int(Ns[k])).reshape(int(Ns[k]),
                                                              -1)
            data.append(d)
            tx.append(MsPk[k] @ self.qam.modulate(d))
        joint = sum(tx)
        n = joint.shape[1]
        ext = [np.sqrt(pe) * (rng.randn(1, n) + 1j * rng.randn(1, n)) /
               np.sqrt(2)]
        out = mu.corrupt_data([joint[:self.N], joint[self.N:]], ext)

        errors, total = 0, 0
        for k in range(self.K):
            eq = Wk[k] @ out[k]  # numpy in -> numpy out
            decided = self.qam.demodulate(eq)
            errors += int(np.sum(decided != data[k]))
            total += decided.size

        results = SimulationResults()
        results.add_result(Result.create("ser", Result.RATIOTYPE, errors,
                                         total))
        return results


def main():
    for metric in [None, "naive", "fixed", "capacity",
                   "effective_throughput"]:
        runner = CompBDSimulationRunner(metric)
        runner.simulate()
        ser = np.array(runner.results.get_result_values_list("ser"))
        print(f"{str(metric):20s} SER vs Pe: "
              + " ".join(f"{s:.4f}" for s in ser))


if __name__ == "__main__":
    main()
