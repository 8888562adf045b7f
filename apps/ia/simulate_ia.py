#!/usr/bin/env python
"""3-user MIMO interference channel: IA solver BER + sum-capacity sweep.

JAX-native counterpart of the reference's ``apps/ia/simulate_ia.py``
(reference simulate_ia.py:24-888): one ``IASimulationRunner`` base class
carrying the full transmit chain (IA solve -> modulate -> precode with
``full_F`` -> interference channel -> ``full_W_H`` filter -> demodulate ->
count errors), one thin subclass per IA algorithm (Closed Form, Alt. Min.,
Max SINR, MMSE, Min. Leakage), all driven by ``ia_config_file.txt`` with
the SNR / max_iterations / initialize_with sweep unpacked by the Monte
Carlo engine, and per-solver result pickles whose names embed the scenario
(reference simulate_ia.py:505-600).

The object solvers are host-side (SURVEY §7 step 8 keeps the combinatorial
/ iterative object API off the device hot path; the batched device solvers
live in ``pyphysim_tpu.ia.batched``), so this app forces the CPU backend.

Run:  python apps/ia/simulate_ia.py [-c config] [-i index]
"""

import os
import sys
from time import time

sys.path.insert(0, ".")

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np

from pyphysim_tpu.channels import MultiUserChannelMatrix
from pyphysim_tpu.ia import (AlternatingMinIASolver, ClosedFormIASolver,
                             MaxSinrIASolver, MinLeakageIASolver,
                             MMSEIASolver)
from pyphysim_tpu.modulators import PSK, QAM, BPSK, QPSK
from pyphysim_tpu.simulations import (Result, SimulationResults,
                                      SimulationRunner,
                                      simulate_do_what_i_mean)
from pyphysim_tpu.utils import misc
from pyphysim_tpu.utils.conversion import dB2Linear
from pyphysim_tpu.utils.misc import count_bit_errors, level2bits

# Config spec shared by all runners (reference simulate_ia.py:320-341).
SPEC = """[Scenario]
SNR=real_numpy_array(min=-50, max=100, default=0:5:31)
M=integer(min=4, max=512, default=4)
modulator=option('QPSK', 'PSK', 'QAM', 'BPSK', default="PSK")
NSymbs=integer(min=10, max=1000000, default=200)
K=integer(min=2, default=3)
Nr=integer_scalar_or_integer_numpy_array_check(min=2, default=2)
Nt=integer_scalar_or_integer_numpy_array_check(min=2, default=2)
Ns=integer_scalar_or_integer_numpy_array_check(min=1, default=1)
[IA Algorithm]
max_iterations=integer_numpy_array(min=1, default=60)
initialize_with=string_list(default=list('random'))
[General]
rep_max=integer(min=1, default=20)
max_bit_errors=integer(min=1, default=3000)
unpacked_parameters=string_list(default=list('SNR'))
""".split("\n")


def _make_modulator(name: str, M: int):
    if name == "BPSK":
        return BPSK()
    if name == "QPSK":
        return QPSK()
    if name == "QAM":
        return QAM(M)
    return PSK(M)


class IASimulationRunner(SimulationRunner):
    """Base IA Monte Carlo runner (reference simulate_ia.py:24-302).

    Owns a ``MultiUserChannelMatrix`` and an IA solver; each repetition
    draws a fresh channel, solves IA, and transmits ``NSymbs`` modulated
    symbols per stream through the aligned network.
    """

    def __init__(self, IaSolverClass, default_config_file: str,
                 read_command_line_args: bool = True):
        super().__init__(default_config_file, SPEC, read_command_line_args)

        self.multiUserChannel = MultiUserChannelMatrix()
        self.ia_solver = IaSolverClass(self.multiUserChannel)

        M = int(self.params["M"])
        self.modulator = _make_modulator(str(self.params["modulator"]), M)
        self.rep_max = int(self.params["rep_max"])
        self.progressbar_message = (f"{IaSolverClass.__name__} - "
                                    "SNR {SNR}")
        self._rep_seed = 0

    def _run_simulation(self, current_parameters):
        M = self.modulator.M
        NSymbs = int(current_parameters["NSymbs"])
        K = int(current_parameters["K"])
        Nr = current_parameters["Nr"]
        Nt = current_parameters["Nt"]
        Ns = current_parameters["Ns"]
        SNR = float(current_parameters["SNR"])
        noise_var = 1.0 / dB2Linear(SNR)

        self._rep_seed += 1
        rs = np.random.RandomState(self._rep_seed)

        # IA first: stream count per user can drop below Ns if the solver
        # chooses a zero-energy precoder dimension (simulate_ia.py:110-129)
        self.multiUserChannel.set_channel_seed(self._rep_seed)
        self.multiUserChannel.randomize(Nr, Nt, K)
        self.multiUserChannel.noise_var = noise_var
        self.ia_solver.clear()
        self.ia_solver.solve(Ns)
        Ns_arr = self.ia_solver.Ns
        cumNs = np.cumsum(Ns_arr)

        # modulate all users' data stacked (simulate_ia.py:132-141)
        inputData = rs.randint(0, M, (int(np.sum(Ns_arr)), NSymbs))
        modulatedData = np.asarray(self.modulator.modulate(inputData))

        transmit_signal = np.split(modulatedData, cumNs[:-1])
        precoded = [self.ia_solver.full_F[k] @ transmit_signal[k]
                    for k in range(K)]

        received = self.multiUserChannel.corrupt_data(precoded)
        received = [r.to_numpy() if hasattr(r, "to_numpy") else r
                    for r in received]

        no_interf = [self.ia_solver.full_W_H[k] @ received[k]
                     for k in range(K)]
        demodulated = np.asarray(
            self.modulator.demodulate(np.vstack(no_interf)))

        symbolErrors = int(np.sum(inputData != demodulated))
        bitErrors = int(count_bit_errors(inputData, demodulated))
        numSymbols = inputData.size
        numBits = inputData.size * level2bits(M)
        ia_cost = float(self.ia_solver.get_cost())

        sinr_all_k = self.ia_solver.calc_SINR()
        total_sum_capacity = float(sum(
            np.sum(np.log2(1.0 + np.asarray(s))) for s in sinr_all_k))
        ia_runned_iterations = int(
            getattr(self.ia_solver, "runned_iterations", 0) or 0)

        simResults = SimulationResults()
        simResults.add_result(
            Result.create("symbol_errors", Result.SUMTYPE, symbolErrors))
        simResults.add_result(
            Result.create("num_symbols", Result.SUMTYPE, numSymbols))
        simResults.add_result(
            Result.create("bit_errors", Result.SUMTYPE, bitErrors))
        simResults.add_result(
            Result.create("num_bits", Result.SUMTYPE, numBits))
        simResults.add_result(Result.create(
            "ber", Result.RATIOTYPE, bitErrors, numBits))
        simResults.add_result(Result.create(
            "ser", Result.RATIOTYPE, symbolErrors, numSymbols))
        simResults.add_result(Result.create(
            "ia_cost", Result.RATIOTYPE, ia_cost, 1))
        simResults.add_result(Result.create(
            "sum_capacity", Result.RATIOTYPE, total_sum_capacity, 1))
        simResults.add_result(Result.create(
            "ia_runned_iterations", Result.SUMTYPE, ia_runned_iterations))
        return simResults

    def _keep_going(self, current_params, current_sim_results, current_rep):
        # stop once the accumulated bit errors reach max_bit_errors
        # (simulate_ia.py:247-266)
        if "bit_errors" in current_sim_results and \
                current_sim_results["bit_errors"]:
            cumulated = current_sim_results["bit_errors"][-1].get_result()
            return cumulated < int(self.params["max_bit_errors"])
        return True

    def _on_simulate_current_params_start(self, current_params):
        # iterative solvers sweep these; overridden by subclasses that
        # lack one of the knobs (simulate_ia.py:296-302)
        if "max_iterations" in current_params:
            self.ia_solver.max_iterations = int(
                current_params["max_iterations"])
        if "initialize_with" in current_params:
            self.ia_solver.initialize_with = str(
                current_params["initialize_with"])


class ClosedFormSimulationRunner(IASimulationRunner):
    """Non-iterative closed form solver (simulate_ia.py:348-388)."""

    def __init__(self, default_config_file, read_command_line_args=True):
        super().__init__(ClosedFormIASolver, default_config_file,
                         read_command_line_args)

    def _on_simulate_current_params_start(self, current_params):
        pass  # not iterative


class AlternatingSimulationRunner(IASimulationRunner):
    """Alt-Min solver; sweeps max_iterations only (simulate_ia.py:305-345)."""

    def __init__(self, default_config_file, read_command_line_args=True):
        super().__init__(AlternatingMinIASolver, default_config_file,
                         read_command_line_args)

    def _on_simulate_current_params_start(self, current_params):
        if "max_iterations" in current_params:
            self.ia_solver.max_iterations = int(
                current_params["max_iterations"])


class MinLeakageSimulationRunner(IASimulationRunner):
    """Min-Leakage solver (simulate_ia.py:391-425)."""

    def __init__(self, default_config_file, read_command_line_args=True):
        super().__init__(MinLeakageIASolver, default_config_file,
                         read_command_line_args)


class MaxSINRSimulationRunner(IASimulationRunner):
    """Max-SINR solver (simulate_ia.py:428-462)."""

    def __init__(self, default_config_file, read_command_line_args=True):
        super().__init__(MaxSinrIASolver, default_config_file,
                         read_command_line_args)


class MMSESimulationRunner(IASimulationRunner):
    """MMSE solver (simulate_ia.py:465-502)."""

    def __init__(self, default_config_file, read_command_line_args=True):
        super().__init__(MMSEIASolver, default_config_file,
                         read_command_line_args)


def main_simulate(algorithms_to_simulate, config_file="ia_config_file.txt",
                  read_command_line_args=True):
    """Build and run one runner per requested algorithm
    (simulate_ia.py:505-600); returns the runners for inspection."""
    tic = time()
    runners = []

    if "Closed Form" in algorithms_to_simulate:
        runner = ClosedFormSimulationRunner(config_file,
                                            read_command_line_args)
        for p in ("max_iterations", "initialize_with"):
            try:
                runner.params.remove(p)
            except KeyError:
                pass
        runner.set_results_filename(
            "ia_closed_form_results_{M}-{modulator}_{Nr}x{Nt}_({Ns})")
        runners.append(runner)

    if "Alt Min" in algorithms_to_simulate:
        runner = AlternatingSimulationRunner(config_file,
                                             read_command_line_args)
        try:
            runner.params.remove("initialize_with")
        except KeyError:
            pass
        runner.set_results_filename(
            "ia_alt_min_results_{M}-{modulator}_{Nr}x{Nt}_({Ns})"
            "_MaxIter_{max_iterations}")
        runners.append(runner)

    if "Min Leakage" in algorithms_to_simulate:
        runner = MinLeakageSimulationRunner(config_file,
                                            read_command_line_args)
        runner.set_results_filename(
            "ia_min_leakage_results_{M}-{modulator}_{Nr}x{Nt}_({Ns})"
            "_MaxIter_{max_iterations}_{initialize_with}")
        runners.append(runner)

    if "Max SINR" in algorithms_to_simulate:
        runner = MaxSINRSimulationRunner(config_file,
                                         read_command_line_args)
        runner.set_results_filename(
            "ia_max_sinr_results_{M}-{modulator}_{Nr}x{Nt}_({Ns})"
            "_MaxIter_{max_iterations}_{initialize_with}")
        runners.append(runner)

    if "MMSE" in algorithms_to_simulate:
        runner = MMSESimulationRunner(config_file, read_command_line_args)
        runner.set_results_filename(
            "ia_mmse_results_{M}-{modulator}_{Nr}x{Nt}_({Ns})"
            "_MaxIter_{max_iterations}_{initialize_with}")
        runners.append(runner)

    simulate_do_what_i_mean(runners)
    print("Total Elapsed Time: {0}".format(misc.pretty_time(time() - tic)))
    return runners


def main():
    config = "ia_config_file.txt"
    if not os.path.exists(config):
        here = os.path.dirname(os.path.abspath(__file__))
        candidate = os.path.join(here, "ia_config_file.txt")
        config = candidate if os.path.exists(candidate) else None

    algorithms = ["Closed Form", "Alt Min", "Max SINR", "MMSE"]
    runners = main_simulate(algorithms, config)

    for runner in runners:
        caps = np.array(
            runner.results.get_result_values_list("sum_capacity"))
        bers = np.array(runner.results.get_result_values_list("ber"))
        name = type(runner).__name__.replace("SimulationRunner", "")
        print(f"{name:12s} ({runner.elapsed_time}): "
              f"capacity {np.round(caps, 2)}  ber {bers}")


if __name__ == "__main__":
    main()
