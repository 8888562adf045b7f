"""'Do what I mean' simulation launchers.

Behavioral counterpart of the reference
``pyphysim/simulations/simulationhelpers.py:22-224``: pick the execution
mode automatically, run one or many runners, and print result locations.

Mode selection (device-native): the reference probed for a live IPython
cluster; here the equivalent of 'parallel hardware is available' is a
multi-device jax backend — if more than one device is visible the sweep's
repetition batches are sharded over a mesh, otherwise the single-device
path runs. A ``-i/--index`` CLI argument always forces single-variation
serial mode (cluster job splitting).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence, Union

from .runner import SimulationRunner

__all__ = ["simulate_do_what_i_mean"]


def simulate_do_what_i_mean(
        runner_or_list: Union[SimulationRunner, Sequence[SimulationRunner]],
        folder: Optional[str] = None) -> None:
    """Run simulation(s) in the most appropriate way.

    Parameters
    ----------
    runner_or_list : SimulationRunner or list of SimulationRunner
        The simulation runner(s) to execute. A list runs CONCURRENTLY
        (threads — the work is device-bound, so the GIL is released at
        every XLA dispatch) sharing one progress server, matching the
        reference's multi-runner mode
        (simulationhelpers.py:164-224).
    folder : str, optional
        Ignored in this build (the reference appended it to workers'
        sys.path so pickled runners could import user code; an SPMD program
        has no such requirement). Accepted for call-site compatibility.
    """
    if isinstance(runner_or_list, SimulationRunner):
        _simulate_single(runner_or_list)
    else:
        _simulate_multiple(list(runner_or_list))


def _simulate_multiple(runners: List[SimulationRunner]) -> None:
    """Dispatch several runners concurrently with one shared progress
    server (reference ``_simulate_do_what_i_mean_multiple_runners``,
    simulationhelpers.py:164-224). With a ``-i/--index`` CLI argument
    every runner degrades to its single-variation serial mode (still
    concurrent — the variations are independent)."""
    from ..progressbar import ProgressbarMultiProcessServer

    server = ProgressbarMultiProcessServer(
        message="Simulating all runners")
    for runner in runners:
        num_vars = runner.params.get_num_unpacked_variations()
        if runner.command_line_args.index is not None:
            num_vars = 1
        proxy = server.register_client_and_get_proxy_progressbar(
            runner.rep_max * num_vars)
        runner.external_progress_proxy = proxy

    server.start_updater()
    try:
        with ThreadPoolExecutor(max_workers=len(runners)) as pool:
            futures = [pool.submit(_simulate_single, r) for r in runners]
            for f in futures:
                f.result()  # re-raise the first worker failure
    finally:
        server.stop_updater()
        for runner in runners:
            runner.external_progress_proxy = None


def _simulate_single(runner: SimulationRunner) -> None:
    import jax
    index = runner.command_line_args.index
    if index is not None:
        runner.simulate(param_variation_index=index)
        return

    if jax.device_count() > 1:
        runner.simulate_in_parallel()
    else:
        runner.simulate()

    filename = runner.results_base_filename
    if filename is not None:
        print(f"Results saved to '{runner._get_results_filename()}'")
