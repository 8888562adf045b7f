"""The Monte Carlo simulation runner — the framework's engine.

Behavioral counterpart of the reference
``pyphysim/simulations/runner.py:1076-1948`` (template-method engine,
lifecycle hooks, early stop via ``_keep_going``, ``SkipThisOne`` skip-and-
retry accounting, partial-results checkpoint/resume, progress tracking, CLI
integration), re-architected for accelerator execution:

  * **Compat path** — subclasses implement
    ``_run_simulation(current_parameters) -> SimulationResults`` exactly
    like the reference (runner.py:1334-1366) and get the same serial
    per-repetition loop. Useful for porting and for host-side algorithms.

  * **device batch path** — subclasses instead implement
    ``_gen_simulation_kernel(current_parameters)`` returning a pure
    function ``kernel(key) -> {name: value | (value, total)}`` and declare
    result types in ``self.batch_result_types``. The runner vmaps the
    kernel over a batch of split PRNG keys, jits ONCE per variation, and
    runs ``lax``-free host chunks: each chunk produces per-repetition
    counter arrays that feed ``Result.update_batch``. The reference's
    per-repetition Python loop (runner.py:1491-1517) thus becomes a single
    compiled SPMD program; early stop (``_keep_going``) and
    checkpoint/resume keep their exact semantics at chunk granularity.
    With a device mesh (``runner.mesh``), the key batch is sharded across
    devices (the reference's ipyparallel data-parallelism, P2 in SURVEY
    §2.11, replaced by XLA sharding).

    Two refinements mirror the reference's remaining loop semantics on
    the batch path:

    - **Masked skip** (reference ``SkipThisOne``, runner.py:151-185 and
      the rep-loop handling at runner.py:1491-1517): a kernel may return
      a boolean under the reserved key ``"__valid__"``. Invalid
      repetitions are excluded from every Result, counted into
      ``num_skipped_reps``, and automatically retried with FRESH fold_in
      indices — the runner keeps an *attempt cursor* separate from the
      accepted-repetition count, so the accepted set is exactly "the
      first ``rep_max`` valid attempts" no matter how the attempts are
      chunked, sharded or resumed.

    - **On-device early stop** (SURVEY §7 "early stop without
      divergence"): setting ``self.batch_stop_criterion = (name, limit)``
      makes each dispatched chunk run as a ``lax.scan`` over sub-chunks
      whose kernel work is gated by ``lax.cond`` on the accumulated
      value of result ``name`` — once the limit is crossed the remaining
      sub-chunks execute no kernel FLOPs at all, so a high-SNR sweep
      point stops within ``chunk/num_stop_subchunks`` repetitions of its
      threshold instead of overshooting by a whole host chunk.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from .parameters import SimulationParameters
from .results import Result, SimulationResults

__all__ = ["SimulationRunner", "SkipThisOne", "get_common_parser",
           "get_partial_results_filename", "kernel_stream_seed"]


def kernel_stream_seed(base_seed: int, unpack_index: int) -> int:
    """Per-variation int32 seed for an in-kernel generator's bulk-kernel
    stream family (the kernel-tier apps' shared keying: one fix to the
    formula applies to every app; attempt-level independence comes
    from the kernel's absolute-index streams, variation-level from
    this)."""
    return (int(base_seed) * 1000003 + max(int(unpack_index), 0)) \
        & 0x7FFFFFFF


def get_partial_results_filename(
        results_base_filename: str,
        current_params: SimulationParameters,
        partial_results_folder: Optional[str] = None) -> str:
    """Name of the partial-results checkpoint file for one unpacked
    variation: ``<base>_unpack_<i>.pickle`` with the index zero-padded to
    the digit count of the total number of variations
    (parity: runner.py:109-145)."""
    total_unpacks = current_params.get_num_unpacked_variations()
    num_digits = len(str(total_unpacks))
    unpack_index_str = str(max(current_params.unpack_index, 0)).zfill(
        num_digits)
    filename = f"{results_base_filename}_unpack_{unpack_index_str}.pickle"
    if partial_results_folder is not None:
        filename = os.path.join(partial_results_folder, filename)
    return filename


class SkipThisOne(Exception):
    """Raised inside ``_run_simulation`` to discard the current repetition
    (e.g. a singular matrix was drawn); the repetition is retried and a
    ``num_skipped_reps`` SUMTYPE result accounts for it
    (parity: runner.py:151-185)."""

    def __init__(self, msg: str = "") -> None:
        super().__init__(msg)
        self.msg = msg


_common_parser: Optional[argparse.ArgumentParser] = None


def get_common_parser() -> argparse.ArgumentParser:
    """Singleton argparse parser with the shared simulation options
    (parity: runner.py:44-101)."""
    global _common_parser
    if _common_parser is None:
        parser = argparse.ArgumentParser(add_help=False)
        group = parser.add_argument_group("Simulation options")
        group.add_argument("-c", "--config", type=str, default=None,
                           help="Config file with simulation parameters")
        group.add_argument("-i", "--index", type=int, default=None,
                           help="Run only the variation with this unpack "
                                "index and save only its partial results")
        group.add_argument("-n", "--number_variations", action="store_true",
                           help="Print the number of unpacked variations "
                                "and exit")
        _common_parser = parser
    return _common_parser


class _OffsetProgressProxy:
    """Adapter mapping a variation's local repetition count into a
    runner-global count on a shared progress-server proxy."""

    def __init__(self, proxy, offset: int) -> None:
        self._proxy = proxy
        self._offset = int(offset)

    def progress(self, count: int) -> None:
        self._proxy.progress(self._offset + int(count))


class SimulationRunner:
    """Monte Carlo engine: parameter sweep x repetitions -> typed results."""

    def __init__(self, default_config_file: Optional[str] = None,
                 config_spec=None, read_command_line_args: bool = True,
                 save_parsed_file: bool = False) -> None:
        self.rep_max = 1
        self._elapsed_time = 0.0
        self._runned_reps: List[int] = []
        # serial-path attempt cursor (set by _serial_loop before every
        # _run_simulation call; resume-safe — see _serial_loop)
        self.serial_attempt = 0
        self.params = SimulationParameters()
        self.results = SimulationResults()

        # Progress display
        self.progressbar_message = "Progress"
        self.update_progress_function_style: Optional[str] = "text1"
        self.progress_output_type = "screen"  # or 'file'
        self.progressbar_extra_args: Dict[str, Any] = {}

        # Checkpointing
        self.partial_results_folder = "partial_results"
        self.delete_partial_results_bool = False
        self.__results_base_filename: Optional[str] = None
        self.__partial_files_to_delete: List[Path] = []
        self.__last_checkpoint_time = time.time()
        self.__last_checkpoint_rep = 0

        # device batch execution
        self.batch_size: Optional[int] = None  # auto if None
        self.batch_result_types: Dict[str, Any] = {}
        self.mesh = None          # optional jax.sharding.Mesh
        self.mesh_axis = "mc"     # axis name used for key sharding
        self.base_seed = 1234
        # On-device early stop: (result_name, limit) stops a variation
        # once the ACCUMULATED raw value of that (SUMTYPE, or RATIOTYPE
        # numerator) result crosses ``limit`` — at sub-chunk granularity
        # inside the compiled program, not just between host chunks.
        self.batch_stop_criterion: Optional[Tuple[str, float]] = None
        self.num_stop_subchunks = 8

        # Shared-progress-server proxy installed by the multi-runner
        # launcher (simulationhelpers._simulate_multiple); overrides the
        # per-variation progress bars when set.
        self.external_progress_proxy = None

        # Command line integration (parity: runner.py:685-758)
        self.command_line_args = argparse.Namespace(
            config=None, index=None, number_variations=False)
        if read_command_line_args and not self._running_under_test():
            parser = argparse.ArgumentParser(parents=[get_common_parser()])
            self.command_line_args, _ = parser.parse_known_args()

        config_file = self.command_line_args.config or default_config_file
        if config_file is not None and os.path.exists(config_file):
            self.params = SimulationParameters.load_from_config_file(
                config_file, config_spec, save_parsed_file)

    @staticmethod
    def _running_under_test() -> bool:
        return "pytest" in sys.modules or "unittest" in sys.modules

    # ------------------------------------------------------------------
    # Template methods (subclass API)
    # ------------------------------------------------------------------

    def _run_simulation(
            self, current_parameters: SimulationParameters
    ) -> SimulationResults:
        """One repetition (compat path). Subclasses the reference way
        override this (runner.py:1334-1366)."""
        raise NotImplementedError(
            "Implement either _run_simulation (serial path) or "
            "_gen_simulation_kernel (device batch path)")

    def _gen_simulation_kernel(
            self, current_parameters: SimulationParameters
    ) -> Optional[Callable]:
        """device batch path: return a pure function ``kernel(key)`` producing
        ``{name: value}`` / ``{name: (value, total)}`` scalars; declare the
        types in ``self.batch_result_types``. Return None (default) to use
        the serial path."""
        return None

    def _gen_bulk_kernel(
            self, current_parameters: SimulationParameters
    ) -> Optional[Callable]:
        """Bring-your-own-batching path, for kernels that own their rep
        dimension (e.g. a Pallas program generating data/noise from an
        in-kernel counter-based generator — see ``ops/ia_pallas.py`` and
        ``apps/ia/ia_mc_kernel.py`` — or a self-batched XLA chain, as in
        ``apps/ofdm/ofdm_mc_kernel.py``).

        Return ``fn(start: int, n: int) -> {name: out}`` where every
        ``out`` has leading axis ``n`` (or is a ``(values, totals)``
        pair of such arrays for RATIOTYPE); declare the Result types in
        ``self.batch_result_types`` exactly like the per-key path. The
        reserved ``"__valid__"`` mask and its skip-and-retry accounting
        apply unchanged.

        Contract: attempt ``start + i``'s randomness must depend only on
        ``(base_seed, unpack_index, start + i)`` — that is what makes
        results chunk-size invariant and checkpoint/resume exact, the
        property the per-key path gets from its fold_in schedule. ``n``
        comes from a fixed 4-entry ladder (batch, batch/2, /4, /8):
        without a stop criterion it is always the full batch size (the
        runner discards surplus rows past the accepted prefix rather
        than requesting odd tail sizes); with ``batch_stop_criterion``
        set, the runner shrinks down the ladder as the accumulated
        metric approaches the limit, so a kernel that caches one
        compiled program per distinct ``n`` compiles at most 4. Returning
        lazy jax arrays (not numpy) lets the runner enqueue chunk k+1
        before fetching chunk k (double-buffered dispatch). A kernel
        with MANY declared results should return the runner's packed
        single-transfer form instead: call ``self._pack_tree(out_tree,
        ones_mask, box)`` inside its jitted program and return
        ``self._LazyChunk(packed, box)`` — one fixed-latency host
        transfer per chunk instead of one per result array (see
        ``apps/comp_BD/simulate_comp.py``). Sharding is
        the kernel's own responsibility — ``self.mesh`` is set while
        :meth:`simulate_in_parallel` runs, and
        :func:`pyphysim_tpu.parallel.shard_reps` splits the rep axis over
        the mesh with per-device absolute start offsets (bit-identical to
        unsharded). Takes
        precedence over ``_gen_simulation_kernel``. Return None
        (default) if unused."""
        return None

    # noinspection PyUnusedLocal
    def _keep_going(self, current_params: SimulationParameters,
                    current_sim_results: SimulationResults,
                    current_rep: int) -> bool:
        """Early-stop predicate, checked between repetitions (serial) or
        chunks (batch). Default: never stop early."""
        return True

    def _on_simulate_start(self) -> None:
        """Hook called once at simulation start (runner.py:1889)."""

    def _on_simulate_finish(self) -> None:
        """Hook called once at simulation end."""

    def _on_simulate_current_params_start(
            self, current_params: SimulationParameters) -> None:
        """Hook called before each variation (re-seed RNGs here when
        running with external schedulers)."""

    def _on_simulate_current_params_finish(
            self, current_params: SimulationParameters,
            current_params_sim_results: SimulationResults) -> None:
        """Hook called after each variation."""

    # ------------------------------------------------------------------
    # Properties
    # ------------------------------------------------------------------

    @property
    def elapsed_time(self) -> str:
        from ..utils.misc import pretty_time
        return pretty_time(self._elapsed_time)

    @property
    def runned_reps(self) -> List[int]:
        """Repetitions actually executed per variation."""
        return self._runned_reps

    @property
    def results_base_filename(self) -> Optional[str]:
        return self.__results_base_filename

    @property
    def results_filename(self) -> Optional[str]:
        """Final results filename with ``{param}`` placeholders replaced
        (parity: runner.py results_filename property)."""
        return self._get_results_filename()

    def set_results_filename(self, filename: Optional[str] = None) -> None:
        """Set the base filename for final and partial results
        ( ``{param}`` templating supported)."""
        self.__results_base_filename = filename

    # ------------------------------------------------------------------
    # Checkpointing (parity: runner.py:761-1069)
    # ------------------------------------------------------------------

    def _get_results_filename(self) -> Optional[str]:
        if self.__results_base_filename is None:
            return None
        from ..utils.misc import replace_dict_values
        return replace_dict_values(self.__results_base_filename,
                                   self.params.parameters,
                                   filename_mode=True)

    def _get_partial_results_filename(
            self, current_params: SimulationParameters) -> Optional[str]:
        base = self._get_results_filename()
        if base is None:
            return None
        folder = self.partial_results_folder
        if folder and not os.path.isabs(folder):
            # keep partials next to the results file (shared-filesystem
            # semantics of the reference, runner.py:1795-1805)
            folder = os.path.join(os.path.dirname(base), folder)
        return get_partial_results_filename(
            os.path.basename(base), current_params,
            folder or os.path.dirname(base))

    @staticmethod
    def _is_primary_host() -> bool:
        """Under multi-process execution only process 0 touches the
        filesystem (the reference's P3 semantics: partials live on a
        shared filesystem and are written/deleted once,
        runner.py:1795-1805). All hosts still LOAD checkpoints — the
        replicated outputs keep their accounting in lockstep."""
        import jax
        try:
            return jax.process_index() == 0
        except RuntimeError:  # backend not initialized yet
            return True

    def _save_partial_results(self, current_rep: int,
                              current_params: SimulationParameters,
                              current_sim_results: SimulationResults) -> None:
        if not self._is_primary_host():
            return
        filename = self._get_partial_results_filename(current_params)
        if filename is None:
            return
        current_sim_results.set_parameters(current_params)
        current_sim_results.current_rep = current_rep
        folder = os.path.dirname(filename)
        if folder:
            os.makedirs(folder, exist_ok=True)
        current_sim_results.save_to_file(filename)
        self.__partial_files_to_delete.append(Path(filename).absolute())

    def _save_partial_results_maybe(
            self, current_rep: int, current_params: SimulationParameters,
            current_sim_results: SimulationResults) -> None:
        """Throttled checkpoint: every 500 reps or 300 s
        (parity: runner.py:996-1017). The rep throttle fires on CROSSING
        a multiple of 500, not on exact equality — batch chunks whose
        size does not divide 500 would otherwise never trigger it."""
        now = time.time()
        if now - self.__last_checkpoint_time > 300 or \
                current_rep // 500 > self.__last_checkpoint_rep // 500:
            self._save_partial_results(current_rep, current_params,
                                       current_sim_results)
            self.__last_checkpoint_time = now
            self.__last_checkpoint_rep = current_rep

    def _load_partial_results(
            self, current_params: SimulationParameters
    ) -> Optional[SimulationResults]:
        """Load+validate a partial-results checkpoint; raises ValueError on
        parameter mismatch (resume-reject, parity runner.py:1042-1063)."""
        filename = self._get_partial_results_filename(current_params)
        if filename is None or not os.path.exists(filename):
            return None
        partial = SimulationResults.load_from_file(filename)
        if not current_params == partial.params:
            raise ValueError(
                "Partial results loaded from file do not match current "
                f"parameters.\nfile: '{filename}'\nDelete that file first "
                "to simulate with a new configuration.")
        return partial

    def __delete_partial_results_maybe(self) -> None:
        if self.delete_partial_results_bool and self._is_primary_host():
            for f in self.__partial_files_to_delete:
                try:
                    f.unlink()
                except OSError:
                    pass
            self.__partial_files_to_delete.clear()

    # ------------------------------------------------------------------
    # Progress helpers
    # ------------------------------------------------------------------

    def _get_progress_bar(self, variation_index: int, num_variations: int,
                          rep_max: int, current_params=None):
        if self.external_progress_proxy is not None:
            # Multi-runner mode (simulationhelpers): one proxy covers the
            # whole runner; per-variation counts are offset into it.
            return _OffsetProgressProxy(self.external_progress_proxy,
                                        variation_index * rep_max)
        from ..progressbar import (DummyProgressbar, ProgressbarText,
                                   ProgressbarText2, ProgressbarText3)
        styles = {"text1": ProgressbarText, "text2": ProgressbarText2,
                  "text3": ProgressbarText3}
        if self.update_progress_function_style not in styles or \
                not self._is_primary_host():
            return DummyProgressbar()
        source = (current_params.parameters if current_params is not None
                  else self.params.parameters)
        try:
            message = self.progressbar_message.format(**{
                k: v for k, v in source.items()
                if not isinstance(v, (list, np.ndarray))})
        except (KeyError, IndexError):
            message = self.progressbar_message
        output = None
        if self.progress_output_type == "file":
            base = self._get_results_filename() or "simulation"
            output = open(
                f"{base}_progress_{variation_index + 1}_of_"
                f"{num_variations}.txt", "w")
        return styles[self.update_progress_function_style](
            rep_max, message=message, output=output,
            **self.progressbar_extra_args)

    # ------------------------------------------------------------------
    # Main entry points
    # ------------------------------------------------------------------

    def simulate(self,
                 param_variation_index: Optional[int] = None) -> None:
        """Run the full simulation (all variations), or exactly one
        variation when ``param_variation_index`` (or the ``-i`` CLI arg)
        is given — the cluster job-splitting mode that only writes that
        variation's partial results file (parity: runner.py:1636-1668)."""
        if self.command_line_args.number_variations:
            print(self.params.get_num_unpacked_variations())
            return
        if param_variation_index is None:
            param_variation_index = self.command_line_args.index

        tic = time.time()
        self.__partial_files_to_delete.clear()
        self.params.add("rep_max", self.rep_max)
        self.results = SimulationResults()
        self.results.set_parameters(self.params)
        self._runned_reps = []
        self._on_simulate_start()

        unpacked = self.params.get_unpacked_params_list()
        if param_variation_index is not None:
            if not 0 <= param_variation_index < len(unpacked):
                raise ValueError(
                    f"Invalid variation index: {param_variation_index}")
            unpacked = [unpacked[param_variation_index]]

        for i, current_params in enumerate(unpacked):
            if self.update_progress_function_style is not None and \
                    self.progress_output_type == "screen" and \
                    len(unpacked) > 1:
                print(f"Current Variation: {i + 1}/{len(unpacked)}")
            current_results, reps = self._simulate_for_current_params(
                current_params, i, len(unpacked))
            self._runned_reps.append(reps)
            if param_variation_index is None:
                self.results.append_all_results(current_results)

        self._elapsed_time = time.time() - tic
        self._on_simulate_finish()
        self.results.runned_reps = list(self._runned_reps)

        if param_variation_index is None:
            filename = self._get_results_filename()
            if filename is not None and self._is_primary_host():
                self.results.save_to_file(filename)
            self.__delete_partial_results_maybe()

    # alias matching the reference's "serial" nomenclature
    simulate_serially = simulate

    def wait_parallel_simulation(self) -> None:
        """Await a sweep started with ``simulate_in_parallel(block=
        False)`` — the reference's async-dispatch contract
        (runner.py:1857-1886): join the sweep thread, then re-raise any
        error it hit. A no-op when no async sweep is running (including
        after the default blocking ``simulate_in_parallel``, which has
        already gathered results when it returns)."""
        thread = getattr(self, "_parallel_thread", None)
        if thread is None:
            return
        thread.join()
        self._parallel_thread = None
        err = self.__dict__.pop("_parallel_error", None)
        if err is not None:
            raise err

    def simulate_common_cleaning(self) -> None:
        """Finalize a simulation: save final results and delete partials
        if requested (parity: runner.py:1621-1634). Called automatically
        by :meth:`simulate`; public for reference compatibility."""
        filename = self._get_results_filename()
        if filename is not None and self._is_primary_host():
            self.results.save_to_file(filename)
        self.__delete_partial_results_maybe()

    def simulate_in_parallel(self, mesh=None, block: bool = True) -> None:
        """Run the sweep with repetitions sharded over a device mesh.

        Device-native replacement for the reference's ipyparallel dispatch
        (runner.py:1774-1886): instead of pickling the runner to worker
        processes, the SAME jitted kernel runs SPMD with its key batch
        sharded across devices; XLA inserts the collectives. Bulk
        kernels get the mesh through ``self.mesh`` (see
        :meth:`_gen_bulk_kernel`).

        ``block=False`` reproduces the reference's ASYNC dispatch: the
        call returns immediately with the sweep running on a background
        thread (host work can overlap the device sweep) and results are
        gathered by :meth:`wait_parallel_simulation` — the exact
        dispatch/await split of reference runner.py:1774-1886. Don't
        touch ``self.results`` until the wait returns.
        """
        thread = getattr(self, "_parallel_thread", None)
        if thread is not None:
            if thread.is_alive():
                raise RuntimeError(
                    "An asynchronous sweep is already running on this "
                    "runner; call wait_parallel_simulation() first")
            # The previous sweep already finished — auto-join it (and
            # surface any error it stored) instead of forcing an
            # explicit wait for a dead thread.
            self.wait_parallel_simulation()
        if mesh is None:
            from ..parallel.mesh import make_mesh
            mesh = make_mesh()
        self.mesh = mesh

        def _sweep() -> None:
            try:
                self.simulate()
            finally:
                self.mesh = None

        if block:
            _sweep()
            return

        import threading

        def _async() -> None:
            try:
                _sweep()
            except BaseException as exc:  # re-raised by the wait
                self._parallel_error = exc

        self._parallel_error = None
        self._parallel_thread = threading.Thread(
            target=_async, name="simulate_in_parallel", daemon=True)
        self._parallel_thread.start()

    # ------------------------------------------------------------------
    # Per-variation execution
    # ------------------------------------------------------------------

    def _simulate_for_current_params(
            self, current_params: SimulationParameters,
            variation_index: int,
            num_variations: int) -> Tuple[SimulationResults, int]:
        self._on_simulate_current_params_start(current_params)

        partial = self._load_partial_results(current_params)
        if partial is not None:
            current_results = partial
            current_rep = partial.current_rep
        else:
            current_results = SimulationResults()
            current_rep = 0
        self.__last_checkpoint_rep = current_rep

        pbar = self._get_progress_bar(variation_index, num_variations,
                                      self.rep_max, current_params)

        bulk = self._gen_bulk_kernel(current_params)
        kernel = (self._gen_simulation_kernel(current_params)
                  if bulk is None else None)
        tic = time.time()
        if bulk is not None:
            current_rep = self._bulk_loop(bulk, current_params,
                                          current_results, current_rep,
                                          pbar)
        elif kernel is not None:
            current_rep = self._batch_loop(kernel, current_params,
                                           current_results, current_rep,
                                           pbar)
        else:
            current_rep = self._serial_loop(current_params, current_results,
                                            current_rep, pbar)
        pbar.progress(self.rep_max)

        self._on_simulate_current_params_finish(current_params,
                                                current_results)
        if current_rep > 0:
            self._save_partial_results(current_rep, current_params,
                                       current_results)
        elapsed = time.time() - tic
        return current_results, current_rep

    # -- serial (compat) path ---------------------------------------------

    def _serial_loop(self, current_params, current_results, current_rep,
                     pbar) -> int:
        # ``serial_attempt`` is the serial path's analog of the bulk
        # path's absolute attempt cursor: monotone within a variation
        # (skipped attempts advance it, so retries get fresh
        # randomness) and derived from the PERSISTED repetition AND
        # skip counts, so a checkpoint-resume continues the attempt
        # sequence instead of replaying realizations already
        # accumulated — including after skips, which is why every skip
        # is merged into the results IMMEDIATELY (so mid-loop
        # checkpoints carry the running skip count, exactly like the
        # bulk path's ``cursor = current_rep + skipped_before``). User
        # ``_run_simulation`` code that seeds per-repetition randomness
        # should key it on this (plus the variation's unpack_index)
        # rather than an in-memory counter.
        skipped_before = 0
        if "num_skipped_reps" in current_results and \
                current_results["num_skipped_reps"]:
            prior = current_results["num_skipped_reps"][-1]
            if prior.num_updates > 0:
                skipped_before = int(prior.get_result())
        attempt = current_rep + skipped_before
        while current_rep < self.rep_max and self._keep_going(
                current_params, current_results, current_rep):
            tic = time.time()
            attempt += 1
            self.serial_attempt = attempt
            try:
                rep_results = self._run_simulation(current_params)
            except SkipThisOne:
                self._merge_skip_count(current_results, 1)
                continue
            elapsed = time.time() - tic
            rep_results.add_result(
                Result.create("elapsed_time", Result.SUMTYPE, elapsed))
            current_results.merge_all_results(rep_results)
            current_rep += 1
            pbar.progress(current_rep)
            self._save_partial_results_maybe(current_rep, current_params,
                                             current_results)
        self._merge_skip_count(current_results, 0)  # ensure existence
        return current_rep

    @staticmethod
    def _merge_skip_count(current_results, num_skipped: int) -> None:
        skip = Result.create("num_skipped_reps", Result.SUMTYPE, num_skipped)
        if "num_skipped_reps" in current_results:
            current_results["num_skipped_reps"][-1].merge(skip)
        else:
            current_results.add_result(skip)

    # -- device batch path ----------------------------------------------------

    def _default_batch_size(self) -> int:
        if self.batch_size is not None:
            bsize = int(self.batch_size)
        else:
            # One compile; chunks small enough for early-stop granularity
            # but large enough to amortize dispatch.
            bsize = int(min(max(self.rep_max // 8, 1), 4096))
        return self._round_chunk(bsize)

    def _chunk_quantum(self) -> int:
        """Chunk sizes must be a multiple of this: the mesh axis size
        (even shards) times the early-stop sub-chunk count (even scan)."""
        q = 1
        if self.mesh is not None:
            q *= int(self.mesh.shape[self.mesh_axis])
        if self.batch_stop_criterion is not None:
            q *= max(int(self.num_stop_subchunks), 1)
        return q

    def _round_chunk(self, n: int) -> int:
        q = self._chunk_quantum()
        return ((max(int(n), 1) + q - 1) // q) * q

    # -- chunk executors ---------------------------------------------------

    def _make_chunk_executor(self, kernel):
        """Build ``executor(keys, prior_metric) -> (outputs, active)``.

        ``outputs`` is the kernel's per-repetition pytree with a leading
        batch axis; ``active`` is a per-repetition bool saying whether the
        repetition was actually computed (device early stop gates whole
        sub-chunks off once ``batch_stop_criterion`` is crossed). Without
        a stop criterion every repetition is active and the executor is a
        plain jitted vmap. jax.jit caches per key-batch shape, so the
        (single) smaller tail chunk costs one extra compile instead of
        computing and discarding a full-size batch.
        """
        import jax
        import jax.numpy as jnp

        batched = jax.vmap(kernel)
        box = {}  # static treedef + per-chunk-size leaf specs

        if self.batch_stop_criterion is None:
            def packed_fn(keys):
                out = batched(keys)
                ones = jnp.ones(keys.shape[0], bool)
                return self._pack_tree(out, ones, box)

            if self.mesh is not None:
                from jax.sharding import NamedSharding, PartitionSpec as P
                key_sharding = NamedSharding(self.mesh, P(self.mesh_axis))
                # Outputs are REPLICATED (an all-gather of counter-sized
                # arrays): under a multi-process mesh a sharded output
                # would not be host-addressable, and every host needs the
                # full per-rep arrays to run the (deterministic, lockstep)
                # Result accounting — the reference's P2 'results cross
                # back to the launcher' semantics (runner.py:1857-1886)
                # without a pickle channel.
                rep_sharding = NamedSharding(self.mesh, P())
                run = jax.jit(packed_fn, in_shardings=(key_sharding,),
                              out_shardings=rep_sharding)

                def executor(keys, prior_metric):
                    del prior_metric
                    return self._LazyChunk(
                        run(self._globalize(keys, key_sharding)), box)

                return executor

            run = jax.jit(packed_fn)

            def executor(keys, prior_metric):
                del prior_metric
                return self._LazyChunk(run(keys), box)

            return executor

        stop_name, limit = self.batch_stop_criterion
        limit = float(limit)
        n_sub = max(int(self.num_stop_subchunks), 1)

        def chunk_fn(keys, prior_metric):
            # keys: (n_sub, sub, ...) — reshaped on the host so the mesh
            # sharding annotation stays a plain leading-axis spec
            out_shapes = jax.eval_shape(batched, keys[0])

            def body(acc, kk):
                active = acc < limit

                def run(k):
                    return batched(k)

                def dont(k):
                    del k
                    return jax.tree_util.tree_map(
                        lambda s: jnp.zeros(s.shape, s.dtype), out_shapes)

                out = jax.lax.cond(active, run, dont, kk)
                metric = out[stop_name]
                if isinstance(metric, tuple):
                    metric = metric[0]
                if "__valid__" in out:
                    metric = jnp.where(out["__valid__"], metric, 0)
                acc = acc + jnp.sum(metric).astype(jnp.float32)
                return acc, (out, jnp.broadcast_to(active, kk.shape[:1]))

            _, (outs, actives) = jax.lax.scan(body,
                                              jnp.float32(prior_metric),
                                              keys)
            flat = jax.tree_util.tree_map(
                lambda x: x.reshape((-1,) + x.shape[2:]), outs)
            return flat, actives.reshape(-1)

        def chunk_fn_packed(keys, prior_metric):
            flat, actives = chunk_fn(keys, prior_metric)
            return self._pack_tree(flat, actives, box)

        sub_sharding = None
        if self.mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P
            sub_sharding = NamedSharding(self.mesh, P(None, self.mesh_axis))
            run = jax.jit(chunk_fn_packed, in_shardings=(sub_sharding, None),
                          out_shardings=NamedSharding(self.mesh, P()))
        else:
            run = jax.jit(chunk_fn_packed)

        def executor(keys, prior_metric):
            nk = keys.shape[0]
            sub = nk // n_sub  # nk is a _round_chunk multiple of n_sub
            keys = keys.reshape((n_sub, sub) + keys.shape[1:])
            if sub_sharding is not None:
                keys = self._globalize(keys, sub_sharding)
            return self._LazyChunk(run(keys, prior_metric), box)

        return executor

    @staticmethod
    def _globalize(x, sharding):
        """Build a global device array from a host-replicated value.

        Under a multi-process mesh a plain (host-local) array cannot feed
        a jit whose input sharding spans non-addressable devices; every
        host computes the SAME key array, so each just contributes its
        local shards."""
        import jax
        if jax.process_count() <= 1:
            return x
        host = np.asarray(x)
        return jax.make_array_from_callback(host.shape, sharding,
                                            lambda idx: host[idx])

    def _stop_metric_value(self, current_results) -> float:
        """Accumulated raw value of the stop-criterion result (SUMTYPE
        value, or RATIOTYPE numerator)."""
        name, _ = self.batch_stop_criterion
        if name in current_results and current_results[name]:
            r = current_results[name][-1]
            if r.num_updates > 0:
                return float(r._value)
        return 0.0

    def _stop_criterion_ok(self, current_results) -> bool:
        if self.batch_stop_criterion is None:
            return True
        return self._stop_metric_value(current_results) < \
            float(self.batch_stop_criterion[1])

    def _batch_loop(self, kernel, current_params, current_results,
                    current_rep, pbar) -> int:
        import jax
        import jax.numpy as jnp

        if not self.batch_result_types:
            raise RuntimeError(
                "The device batch path requires self.batch_result_types to "
                "declare the Result type of every kernel output")

        bsize = self._default_batch_size()
        executor = self._make_chunk_executor(kernel)

        # Deterministic, resumable key schedule: variation key folded from
        # the base seed and unpack index; each ATTEMPT's key folded from
        # its global attempt index — INDEPENDENT of chunk/batch size, so
        # serial, resumed and mesh-sharded runs of the same seed produce
        # identical streams and the accepted set is always "the first
        # rep_max valid attempts".
        var_key = jax.random.fold_in(
            jax.random.PRNGKey(self.base_seed),
            max(current_params.unpack_index, 0))
        fold_batch = jax.jit(jax.vmap(
            lambda i: jax.random.fold_in(var_key, i)))

        # The attempt cursor resumes as accepted + skipped: skipped
        # attempts consumed fold_in indices too (skip-and-retry parity
        # with reference runner.py:1491-1517).
        skipped_before = 0
        if "num_skipped_reps" in current_results and \
                current_results["num_skipped_reps"]:
            prior = current_results["num_skipped_reps"][-1]
            if prior.num_updates > 0:
                skipped_before = int(prior.get_result())
        cursor = current_rep + skipped_before

        def dispatch(cur: int, nk: int):
            keys = fold_batch(jnp.arange(cur, cur + nk))
            prior_metric = (self._stop_metric_value(current_results)
                            if self.batch_stop_criterion is not None
                            else 0.0)
            return executor(keys, prior_metric)

        # Double-buffered dispatch (the reference's async ipyparallel
        # dispatch delta, runner.py:1774-1886): chunk k+1 is ENQUEUED
        # before chunk k's outputs are materialized — JAX async dispatch
        # makes this a reordering, not a thread — hiding the fixed
        # per-dispatch latency behind chunk k's host accounting.
        # Off when a device stop criterion is set (the speculated
        # prior_metric would gate sub-chunks differently); a mispredicted
        # cursor (skips landed in chunk k) just discards the speculative
        # result and re-dispatches.
        speculate = self.batch_stop_criterion is None
        pending: Optional[Tuple[int, int, Any]] = None
        while current_rep < self.rep_max and \
                self._stop_criterion_ok(current_results) and \
                self._keep_going(current_params, current_results,
                                 current_rep):
            tic = time.time()
            needed = self.rep_max - current_rep
            nk = min(bsize, self._round_chunk(needed))
            if pending is not None and pending[:2] == (cursor, nk):
                lazy = pending[2]
            else:
                lazy = dispatch(cursor, nk)
            pending = None
            if speculate and needed > nk:
                nk_next = min(bsize, self._round_chunk(needed - nk))
                pending = (cursor + nk, nk_next,
                           dispatch(cursor + nk, nk_next))
            # ONE host transfer for the whole chunk (out tree + active
            # mask), AFTER the speculative dispatch above was enqueued
            out, active = lazy.materialize()
            elapsed = time.time() - tic

            n_accept, consumed, n_skip = self._consume_chunk(
                out, active, nk, needed, elapsed, current_results)

            current_rep += n_accept
            cursor += consumed
            if consumed != nk:
                # skips shifted the cursor: every future speculation
                # would mispredict, so stop paying for discarded chunks
                speculate = False
            pbar.progress(current_rep)
            self._save_partial_results_maybe(current_rep, current_params,
                                             current_results)
            if n_accept == 0 and n_skip == 0:
                # device early stop gated the whole chunk off
                break
        self._merge_skip_count(current_results, 0)
        return current_rep

    @staticmethod
    def _pack_tree(out, actives, box):
        """Inside-jit packing of a chunk's output tree + active mask
        into ONE f32 matrix (nk, D): every device-to-host transfer pays
        a fixed latency, so a kernel with many declared results would
        otherwise pay it once PER ARRAY per chunk. int32/uint32/bool leaves ride
        as exact bitcasts (bool via int32), so the round trip is
        bit-exact; static leaf specs are recorded per chunk size."""
        import jax
        import jax.numpy as jnp
        leaves, treedef = jax.tree_util.tree_flatten(out)
        leaves = leaves + [actives]
        nk = actives.shape[0]
        cols, specs = [], []
        for leaf in leaves:
            x = jnp.asarray(leaf)
            specs.append((np.dtype(x.dtype), x.shape))
            if x.dtype == jnp.bool_:
                x = x.astype(jnp.int32)
            if x.dtype in (jnp.int32, jnp.uint32):
                x = jax.lax.bitcast_convert_type(x, jnp.float32)
            elif x.dtype != jnp.float32:
                x = x.astype(jnp.float32)  # (b)f16 upcasts are exact
            cols.append(x.reshape(nk, -1))
        box["treedef"] = treedef
        box["specs", nk] = specs
        return jnp.concatenate(cols, axis=-1)

    class _LazyChunk:
        """Deferred single-transfer chunk outputs: ``materialize()``
        fetches the packed matrix once (AFTER the loop has enqueued
        the next speculative chunk, preserving the double-buffer
        overlap) and rebuilds ``(out_tree, actives)``."""

        def __init__(self, dev, box):
            self._dev, self._box = dev, box

        def materialize(self):
            import jax
            host = np.asarray(self._dev)
            nk = host.shape[0]
            specs = self._box["specs", nk]
            leaves, off = [], 0
            for dtype, shape in specs:
                w = int(np.prod(shape[1:])) if len(shape) > 1 else 1
                col = np.ascontiguousarray(host[:, off:off + w])
                off += w
                if dtype == np.bool_:
                    arr = col.view(np.int32).astype(bool)
                elif dtype in (np.dtype(np.int32), np.dtype(np.uint32)):
                    arr = col.view(dtype)
                else:
                    arr = col.astype(dtype, copy=False)
                leaves.append(arr.reshape(shape))
            actives = leaves.pop()
            return (jax.tree_util.tree_unflatten(self._box["treedef"],
                                                 leaves), actives)

    def _consume_chunk(self, out, active, nk, needed, elapsed,
                       current_results) -> Tuple[int, int, int]:
        """Accept-prefix + skip accounting + Result merging for one chunk
        of attempt outputs (shared by the vmapped and bulk batch paths).

        ``active`` is True on a prefix of the chunk (sub-chunk granular
        early stop); attempts after the stop point never ran and do not
        consume stream indices. Returns (n_accept, consumed, n_skip)."""
        valid = out.pop("__valid__", None)
        if valid is None:
            valid = np.ones(nk, dtype=bool)
        else:
            valid = np.asarray(valid).astype(bool)
        candidates = valid & active
        cand_pos = np.flatnonzero(candidates)
        if len(cand_pos) >= needed:
            last = int(cand_pos[needed - 1])
            accept = candidates & (np.arange(nk) <= last)
            consumed = last + 1
        else:
            accept = candidates
            consumed = int(np.count_nonzero(active))
        n_accept = int(np.count_nonzero(accept))
        n_skip = consumed - int(np.count_nonzero(accept[:consumed]))

        chunk_results = SimulationResults()
        for name, spec in self.batch_result_types.items():
            if name not in out:
                raise RuntimeError(
                    f"Kernel did not produce declared result {name!r}")
            type_code, choice_num = self._parse_type_spec(spec)
            r = Result(name, type_code, choice_num=choice_num)
            value = out[name]
            if isinstance(value, tuple):
                r.update_batch(value[0][accept], value[1][accept])
            else:
                r.update_batch(np.asarray(value)[accept])
            chunk_results.add_result(r)
        chunk_results.add_result(
            Result.create("elapsed_time", Result.SUMTYPE, elapsed))
        chunk_results.add_result(
            Result.create("num_skipped_reps", Result.SUMTYPE, n_skip))
        current_results.merge_all_results(chunk_results)
        return n_accept, consumed, n_skip

    def _bulk_loop(self, bulk, current_params, current_results,
                   current_rep, pbar) -> int:
        """Chunk loop for self-batched kernels (``_gen_bulk_kernel``):
        identical accept/skip/checkpoint semantics to ``_batch_loop``,
        but the kernel owns its rep axis — the runner only hands it an
        absolute attempt cursor and the (fixed) chunk size."""
        import jax

        if not self.batch_result_types:
            raise RuntimeError(
                "The device batch path requires self.batch_result_types to "
                "declare the Result type of every kernel output")

        bsize = self._default_batch_size()

        skipped_before = 0
        if "num_skipped_reps" in current_results and \
                current_results["num_skipped_reps"]:
            prior = current_results["num_skipped_reps"][-1]
            if prior.num_updates > 0:
                skipped_before = int(prior.get_result())
        cursor = current_rep + skipped_before

        # Sub-chunk-granular early stop for self-batched kernels: the
        # kernel always receives a size from a FIXED 4-entry ladder
        # (bsize, bsize/2, bsize/4, bsize/8 — quantum-rounded), so it
        # compiles at most 4 shapes; as the accumulated stop metric
        # approaches the limit the runner picks the smallest rung that
        # covers the EXPECTED remaining attempts (estimated from the
        # accepted-rep metric rate), landing the executed work within
        # ~bsize/8 of the threshold instead of overshooting by a whole
        # chunk (reference _keep_going granularity, runner.py:1491-1517).
        ladder = sorted({self._round_chunk(max(bsize // d, 1))
                         for d in (8, 4, 2, 1)})

        def pick_chunk(needed: int) -> int:
            if self.batch_stop_criterion is None:
                return bsize
            # smallest rung covering rep_max's remaining reps (surplus
            # rows past the accepted prefix are discarded as usual)
            nk = next((n for n in ladder if n >= needed), ladder[-1])
            limit = float(self.batch_stop_criterion[1])
            metric = self._stop_metric_value(current_results)
            if current_rep > 0 and metric > 0:
                rate = metric / current_rep
                expected = (limit - metric) / rate
                # largest rung NOT exceeding the expected remaining
                # attempts (clamped to the smallest): approach the
                # threshold in shrinking steps so the crossing chunk is
                # the ~bsize/8 rung, not a full chunk
                rung = ladder[0]
                for n in ladder:
                    if n <= expected:
                        rung = n
                nk = min(nk, rung)
            return nk

        # Double-buffered dispatch, as in _batch_loop: when no stop
        # criterion gates the work, chunk k+1 is enqueued before chunk
        # k's outputs are fetched — effective when the kernel returns
        # lazy device arrays (see _gen_bulk_kernel contract).
        speculate = self.batch_stop_criterion is None
        pending: Optional[Tuple[int, int, Any]] = None
        while current_rep < self.rep_max and \
                self._stop_criterion_ok(current_results) and \
                self._keep_going(current_params, current_results,
                                 current_rep):
            tic = time.time()
            needed = self.rep_max - current_rep
            nk = pick_chunk(needed)
            if pending is not None and pending[:2] == (cursor, nk):
                out = pending[2]
            else:
                out = bulk(cursor, nk)
            pending = None
            if speculate and needed > nk:
                pending = (cursor + nk, bsize, bulk(cursor + nk, bsize))
            if isinstance(out, SimulationRunner._LazyChunk):
                # a bulk kernel may return the runner's packed
                # single-transfer form directly (build with
                # _pack_tree inside its jitted program) — one host
                # fetch for the whole chunk instead of one per result
                out, _ = out.materialize()
            else:
                out = jax.tree_util.tree_map(np.asarray, out)
            elapsed = time.time() - tic
            active = np.ones(nk, dtype=bool)
            n_accept, consumed, n_skip = self._consume_chunk(
                out, active, nk, needed, elapsed, current_results)
            current_rep += n_accept
            cursor += consumed
            if consumed != nk:
                speculate = False  # see _batch_loop
            pbar.progress(current_rep)
            self._save_partial_results_maybe(current_rep, current_params,
                                             current_results)
            if n_accept == 0 and n_skip == 0:
                break
        self._merge_skip_count(current_results, 0)
        return current_rep

    @staticmethod
    def _parse_type_spec(spec) -> Tuple[int, Optional[int]]:
        if isinstance(spec, tuple):
            return int(spec[0]), int(spec[1])
        return int(spec), None

    # ------------------------------------------------------------------

    def clear(self) -> None:
        """Reset results/time, keeping the parameters."""
        self._elapsed_time = 0.0
        self._runned_reps = []
        self.results = SimulationResults()
