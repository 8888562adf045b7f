"""Tests for the Monte Carlo runtime — mirrors the reference's
tests/simulations_package_test.py strategy: dummy runners with analytically
known results, checkpoint save/load/mismatch, resume-after-rep_max-increase
(SURVEY.md §4 items 5-6)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pyphysim_tpu.simulations import (Result, SimulationParameters,
                                      SimulationResults, SimulationRunner,
                                      SkipThisOne,
                                      combine_simulation_results,
                                      get_partial_results_filename)
from pyphysim_tpu.simulations.parameters import \
    combine_simulation_parameters
from pyphysim_tpu.simulations.configobjvalidation import (
    ValidationError, integer_numpy_array_check, load_config,
    real_numpy_array_check, validate_value)


class TestResult:
    def test_sumtype(self):
        r = Result("name", Result.SUMTYPE)
        r.update(13)
        r.update(4)
        assert r.get_result() == 17
        assert r.num_updates == 2
        assert r.type_name == "SUMTYPE"

    def test_ratiotype(self):
        r = Result("name2", Result.RATIOTYPE)
        r.update(4, 10)
        r.update(3, 4)
        assert r.get_result() == 0.5
        other = Result("name2", Result.RATIOTYPE)
        other.update(3, 11)
        other.merge(r)
        assert other.get_result() == 0.4
        assert other.num_updates == 3
        assert other._value == 10
        assert other._total == 25
        # merging into the other direction must not have changed r
        assert r.get_result() == 0.5

    def test_ratiotype_requires_total(self):
        r = Result("x", Result.RATIOTYPE)
        with pytest.raises(ValueError):
            r.update(5)

    def test_misctype(self):
        r = Result("m", Result.MISCTYPE)
        r.update("something")
        r.update("else")
        assert r.get_result() == "else"

    def test_choicetype(self):
        r = Result("c", Result.CHOICETYPE, choice_num=4)
        for v in [0, 1, 1, 3]:
            r.update(v)
        assert np.allclose(r.get_result(), [0.25, 0.5, 0, 0.25])
        with pytest.raises(RuntimeError):
            Result("c", Result.CHOICETYPE)  # missing choice_num

    def test_invalid_type(self):
        with pytest.raises(ValueError):
            Result("bad", 17)

    def test_merge_type_mismatch(self):
        a = Result("a", Result.SUMTYPE)
        b = Result("b", Result.SUMTYPE)
        with pytest.raises(ValueError):
            a.merge(b)

    def test_mean_var_ci(self):
        r = Result("s", Result.SUMTYPE)
        vals = [1.0, 2.0, 3.0, 4.0]
        for v in vals:
            r.update(v)
        assert np.isclose(r.get_result_mean(), np.mean(vals))
        assert np.isclose(r.get_result_var(), np.var(vals))
        lo, hi = r.get_confidence_interval(95.0)
        assert lo < np.mean(vals) < hi

    def test_update_batch_matches_loop(self):
        a = Result("x", Result.RATIOTYPE)
        b = Result("x", Result.RATIOTYPE)
        vals = np.array([3, 1, 4, 1, 5])
        tots = np.array([10, 10, 10, 10, 10])
        for v, t in zip(vals, tots):
            a.update(int(v), int(t))
        b.update_batch(vals, tots)
        assert a.get_result() == b.get_result()
        assert np.isclose(a._result_sum, b._result_sum)
        assert np.isclose(a._result_squared_sum, b._result_squared_sum)
        assert a.num_updates == b.num_updates

    def test_update_batch_choice(self):
        r = Result("c", Result.CHOICETYPE, choice_num=3)
        r.update_batch(np.array([0, 2, 2, 1]))
        assert np.allclose(r.get_result(), [0.25, 0.25, 0.5])

    def test_json_roundtrip(self):
        r = Result.create("ber", Result.RATIOTYPE, 12, 1000)
        r2 = Result.from_json(r.to_json())
        assert r == r2
        c = Result("c", Result.CHOICETYPE, choice_num=3)
        c.update(1)
        c2 = Result.from_json(c.to_json())
        assert c == c2

    def test_accumulate_values(self):
        r = Result("s", Result.SUMTYPE, accumulate_values=True)
        r.update(1)
        r.update(2)
        assert r.get_result_accumulated_values() == [1, 2]


class TestSimulationParameters:
    def test_create_and_access(self):
        p = SimulationParameters.create({"a": 1, "b": [1, 2, 3]})
        assert p["a"] == 1
        assert len(p) == 2
        assert "a" in p

    def test_unpack(self):
        p = SimulationParameters.create(
            {"a": 1, "b": 2, "c": [3, 4], "d": [5, 6]})
        p.set_unpack_parameter("c")
        p.set_unpack_parameter("d")
        lst = p.get_unpacked_params_list()
        assert len(lst) == 4
        assert p.get_num_unpacked_variations() == 4
        # itertools.product order over sorted names (c outer, d inner)
        assert [(v["c"], v["d"]) for v in lst] == \
            [(3, 5), (3, 6), (4, 5), (4, 6)]
        assert [v.unpack_index for v in lst] == [0, 1, 2, 3]

    def test_unpack_not_iterable(self):
        p = SimulationParameters.create({"a": 1})
        with pytest.raises(ValueError):
            p.set_unpack_parameter("a")
        with pytest.raises(ValueError):
            p.set_unpack_parameter("zzz")

    def test_get_pack_indexes(self):
        p = SimulationParameters.create(
            {"p1": [1, 2, 3], "p2": ["a", "b"], "p3": 15})
        p.set_unpack_parameter("p1")
        p.set_unpack_parameter("p2")
        idx = p.get_pack_indexes({"p1": 3, "p3": 15})
        lst = p.get_unpacked_params_list()
        assert len(idx) == 2
        for i in idx:
            assert lst[i]["p1"] == 3

    def test_equality_ignores_rep_max(self):
        p1 = SimulationParameters.create({"a": 1, "rep_max": 100})
        p2 = SimulationParameters.create({"a": 1, "rep_max": 500})
        assert p1 == p2
        p3 = SimulationParameters.create({"a": 2, "rep_max": 100})
        assert p1 != p3

    def test_equality_with_arrays(self):
        p1 = SimulationParameters.create({"snr": np.array([0, 5, 10])})
        p2 = SimulationParameters.create({"snr": np.array([0, 5, 10])})
        p3 = SimulationParameters.create({"snr": np.array([0, 5, 11])})
        assert p1 == p2
        assert p1 != p3

    def test_json_roundtrip(self):
        p = SimulationParameters.create(
            {"a": 1, "snr": np.array([0.0, 5.0])})
        p.set_unpack_parameter("snr")
        p2 = SimulationParameters.from_json(p.to_json())
        assert p == p2

    def test_to_grid(self):
        p = SimulationParameters.create({"snr": np.array([0., 5.]),
                                         "m": np.array([2, 4, 8])})
        p.set_unpack_parameter("snr")
        p.set_unpack_parameter("m")
        m, snr = p.to_grid("m", "snr")
        assert m.shape == snr.shape == (6,)
        lst = p.get_unpacked_params_list()
        for i, v in enumerate(lst):
            assert v["m"] == m[i] and v["snr"] == snr[i]

    def test_combine(self):
        p1 = SimulationParameters.create({"a": 1, "s": np.array([0, 5])})
        p1.set_unpack_parameter("s")
        p2 = SimulationParameters.create({"a": 1, "s": np.array([10, 5])})
        p2.set_unpack_parameter("s")
        u = combine_simulation_parameters(p1, p2)
        assert np.array_equal(u["s"], [0, 5, 10])
        p3 = SimulationParameters.create({"a": 2, "s": np.array([0])})
        p3.set_unpack_parameter("s")
        with pytest.raises(RuntimeError):
            combine_simulation_parameters(p1, p3)


class TestSimulationResults:
    def make_results(self, snrs=(0, 5, 10), seed=0):
        res = SimulationResults()
        p = SimulationParameters.create({"snr": np.array(snrs), "m": 4})
        p.set_unpack_parameter("snr")
        res.set_parameters(p)
        for i, _ in enumerate(snrs):
            res.append_result(
                Result.create("ber", Result.RATIOTYPE, 10 * (i + 1), 1000))
        return res

    def test_append_and_get(self):
        res = self.make_results()
        assert res.get_result_names() == ["ber"]
        assert res.get_result_values_list("ber") == [0.01, 0.02, 0.03]
        assert len(res["ber"]) == 3

    def test_merge_all_results(self):
        a = self.make_results()
        b = SimulationResults()
        b.add_result(Result.create("ber", Result.RATIOTYPE, 10, 1000))
        a.merge_all_results(b)
        # only last variation entry merged
        assert a.get_result_values_list("ber") == [0.01, 0.02, 0.02]

    def test_save_load_pickle_json(self, tmp_path):
        res = self.make_results()
        for ext in (".pickle", ".json"):
            fn = str(tmp_path / f"r{ext}")
            saved = res.save_to_file(fn)
            loaded = SimulationResults.load_from_file(saved)
            assert loaded.get_result_values_list("ber") == \
                res.get_result_values_list("ber")
            assert loaded.params == res.params

    def test_filename_templating(self, tmp_path):
        res = self.make_results()
        fn = str(tmp_path / "r_{m}_{snr}")
        saved = res.save_to_file(fn)
        assert saved.endswith("r_4_[0_(5)_10].pickle")

    def test_to_dataframe(self):
        df = self.make_results().to_dataframe()
        assert list(df["snr"]) == [0, 5, 10]
        assert np.allclose(df["ber"], [0.01, 0.02, 0.03])

    def test_combine_simulation_results(self):
        a = self.make_results((0, 5))
        b = self.make_results((10, 15))
        u = combine_simulation_results(a, b)
        assert np.array_equal(u.params["snr"], [0, 5, 10, 15])
        assert len(u["ber"]) == 4


class TestConfigValidation:
    def test_range_expr(self):
        assert np.array_equal(real_numpy_array_check("0:5:21"),
                              [0, 5, 10, 15, 20])
        assert np.array_equal(real_numpy_array_check("3:8"), [3, 4, 5, 6, 7])
        assert np.array_equal(real_numpy_array_check("[0 5 10:2:16]"),
                              [0, 5, 10, 12, 14])
        assert np.array_equal(integer_numpy_array_check("1:4"), [1, 2, 3])

    def test_bounds(self):
        with pytest.raises(ValidationError):
            real_numpy_array_check("0:5:21", min=1)
        with pytest.raises(ValidationError):
            real_numpy_array_check("0:5:21", max=10)

    def test_validate_value(self):
        assert validate_value("integer(min=1, max=10, default=5)", None) == 5
        assert validate_value("integer(min=1)", "7") == 7
        with pytest.raises(ValidationError):
            validate_value("integer(max=3)", "7")
        arr = validate_value(
            "real_numpy_array(min=0, max=100, default=0:5:31)", None)
        assert np.array_equal(arr, np.arange(0, 31, 5))

    def test_load_config(self, tmp_path):
        cfg = tmp_path / "sim.conf"
        cfg.write_text("""
[Scenario]
SNR = 0:5:31
M = 16
[General]
rep_max = 1000
unpacked_parameters = SNR
""")
        spec = """
[Scenario]
SNR = real_numpy_array(min=-50, max=100, default=15)
M = integer(min=2, max=512, default=4)
[General]
rep_max = integer(min=1, default=500)
unpacked_parameters = string_list(default=list())
"""
        params = load_config(str(cfg), spec)
        assert np.array_equal(params["SNR"], np.arange(0, 31, 5))
        assert params["M"] == 16
        assert params["rep_max"] == 1000
        assert params.unpacked_parameters == ["SNR"]
        assert params.get_num_unpacked_variations() == 7

    def test_string_list_default_with_list_wrapper(self, tmp_path):
        # configobj spells list defaults as list('a', 'b'); the default
        # must parse when the key is absent from the config file
        cfg = tmp_path / "sim2.conf"
        cfg.write_text("[General]\nSNR = 0:2:5\n")
        spec = """
[General]
SNR = real_numpy_array(default=15)
unpacked_parameters = string_list(default=list('SNR'))
"""
        params = load_config(str(cfg), spec)
        assert params.unpacked_parameters == ["SNR"]
        assert params.get_num_unpacked_variations() == 3


# ---------------------------------------------------------------------------
# Dummy runners (SURVEY §4.5 pattern)
# ---------------------------------------------------------------------------


class _DummyRunner(SimulationRunner):
    """Serial-path runner with analytically known result 1.2*SNR + bias."""

    def __init__(self):
        super().__init__(read_command_line_args=False)
        self.params.add("SNR", np.array([0.0, 5.0, 10.0]))
        self.params.add("bias", 1.3)
        self.params.set_unpack_parameter("SNR")
        self.rep_max = 10
        self.update_progress_function_style = None

    def _run_simulation(self, current_parameters):
        res = SimulationResults()
        value = 1.2 * current_parameters["SNR"] + current_parameters["bias"]
        res.add_result(Result.create("lala", Result.RATIOTYPE, value, 1))
        return res


class _DummyRunnerWithSkip(_DummyRunner):
    def __init__(self):
        super().__init__()
        self._count = 0

    def _run_simulation(self, current_parameters):
        self._count += 1
        if self._count % 3 == 0:
            raise SkipThisOne("skip every third")
        return super()._run_simulation(current_parameters)


class _DummyBatchRunner(SimulationRunner):
    """device batch-path runner: same analytic result via a jitted kernel."""

    def __init__(self):
        super().__init__(read_command_line_args=False)
        self.params.add("SNR", np.array([0.0, 5.0, 10.0]))
        self.params.add("bias", 1.3)
        self.params.set_unpack_parameter("SNR")
        self.rep_max = 10
        self.update_progress_function_style = None
        self.batch_result_types = {"lala": Result.RATIOTYPE}

    def _gen_simulation_kernel(self, current_parameters):
        snr = float(current_parameters["SNR"])
        bias = float(current_parameters["bias"])

        def kernel(key):
            del key
            return {"lala": (jnp.asarray(1.2 * snr + bias),
                             jnp.asarray(1.0))}

        return kernel


class TestGetPartialResultsFilename:
    def test_padding_follows_variation_count(self):
        # runner.py:109-145: the unpack index is zero-padded to the digit
        # count of the total number of variations
        p = SimulationParameters.create({"snr": np.arange(12), "m": 4})
        p.set_unpack_parameter("snr")
        variations = p.get_unpacked_params_list()
        assert get_partial_results_filename("res", variations[3]) == \
            "res_unpack_03.pickle"
        assert get_partial_results_filename(
            "res", variations[11], "some/folder") == \
            os.path.join("some/folder", "res_unpack_11.pickle")

    def test_single_digit_total(self):
        p = SimulationParameters.create({"snr": np.arange(3)})
        p.set_unpack_parameter("snr")
        v = p.get_unpacked_params_list()[2]
        assert get_partial_results_filename("res", v) == \
            "res_unpack_2.pickle"


class TestSimulationRunner:
    def test_serial_simulate(self):
        runner = _DummyRunner()
        runner.simulate()
        assert runner.runned_reps == [10, 10, 10]
        values = runner.results.get_result_values_list("lala")
        assert np.allclose(values, [1.3, 7.3, 13.3])
        # elapsed_time result exists per variation
        assert len(runner.results["elapsed_time"]) == 3

    def test_skip_accounting(self):
        runner = _DummyRunnerWithSkip()
        runner.simulate()
        skipped = runner.results.get_result_values_list("num_skipped_reps")
        assert sum(skipped) > 0
        assert runner.runned_reps == [10, 10, 10]

    def test_batch_simulate(self):
        runner = _DummyBatchRunner()
        runner.simulate()
        assert runner.runned_reps == [10, 10, 10]
        values = runner.results.get_result_values_list("lala")
        assert np.allclose(values, [1.3, 7.3, 13.3])

    def test_batch_equals_serial(self):
        a, b = _DummyRunner(), _DummyBatchRunner()
        a.simulate()
        b.simulate()
        assert np.allclose(a.results.get_result_values_list("lala"),
                           b.results.get_result_values_list("lala"))

    def test_single_variation_index(self, tmp_path):
        runner = _DummyRunner()
        runner.set_results_filename(str(tmp_path / "res"))
        runner.partial_results_folder = str(tmp_path / "partial")
        runner.simulate(param_variation_index=1)
        # only that variation's partial file exists; no final results file
        # (index zero-padded to the digit count of the variation total,
        # parity: runner.py:109-145)
        partials = os.listdir(runner.partial_results_folder)
        assert partials == ["res_unpack_1.pickle"]

    def test_results_filename_and_cleaning(self, tmp_path):
        # runner.py compat surface: results_filename property,
        # simulate_common_cleaning, wait_parallel_simulation (no-op)
        runner = _DummyRunner()
        assert runner.results_filename is None
        runner.set_results_filename(str(tmp_path / "res_{bias}"))
        runner.simulate()
        assert runner.results_filename.endswith(
            f"res_{runner.params['bias']}")
        runner.wait_parallel_simulation()  # synchronous backend: no-op
        runner.simulate_common_cleaning()
        assert os.path.exists(runner.results_filename + ".pickle") or \
            os.path.exists(runner.results_filename)

    def test_checkpoint_resume(self, tmp_path):
        # run fully, then increase rep_max and simulate() again: only the
        # remaining reps run (reference notebook semantics)
        runner = _DummyBatchRunner()
        runner.set_results_filename(str(tmp_path / "res"))
        runner.partial_results_folder = str(tmp_path / "partial")
        runner.simulate()
        assert runner.runned_reps == [10, 10, 10]

        runner2 = _DummyBatchRunner()
        runner2.rep_max = 16
        runner2.set_results_filename(str(tmp_path / "res"))
        runner2.partial_results_folder = str(tmp_path / "partial")
        runner2.simulate()
        # resumed: 10 already done; values merged across 16 updates
        lala = runner2.results["lala"][0]
        assert lala.num_updates == 16

    def test_serial_attempt_cursor_resume(self, tmp_path):
        """The serial path's attempt cursor (``runner.serial_attempt``)
        derives from the PERSISTED repetition count: a resumed run
        continues the attempt sequence instead of replaying
        realizations already accumulated (advisor r4 finding on the
        comp_BD host engine's in-memory counter)."""
        from pyphysim_tpu.simulations import (Result, SimulationResults,
                                              SimulationRunner)
        seen = []

        class _AttemptRunner(SimulationRunner):
            def __init__(self):
                super().__init__(read_command_line_args=False)
                self.params.add("x", 1.0)
                self.rep_max = 4
                self.update_progress_function_style = None

            def _run_simulation(self, p):
                seen.append(self.serial_attempt)
                res = SimulationResults()
                res.add_result(Result.create("v", Result.SUMTYPE, 1.0))
                return res

        r = _AttemptRunner()
        r.set_results_filename(str(tmp_path / "res"))
        r.partial_results_folder = str(tmp_path / "partial")
        r.simulate()
        assert seen == [1, 2, 3, 4]

        r2 = _AttemptRunner()
        r2.rep_max = 7
        r2.set_results_filename(str(tmp_path / "res"))
        r2.partial_results_folder = str(tmp_path / "partial")
        r2.simulate()
        assert seen == [1, 2, 3, 4, 5, 6, 7]

    def test_serial_attempt_cursor_resume_with_skips(self, tmp_path):
        """Skips advance the persisted cursor too: a resumed run never
        replays an accepted attempt's index even when skips preceded
        the checkpoint (the skip count is merged into the results
        immediately, so it persists — round-5 review finding)."""
        from pyphysim_tpu.simulations import (Result, SimulationResults,
                                              SimulationRunner)
        from pyphysim_tpu.simulations.runner import SkipThisOne
        seen = []

        class _SkipRunner(SimulationRunner):
            def __init__(self):
                super().__init__(read_command_line_args=False)
                self.params.add("x", 1.0)
                self.rep_max = 2
                self.update_progress_function_style = None

            def _run_simulation(self, p):
                seen.append(self.serial_attempt)
                if self.serial_attempt == 1:
                    raise SkipThisOne("degenerate draw")
                res = SimulationResults()
                res.add_result(Result.create(
                    "v", Result.SUMTYPE, float(self.serial_attempt)))
                return res

        r = _SkipRunner()
        r.set_results_filename(str(tmp_path / "res"))
        r.partial_results_folder = str(tmp_path / "partial")
        r.simulate()
        assert seen == [1, 2, 3]  # attempt 1 skipped, 2-3 accepted
        assert int(r.results.get_result_values_list(
            "num_skipped_reps")[0]) == 1

        r2 = _SkipRunner()
        r2.rep_max = 4
        r2.set_results_filename(str(tmp_path / "res"))
        r2.partial_results_folder = str(tmp_path / "partial")
        r2.simulate()
        # the resumed cursor continues PAST the skip: no attempt index
        # is replayed, so no realization is double-counted
        assert seen == [1, 2, 3, 4, 5]
        assert float(r2.results.get_result_values_list("v")[0]) == \
            2.0 + 3.0 + 4.0 + 5.0

    def test_choicetype_through_packed_batch_path(self):
        """A CHOICETYPE histogram result through the vmapped batch
        path: the int32 choice indices ride the packed single-transfer
        chunk (bitcast round trip) and accumulate into the histogram
        exactly."""
        from pyphysim_tpu.simulations import (Result, SimulationRunner)

        class _ChoiceRunner(SimulationRunner):
            def __init__(self):
                super().__init__(read_command_line_args=False)
                self.params.add("x", 1.0)
                self.rep_max = 64
                self.batch_size = 16
                self.update_progress_function_style = None
                self.batch_result_types = {
                    "pick": (Result.CHOICETYPE, 4),
                    "val": Result.SUMTYPE}

            def _gen_simulation_kernel(self, p):
                def kernel(key):
                    pick = jax.random.randint(key, (), 0, 4)
                    return {"pick": pick,
                            "val": pick.astype(jnp.float32)}
                return kernel

        r = _ChoiceRunner()
        r.simulate()
        hist = np.asarray(r.results["pick"][0].get_result())
        assert hist.shape == (4,)
        assert np.isclose(hist.sum(), 1.0)   # normalized histogram
        assert np.all(hist > 0)              # every bin hit at 64 reps
        # the SUM of the picks must equal the histogram's implied sum
        val = float(r.results.get_result_values_list("val")[0])
        assert val == float(
            np.dot(hist * 64, np.arange(4)).round())

    def test_checkpoint_mismatch_rejected(self, tmp_path):
        runner = _DummyBatchRunner()
        runner.set_results_filename(str(tmp_path / "res"))
        runner.partial_results_folder = str(tmp_path / "partial")
        runner.simulate()

        runner2 = _DummyBatchRunner()
        runner2.params.add("bias", 99.0)  # different scenario
        runner2.set_results_filename(str(tmp_path / "res"))
        runner2.partial_results_folder = str(tmp_path / "partial")
        with pytest.raises(ValueError):
            runner2.simulate()

    def test_final_results_file(self, tmp_path):
        runner = _DummyRunner()
        runner.set_results_filename(str(tmp_path / "final"))
        runner.partial_results_folder = str(tmp_path / "partial")
        runner.delete_partial_results_bool = True
        runner.simulate()
        loaded = SimulationResults.load_from_file(
            str(tmp_path / "final.pickle"))
        assert np.allclose(loaded.get_result_values_list("lala"),
                           [1.3, 7.3, 13.3])
        # partial files were deleted
        assert os.listdir(runner.partial_results_folder) == []


class TestEndToEndQpskAwgn:
    """SURVEY §7 step 4: the minimum end-to-end slice — QPSK over AWGN BER
    matching theory within MC confidence bounds."""

    class QpskAwgnRunner(SimulationRunner):
        def __init__(self, snrs, num_symbols=1000, rep_max=50):
            super().__init__(read_command_line_args=False)
            from pyphysim_tpu.modulators import QPSK
            self.params.add("SNR", np.asarray(snrs, dtype=float))
            self.params.set_unpack_parameter("SNR")
            self.rep_max = rep_max
            self.num_symbols = num_symbols
            self.modulator = QPSK()
            self.update_progress_function_style = None
            self.batch_result_types = {
                "symbol_errors": Result.SUMTYPE,
                "ser": Result.RATIOTYPE,
                "bit_errors": Result.SUMTYPE,
                "ber": Result.RATIOTYPE,
            }

        def _gen_simulation_kernel(self, current_parameters):
            from pyphysim_tpu.utils.conversion import dB2Linear
            from pyphysim_tpu.utils.misc import count_bit_errors, randn_c
            snr = dB2Linear(float(current_parameters["SNR"]))
            noise_scale = float(np.sqrt(1.0 / snr))
            mod = self.modulator
            n = self.num_symbols
            K = mod.K

            def kernel(key):
                k1, k2 = jax.random.split(key)
                data = jax.random.randint(k1, (n,), 0, mod.M)
                tx = mod.modulate(data)
                rx = tx + randn_c(k2, n) * noise_scale
                decided = mod.demodulate(rx)
                symbol_errors = jnp.sum(decided != data)
                bit_errors = count_bit_errors(data, decided)
                return {
                    "symbol_errors": symbol_errors,
                    "ser": (symbol_errors, jnp.asarray(n)),
                    "bit_errors": bit_errors,
                    "ber": (bit_errors, jnp.asarray(n * K)),
                }

            return kernel

    def test_ber_matches_theory(self):
        snrs = [0.0, 4.0, 8.0]
        runner = self.QpskAwgnRunner(snrs, num_symbols=2000, rep_max=50)
        runner.simulate()
        ser = np.array(runner.results.get_result_values_list("ser"))
        # exact QPSK SER: 1 - (1 - Q(sqrt(snr)))^2 (the calcTheoreticalSER
        # union-bound approximation overestimates at low SNR)
        from pyphysim_tpu.utils.misc import qfunc
        p = qfunc(np.sqrt(10 ** (np.array(snrs) / 10)))
        exact = 1 - (1 - p) ** 2
        approx = runner.modulator.calcTheoreticalSER(np.array(snrs))
        assert np.allclose(approx, exact, rtol=0.15)  # formulas agree-ish
        total = 2000 * 50
        for s, t in zip(ser, exact):
            std = np.sqrt(t * (1 - t) / total)
            assert abs(s - t) < 4 * std + 1e-6, (s, t)

    def test_early_stop(self):
        class EarlyStopRunner(self.QpskAwgnRunner):
            max_symbol_errors = 500

            def _keep_going(self, params, results, rep):
                if "symbol_errors" in results and results["symbol_errors"]:
                    return results["symbol_errors"][-1].get_result() < \
                        self.max_symbol_errors
                return True

        runner = EarlyStopRunner([0.0], num_symbols=2000, rep_max=50)
        runner.batch_size = 1  # fine-grained early stop
        runner.simulate()
        # at 0 dB the SER is ~0.3: should stop well before 50 reps
        assert runner.runned_reps[0] < 50


# ---------------------------------------------------------------------------
# Masked skip (SkipThisOne semantics on the device batch path)
# ---------------------------------------------------------------------------


_SKIP_PROB = 0.1


def _skip_kernel_outputs(key):
    """Shared kernel used by both the serial (SkipThisOne) and the batch
    (``__valid__`` mask) runners: ~10% degenerate draws; the value is a
    deterministic function of the key so accepted sets can be compared
    attempt-for-attempt."""
    u = jax.random.uniform(key)
    valid = u > _SKIP_PROB
    value = jnp.floor(u * 1000.0)
    return value, valid


class _SkipBatchRunner(SimulationRunner):
    """Batch path with a validity mask (reference SkipThisOne semantics,
    runner.py:151-185 + rep-loop handling at runner.py:1491-1517)."""

    def __init__(self, rep_max=30, batch_size=None):
        super().__init__(read_command_line_args=False)
        self.params.add("SNR", np.array([0.0, 5.0]))
        self.params.set_unpack_parameter("SNR")
        self.rep_max = rep_max
        self.batch_size = batch_size
        self.update_progress_function_style = None
        self.batch_result_types = {"val": Result.RATIOTYPE}

    def _gen_simulation_kernel(self, current_parameters):
        def kernel(key):
            value, valid = _skip_kernel_outputs(key)
            return {"val": (value, jnp.asarray(1.0)), "__valid__": valid}

        return kernel


class _SkipSerialRunner(SimulationRunner):
    """Serial compat path raising SkipThisOne on the SAME key schedule the
    batch loop uses (fold_in(var_key, attempt_index))."""

    def __init__(self, rep_max=30):
        super().__init__(read_command_line_args=False)
        self.params.add("SNR", np.array([0.0, 5.0]))
        self.params.set_unpack_parameter("SNR")
        self.rep_max = rep_max
        self.update_progress_function_style = None
        self._attempt = 0
        self._var_key = None

    def _on_simulate_current_params_start(self, current_params):
        self._attempt = 0
        self._var_key = jax.random.fold_in(
            jax.random.PRNGKey(self.base_seed),
            max(current_params.unpack_index, 0))

    def _run_simulation(self, current_parameters):
        key = jax.random.fold_in(self._var_key, self._attempt)
        self._attempt += 1
        value, valid = _skip_kernel_outputs(key)
        if not bool(valid):
            raise SkipThisOne("degenerate draw")
        res = SimulationResults()
        res.add_result(Result.create("val", Result.RATIOTYPE,
                                     float(value), 1.0))
        return res


class TestBatchSkipSemantics:
    def test_batch_matches_serial_skip_and_retry(self):
        serial = _SkipSerialRunner(rep_max=30)
        serial.simulate()
        batch = _SkipBatchRunner(rep_max=30, batch_size=7)
        batch.simulate()

        # both filled rep_max ACCEPTED reps per variation
        assert serial.runned_reps == [30, 30]
        assert batch.runned_reps == [30, 30]
        # accepted values are the same set (first 30 valid attempts)
        for i in range(2):
            s, b = serial.results["val"][i], batch.results["val"][i]
            assert s._value == pytest.approx(b._value)
            assert s._total == pytest.approx(b._total)
            assert s.num_updates == b.num_updates == 30
        # and the same attempts were skipped
        s_skips = serial.results.get_result_values_list("num_skipped_reps")
        b_skips = batch.results.get_result_values_list("num_skipped_reps")
        assert s_skips == b_skips
        assert sum(b_skips) > 0  # the 10% skip rate actually fired

    def test_skip_is_chunk_size_invariant(self):
        a = _SkipBatchRunner(rep_max=30, batch_size=30)
        b = _SkipBatchRunner(rep_max=30, batch_size=4)
        a.simulate()
        b.simulate()
        for i in range(2):
            assert a.results["val"][i]._value == \
                pytest.approx(b.results["val"][i]._value)
        assert a.results.get_result_values_list("num_skipped_reps") == \
            b.results.get_result_values_list("num_skipped_reps")

    def test_resume_preserves_attempt_cursor(self, tmp_path):
        # interrupted at rep_max=12 then resumed to 30 must equal an
        # uninterrupted rep_max=30 run: the attempt cursor (accepted +
        # skipped) is reconstructed from the checkpointed skip count
        part = _SkipBatchRunner(rep_max=12, batch_size=5)
        part.set_results_filename(str(tmp_path / "res"))
        part.partial_results_folder = str(tmp_path / "partial")
        part.simulate()

        resumed = _SkipBatchRunner(rep_max=30, batch_size=5)
        resumed.set_results_filename(str(tmp_path / "res"))
        resumed.partial_results_folder = str(tmp_path / "partial")
        resumed.simulate()

        full = _SkipBatchRunner(rep_max=30, batch_size=5)
        full.simulate()
        for i in range(2):
            assert resumed.results["val"][i]._value == \
                pytest.approx(full.results["val"][i]._value)
        assert resumed.results.get_result_values_list("num_skipped_reps") \
            == full.results.get_result_values_list("num_skipped_reps")


class TestUpdateBatchZeroTotalGuard:
    def test_zero_total_rows_do_not_poison_stats(self):
        r = Result("ber", Result.RATIOTYPE)
        r.update_batch(np.array([1.0, 0.0, 3.0]),
                       np.array([10.0, 0.0, 10.0]))
        # the 0/0 row contributes to neither the mean nor num_updates
        assert r.num_updates == 2
        assert r.get_result_mean() == pytest.approx(0.2)
        assert np.isfinite(r.get_result_var())
        # aggregate numerator/denominator still include the masked row
        assert r._value == pytest.approx(4.0)
        assert r._total == pytest.approx(20.0)

    def test_all_zero_totals(self):
        r = Result("ber", Result.RATIOTYPE)
        r.update_batch(np.zeros(4), np.zeros(4))
        assert r.num_updates == 0
        assert r._result_sum == 0.0


class TestCheckpointThrottle:
    def test_fires_on_crossing_multiples_of_500(self, tmp_path):
        runner = _DummyBatchRunner()
        runner.set_results_filename(str(tmp_path / "res"))
        runner.partial_results_folder = str(tmp_path / "partial")
        saves = []
        orig = runner._save_partial_results

        def spy(current_rep, *a, **k):
            saves.append(current_rep)
            return orig(current_rep, *a, **k)

        runner._save_partial_results = spy
        runner.rep_max = 1203
        runner.batch_size = 7  # never lands exactly on a multiple of 500
        runner.simulate()
        # throttled saves fired when crossing 500 and 1000 (plus the final
        # unconditional save per variation)
        mid_saves = [s for s in saves if s not in (1203,)]
        crossings = {s // 500 for s in mid_saves}
        assert {1, 2} <= crossings, saves


class TestDeviceEarlyStop:
    """VERDICT item 6: masked accumulation inside the dispatched chunk —
    sub-chunk granular stop, and the gated sub-chunks execute NO kernel
    work (lax.cond, observed via jax.debug.callback)."""

    class StopRunner(SimulationRunner):
        def __init__(self, executed_log):
            super().__init__(read_command_line_args=False)
            self.params.add("SNR", np.array([0.0]))
            self.params.set_unpack_parameter("SNR")
            self.rep_max = 64
            self.batch_size = 64
            self.num_stop_subchunks = 8
            self.update_progress_function_style = None
            self.batch_result_types = {"errors": Result.SUMTYPE,
                                       "payload": Result.SUMTYPE}
            self.batch_stop_criterion = ("errors", 100.0)
            self._executed_log = executed_log

        def _gen_simulation_kernel(self, current_parameters):
            log = self._executed_log

            def kernel(key):
                jax.debug.callback(lambda u: log.append(1),
                                   jax.random.uniform(key))
                # deterministic 10 errors/rep; payload derived from key
                return {"errors": jnp.asarray(10, jnp.int32),
                        "payload": jnp.floor(
                            jax.random.uniform(key) * 100.0)}

            return kernel

    def test_subchunk_granular_stop_and_gated_work(self):
        log = []
        runner = self.StopRunner(log)
        runner.simulate()
        jax.effects_barrier()
        # 8 reps/sub-chunk x 10 errors: acc hits 160 >= 100 after the 2nd
        # sub-chunk -> exactly 16 reps counted
        assert runner.runned_reps == [16]
        assert runner.results["errors"][0].get_result() == 160
        # only 2 of the 8 sub-chunks actually ran the kernel
        assert len(log) == 16

    def test_values_match_ungated_prefix(self):
        log = []
        gated = self.StopRunner(log)
        gated.simulate()

        free = self.StopRunner([])
        free.batch_stop_criterion = None
        free.rep_max = 16
        free.batch_size = 16
        free.simulate()
        assert gated.results["payload"][0].get_result() == \
            pytest.approx(free.results["payload"][0].get_result())


class TestConcurrentMultiRunner:
    """simulationhelpers multi-runner mode: runners execute CONCURRENTLY
    sharing one progress server (reference simulationhelpers.py:164-224)."""

    def test_runners_run_concurrently_with_shared_progress(self):
        import threading

        from pyphysim_tpu.simulations.simulationhelpers import \
            simulate_do_what_i_mean

        # both runners must be inside a repetition at the same time or the
        # barrier times out and breaks
        barrier = threading.Barrier(2, timeout=30)

        class Meet(_DummyRunner):
            def _run_simulation(self, current_parameters):
                barrier.wait()
                return super()._run_simulation(current_parameters)

        r1, r2 = Meet(), Meet()
        simulate_do_what_i_mean([r1, r2])
        assert not barrier.broken
        for r in (r1, r2):
            assert r.runned_reps == [10, 10, 10]
            assert np.allclose(r.results.get_result_values_list("lala"),
                               [1.3, 7.3, 13.3])
            assert r.external_progress_proxy is None  # restored

    def test_worker_failure_propagates(self):
        from pyphysim_tpu.simulations.simulationhelpers import \
            simulate_do_what_i_mean

        class Boom(_DummyRunner):
            def _run_simulation(self, current_parameters):
                raise RuntimeError("kaboom")

        with pytest.raises(RuntimeError, match="kaboom"):
            simulate_do_what_i_mean([_DummyRunner(), Boom()])


class TestSkipStopMeshCombination:
    """The three batch-path mechanisms compose: validity mask + on-device
    early stop + mesh sharding in one runner."""

    class ComboRunner(SimulationRunner):
        def __init__(self, stop_limit=None, use_mesh=False):
            super().__init__(read_command_line_args=False)
            self.params.add("SNR", np.array([0.0]))
            self.params.set_unpack_parameter("SNR")
            self.rep_max = 64
            self.batch_size = 32
            self.num_stop_subchunks = 4
            self.update_progress_function_style = None
            self.batch_result_types = {"errors": Result.SUMTYPE,
                                       "payload": Result.RATIOTYPE}
            if stop_limit is not None:
                self.batch_stop_criterion = ("errors", stop_limit)
            if use_mesh:
                from pyphysim_tpu.parallel.mesh import make_mesh
                self.mesh = make_mesh()

        def _gen_simulation_kernel(self, p):
            def kernel(key):
                u = jax.random.uniform(key)
                valid = u > 0.15
                return {"errors": jnp.asarray(10, jnp.int32),
                        "payload": (jnp.floor(u * 100.0),
                                    jnp.asarray(1.0)),
                        "__valid__": valid}

            return kernel

    def test_skip_plus_device_stop(self):
        r = self.ComboRunner(stop_limit=200.0)
        r.simulate()
        # 10 errors per VALID rep; stop once accumulated errors cross
        # 200 -> 20-ish accepted reps at sub-chunk granularity
        assert 20 <= r.runned_reps[0] < 64
        assert r.results["errors"][0].get_result() == \
            10 * r.runned_reps[0]
        assert sum(r.results.get_result_values_list(
            "num_skipped_reps")) > 0

    def test_mesh_matches_unsharded(self):
        a = self.ComboRunner(stop_limit=200.0, use_mesh=False)
        b = self.ComboRunner(stop_limit=200.0, use_mesh=True)
        a.simulate()
        b.simulate()
        assert a.runned_reps == b.runned_reps
        assert a.results["payload"][0]._value == \
            pytest.approx(b.results["payload"][0]._value)
        assert a.results.get_result_values_list("num_skipped_reps") == \
            b.results.get_result_values_list("num_skipped_reps")


class _DummyBulkRunner(SimulationRunner):
    """Bulk-kernel-path runner (``_gen_bulk_kernel``): the kernel owns
    its rep axis and is handed an absolute attempt cursor. The
    ``attempt_sum`` SUMTYPE result records WHICH attempts were accepted,
    so the tests can assert the accepted set is exactly "the first
    rep_max valid attempts" under any chunking."""

    def __init__(self, skip_every=None, batch_size=None):
        super().__init__(read_command_line_args=False)
        self.params.add("SNR", np.array([0.0, 5.0, 10.0]))
        self.params.add("bias", 1.3)
        self.params.set_unpack_parameter("SNR")
        self.rep_max = 10
        self.update_progress_function_style = None
        self.batch_size = batch_size
        self.batch_result_types = {"lala": Result.RATIOTYPE,
                                   "attempt_sum": Result.SUMTYPE}
        self._skip_every = skip_every
        self.bulk_calls = []

    def _gen_bulk_kernel(self, current_parameters):
        snr = float(current_parameters["SNR"])
        bias = float(current_parameters["bias"])
        skip_every = self._skip_every
        calls = self.bulk_calls

        def bulk(start, n):
            calls.append((start, n))
            j = np.arange(start, start + n)
            out = {
                "lala": (np.full(n, 1.2 * snr + bias), np.ones(n)),
                "attempt_sum": j.astype(float),
            }
            if skip_every:
                out["__valid__"] = (j % skip_every) != 0
            return out

        return bulk


class TestBulkKernelPath:
    def test_matches_serial_values(self):
        a, b = _DummyRunner(), _DummyBulkRunner()
        a.simulate()
        b.simulate()
        assert b.runned_reps == [10, 10, 10]
        assert np.allclose(a.results.get_result_values_list("lala"),
                           b.results.get_result_values_list("lala"))
        # accepted attempts are exactly 0..9
        assert b.results.get_result_values_list("attempt_sum") == \
            [45.0, 45.0, 45.0]

    def test_skip_and_retry_accounting(self):
        r = _DummyBulkRunner(skip_every=3)
        r.simulate()
        assert r.runned_reps == [10, 10, 10]
        # first 10 attempts with j % 3 != 0: j = 1,2,4,5,7,8,10,11,13,14
        assert r.results.get_result_values_list("attempt_sum") == \
            [75.0, 75.0, 75.0]
        # consumed 15 attempts for 10 accepted -> 5 skipped
        assert r.results.get_result_values_list("num_skipped_reps") == \
            [5, 5, 5]

    def test_chunk_size_invariant(self):
        a = _DummyBulkRunner(skip_every=3, batch_size=4)
        b = _DummyBulkRunner(skip_every=3, batch_size=32)
        a.simulate()
        b.simulate()
        assert a.results.get_result_values_list("attempt_sum") == \
            b.results.get_result_values_list("attempt_sum")
        assert a.results.get_result_values_list("num_skipped_reps") == \
            b.results.get_result_values_list("num_skipped_reps")
        # the small batch really did chunk (multiple calls per variation)
        assert len(a.bulk_calls) > len(b.bulk_calls)
        # every chunk asks for the full batch size (bulk kernels
        # recompile per distinct n, so no smaller tail chunks)
        assert all(n == 4 for _, n in a.bulk_calls)

    def test_resume_preserves_attempt_cursor(self, tmp_path):
        r = _DummyBulkRunner(skip_every=3)
        r.set_results_filename(str(tmp_path / "res"))
        r.partial_results_folder = str(tmp_path / "partial")
        r.simulate()
        assert r.results.get_result_values_list("attempt_sum") == \
            [75.0, 75.0, 75.0]
        # resume with a higher rep_max: continues from attempt 15, the
        # accepted set stays "the first 20 valid attempts"
        r2 = _DummyBulkRunner(skip_every=3)
        r2.set_results_filename(str(tmp_path / "res"))
        r2.partial_results_folder = str(tmp_path / "partial")
        r2.rep_max = 20
        r2.simulate()
        assert r2.runned_reps == [20, 20, 20]
        valid = [j for j in range(100) if j % 3 != 0][:20]
        assert r2.results.get_result_values_list("attempt_sum") == \
            [float(sum(valid))] * 3
        # starts were absolute (second run resumed at cursor 15)
        assert r2.bulk_calls[0][0] == 15

    def test_takes_precedence_over_batch_kernel(self):
        class Both(_DummyBulkRunner):
            def _gen_simulation_kernel(self, current_parameters):
                raise AssertionError(
                    "bulk kernel must take precedence")

        r = Both()
        r.simulate()
        assert r.runned_reps == [10, 10, 10]


class _DummyBulkStopRunner(SimulationRunner):
    """Bulk runner with a deterministic 1-error-per-attempt metric, for
    pinning the adaptive chunk-ladder early stop."""

    def __init__(self, limit=100.0, batch_size=64):
        super().__init__(read_command_line_args=False)
        self.params.add("SNR", np.array([0.0]))
        self.params.set_unpack_parameter("SNR")
        self.rep_max = 1000
        self.update_progress_function_style = None
        self.batch_size = batch_size
        self.batch_result_types = {"errors": Result.SUMTYPE}
        self.batch_stop_criterion = ("errors", limit)
        self.bulk_calls = []

    def _gen_bulk_kernel(self, current_parameters):
        calls = self.bulk_calls

        def bulk(start, n):
            calls.append((start, n))
            return {"errors": np.ones(n)}

        return bulk


class TestBulkAdaptiveEarlyStop:
    """VERDICT round-2 item 4: the bulk path's early stop must land
    within ~batch/8 of the threshold, not overshoot by a whole chunk.
    The runner shrinks successive chunks down a fixed 4-rung ladder as
    the accumulated metric approaches the limit."""

    def test_executed_work_lands_within_min_rung(self):
        r = _DummyBulkStopRunner(limit=100.0, batch_size=64)
        r.simulate()
        # 64 (no estimate yet) -> expected 36 -> rung 32 -> expected 4
        # -> rung 8 crosses the limit: 104 executed, 4 past the
        # threshold (< 64/8 = 8)
        assert r.bulk_calls == [(0, 64), (64, 32), (96, 8)]
        assert r.runned_reps == [104]
        assert r.results["errors"][0].get_result() == 104

    def test_kernel_sees_only_ladder_sizes(self):
        r = _DummyBulkStopRunner(limit=777.0, batch_size=64)
        r.simulate()
        sizes = {n for _, n in r.bulk_calls}
        assert sizes <= {64, 32, 16, 8}
        # overshoot past the crossing is bounded by the smallest rung
        assert 777 <= r.runned_reps[0] < 777 + 8

    def test_matches_unlimited_prefix(self):
        """The accepted attempts are a PREFIX of the no-criterion run:
        adaptive chunking must not change which attempts are counted."""
        a = _DummyBulkStopRunner(limit=100.0, batch_size=64)
        a.simulate()
        b = _DummyBulkStopRunner(limit=1e9, batch_size=64)
        b.rep_max = a.runned_reps[0]
        b.simulate()
        assert a.results["errors"][0].get_result() == \
            b.results["errors"][0].get_result()


class TestAsyncParallelDispatch:
    """simulate_in_parallel(block=False) + wait_parallel_simulation —
    the reference's async dispatch/await split (runner.py:1774-1886):
    the call returns while the sweep runs; the wait gathers results."""

    def test_returns_immediately_and_wait_gathers(self):
        import threading

        gate = threading.Event()

        class Gated(_DummyBulkRunner):
            def _on_simulate_start(self):
                gate.wait(timeout=30)

        r = Gated()
        r.simulate_in_parallel(block=False)
        # the sweep has NOT run yet — the dispatch returned immediately
        assert r.runned_reps == []
        gate.set()
        r.wait_parallel_simulation()
        assert r.runned_reps == [10, 10, 10]
        assert r.results.get_result_values_list("attempt_sum") == \
            [45.0, 45.0, 45.0]
        assert r.mesh is None  # released after the sweep

    def test_wait_reraises_sweep_errors(self):
        class Boom(_DummyBulkRunner):
            def _on_simulate_start(self):
                raise RuntimeError("engine failure")

        r = Boom()
        r.simulate_in_parallel(block=False)
        with pytest.raises(RuntimeError, match="engine failure"):
            r.wait_parallel_simulation()
        # a second wait is a no-op, not a re-raise
        r.wait_parallel_simulation()

    def test_wait_without_async_sweep_is_noop(self):
        r = _DummyBulkRunner()
        r.simulate()
        r.wait_parallel_simulation()
        assert r.runned_reps == [10, 10, 10]

    def test_second_async_dispatch_without_wait_rejected(self):
        import threading

        gate = threading.Event()

        class Gated(_DummyBulkRunner):
            def _on_simulate_start(self):
                gate.wait(timeout=30)

        r = Gated()
        r.simulate_in_parallel(block=False)
        try:
            with pytest.raises(RuntimeError, match="already running"):
                r.simulate_in_parallel(block=False)
        finally:
            gate.set()
            r.wait_parallel_simulation()
        assert r.runned_reps == [10, 10, 10]


class TestDoubleBufferedDispatch:
    """VERDICT round-2 item 5: chunk k+1 is enqueued before chunk k's
    outputs are consumed. Results must be invariant; a mispredicted
    speculative chunk (skips shifted the cursor) is discarded."""

    def test_bulk_results_unchanged_with_skips(self):
        a = _DummyBulkRunner(skip_every=3, batch_size=4)
        a.simulate()
        assert a.results.get_result_values_list("attempt_sum") == \
            [75.0, 75.0, 75.0]
        assert all(n == 4 for _, n in a.bulk_calls)

    def test_speculative_chunk_is_dispatched_ahead(self):
        """The bulk kernel sees the k+1 dispatch BEFORE the runner's
        per-chunk checkpoint hook for chunk k runs."""
        order = []

        class Spy(_DummyBulkRunner):
            def _save_partial_results_maybe(self, rep, p, res):
                order.append(("consumed", rep))
                return super()._save_partial_results_maybe(rep, p, res)

        r = Spy(batch_size=4)
        orig_gen = r._gen_bulk_kernel

        def wrapped_gen(p):
            inner = orig_gen(p)

            def bulk(start, n):
                order.append(("dispatch", start))
                return inner(start, n)

            return bulk

        r._gen_bulk_kernel = wrapped_gen
        r.simulate()
        # for the first variation: dispatch 0, dispatch 4 (speculative),
        # THEN consume chunk 0
        assert order[:3] == [("dispatch", 0), ("dispatch", 4),
                             ("consumed", 4)]
