"""Smoke tests: every shipped example app runs end-to-end on a shrunk
workload. The reference ships its apps untested; here each one is
exercised so API drift in the library breaks CI, not users."""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def _shrink(runner, snrs, rep_max, **attrs):
    runner.params.add("SNR", np.asarray(snrs, dtype=float))
    runner.params.set_unpack_parameter("SNR")
    runner.rep_max = rep_max
    runner.update_progress_function_style = None
    for k, v in attrs.items():
        setattr(runner, k, v)
    return runner


class TestAwgnApps:
    def test_psk_runner_matches_theory(self):
        from apps.awgn_modulators.simulate_psk import \
            VerySimplePskSimulationRunner
        r = VerySimplePskSimulationRunner()
        _shrink(r, [10.0], rep_max=50)
        r.simulate()
        ber = float(r.results.get_result_values_list("ber")[0])
        t_ber = float(r.modulator.calcTheoreticalBER(10.0))  # SNR in dB
        assert np.isclose(ber, t_ber, rtol=0.3)

    def test_bpsk_runner(self):
        from apps.awgn_modulators.simulate_bpsk import \
            VerySimpleBpskSimulationRunner
        r = VerySimpleBpskSimulationRunner()
        _shrink(r, [4.0, 8.0], rep_max=30)
        r.simulate()
        ber = [float(b) for b in r.results.get_result_values_list("ber")]
        assert ber[1] < ber[0]  # monotone in SNR

    def test_qam_runner(self):
        from apps.awgn_modulators.simulate_qam import \
            VerySimpleQamSimulationRunner
        r = VerySimpleQamSimulationRunner()
        _shrink(r, [12.0], rep_max=30)
        r.simulate()
        assert float(r.results.get_result_values_list("ser")[0]) > 0

    def test_parallel_psk_serial_equals_parallel(self):
        from apps.awgn_modulators.simulate_psk import \
            VerySimplePskSimulationRunner
        a = _shrink(VerySimplePskSimulationRunner(), [5.0, 10.0], 20)
        b = _shrink(VerySimplePskSimulationRunner(), [5.0, 10.0], 20)
        a.simulate()
        b.simulate_in_parallel()
        va = a.results.get_result_values_list("ber")
        vb = b.results.get_result_values_list("ber")
        assert np.allclose(va, vb)


class TestMimoApp:
    @pytest.mark.parametrize("scheme,nr", [("alamouti", 2), ("mrc", 2),
                                           ("blast", 2)])
    def test_runner(self, scheme, nr):
        from apps.mimo.simulate_mimo import MimoSimulationRunner
        r = MimoSimulationRunner(scheme, nr)
        r.params.add("SNR", np.array([5.0, 15.0]))
        r.params.set_unpack_parameter("SNR")
        r.rep_max = 20
        r.NSymbs = 200
        r.update_progress_function_style = None
        r.simulate()
        ber = [float(b) for b in r.results.get_result_values_list("ber")]
        assert ber[1] < ber[0]


class TestOfdmApps:
    def test_ofdm_tdl_runner(self):
        from apps.ofdm.ofdm_tdlchannel import OfdmTdlSimulationRunner
        r = OfdmTdlSimulationRunner()
        r.params.add("SNR", np.array([10.0, 25.0]))
        r.params.set_unpack_parameter("SNR")
        r.rep_max = 8
        r.update_progress_function_style = None
        r.simulate()
        ber = [float(b) for b in r.results.get_result_values_list("ber")]
        assert ber[1] < ber[0]

    def test_ofdm_mc_kernel_runner(self):
        # the bulk-path app: the fused chain self-batched over attempts
        from apps.ofdm.ofdm_mc_kernel import OfdmMcKernelSimulationRunner
        r = OfdmMcKernelSimulationRunner(ofdm_symbols=32)
        r.params.add("SNR", np.array([10.0, 25.0]))
        r.params.set_unpack_parameter("SNR")
        r.rep_max = 4
        r.batch_size = 2
        r.update_progress_function_style = None
        r.simulate()
        ber = [float(b) for b in r.results.get_result_values_list("ber")]
        assert 0.0 < ber[1] < ber[0] < 0.5

    def test_psd_plot(self, tmp_path, monkeypatch):
        import matplotlib
        matplotlib.use("Agg")
        from apps.ofdm.plot_ofdm_PSD import main
        out = str(tmp_path / "psd.png")
        monkeypatch.setattr(sys, "argv", ["plot_ofdm_PSD.py", "--out", out])
        main()
        assert os.path.exists(out)


class TestIaApps:
    def test_simple_ia(self, capsys):
        from apps.ia.simple_ia import main
        main()
        out = capsys.readouterr().out
        assert "SINR" in out or "capacity" in out.lower()

    def test_feasibility(self, capsys):
        from apps.ia.test_ia_feasibility import main
        main()
        assert capsys.readouterr().out.strip()

    def test_sinrs_and_capacity(self, monkeypatch, capsys):
        # --crosscheck runs the host ClosedForm solver on the same
        # realizations and ASSERTS device/host agreement (the apps-level
        # sum-capacity cross-check for the batched IA family)
        from apps.ia.ia_SINRs_and_capacity import main
        monkeypatch.setattr(sys, "argv",
                            ["ia_SINRs_and_capacity.py", "--reps", "4",
                             "--iters", "5", "--crosscheck", "4",
                             "--solvers", "altmin,closedform"])
        main()
        out = capsys.readouterr().out
        assert "Alt Min" in out and "Closed Form" in out
        assert "crosscheck" in out


class TestCompBDApps:
    def test_comp_bd_runner(self):
        from apps.comp_BD.simulate_comp_bd import CompBDSimulationRunner
        r = CompBDSimulationRunner("capacity")
        r.rep_max = 3
        r.NSymbs = 100
        r.update_progress_function_style = None
        r.simulate()
        sers = r.results.get_result_values_list("ser")
        assert len(sers) == 3  # one per Pe_dB point

    def test_comp_simple_matches_reference_code(self):
        # Re-running the reference's own code on this scenario gives
        # SER = 0.0078 at 15 dB (250 reps); our seed spread at 200-400
        # reps is 0.008-0.011. (The reference script's comment claiming
        # ~0.0177 is stale — its current code does not produce it.)
        from apps.comp_BD.simulate_comp_simple import simulate
        ser, ber, total = simulate(rep_max=400)
        assert total == 1_200_000
        assert 0.006 < ser < 0.013, ser
        assert 0 < ber < ser

    def test_comp_ext_int_simple(self, monkeypatch, capsys):
        from apps.comp_BD.simulate_comp_with_ext_int_simple import main
        monkeypatch.setattr(sys, "argv", ["x", "--reps", "5"])
        main()
        assert capsys.readouterr().out.strip()

    def test_comp_ext_int_matches_reference_code(self):
        # Reference CODE re-run at Pe=35 dBm, capacity metric: SER
        # 0.0077, PER 0.235, SE 1.53. No stream reduction: SER ~0.70.
        from apps.comp_BD.simulate_comp_with_ext_int_simple import simulate
        ser, ber, per, se = simulate(reps=60, pe_dbm=35.0,
                                     metric="capacity", verbose=False)
        assert 0.005 < ser < 0.012, ser
        assert 0.15 < per < 0.33, per
        ser0, _, _, se0 = simulate(reps=15, pe_dbm=35.0, metric="None",
                                   verbose=False)
        assert 0.6 < ser0 < 0.8, ser0
        assert se0 < 1e-6  # PER saturates -> zero spectral efficiency


class TestStandaloneApps:
    def test_metis_ps7(self):
        from apps.metis_scenarios.simulate_metis_ps7 import simulate
        sinr, xs, ys = simulate(num_rooms_per_side=2, grid_points=10)
        assert np.all(np.isfinite(sinr))
        assert sinr.shape == (10, 10)

    def test_simple_bd_with_whitening(self, capsys):
        from apps.simple_BD_with_whitening import main
        main()
        assert capsys.readouterr().out.strip()

    def test_simple_precoded_srs(self, capsys):
        from apps.simple_precoded_srs import main
        main()
        assert capsys.readouterr().out.strip()

    def test_configobj_usage_example(self, tmp_path, monkeypatch, capsys):
        from apps.configobj_usage_example import main
        monkeypatch.chdir(tmp_path)
        monkeypatch.setattr(sys, "argv", ["configobj_usage_example.py"])
        main()
        assert os.path.exists(tmp_path / "psk_simulation_config.txt")

    def test_min_distance_codebooks(self, tmp_path, monkeypatch, capsys):
        from apps.codebooks.minimum_distance_all_codebooks import main
        monkeypatch.setattr(sys, "argv",
                            ["x", "--Nt", "2", "--Ns", "1", "--K", "4:9:4",
                             "--dir", str(tmp_path / "cb")])
        main()
        assert capsys.readouterr().out.strip()


class TestBatchedStreamSelection:
    @pytest.mark.heavy  # the light histogram test covers the app path;
    # this full 3-SNR CLI run costs ~4 min of compile
    def test_runs_and_prefers_more_streams_at_high_snr(self, monkeypatch,
                                                       capsys):
        from apps.ia.batched_stream_selection import (
            StreamSelectionRunner, main)
        monkeypatch.setattr(sys, "argv",
                            ["batched_stream_selection.py", "--reps", "16",
                             "--iters", "8"])
        main()
        out = capsys.readouterr().out
        assert "mean best capacity" in out

    def test_histogram_semantics_light(self):
        """One SNR point = one compile of the brute+greedy program; the
        histogram and greedy-bound semantics survive. The two-point
        cap-monotonicity variant is the heavy sibling below."""
        from apps.ia.batched_stream_selection import StreamSelectionRunner
        r = StreamSelectionRunner(iters=3, reps=6)
        r.params.add("SNR", np.array([20.0]))
        r.simulate()
        hist = r.results["stream_choice"][0].get_result()
        assert np.isclose(hist.sum(), 1.0)  # CHOICETYPE fractions
        # with the shared svd candidate policy the greedy search is
        # bounded by the exhaustive one BY CONSTRUCTION and keeps most
        # of its capacity
        for g in r.results.get_result_values_list("greedy_capacity_ratio"):
            assert 0.7 < float(g) < 1.0 + 1e-5

    @pytest.mark.heavy
    def test_histogram_semantics(self):
        from apps.ia.batched_stream_selection import StreamSelectionRunner
        r = StreamSelectionRunner(iters=6, reps=8)
        # two SNR points keep the semantics (histogram fractions, cap
        # monotonicity, greedy/brute bound) at 2/3 the compile cost
        r.params.add("SNR", np.array([0.0, 20.0]))
        r.simulate()
        for i in range(2):
            hist = r.results["stream_choice"][i].get_result()
            assert np.isclose(hist.sum(), 1.0)  # CHOICETYPE fractions
        # capacity grows with SNR
        caps = r.results.get_result_values_list("sum_capacity")
        assert caps[0] < caps[1]
        # with the shared svd candidate policy the greedy search is
        # bounded by the exhaustive one BY CONSTRUCTION and keeps most
        # of its capacity
        for g in r.results.get_result_values_list("greedy_capacity_ratio"):
            assert 0.7 < float(g) < 1.0 + 1e-5
