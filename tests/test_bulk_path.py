"""Tests for the runner's bulk path on the flagship chain
(apps/ofdm/ofdm_mc_kernel.py): ``build_bulk_chain`` self-batches the
fused OFDM-over-TDL XLA chain over an absolute attempt cursor, so each
repetition equals the per-key batch-path step for its attempt, results
are chunk-size invariant, and sharding the chunk over a mesh is
bit-identical to one device.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from apps.ofdm.ofdm_mc_kernel import (OfdmMcKernelSimulationRunner,
                                      build_bulk_chain)

OFDM_SYMBOLS = 4


def _runner(batch_size=4):
    r = OfdmMcKernelSimulationRunner(ofdm_symbols=OFDM_SYMBOLS,
                                     read_command_line_args=False)
    r.params.add("SNR", np.array([5.0, 15.0]))
    r.params.set_unpack_parameter("SNR")
    r.rep_max = 6
    r.batch_size = batch_size
    r.update_progress_function_style = None
    return r


class TestBulkChain:
    def test_matches_batch_path_step(self):
        """Repetition r of a call at ``start`` is the batch-path step
        for attempt start + r, keyed fold_in(PRNGKey(seed), attempt)."""
        import __graft_entry__ as g
        step = g._make_chain_step(num_symbols=OFDM_SYMBOLS * 300,
                                  fft_size=512, cp_size=52, num_used=300,
                                  block_static=True, fused=True)
        snr = np.float32(10.0)
        got = np.asarray(build_bulk_chain(OFDM_SYMBOLS, 4, map_batch=2)(
            jnp.int32(9), snr, jnp.int32(3)))
        base = jax.random.PRNGKey(9)
        want = [int(step(jax.random.fold_in(base, 3 + r), snr))
                for r in range(4)]
        np.testing.assert_array_equal(got, want)

    def test_map_batch_invariant(self):
        a = build_bulk_chain(OFDM_SYMBOLS, 4, map_batch=1)(
            jnp.int32(2), np.float32(10.0))
        b = build_bulk_chain(OFDM_SYMBOLS, 4, map_batch=4)(
            jnp.int32(2), np.float32(10.0))
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    @pytest.mark.parametrize("ndev", [2, 8])
    def test_sharded_bit_identical(self, ndev):
        from pyphysim_tpu.parallel import make_mesh
        one = build_bulk_chain(OFDM_SYMBOLS, 8)(jnp.int32(0),
                                                np.float32(10.0), 5)
        sharded = build_bulk_chain(OFDM_SYMBOLS, 8, mesh=make_mesh(ndev))(
            jnp.int32(0), np.float32(10.0), 5)
        np.testing.assert_array_equal(np.asarray(one), np.asarray(sharded))

    def test_reps_must_divide(self):
        from pyphysim_tpu.parallel import make_mesh
        with pytest.raises(ValueError, match="divisible"):
            build_bulk_chain(OFDM_SYMBOLS, 6, mesh=make_mesh(4))

    @pytest.mark.parametrize("snr_db,lo,hi", [
        (5.0, 0.08, 0.22),
        (15.0, 0.02, 0.06),
        (30.0, 2e-4, 6e-3),
    ])
    def test_ber_corners(self, snr_db, lo, hi):
        """Same empirical BER brackets the bench and chip_smoke.py assert
        (bench.py BER_CORNERS) hold on the bulk path."""
        reps, ofdm_symbols = 64, 8
        counts = np.asarray(build_bulk_chain(ofdm_symbols, reps)(
            jnp.int32(11), np.float32(10 ** (snr_db / 10.0))), np.int64)
        ber = counts.sum() / (reps * ofdm_symbols * 300 * 4)
        assert lo < ber < hi, f"BER {ber} outside ({lo}, {hi}) at {snr_db}"


class TestRunnerIntegration:
    """The bulk-kernel runner path (SimulationRunner._gen_bulk_kernel)
    driving the self-batched chain."""

    def test_runner_drives_kernel(self):
        r = _runner()
        r.simulate()
        assert r.runned_reps == [6, 6]
        ber5, ber15 = r.results.get_result_values_list("ber")
        assert 0.0 < ber15 < ber5 < 0.5

    def test_chunk_size_invariant(self):
        a = _runner(batch_size=2)
        b = _runner(batch_size=6)
        a.simulate()
        b.simulate()
        assert np.allclose(a.results.get_result_values_list("ber"),
                           b.results.get_result_values_list("ber"))
        assert a.results["bit_errors"][0].get_result() == \
            b.results["bit_errors"][0].get_result()

    @pytest.mark.parametrize("ndev", [2, 8])
    def test_mesh_sharded_runner_identical(self, ndev):
        """Bulk-path runner results must be bit-identical on 1 vs N
        virtual devices. simulate_in_parallel shards each chunk's rep
        axis over the mesh; the absolute-index stream contract plus
        chunk-size invariance make the Results equal EXACTLY, not just
        statistically."""
        from pyphysim_tpu.parallel import make_mesh
        a = _runner(batch_size=8)
        a.simulate()
        b = _runner(batch_size=8)
        b.simulate_in_parallel(make_mesh(ndev))
        assert b.runned_reps == a.runned_reps
        for name in ("bit_errors", "ber"):
            av = a.results.get_result_values_list(name)
            bv = b.results.get_result_values_list(name)
            np.testing.assert_array_equal(np.asarray(av), np.asarray(bv))
