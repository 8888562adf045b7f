"""Tests for mesh-sharded Monte Carlo execution — the device-native
replacement of the reference's ipyparallel path, validated on the virtual
8-device CPU mesh (SURVEY §4: 'run the pjit program on a mocked/CPU
mesh')."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pyphysim_tpu.parallel import make_mesh, shard_batch
from pyphysim_tpu.simulations import Result, SimulationRunner


class _BatchQpskRunner(SimulationRunner):
    """Tiny QPSK/AWGN runner for parallel-vs-serial equivalence."""

    def __init__(self):
        super().__init__(read_command_line_args=False)
        self.params.add("SNR", np.array([0.0, 10.0]))
        self.params.set_unpack_parameter("SNR")
        self.rep_max = 64
        self.update_progress_function_style = None
        self.batch_result_types = {"ber": Result.RATIOTYPE}

    def _gen_simulation_kernel(self, cp):
        from pyphysim_tpu.modulators import QPSK
        from pyphysim_tpu.utils.conversion import dB2Linear
        from pyphysim_tpu.utils.misc import count_bit_errors, randn_c
        snr = dB2Linear(float(cp["SNR"]))
        mod = QPSK()
        n = 256

        def kernel(key):
            k1, k2 = jax.random.split(key)
            data = jax.random.randint(k1, (n,), 0, 4)
            rx = mod.modulate(data) + randn_c(k2, n) * jnp.sqrt(1 / snr)
            return {"ber": (count_bit_errors(data, mod.demodulate(rx)),
                            jnp.asarray(2 * n))}

        return kernel


class TestMeshHelpers:
    def test_make_mesh(self):
        mesh = make_mesh()
        assert mesh.devices.size == jax.device_count()
        assert mesh.axis_names == ("mc",)

    def test_shard_batch(self):
        mesh = make_mesh()
        x = jnp.arange(jax.device_count() * 4)
        sharded = shard_batch(mesh, x)
        assert sharded.sharding.num_devices == jax.device_count()

    def test_make_host_chip_mesh(self):
        from pyphysim_tpu.parallel import make_host_chip_mesh
        mesh = make_host_chip_mesh(num_hosts=2)
        assert mesh.axis_names == ("host", "chip")
        assert mesh.shape["host"] == 2
        assert mesh.shape["chip"] == jax.device_count() // 2
        # a psum over 'chip' stays within a host group
        from jax.sharding import NamedSharding, PartitionSpec as P
        x = jnp.ones((2, jax.device_count() // 2, 8))
        x = jax.device_put(x, NamedSharding(mesh, P("host", "chip")))
        with mesh:
            total = jax.jit(lambda v: v.sum(axis=(1, 2)))(x)
        assert np.allclose(np.asarray(total), 4 * jax.device_count())
        import pytest
        with pytest.raises(ValueError):
            make_host_chip_mesh(num_hosts=3)  # 8 devices don't split by 3


class TestParallelRunner:
    def test_parallel_matches_serial(self):
        assert jax.device_count() == 8  # conftest forces 8 CPU devices
        serial = _BatchQpskRunner()
        serial.batch_size = 64
        serial.simulate()

        parallel = _BatchQpskRunner()
        parallel.batch_size = 64
        parallel.simulate_in_parallel()
        assert parallel.mesh is None  # reset after the run

        # identical key schedule -> identical counters
        assert serial.results.get_result_values_list("ber") == \
            parallel.results.get_result_values_list("ber")

    def test_parallel_sharding_actually_used(self):
        runner = _BatchQpskRunner()
        runner.batch_size = 64
        mesh = make_mesh()
        runner.simulate_in_parallel(mesh)
        ber = runner.results.get_result_values_list("ber")
        assert 0.05 < ber[0] < 0.25  # QPSK@0dB
        assert ber[1] < ber[0]


class TestGraftDryrun:
    @pytest.mark.heavy  # the driver executes dryrun_multichip(8)
    # separately every round and records MULTICHIP_r*.json; CI keeps
    # the 2-device variant below for fast engine coverage
    def test_dryrun_multichip_8(self):
        """Run in a fresh subprocess, exactly like the driver does:
        under full-profile memory pressure the in-process run once hit
        the known XLA:CPU native-crash class and took the xdist worker
        down with it — isolation turns that into a plain failure with
        the subprocess output attached."""
        import os
        import subprocess
        import sys as _sys
        repo = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "..")
        env = {**os.environ,
               "XLA_FLAGS": "--xla_force_host_platform_device_count=8",
               "JAX_PLATFORMS": "cpu"}
        r = subprocess.run(
            [_sys.executable, "-c",
             "import __graft_entry__ as g; g.dryrun_multichip(8)"],
            cwd=repo, env=env, capture_output=True, text=True,
            timeout=1500)
        assert r.returncode == 0, f"\n{r.stdout}\n{r.stderr}"
        assert "2-process (Gloo) runner sweep" in r.stdout, r.stdout

    def test_dryrun_multichip_2(self, monkeypatch):
        import __graft_entry__ as g
        # the 2-process (Gloo) stage spawns two fresh interpreters
        # (~15 s); it is covered by tests/test_multihost.py AND executed
        # by the driver's own dryrun_multichip(8) run every round — CI
        # keeps the in-process stages here
        monkeypatch.setattr(g, "_dryrun_two_process_runner",
                            lambda n: None)
        g.dryrun_multichip(2)

    def test_entry_compiles(self):
        import __graft_entry__ as g
        fn, args = g.entry()
        out = jax.jit(fn)(*args)
        assert int(out) >= 0


class TestTimeShardedChannel:
    """SURVEY §5 long-context equivalent: time-block sharding with
    ppermute halo exchange must reproduce the unsharded convolution."""

    def _make_channel(self):
        from pyphysim_tpu.channels import (COST259_TUx, JakesSampleGenerator,
                                           TdlChannel)
        jakes = JakesSampleGenerator(Fd=50.0, Ts=1.0 / 20e6, L=12)
        return TdlChannel(jakes, COST259_TUx)

    def test_matches_unsharded(self):
        from pyphysim_tpu.parallel import corrupt_data_time_sharded
        from pyphysim_tpu.utils.misc import randn_c

        channel = self._make_channel()
        mesh = make_mesh(axis_name="time")
        block = 128
        N = 8 * 4 * block  # 4 blocks per device
        signal = randn_c(jax.random.PRNGKey(0), N)
        state = channel.init_state(jax.random.PRNGKey(1))

        ref_out, ref_ir, _ = channel.corrupt_data(state, signal,
                                                  block_size=block)
        out, ir, _ = corrupt_data_time_sharded(channel, state, signal,
                                               block, mesh)
        np.testing.assert_allclose(np.asarray(out.re),
                                   np.asarray(ref_out.re[..., :N]),
                                   atol=2e-5)
        np.testing.assert_allclose(np.asarray(out.im),
                                   np.asarray(ref_out.im[..., :N]),
                                   atol=2e-5)
        # the halo really crossed devices: energy at shard boundaries
        # must match too (first halo samples of every non-first shard)
        span = channel.num_taps_with_padding
        n_local = N // 8
        for d in range(1, 8):
            seg = slice(d * n_local, d * n_local + span - 1)
            np.testing.assert_allclose(np.asarray(out.re[seg]),
                                       np.asarray(ref_out.re[seg]),
                                       atol=2e-5)

    @pytest.mark.heavy  # detail sibling of test_matches_unsharded
    def test_ir_matches_unsharded_blocks(self):
        from pyphysim_tpu.parallel import corrupt_data_time_sharded
        from pyphysim_tpu.utils.misc import randn_c

        channel = self._make_channel()
        mesh = make_mesh(axis_name="time")
        block = 128
        N = 8 * 2 * block
        signal = randn_c(jax.random.PRNGKey(2), N)
        state = channel.init_state(jax.random.PRNGKey(3))

        _, ref_ir, _ = channel.corrupt_data(state, signal, block_size=block)
        _, ir, _ = corrupt_data_time_sharded(channel, state, signal,
                                             block, mesh)
        # both paths keep one strided IR value per block
        np.testing.assert_allclose(np.asarray(ir.tap_values_sparse.re),
                                   np.asarray(ref_ir.tap_values_sparse.re),
                                   atol=2e-5)
        np.testing.assert_allclose(np.asarray(ir.tap_values_sparse.im),
                                   np.asarray(ref_ir.tap_values_sparse.im),
                                   atol=2e-5)

    def test_length_validation(self):
        from pyphysim_tpu.parallel import corrupt_data_time_sharded
        from pyphysim_tpu.utils.misc import randn_c

        channel = self._make_channel()
        mesh = make_mesh(axis_name="time")
        signal = randn_c(jax.random.PRNGKey(4), 1000)  # not divisible
        state = channel.init_state(jax.random.PRNGKey(5))
        with pytest.raises(ValueError):
            corrupt_data_time_sharded(channel, state, signal, 128, mesh)


class TestWeakScalingShape:
    def test_per_device_work_constant_across_mesh_sizes(self):
        """Weak scaling, structurally: at FIXED per-device batch, the
        compiled SPMD program's per-partition FLOPs stay constant as
        the mesh grows 1 -> 8 devices — the work divides evenly and
        the counter reduction adds no per-device replication blowup
        (the shape behind the 'linear until dispatch-bound' scaling
        claim; measured curve: bin/weak_scaling_curve.py). Wall-clock flatness is NOT asserted — the virtual
        devices share this host's two cores."""
        from jax.sharding import NamedSharding, PartitionSpec as P

        from pyphysim_tpu.modulators import QPSK
        from pyphysim_tpu.utils.misc import count_bit_errors, randn_c

        qpsk = QPSK()
        n_sym = 512

        def step(key, snr_linear):
            k1, k2 = jax.random.split(key)
            data = jax.random.randint(k1, (n_sym,), 0, 4)
            rx = qpsk.modulate(data) + \
                randn_c(k2, n_sym) * jnp.sqrt(1.0 / snr_linear)
            return count_bit_errors(data, qpsk.demodulate(rx))

        def mc_step(keys, snrs):
            return jnp.sum(jax.vmap(step)(keys, snrs))

        per_dev = 4
        flops = {}
        for n in (1, 2, 4, 8):
            mesh = make_mesh(n)
            sharding = NamedSharding(mesh, P("mc"))
            batch = n * per_dev
            keys = jax.device_put(
                jax.random.split(jax.random.PRNGKey(0), batch),
                sharding)
            snrs = jax.device_put(jnp.full((batch,), 10.0), sharding)
            with mesh:
                compiled = jax.jit(
                    mc_step, in_shardings=(sharding, sharding)).lower(
                    keys, snrs).compile()
            cost = compiled.cost_analysis()
            if isinstance(cost, (list, tuple)):
                cost = cost[0]
            flops[n] = float(cost["flops"])
        base = flops[1]
        for n in (2, 4, 8):
            assert 0.95 * base <= flops[n] <= 1.05 * base, flops
