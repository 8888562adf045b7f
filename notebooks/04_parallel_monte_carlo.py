# %% [markdown]
# # Parallel Monte Carlo on a device mesh
#
# The reference parallelizes with ipyparallel task farming; here the
# whole sweep is ONE SPMD program. This tutorial shows the two sharding
# axes the framework provides:
#
# 1. **Realization sharding** — `SimulationRunner.simulate_in_parallel`
#    splits the Monte Carlo batch across a mesh (bit-identical to the
#    serial path).
# 2. **Time sharding** — `corrupt_data_time_sharded` splits one long
#    symbol stream across devices with a `ppermute` halo exchange.
#
# Run on CPU with 8 virtual devices
# (`XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu`)
# or on real GPUs unchanged.

# %%
import jax

if len(jax.devices()) == 1:  # pragma: no cover - convenience for CPU runs
    import os

    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"

import jax.numpy as jnp
import numpy as np

from pyphysim_tpu.modulators import QPSK
from pyphysim_tpu.simulations import Result, SimulationRunner
from pyphysim_tpu.utils.conversion import dB2Linear
from pyphysim_tpu.utils.misc import count_bit_errors, randn_c

print("devices:", jax.devices())


# %% A batch-path runner: declare result types, return a pure kernel
class QpskAwgnRunner(SimulationRunner):
    def __init__(self):
        super().__init__(read_command_line_args=False)
        self.params.add("SNR", np.arange(0.0, 16.0, 5.0))
        self.params.set_unpack_parameter("SNR")
        self.rep_max = 512
        self.update_progress_function_style = None
        self.batch_result_types = {"ber": Result.RATIOTYPE}

    def _gen_simulation_kernel(self, current_params):
        snr = dB2Linear(float(current_params["SNR"]))
        mod = QPSK()
        n = 512

        def kernel(key):
            k1, k2 = jax.random.split(key)
            data = jax.random.randint(k1, (n,), 0, 4)
            rx = mod.modulate(data) + randn_c(k2, n) * jnp.sqrt(1 / snr)
            errors = count_bit_errors(data, mod.demodulate(rx))
            return {"ber": (errors, jnp.asarray(2 * n))}

        return kernel


# %% Serial vs mesh-parallel: the SAME results, bit for bit
runner_serial = QpskAwgnRunner()
runner_serial.simulate()
runner_parallel = QpskAwgnRunner()
runner_parallel.simulate_in_parallel()

for snr, r_s, r_p in zip(runner_serial.params["SNR"],
                         runner_serial.results["ber"],
                         runner_parallel.results["ber"]):
    print(f"SNR {snr:5.1f} dB: serial BER {r_s.get_result():.5f}  "
          f"parallel BER {r_p.get_result():.5f}  "
          f"equal: {r_s.get_result() == r_p.get_result()}")

# %% [markdown]
# ## Time-sharding one long stream
#
# A single long OFDM transmission is split over the mesh: every device
# computes its channel taps locally from the closed-form Jakes state
# (`skip` is O(1)) and exchanges the convolution halo with one
# `ppermute`. The result is bit-identical to the unsharded channel.

# %%
from pyphysim_tpu.channels import (COST259_TUx, JakesSampleGenerator,
                                   TdlChannel)
from pyphysim_tpu.modulators import OFDM, QAM
from pyphysim_tpu.modulators.ofdm import OfdmOneTapEqualizer
from pyphysim_tpu.parallel import corrupt_data_time_sharded, make_mesh

fft, cp, used = 512, 52, 300
qam, ofdm = QAM(16), OFDM(fft, cp, used)
channel = TdlChannel(JakesSampleGenerator(Fd=30.0, Ts=1 / 20e6, L=16),
                     COST259_TUx)
equalizer = OfdmOneTapEqualizer(ofdm)
mesh = make_mesh(axis_name="time")
block = ofdm.samples_per_symbol
n_sym = 2 * len(mesh.devices.ravel())

data = jax.random.randint(jax.random.PRNGKey(0), (used * n_sym,), 0, 16)
tx = ofdm.modulate(qam.modulate(data))
state = channel.init_state(jax.random.PRNGKey(1))
noise = randn_c(jax.random.PRNGKey(2), tx.shape[-1]) * jnp.sqrt(10 ** -1.5)

rx_sharded, ir, _ = corrupt_data_time_sharded(channel, state, tx, block,
                                              mesh)
rx_ref, ir_ref, _ = channel.corrupt_data(state, tx, block_size=block)

for name, rx, ir_ in (("time-sharded", rx_sharded, ir),
                      ("unsharded   ", rx_ref[..., :tx.shape[-1]], ir_ref)):
    eq = equalizer.equalize_data(ofdm.demodulate(rx + noise), ir_)
    errs = int(count_bit_errors(data, qam.demodulate_hard(eq)))
    print(f"{name}: {errs} bit errors / {used * n_sym * 4}")
