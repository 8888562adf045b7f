# %% [markdown]
# # The kernel tier: whole Monte Carlo repetitions in one Pallas kernel
#
# The fastest execution tier in `pyphysim_tpu` runs an ENTIRE Monte
# Carlo repetition inside one Pallas kernel (compiled for the GPU
# through Triton): data bits, channels and noise come from an in-kernel
# counter-based generator (`ops/counter_rng.py`), every intermediate
# stays on chip, and the only device-memory traffic is one reduced
# number per program. The kernels and their measured times on the card
# are listed in `PERF.md` (the flagship OFDM/TDL chain has no kernel:
# XLA's fused chain beat it on the H100):
#
# | family | class |
# |---|---|
# | Alamouti 2x1 QPSK BER | `ops.alamouti_pallas.MonteCarloAlamouti` |
# | Max-SINR IA sum capacity | `ops.ia_pallas.MonteCarloMaxSinr` |
# | BD CoMP sum capacity | `ops.bd_pallas.MonteCarloBD` |
#
# Each kernel has a GEOMETRY MENU (users x antennas x streams) and can
# shard its repetition axis over a device mesh bit-identically. This
# notebook exercises the tier on the CPU: `interpret=True` runs the
# production kernel under the Pallas interpreter, drawing the same bits
# from the same generator as on the GPU.

# %%
import sys

sys.path.insert(0, "..")

import numpy as np

# force the CPU backend: the kernels run under the Pallas interpreter
import jax

try:
    jax.config.update("jax_platforms", "cpu")
except RuntimeError:
    pass

# %% [markdown]
# ## A BD capacity sweep riding the kernel, at a non-bench geometry
#
# `BDKernelCapacityRunner` plugs the BD kernel into `SimulationRunner`
# through the bulk-kernel extension point: the kernel owns the
# repetition axis, the runner owns the parameter sweep, Result
# accumulation and checkpoint/resume. `K`/`nr_u` pick the geometry —
# here 2 users x 2 antennas (not the K=3 bench point).

# %%
from apps.comp_BD.batched_bd_capacity import BDKernelCapacityRunner

runner = BDKernelCapacityRunner(K=2, nr_u=2, tile=8, lane=128,
                                num_tiles=1, interpret=True)
runner.params.add("Pu_dB", np.array([-5.0, 5.0, 15.0]))
runner.rep_max = 2
runner.batch_size = 2
runner.update_progress_function_style = None
runner.simulate()
caps = np.array(runner.results.get_result_values_list("sum_capacity"))
print("per-BS power (dB):", runner.results.params["Pu_dB"])
print("mean BD sum capacity (b/s/Hz):", np.round(caps, 2))

# %% [markdown]
# ## The IA kernel's menu: users x antennas x streams
#
# `MonteCarloMaxSinr(K=, N=, Ns=)` generates the plane program from
# the geometry. The (N, Ns) = (2, 1) point uses hand-tuned closed-form
# 2x2 algebra; other points (e.g. 4x4 antennas, 2 streams/user) run a
# general program with unrolled LDL^H solves. Both are pinned against
# the XLA solver `ia/batched.max_sinr_solve` on identical channels in
# the test suite.

# %%
import jax.numpy as jnp

from pyphysim_tpu.ops.ia_pallas import MonteCarloMaxSinr

for K, N, Ns in [(3, 2, 1), (2, 4, 2)]:
    mc = MonteCarloMaxSinr(tile=8, lane=128, iterations=4, K=K, N=N,
                           Ns=Ns)
    cap = float(np.asarray(mc.build(1, 1, interpret=True)(
        jnp.int32(7), 0.1)).sum())
    per_solve = cap / (mc._tile * mc._lane)
    print(f"(K={K}, {N}x{N}, Ns={Ns}): mean sum capacity "
          f"{per_solve:.2f} b/s/Hz")

# %% [markdown]
# ## Sharding the kernel tier over a mesh
#
# Every kernel keys its random streams by the ABSOLUTE repetition
# index, so splitting the rep axis over a `jax.sharding.Mesh` under
# `shard_map` (each device offsets its stream window by
# `device_index * reps_local`) produces BIT-identical results to the
# unsharded kernel — the property that makes multi-device scaling
# exact, certified here on the virtual CPU mesh.

# %%
from pyphysim_tpu.ops.bd_pallas import MonteCarloBD
from pyphysim_tpu.parallel import make_mesh

mc = MonteCarloBD(tile=8, lane=128, K=2, Nr_u=1)
reps = 8
one = np.asarray(mc.build(reps, 1, interpret=True)(jnp.int32(3)))
sharded = np.asarray(
    mc.build(reps, 1, mesh=make_mesh(8), interpret=True)(jnp.int32(3)))
print("sharded == unsharded, bit-identical:",
      np.array_equal(one, sharded))

# %% [markdown]
# On the GPU the same `build(...)` call (without `interpret`) takes
# `mesh=` too, and `SimulationRunner.simulate_in_parallel(mesh)` drives
# any of these kernels through the same sweep/checkpoint machinery —
# see `apps/mimo/alamouti_mc_kernel.py`, `apps/ia/ia_mc_kernel.py` and
# `apps/comp_BD/batched_bd_capacity.py` for the three family apps.
