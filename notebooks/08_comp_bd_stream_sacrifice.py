# %% [markdown]
# # CoMP block diagonalization with external interference
#
# Tutorial counterpart of the reference's largest app
# (`apps/comp_BD/simulate_comp.py`): a 3-cell cluster jointly transmits
# to one user per cell with Block Diagonalization precoding while an
# external interference source sits at the cluster border. Sacrificing
# transmit streams in the directions the interference occupies can buy
# back a lot of SER — `EnhancedBD` decides how many streams to drop per
# user using one of several metrics, and `WhiteningBD` whitens instead.
#
# Here the WHOLE study runs on the device engine: each Monte Carlo
# repetition drops users at random positions (host-side geometry,
# vectorized per chunk), and one jitted device program draws the
# path-loss-scaled channels, solves all the precoders and pushes the
# transmit chain for every repetition in the chunk
# (`pyphysim_tpu.comm.batched.enhanced_bd_batched` /
# `whitening_bd_batched`).

# %%
import sys

sys.path.insert(0, "..")

import numpy as np

# force the CPU backend when running this notebook without a GPU
# (the device engine is backend-agnostic; on a real chip remove this)
import jax

try:
    jax.config.update("jax_platforms", "cpu")
except RuntimeError:
    pass

from apps.comp_BD.simulate_comp import METRICS, BDSimulationRunner

# %% [markdown]
# ## The scenario runner
#
# `BDSimulationRunner` reads the reference-shaped config
# (`apps/comp_BD/bd_config_file.txt`) — grid geometry, (SNR, Pe_dBm)
# sweep, modulation — and simulates every stream-sacrifice metric at
# once, sharing the data / interference / noise draws across metrics
# exactly like the reference so per-repetition comparisons are paired.

# %%
runner = BDSimulationRunner(read_command_line_args=False)
runner.params.add("SNR", np.array([20.0]))
runner.params.add("Pe_dBm", np.array([10.0]))  # strong interferer
runner.params.add("NSymbs", 200)
runner.rep_max = 32
runner.batch_size = 32
runner.update_progress_function_style = None
runner.simulate()

# %%
print(f"{'metric':>18} {'SER':>9} {'PER':>7} {'spec effic':>11}")
for m in METRICS:
    ser = float(runner.results.get_result_values_list(f"ser_{m}")[0])
    per = float(runner.results.get_result_values_list(f"per_{m}")[0])
    se = float(
        runner.results.get_result_values_list(f"spec_effic_{m}")[0])
    print(f"{m:>18} {ser:9.4f} {per:7.3f} {se:11.2f}")

# %% [markdown]
# With a strong external interferer the "None" row (no stream
# reduction) suffers: the receiver has no spatial dimensions left to
# dodge the interference. The `capacity` / `effective_throughput`
# metrics sacrifice a stream exactly when that trade is worth it, and
# `WhiteningBD` gets part of the benefit without dropping streams.
#
# ## Non-square geometry
#
# The device solvers are shape-general for `Nt_u >= Nr_u`: with more
# transmit than receive antennas per base station the null spaces grow,
# and the precoder keeps the best `Nr_u` stream directions of the FULL
# null space. A shipped config exercises it:

# %%
import os

cfg = os.path.join("..", "apps", "comp_BD",
                   "bd_config_file_nonsquare.txt")
if not os.path.exists(cfg):  # running from the repo root
    cfg = os.path.join("apps", "comp_BD",
                       "bd_config_file_nonsquare.txt")
ns_runner = BDSimulationRunner(
    read_command_line_args=False, default_config_file=cfg,
    metrics=["None", "capacity", "Whitening"])
ns_runner.params.add("SNR", np.array([20.0]))
ns_runner.params.add("Pe_dBm", np.array([10.0]))
ns_runner.params.add("NSymbs", 200)
ns_runner.rep_max = 16
ns_runner.batch_size = 16
ns_runner.update_progress_function_style = None
ns_runner.simulate()
for m in ns_runner.metrics:
    ser = float(ns_runner.results.get_result_values_list(f"ser_{m}")[0])
    print(f"Nt=3 > Nr=2  {m:>10}: SER {ser:.4f}")

# %% [markdown]
# ## Parity anchor
#
# `engine="host"` runs the same scenario through the per-repetition
# host solver classes (`EnhancedBD` / `WhiteningBD` objects, the
# reference's flow) — useful for validating the device program on a
# new geometry. The test suite pins the two engines against each other
# on the fixed symmetric scenario (`tests/test_apps.py
# TestSimulateCompFull`).
