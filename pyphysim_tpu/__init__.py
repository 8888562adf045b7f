"""pyphysim_tpu — an accelerator-native physical-layer simulation framework.

A brand-new JAX/XLA/Pallas implementation of the capabilities of
darcamo/pyphysim (see /root/reference): M-QAM/M-PSK modulation, OFDM,
AWGN/Rayleigh/TDL channels with Jakes Doppler fading, MIMO schemes,
multiuser precoding (block diagonalization, interference alignment),
path loss and cell-topology models, LTE-style reference signals and
channel estimation — orchestrated by a Monte Carlo engine expressed as
a single jitted SPMD program sharded over a device mesh.

Design principles (accelerator-first, not a port):
  * pure functions + explicit state (PRNG keys, Jakes phase state)
  * batched/vmapped kernels with static shapes; `lax.scan` for loops
  * `jax.sharding.Mesh` + `shard_map`/`pjit` with `psum` reductions for
    the parameter-sweep data parallelism the reference obtained from
    ipyparallel task farming
  * complex64 on-device by default (float32 pairs feed the matrix and vector units)
"""

__version__ = "0.1.0"

from . import utils  # noqa: F401
