"""Device-mesh parallelism: mesh construction, sharded Monte Carlo
reduction, and multi-host initialization (device-native replacement of the
reference's ipyparallel task farming)."""

from .mesh import (init_multihost, make_host_chip_mesh,  # noqa: F401
                   make_mesh, shard_batch, shard_reps)
from .timeshard import corrupt_data_time_sharded  # noqa: F401
