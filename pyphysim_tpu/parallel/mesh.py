"""Mesh helpers: the communication/parallelism backbone.

Device-native replacement for the reference's distributed backend
(ipyparallel ZMQ task farming, SURVEY §2.11): Monte Carlo data
parallelism is expressed as a 1-D (or 2-D host x device)
``jax.sharding.Mesh`` over which repetition batches are sharded;
error-counter reduction happens inside XLA via ``psum``, which XLA hands
to NCCL on GPUs (no sockets). The cards of one host are joined all to
all by NVLink, so every device reaches every other at the same rate and
the mesh's shape follows the algorithm alone: a 1-D mesh over the
repetition axis is the natural layout for Monte Carlo. Multi-host
initialization wraps ``jax.distributed.initialize``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec

__all__ = ["make_mesh", "make_host_chip_mesh", "shard_batch",
           "shard_reps", "init_multihost"]


def make_mesh(devices: Optional[Sequence] = None,
              axis_name: str = "mc") -> Mesh:
    """A 1-D mesh over all (or the given) local devices, for sharding
    Monte Carlo repetition batches. An integer is accepted as a count
    (the first ``devices`` local devices)."""
    if devices is None:
        devices = jax.devices()
    elif isinstance(devices, int):
        devices = jax.devices()[:devices]
    return Mesh(np.asarray(devices), (axis_name,))


def make_host_chip_mesh(num_hosts: Optional[int] = None,
                        axis_names: Sequence[str] = ("host", "chip"),
                        devices: Optional[Sequence] = None) -> Mesh:
    """A 2-D ``(host, chip)`` mesh: the outer axis crosses hosts (the
    slower inter-host network), the inner axis stays within a host
    (NVLink between the cards). Shard the SNR sweep (or realization
    super-batches) over ``host`` — one collective per sweep, amortized
    over the network — and realizations over ``chip``. On a single host,
    ``num_hosts`` splits the local devices into virtual host groups (how
    the tests and the dry run exercise the two-axis layout on one
    machine)."""
    devices = np.asarray(jax.devices() if devices is None else devices)
    if num_hosts is None:
        num_hosts = max(jax.process_count(), 1)
    if devices.size % num_hosts != 0:
        raise ValueError(
            f"{devices.size} devices do not split into {num_hosts} hosts")
    grid = devices.reshape(num_hosts, devices.size // num_hosts)
    return Mesh(grid, tuple(axis_names))


def shard_batch(mesh: Mesh, x, axis_name: str = "mc"):
    """Place a batch array (leading axis = repetitions) so that it is
    sharded across the mesh."""
    sharding = NamedSharding(mesh, PartitionSpec(axis_name))
    return jax.device_put(x, sharding)


def shard_reps(make_call, prologue, reps: int, mesh: Optional[Mesh] = None,
               axis: str = "mc"):
    """Jitted ``run(*args)`` for a self-batched Monte Carlo program whose
    first input is ``seeds = [seed, start]``: repetition ``r`` of a call
    is the absolute attempt ``start + r``.

    ``prologue(*args)`` turns the caller's arguments into the program's
    inputs; ``make_call(n)`` builds the program for ``n`` repetitions.
    With a ``mesh``, the rep axis is split over ``mesh.shape[axis]``
    devices under :func:`jax.shard_map`: device ``i`` runs the same
    program over its contiguous slice with ``start`` advanced by
    ``i * reps_local``, so, with randomness keyed by the absolute attempt,
    the result is bit-identical to the unsharded call. The output is
    gathered to a replicated array so multi-process hosts can read all
    rows.
    """
    if mesh is None:
        call = make_call(reps)

        @jax.jit
        def run(*args):
            return call(*prologue(*args))

        return run

    n_dev = int(mesh.shape[axis])
    if reps % n_dev:
        raise ValueError(f"reps {reps} not divisible by mesh axis "
                         f"{axis!r} size {n_dev}")
    reps_local = reps // n_dev
    call = make_call(reps_local)

    def local(seeds, *rest):
        i = jax.lax.axis_index(axis)
        return call(seeds.at[1].add(i * reps_local), *rest)

    replicated = NamedSharding(mesh, PartitionSpec())

    @jax.jit
    def run(*args):
        ins = prologue(*args)
        sharded = jax.shard_map(
            local, mesh=mesh, in_specs=(PartitionSpec(),) * len(ins),
            out_specs=PartitionSpec(axis), check_vma=False)
        return jax.lax.with_sharding_constraint(sharded(*ins), replicated)

    return run


def init_multihost(coordinator_address: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None) -> None:
    """Initialize multi-host jax (pod-slice execution). Safe to call when
    already initialized."""
    try:
        jax.distributed.initialize(coordinator_address, num_processes,
                                   process_id)
    except RuntimeError:
        pass  # already initialized
