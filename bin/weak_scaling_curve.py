#!/usr/bin/env python
"""Weak-scaling curve of the sharded Monte Carlo step on the virtual
CPU mesh (VERDICT r4 item 7).

The sharded flagship is meant to scale "linearly in device count until
dispatch-bound"; this pins the SHAPE of that claim where it can be
measured without cards: per-device reps held constant while the mesh grows 1 -> 8
virtual CPU devices, so ideal weak scaling = flat reps/s/device. The
collective in the program is the gather implied by replicating the
summed error counters (the runner's psum-style reduction).

CPU caveat: virtual devices share the machine's cores, so the absolute
numbers mean nothing and flatness holds only while cores outnumber
devices; what the curve pins is that the SPMD program adds no
superlinear collective overhead as the mesh grows.

Run:  python bin/weak_scaling_curve.py [per_dev_reps] [iters]
"""

import os
import sys
import time

os.environ.setdefault("XLA_FLAGS",
                      "--xla_force_host_platform_device_count=8")

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

sys.path.insert(0, os.path.join(os.path.dirname(
    os.path.abspath(__file__)), ".."))


def main():
    per_dev = int(sys.argv[1]) if len(sys.argv) > 1 else 4
    iters = int(sys.argv[2]) if len(sys.argv) > 2 else 10

    import __graft_entry__ as g
    from pyphysim_tpu.parallel import make_mesh

    print(f"{'devices':>8} {'reps/s':>12} {'total vs 1':>11} "
          f"{'flops/device':>13} {'vs 1-dev':>9}")
    base_rate, base_flops = None, None
    for n in (1, 2, 4, 8):
        # fresh chain per mesh size: the fused op memoizes traced
        # intermediates per jit trace, so one instance per program
        step = g._make_chain_step(num_symbols=1280, fft_size=256,
                                  cp_size=48, num_used=128,
                                  block_static=True, fused=True)
        mesh = make_mesh(n)
        sharding = NamedSharding(mesh, P("mc"))
        batch = n * per_dev

        def mc_step(keys, snrs):
            return jnp.sum(jax.vmap(step)(keys, snrs))

        keys = jax.device_put(
            jax.random.split(jax.random.PRNGKey(0), batch), sharding)
        snrs = jax.device_put(jnp.full((batch,), 10.0), sharding)
        with mesh:
            fn = jax.jit(mc_step, in_shardings=(sharding, sharding))
            compiled = fn.lower(keys, snrs).compile()
            flops = per_device_flops(compiled)
            fn(keys, snrs).block_until_ready()  # warm
            t0 = time.perf_counter()
            for _ in range(iters):
                out = fn(keys, snrs)
            out.block_until_ready()
            dt = time.perf_counter() - t0
        rate = batch * iters / dt
        if base_rate is None:
            base_rate, base_flops = rate, flops
        print(f"{n:>8} {rate:>12.1f} {rate / base_rate:>10.2f}x "
              f"{flops:>13.3e} {flops / base_flops:>8.2f}x")


def per_device_flops(compiled) -> float:
    """Per-partition FLOPs of a compiled SPMD program (XLA's cost
    analysis describes the per-device module)."""
    cost = compiled.cost_analysis()
    if isinstance(cost, (list, tuple)):
        cost = cost[0]
    return float(cost["flops"])


if __name__ == "__main__":
    main()
