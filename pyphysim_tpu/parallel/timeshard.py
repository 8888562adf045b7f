"""Time-sharded TDL channel corruption: long symbol streams across devices.

The reference handles arbitrarily long streams with a sequential Jakes
clock plus ``skip_samples_for_next_generation`` (fading_generators.py:
495-540) and carries the convolution halo in the ``num_taps_with_padding
- 1`` extra output samples of ``corrupt_data`` (fading.py:1074-1087).
SURVEY §5's device-native equivalent, implemented here: shard the stream
over time-blocks across a mesh axis, let every device generate its own
channel taps directly from the closed-form Jakes state (no sequential
dependency — ``skip`` is O(1) in the block offset), convolve locally,
and exchange the ``span - 1``-sample halo with the right neighbor via a
single ``lax.ppermute`` between devices.

Output is bit-wise the first ``N`` samples of the unsharded
``corrupt_data`` (the trailing halo of the final device is dropped, the
same samples every consumer of the chain slices away).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import cplx
from ..ops.cplx import CArray

try:  # jax >= 0.4.35 exposes shard_map at the top level
    from jax import shard_map
except ImportError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map

__all__ = ["corrupt_data_time_sharded"]


def corrupt_data_time_sharded(channel, state, signal: CArray,
                              block_size: int, mesh: Mesh,
                              axis_name: str = "time"):
    """Block-static ``corrupt_data`` over a time-sharded signal.

    Parameters
    ----------
    channel : TdlChannel
        The channel (SISO shape). Its fading generator state must be
        O(1)-skippable (Jakes closed form or Rayleigh fold-in).
    state : generator state (replicated)
    signal : CArray, shape (N,)
        The full stream; ``N`` must be divisible by
        ``mesh.shape[axis_name] * block_size``.
    block_size : int
        Samples per channel-static block (e.g. one OFDM symbol).
    mesh, axis_name :
        The mesh axis to shard time over.

    Returns
    -------
    (out, ir, state) like ``TdlChannel.corrupt_data`` with ``out`` of
    length exactly ``N`` (truncated convolution) sharded over
    ``axis_name``, and ``ir`` the per-block strided impulse response
    (blocks axis sharded the same way).
    """
    from ..channels.fading import TdlImpulseResponse

    n_dev = mesh.shape[axis_name]
    N = signal.re.shape[-1]
    if N % (n_dev * block_size) != 0:
        raise ValueError(
            f"signal length {N} must divide over {n_dev} devices x "
            f"block_size {block_size}")
    n_local = N // n_dev
    span = channel.num_taps_with_padding
    halo = span - 1
    if halo >= n_local:
        raise ValueError("channel span exceeds the per-device shard")
    gen = channel._fading_generator

    def local_fn(st, sig):
        i = jax.lax.axis_index(axis_name)
        st_i = gen.skip(st, i * n_local)
        out, ir, _ = channel._corrupt_data_impl(st_i, sig, block_size)
        main = out[..., :n_local]
        tail = out[..., n_local:]                   # (halo,) spill-over
        perm = [(j, j + 1) for j in range(n_dev - 1)]
        tr = jax.lax.ppermute(tail.re, axis_name, perm)
        ti = jax.lax.ppermute(tail.im, axis_name, perm)
        head = CArray(main.re[..., :halo] + tr, main.im[..., :halo] + ti)
        res = cplx.concatenate([head, main[..., halo:]], axis=-1)
        return res, ir.tap_values_sparse

    # out leaves: signal (n_local,) -> shard axis 0; sparse taps
    # (num_taps, num_blocks_local) -> shard the blocks axis
    fn = shard_map(local_fn, mesh=mesh,
                   in_specs=(P(), P(axis_name)),
                   out_specs=(P(axis_name), P(None, axis_name)))
    out, taps = fn(state, signal)
    ir = TdlImpulseResponse(taps, channel.channel_profile)
    return out, ir, gen.skip(state, N)
