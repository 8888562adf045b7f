"""Monolithic Alamouti 2x1 Monte-Carlo Pallas kernel.

Register-resident counterpart of the unfused Alamouti chain (the reference's
``apps/mimo/simulate_mimo.py:69-141`` semantics: QPSK -> Alamouti 2x1
encode -> flat Rayleigh block fading -> AWGN -> matched combining ->
hard demod -> bit errors), built like the IA and BD kernels: data
bits, channel and AWGN all come from the in-kernel counter-based
generator (:mod:`.counter_rng`), every intermediate stays on chip, and
the only device-memory traffic is one int32 error count per program.

The algebra collapses to pure sign arithmetic:

* QPSK (pi/4 offset, Gray): index bits ``(b1 b0)`` map to
  ``((1-2 b0) + j (1-2 b1)) / sqrt(2)`` and demodulation is two sign
  tests — no constellation gather, no argmin (matching
  ``modulators.PSK``'s table exactly: re < 0 <=> bit0, im < 0 <=> bit1).
* Each (row, lane) element of a grid block simulates one Alamouti
  CODEWORD (a symbol pair): the two receive samples, the matched
  combiner ``d1 = h1* r1 + h2 r2*``, ``d2 = h2* r1 - h1 r2*``
  (mimo.py:1073-1287; the combiner gain ``|h1|^2+|h2|^2`` is positive,
  so QPSK decisions need no division).
* The channel is constant over a (rep, lane) STREAM: lanes are
  independent virtual repetitions whose ``h`` is drawn once per rep
  from streams 0 and 1 indexed by the lane, and re-derived identically
  by every tile of that rep — keyed by (seed, absolute repetition), so
  the runner's absolute attempt cursor and the mesh sharding both apply
  unchanged. Data and noise come from streams 2..4 indexed by the
  absolute element.

``interpret=True`` runs the identical kernel under the Pallas
interpreter on the CPU; :meth:`MonteCarloAlamouti.reference_counts` is
an independent complex model in plain ``jax.numpy`` fed the same bits.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl

from ..parallel.mesh import shard_reps
from .counter_rng import gauss_half, random_bits
from .pallas_common import (TRITON_PARAMS, block_elements,
                            check_block, require_kernel_backend)

__all__ = ["MonteCarloAlamouti"]


class MonteCarloAlamouti:
    """Builder for the single-kernel Alamouti 2x1 QPSK Monte Carlo rep.

    ``tile`` codeword rows x ``lane`` independent channel streams per
    grid step; a repetition is ``num_tiles`` consecutive tiles sharing
    one channel draw per lane. Symbols per call:
    ``reps * num_tiles * tile * lane * 2``.
    """

    def __init__(self, tile: int = 8, lane: int = 128) -> None:
        check_block(tile, lane)
        self._tile = int(tile)
        self._lane = int(lane)

    # ------------------------------------------------------------------

    def _simulate_block(self, seed, attempt, s, amp):
        """Block ``s`` of repetition ``attempt`` -> bit-error count.
        ``amp``: per-component noise std ``sqrt(0.5/snr)``."""
        f32 = jnp.float32
        tile, lane = self._tile, self._lane
        gauss = gauss_half

        # h components ~ N(0, 1/2) per part, one draw per lane and rep
        lanes = jax.lax.broadcasted_iota(jnp.int32, (1, lane), 1
                                         ).astype(jnp.uint32)
        b1r, b1i = random_bits(seed, attempt, lanes, 0)
        b2r, b2i = random_bits(seed, attempt, lanes, 1)
        h1r, h1i, h2r, h2i = gauss(b1r), gauss(b1i), gauss(b2r), gauss(b2i)
        elem = block_elements(s, tile, lane)
        d_bits, n1r_bits = random_bits(seed, attempt, elem, 2)
        n1i_bits, n2r_bits = random_bits(seed, attempt, elem, 3)
        n2i_bits, _ = random_bits(seed, attempt, elem, 4)

        idx = d_bits.astype(jnp.int32) & 15
        c = f32(1.0 / math.sqrt(2.0))
        s1r = (1 - 2 * (idx & 1)).astype(f32) * c
        s1i = (1 - 2 * ((idx >> 1) & 1)).astype(f32) * c
        s2r = (1 - 2 * ((idx >> 2) & 1)).astype(f32) * c
        s2i = (1 - 2 * ((idx >> 3) & 1)).astype(f32) * c

        sqrt2 = f32(math.sqrt(2.0))
        n1r = gauss(n1r_bits) * sqrt2
        n1i = gauss(n1i_bits) * sqrt2
        n2r = gauss(n2r_bits) * sqrt2
        n2i = gauss(n2i_bits) * sqrt2

        # received samples, power-split encode (mimo.py _encode / sqrt 2):
        # r1 = (h1 s1 + h2 s2)/sqrt2 + n,  r2 = (-h1 s2* + h2 s1*)/sqrt2
        r1r = (h1r * s1r - h1i * s1i + h2r * s2r - h2i * s2i) * c + \
            amp * n1r
        r1i = (h1r * s1i + h1i * s1r + h2r * s2i + h2i * s2r) * c + \
            amp * n1i
        r2r = (-(h1r * s2r + h1i * s2i) + h2r * s1r + h2i * s1i) * c + \
            amp * n2r
        r2i = (-(h1i * s2r - h1r * s2i) + (h2i * s1r - h2r * s1i)) * c + \
            amp * n2i

        # matched combining: d1 = h1* r1 + h2 r2*, d2 = h2* r1 - h1 r2*
        d1r = h1r * r1r + h1i * r1i + h2r * r2r + h2i * r2i
        d1i = h1r * r1i - h1i * r1r - (h2r * r2i - h2i * r2r)
        d2r = h2r * r1r + h2i * r1i - (h1r * r2r + h1i * r2i)
        d2i = h2r * r1i - h2i * r1r + (h1r * r2i - h1i * r2r)

        decided = ((d1r < 0).astype(jnp.int32) |
                   ((d1i < 0).astype(jnp.int32) << 1) |
                   ((d2r < 0).astype(jnp.int32) << 2) |
                   ((d2i < 0).astype(jnp.int32) << 3))
        diff = idx ^ decided
        errs = ((diff & 1) + ((diff >> 1) & 1) + ((diff >> 2) & 1) +
                ((diff >> 3) & 1))
        return jnp.sum(errs)

    def build(self, reps: int, num_tiles: int, mesh=None,
              axis: str = "mc", interpret: bool = False):
        """Jitted ``(seed:int32, snr_linear[, start]) ->
        (reps, num_tiles) int32`` bit-error counts. ``start`` offsets the
        per-repetition stream index (the runner bulk-path contract);
        ``mesh`` shards the rep axis bit-identically (same scheme as
        :func:`~pyphysim_tpu.parallel.shard_reps`). Without
        ``interpret``, a backend other than the GPU raises."""
        require_kernel_backend(interpret)

        def prologue(seed, snr_linear, start=0):
            amp = jnp.sqrt(0.5 / snr_linear).astype(jnp.float32)
            return (jnp.stack([jnp.asarray(seed, jnp.int32),
                               jnp.asarray(start, jnp.int32)]),
                    jnp.reshape(amp, (1,)))

        return shard_reps(
            lambda n: self._make_call(n, num_tiles, interpret), prologue,
            reps, mesh, axis)

    def _make_call(self, reps: int, num_tiles: int, interpret: bool):
        def kernel(seed_ref, amp_ref, out_ref):
            r = pl.program_id(0)
            s = pl.program_id(1)
            out_ref[...] = self._simulate_block(
                seed_ref[0].astype(jnp.uint32),
                (seed_ref[1] + r).astype(jnp.uint32), s, amp_ref[0])

        return pl.pallas_call(
            kernel,
            grid=(reps, num_tiles),
            out_shape=jax.ShapeDtypeStruct((reps, num_tiles), jnp.int32),
            in_specs=[pl.BlockSpec((2,), lambda r, s: (0,)),
                      pl.BlockSpec((1,), lambda r, s: (0,))],
            out_specs=pl.BlockSpec((None, None), lambda r, s: (r, s)),
            backend="triton",
            compiler_params=TRITON_PARAMS,
            interpret=interpret,
            name="alamouti",
        )

    def reference_counts(self, reps: int, num_tiles: int, seed,
                         snr_linear, start=0):
        """``(reps, num_tiles)`` bit-error counts of the same
        repetitions as :meth:`build`, from complex ``jax.numpy``
        arithmetic (encode, channel, matched combiner, sign slicer) on
        the same generator bits — an independent model of the kernel's
        real-plane sign arithmetic."""
        tile, lane = self._tile, self._lane
        rows = num_tiles * tile
        seed = jnp.asarray(seed, jnp.int32).astype(jnp.uint32)
        amp = jnp.sqrt(0.5 / jnp.asarray(snr_linear, jnp.float32))
        lanes = jnp.arange(lane, dtype=jnp.uint32)
        elem = (jnp.arange(rows, dtype=jnp.uint32)[:, None] * lane +
                lanes[None, :])
        c = np.float32(1.0 / math.sqrt(2.0))

        def cgauss(a, b):
            return gauss_half(a) + 1j * gauss_half(b)

        def qpsk(bits2):
            return ((1 - 2 * (bits2 & 1)) +
                    1j * (1 - 2 * ((bits2 >> 1) & 1))) * c

        def one(attempt):
            key = (seed, attempt.astype(jnp.uint32))
            h1 = cgauss(*random_bits(*key, lanes, 0))
            h2 = cgauss(*random_bits(*key, lanes, 1))
            d, n1r = random_bits(*key, elem, 2)
            n1i, n2r = random_bits(*key, elem, 3)
            n2i, _ = random_bits(*key, elem, 4)
            idx = d.astype(jnp.int32) & 15
            s1, s2 = qpsk(idx), qpsk(idx >> 2)
            n1 = cgauss(n1r, n1i) * np.float32(math.sqrt(2.0))
            n2 = cgauss(n2r, n2i) * np.float32(math.sqrt(2.0))
            r1 = (h1 * s1 + h2 * s2) * c + amp * n1
            r2 = (-h1 * jnp.conj(s2) + h2 * jnp.conj(s1)) * c + amp * n2
            d1 = jnp.conj(h1) * r1 + h2 * jnp.conj(r2)
            d2 = jnp.conj(h2) * r1 - h1 * jnp.conj(r2)
            decided = ((d1.real < 0).astype(jnp.int32) |
                       ((d1.imag < 0).astype(jnp.int32) << 1) |
                       ((d2.real < 0).astype(jnp.int32) << 2) |
                       ((d2.imag < 0).astype(jnp.int32) << 3))
            errs = jax.lax.population_count(idx ^ decided)
            return jnp.sum(errs.reshape(num_tiles, -1), axis=-1)

        attempts = jnp.asarray(start, jnp.int32) + jnp.arange(reps)
        return jax.lax.map(one, attempts)

    # ------------------------------------------------------------------

    @property
    def symbols_per_grid_step(self) -> int:
        return self._tile * self._lane * 2
