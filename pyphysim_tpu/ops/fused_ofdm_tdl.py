"""Fused OFDM-over-TDL fast path (block-static SISO).

Algebraic collapse of the chain
``pruned-IDFT -> +CP -> block-FFT -> x H -> block-IFFT -> overlap-add ->
+noise -> strip CP -> pruned-DFT`` into
``(data @ M) x H @ N  (+ equivalent noise)``, exact under two conditions
that the OFDM/TDL geometry itself guarantees:

* ``cp_size >= span - 1``: the convolution tail of each block lands
  entirely inside the NEXT symbol's cyclic prefix, which the receiver
  discards — the overlap-add contributes nothing to any retained sample
  (same reason the CP makes the one-tap equalizer exact);
* the conv's circular length ``L >= samples_per_symbol + span - 1``: no
  wrap-around inside a block.

``M`` (num_used, L) maps data bins straight to the conv spectrum of the
CP-prefixed time symbol; ``N`` (L, num_used) maps the per-block product
spectrum straight to the demodulated used bins of the retained samples.
Both are precomputed in f64 on the host and cached per dtype.

Noise: the receiver transform rows are orthogonal with equal norm
``sqrt(fft_size / power_scale)``, so iid time-domain AWGN of std
``sigma`` is EXACTLY equivalent to iid AWGN of std
``sigma * sqrt(fft_size / power_scale)`` added to the fused output —
1.9x fewer Gaussian samples and one less full-signal memory pass.

Parity: this is this framework's analog of the reference's
``corrupt_data_in_freq_domain`` (fading.py:1126-1287) — a semantically
equivalent faster transmission path — except it reproduces the full
time-domain chain's output exactly (tests pin fused == unfused).
"""

from __future__ import annotations

import math
from typing import Tuple

import jax.numpy as jnp
import numpy as np

from . import cplx
from .cplx import CArray

__all__ = ["FusedOfdmTdl"]


def _taps_spectrum(taps: CArray, idx: np.ndarray, L: int,
                   dtype) -> CArray:
    """Kernel spectrum H[b, k] = sum_i taps[i, b] e^{-2pi i k d_i / L}
    from the sparse taps, in the given dtype."""
    k = np.arange(L)
    phase = -2.0 * np.pi / L * np.outer(idx, k)
    w = CArray(jnp.asarray(np.cos(phase), dtype),
               jnp.asarray(np.sin(phase), dtype))
    return cplx.matmul(taps.astype(dtype).swapaxes(-1, -2), w)


class FusedOfdmTdl:
    """Precomputed fused transforms for one (OFDM, TdlChannel) pair.

    ``mode="diag"`` (default) uses the final algebraic collapse: under the
    same two geometry conditions, ``M diag(H_conv) N`` IS a diagonal
    matrix — the retained window of the linear convolution equals the
    circular convolution over the fft_size grid (the textbook reason OFDM
    uses a cyclic prefix), so each used bin is simply multiplied by the
    channel frequency response at that bin:
    ``rx[s, u] = x[s, u] * sum_i taps[i, s] e^{-2pi j bin_u d_i / fft}``.
    This replaces two (used x L) matmuls per OFDM symbol with one tiny
    (num_taps x used) tap-spectrum matmul and one elementwise multiply —
    ~85x fewer FLOPs, bit-identical output (tests pin diag == spectrum ==
    time-domain chain). ``mode="spectrum"`` keeps the explicit conv-domain
    matmul pair (used for cross-validation).
    """

    def __init__(self, ofdm, channel, mode: str = "diag") -> None:
        if mode not in ("diag", "spectrum"):
            raise ValueError(f"unknown fused mode {mode!r}")
        self._ofdm = ofdm
        self._channel = channel
        self._mode = mode
        profile = channel.channel_profile
        self._tap_idx = profile.tap_delays.astype(int)
        self._span = int(self._tap_idx[-1]) + 1
        spb = ofdm.samples_per_symbol
        if ofdm.cp_size < self._span - 1:
            raise ValueError(
                "Fused OFDM-TDL path requires cp_size >= channel span - 1 "
                f"({ofdm.cp_size} < {self._span - 1}): with a shorter CP "
                "the convolution tail leaks into retained samples and the "
                "time-domain chain must be used")
        # conv circular length, 128-lane aligned like tdl_filter_block_fft
        self._L = ((spb + self._span - 1 + 127) // 128) * 128
        self._cache: dict = {}

    # -- host-side matrix construction (f64, cached per dtype) -----------

    def _matrices(self, dtype) -> Tuple[CArray, CArray]:
        key = jnp.dtype(dtype).name
        if key not in self._cache:
            o, L = self._ofdm, self._L
            n, used, cp = o.fft_size, o.num_used_subcarriers, o.cp_size
            spb = o.samples_per_symbol
            bins = o.get_used_subcarrier_indexes() % n
            ps = o._calculate_power_scale()

            # TX: data bin b -> time sample t of the CP-prefixed symbol
            # (t in 0..spb-1 maps to IDFT index (t - cp) mod n), then
            # -> conv spectrum at L bins.
            t = np.arange(spb)
            idft = np.exp(2j * np.pi / n * np.outer(bins, (t - cp) % n)) \
                * (math.sqrt(ps) / n)                       # (used, spb)
            f_conv = np.exp(-2j * np.pi / L *
                            np.outer(t, np.arange(L)))      # (spb, L)
            M = idft @ f_conv                               # (used, L)

            # RX: conv spectrum -> retained time samples (cp..spb-1)
            # -> demodulated used bins.
            m = np.arange(n)                                # stripped idx
            ifft = np.exp(2j * np.pi / L *
                          np.outer(np.arange(L), cp + m)) / L  # (L, n)
            dft = np.exp(-2j * np.pi / n * np.outer(m, bins)) \
                / math.sqrt(ps)                             # (n, used)
            N = ifft @ dft                                  # (L, used)

            # host (numpy) constants: a jnp array made while tracing
            # would be a tracer, and the cache would leak it
            self._cache[key] = (
                CArray(np.asarray(M.real, dtype), np.asarray(M.imag, dtype)),
                CArray(np.asarray(N.real, dtype), np.asarray(N.imag, dtype)))
        return self._cache[key]

    def _diag_matrix(self, dtype) -> CArray:
        """(num_taps, used) sparse-DFT matrix evaluating the channel
        frequency response exactly at the used bins, in demod order."""
        key = ("diag", jnp.dtype(dtype).name)
        if key not in self._cache:
            o = self._ofdm
            bins = o.get_used_subcarrier_indexes() % o.fft_size
            phase = (-2.0 * np.pi / o.fft_size) * np.outer(self._tap_idx,
                                                           bins)
            self._cache[key] = CArray(np.asarray(np.cos(phase), dtype),
                                      np.asarray(np.sin(phase), dtype))
        return self._cache[key]

    @property
    def noise_gain(self) -> float:
        """Std multiplier making post-fusion AWGN exactly equivalent to
        time-domain AWGN: row norm of the receiver transform."""
        o = self._ofdm
        return math.sqrt(o.fft_size / o._calculate_power_scale())

    # -- the fused op ------------------------------------------------------

    def corrupt_and_demodulate(self, state, data: CArray):
        """``data``: (..., n_sym * num_used) modulated symbols. Returns
        ``(rx_data, ir_block, new_state)`` where ``rx_data`` (same shape)
        is the NOISELESS demodulated receiver data (add equivalent noise
        scaled by :attr:`noise_gain`, then equalize with ``ir_block``)."""
        o = self._ofdm
        used = o.num_used_subcarriers
        batch = data.shape[:-1]
        n_sym = data.shape[-1] // used
        x = data.reshape(batch + (n_sym, used))

        ir_block, state = self._channel._generate_strided_impulse_response(
            state, n_sym, stride=o.samples_per_symbol)
        taps = ir_block.tap_values_sparse                   # (T, .., nb)

        if self._mode == "diag":
            w = self._diag_matrix(x.dtype)                  # (T, used)
            perm = tuple(range(1, taps.ndim)) + (0,)
            tvt = taps.astype(x.dtype).transpose(perm)      # (.., nb, T)
            H = cplx.matmul(tvt, w, precision=o.precision)  # (.., nb, used)
            rx = x * H
        else:
            M, N = self._matrices(x.dtype)
            X = cplx.matmul(x, M, precision=o.precision)    # (.., nb, L)
            H = _taps_spectrum(taps, self._tap_idx,
                               self._L, x.dtype)            # (.., nb, L)
            Y = X * H
            rx = cplx.matmul(Y, N, precision=o.precision)   # (.., nb, used)
        return rx.reshape(batch + (n_sym * used,)), ir_block, state
