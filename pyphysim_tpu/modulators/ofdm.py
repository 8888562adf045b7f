"""OFDM modulation/demodulation as matmul-DFTs, plus the one-tap
equalizer.

JAX-native counterpart of the reference ``pyphysim/modulators/ofdm.py``:
  * subcarrier mapping semantics identical to ofdm.py:188-281 (used
    subcarriers centered on the spectrum, DC skipped, guard bands at the
    edges),
  * power scale ``fft_size^2 / (num_used + cp)`` applied at the IFFT as in
    ofdm.py:370-429,
  * cyclic prefix add/remove as in ofdm.py:320-341,
  * one-tap equalizer semantics of ofdm.py:469-552.

Differences by design (accelerator-first):
  * the transform is the matmul-DFT of ``pyphysim_tpu.ops.fft`` (no complex
    dtype on device; matmuls beat butterflies at these sizes),
  * everything is batched: inputs of shape (..., n_symbols) process each
    leading dim as an independent stream in one fused program,
  * shapes are static under jit: the input length must be a multiple of
    ``num_used_subcarriers`` on the device path (host path zero-pads like
    the reference).
"""

from __future__ import annotations

import math
from typing import Optional, Union

import jax.numpy as jnp
import numpy as np

from ..ops import cplx
from ..ops.cplx import CArray

__all__ = ["OFDM", "OfdmOneTapEqualizer"]


class OFDM:
    """OFDM modulator: subcarrier mapping + IFFT + cyclic prefix."""

    def __init__(self, fft_size: int, cp_size: int,
                 num_used_subcarriers: Optional[int] = None) -> None:
        self.set_parameters(fft_size, cp_size, num_used_subcarriers)
        # matmul precision for the (I)DFT matmuls: HIGHEST = true fp32
        # (default), HIGH = 3-pass bf16, DEFAULT = single-pass bf16
        # (fastest, ~0.4% relative error).
        import jax as _jax
        self.precision = _jax.lax.Precision.HIGHEST

    def set_parameters(self, fft_size: int, cp_size: int,
                       num_used_subcarriers: Optional[int] = None) -> None:
        """(Re)set the OFDM parameters, validating them
        (parity: ofdm.py:52-94)."""
        if num_used_subcarriers is None:
            num_used_subcarriers = fft_size
        if num_used_subcarriers > fft_size:
            raise ValueError(
                "Number of used subcarriers cannot be greater than the "
                "OFDM fft_size")
        if num_used_subcarriers % 2 != 0 or num_used_subcarriers < 2:
            raise ValueError("Number of used subcarriers must be a "
                             "multiple of 2")
        if cp_size < 0 or cp_size > fft_size:
            raise ValueError(
                "cp_size must be nonnegative and at most equal to fft_size")
        self.fft_size = int(fft_size)
        self.cp_size = int(cp_size)
        self.num_used_subcarriers = int(num_used_subcarriers)
        self._used_idx = jnp.asarray(self.get_used_subcarrier_indexes())
        self._pruned_cache: dict = {}

    # -- pruned DFT matrices (cached per dtype) ----------------------------

    def _pruned_idft(self, dtype) -> CArray:
        """(num_used, fft_size) inverse-DFT rows at the used bins, in data
        order, with 1/N and the modulate power scale folded in. The cache
        holds NUMPY arrays — jnp conversion happens per call so no traced
        constant ever leaks across jit traces."""
        key = ("idft", jnp.dtype(dtype).name)
        if key not in self._pruned_cache:
            n = self.fft_size
            bins = self.get_used_subcarrier_indexes() % n
            phase = (2.0 * np.pi / n) * np.outer(bins, np.arange(n))
            amp = math.sqrt(self._calculate_power_scale()) / n
            self._pruned_cache[key] = (np.cos(phase) * amp,
                                       np.sin(phase) * amp)
        re, im = self._pruned_cache[key]
        return CArray(jnp.asarray(re, dtype), jnp.asarray(im, dtype))

    def _pruned_dft(self, dtype) -> CArray:
        """(fft_size, num_used) forward-DFT columns at the used bins, in
        data order, with the demodulate power unscale folded in."""
        key = ("dft", jnp.dtype(dtype).name)
        if key not in self._pruned_cache:
            n = self.fft_size
            bins = self.get_used_subcarrier_indexes() % n
            phase = (-2.0 * np.pi / n) * np.outer(np.arange(n), bins)
            amp = 1.0 / math.sqrt(self._calculate_power_scale())
            self._pruned_cache[key] = (np.cos(phase) * amp,
                                       np.sin(phase) * amp)
        re, im = self._pruned_cache[key]
        return CArray(jnp.asarray(re, dtype), jnp.asarray(im, dtype))

    # -- layout helpers (host, parity with ofdm.py:188-281) ---------------

    def _get_used_subcarrier_numbers(self) -> np.ndarray:
        """Used subcarrier 'numbers': positive then negative frequencies,
        DC (0) never used."""
        half = self.num_used_subcarriers // 2
        return np.hstack([np.arange(1, half + 1), np.arange(-half, 0)])

    def get_used_subcarrier_indexes(self) -> np.ndarray:
        """Used subcarrier FFT-bin indexes in the order data is mapped:
        negative-frequency bins (fft_size - half .. fft_size - 1) first,
        then positive bins (1 .. half) — matching the reference layout."""
        numbers = self._get_used_subcarrier_numbers()
        half = self.num_used_subcarriers // 2
        return np.hstack([self.fft_size + numbers[half:], numbers[:half]])

    def _calc_zeropad(self, input_data_size: int):
        """(zeropad, num_ofdm_symbols) for a given payload size."""
        used = self.num_used_subcarriers
        num_symbols = (input_data_size + used - 1) // used
        return num_symbols * used - input_data_size, num_symbols

    def _calculate_power_scale(self) -> float:
        return (float(self.fft_size) ** 2 /
                (float(self.num_used_subcarriers) + self.cp_size))

    @property
    def samples_per_symbol(self) -> int:
        """Output samples per OFDM symbol (fft_size + cp)."""
        return self.fft_size + self.cp_size

    # -- modulate / demodulate --------------------------------------------

    def modulate(self, input_signal: Union[CArray, np.ndarray]) -> Union[
            CArray, np.ndarray]:
        """OFDM-modulate a stream of data symbols.

        Input shape (..., n); n must be a multiple of
        ``num_used_subcarriers`` for traced (CArray) input; host numpy input
        is zero-padded like the reference. Output shape
        (..., n_ofdm_symbols * (fft_size + cp_size)).
        """
        host = isinstance(input_signal, np.ndarray)
        if host:
            pad, _ = self._calc_zeropad(input_signal.shape[-1])
            if pad:
                input_signal = np.concatenate(
                    [input_signal,
                     np.zeros(input_signal.shape[:-1] + (pad,),
                              dtype=input_signal.dtype)], axis=-1)
            x = cplx.from_numpy(input_signal)
        else:
            x = input_signal
            if x.shape[-1] % self.num_used_subcarriers != 0:
                raise ValueError(
                    "Device-path OFDM.modulate requires the input length "
                    "to be a multiple of num_used_subcarriers "
                    f"({x.shape[-1]} % {self.num_used_subcarriers} != 0)")

        batch = x.shape[:-1]
        n_sym = x.shape[-1] // self.num_used_subcarriers
        x = x.reshape(batch + (n_sym, self.num_used_subcarriers))

        # Pruned inverse DFT: only the used bins carry data, so the
        # transform is one (num_used, fft_size) matmul — 40% fewer matmul
        # FLOPs than assembling the zero-padded spectrum and running the
        # full (fft, fft) IDFT, and no spectrum-assembly memory pass.
        # Exactly equal: the skipped rows multiply zeros. The IDFT 1/N
        # and the power scale are folded into the matrix.
        w = self._pruned_idft(x.dtype)
        td = cplx.matmul(x, w, precision=self.precision)
        # Cyclic prefix: last cp samples prepended.
        if self.cp_size:
            td = cplx.concatenate([td[..., -self.cp_size:], td], axis=-1)
        out = td.reshape(batch + (n_sym * self.samples_per_symbol,))
        return out.to_numpy() if host else out

    def demodulate(self, received_signal: Union[CArray, np.ndarray]) -> Union[
            CArray, np.ndarray]:
        """Inverse of :meth:`modulate` (CP strip -> FFT -> unmap).

        Input length must be a multiple of ``fft_size + cp_size``; any
        zero-padding added by modulate is NOT removed (parity with the
        reference, ofdm.py:300-312).
        """
        host = isinstance(received_signal, np.ndarray)
        y = cplx.from_numpy(received_signal) if host else received_signal
        spb = self.samples_per_symbol
        batch = y.shape[:-1]
        n_sym = y.shape[-1] // spb
        y = y[..., :n_sym * spb].reshape(batch + (n_sym, spb))
        y = y[..., self.cp_size:]
        # Pruned forward DFT straight to the used bins in data order:
        # one (fft_size, num_used) matmul instead of the full DFT plus
        # slice+concatenate unmapping; the power unscale is folded in.
        wf = self._pruned_dft(y.dtype)
        data = cplx.matmul(y, wf, precision=self.precision)
        out = data.reshape(batch + (n_sym * self.num_used_subcarriers,))
        return out.to_numpy() if host else out


class OfdmOneTapEqualizer:
    """Per-subcarrier division by the (time-averaged) channel frequency
    response — the standard OFDM one-tap equalizer (ofdm.py:469-552)."""

    def __init__(self, ofdm_obj: OFDM) -> None:
        self._ofdm_obj = ofdm_obj

    def _equalize_data(self, data: CArray,
                       mean_freq_response: CArray) -> CArray:
        """``data``: (..., n_ofdm_symbols, num_used); ``mean_freq_response``:
        (..., n_ofdm_symbols, fft_size)."""
        o = self._ofdm_obj
        half = o.num_used_subcarriers // 2
        h = cplx.concatenate([mean_freq_response[..., o.fft_size - half:],
                              mean_freq_response[..., 1:half + 1]], axis=-1)
        return data / h

    def equalize_data(self, data, impulse_response) -> Union[CArray,
                                                             np.ndarray]:
        """Equalize demodulated OFDM data given the channel impulse
        response object (anything exposing ``get_freq_response(fft_size)``
        with output shape (..., num_samples, fft_size); the per-OFDM-symbol
        average over its samples is used, as in the reference)."""
        host = isinstance(data, np.ndarray)
        d = cplx.from_numpy(data) if host else data
        used = self._ofdm_obj.num_used_subcarriers
        batch = d.shape[:-1]
        n_sym = d.shape[-1] // used
        d = d.reshape(batch + (n_sym, used))

        # The one-tap equalizer needs the MEAN frequency response per OFDM
        # symbol. Since the DFT is linear, mean(FFT(taps)) == FFT(mean
        # (taps)): average the (cheap, sparse) impulse-response taps per
        # symbol FIRST and transform the tiny result — identical output to
        # the reference's average-of-responses (ofdm.py:515-552) at a
        # fraction of the FLOPs.
        if hasattr(impulse_response, "tap_values_sparse") and \
                impulse_response.num_samples % n_sym == 0:
            taps = impulse_response.tap_values_sparse
            spb = taps.shape[-1] // n_sym
            taps_mean = taps.reshape(taps.shape[:-1] + (n_sym, spb)) \
                .mean(axis=-1)                   # (T, ..., n_sym)
            # Sparse DFT evaluated ONLY at the used subcarrier bins, in
            # the exact order the demodulated data lays them out — skips
            # the (fft_size - num_used) unused bins AND the
            # slice+concatenate reordering pass. Runs at the OFDM
            # object's matmul precision.
            o = self._ofdm_obj
            idx = impulse_response.tap_indexes_sparse
            bins = o.get_used_subcarrier_indexes() % o.fft_size
            phase = (-2.0 * np.pi / o.fft_size) * np.outer(idx, bins)
            keep = (idx < o.fft_size)[:, None]
            w = CArray(jnp.asarray(np.cos(phase) * keep,
                                   taps_mean.dtype),
                       jnp.asarray(np.sin(phase) * keep,
                                   taps_mean.dtype))        # (T, used)
            perm = tuple(range(1, taps_mean.ndim)) + (0,)
            tvt = taps_mean.transpose(perm)      # (..., n_sym, T)
            h = cplx.matmul(tvt, w, precision=o.precision)
            eq = d / h
            eq = eq.reshape(batch + (n_sym * used,))
            return eq.to_numpy() if host else eq
        else:
            freq = impulse_response.get_freq_response(
                self._ofdm_obj.fft_size)
            if isinstance(freq, np.ndarray):
                freq = cplx.from_numpy(freq)
            # (..., num_samples, fft) -> (..., n_sym, spb, fft) -> mean
            fshape = freq.shape
            freq = freq.reshape(fshape[:-2] + (n_sym, fshape[-2] // n_sym,
                                               fshape[-1]))
            mean_freq = freq.mean(axis=-2)
        eq = self._equalize_data(d, mean_freq)
        eq = eq.reshape(batch + (n_sym * used,))
        return eq.to_numpy() if host else eq
