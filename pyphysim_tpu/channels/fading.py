"""Tapped-delay-line fading channels.

JAX-native counterpart of the reference ``pyphysim/channels/fading.py``:

  * :class:`TdlChannelProfile` — tap powers/delays, mean excess delay, RMS
    delay spread, discretization to a sample grid (merge coincident taps,
    renormalize — fading.py:239-304), COST259 standard profiles
    (3GPP TR 25.943, fading.py:323-353). Host-side numpy: this is static
    configuration computed once.
  * :class:`TdlImpulseResponse` — sparse tap values as a CArray
    (``(num_sparse_taps,) [+ (Nr, Nt)] + (num_samples,)``) with static
    integer tap indexes; frequency response via the matmul-DFT over the
    delay axis (reference: numpy FFT at fading.py:513-536).
  * :class:`TdlChannel` / :class:`TdlMimoChannel` — the core channel op.
    ``corrupt_data`` generates a per-symbol impulse response and applies
    the time-varying FIR. The reference loops over taps with a Python
    slice-accumulate (fading.py:1084-1118); here each sparse tap
    contributes one shifted fused multiply-add over the whole signal
    (static unrolled over the ~15 nonzero taps -> one XLA fusion), and the
    MIMO case contracts over transmit antennas with an einsum that lands on
    the matrix units. ``corrupt_data_in_freq_domain`` implements the block-static
    channel path (one impulse response per fft block, channel "skipped"
    fft_size-1 samples between blocks — fading.py:1126-1287) with ALL
    blocks generated in one batched closed-form Jakes evaluation (no
    sequential per-block loop: t enters analytically).

State is explicit: channel methods take and return generator state, so the
whole chain jits/vmaps. Stateful reference-style convenience (no state
argument) is provided on top for host-side use.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import cplx
from ..ops import fft as cfft
from ..ops.cplx import CArray
from ..utils.conversion import dB2Linear, linear2dB
from .fading_generators import (FadingSampleGenerator, JakesSampleGenerator,
                                RayleighSampleGenerator)

__all__ = ["TdlChannelProfile", "TdlImpulseResponse", "TdlChannel",
           "TdlMimoChannel", "COST259_TUx", "COST259_RAx", "COST259_HTx"]


class TdlChannelProfile:
    """Power-delay profile of a TDL channel (host-side configuration)."""

    def __init__(self, tap_powers_dB: Optional[np.ndarray] = None,
                 tap_delays: Optional[np.ndarray] = None,
                 name: str = "custom") -> None:
        self._name = name
        if tap_powers_dB is None and tap_delays is None:
            tap_powers_dB = np.zeros(1)
            tap_delays = np.zeros(1)
        self._tap_powers_dB = np.asarray(tap_powers_dB, dtype=float)
        self._tap_powers_linear = dB2Linear(self._tap_powers_dB)
        self._tap_delays = np.asarray(tap_delays, dtype=float)
        self._num_taps = self._tap_delays.size

        p, d = self._tap_powers_linear, self._tap_delays
        self._mean_excess_delay = float(np.sum(p * d) / np.sum(p))
        aux = float(np.sum(p * d ** 2) / np.sum(p))
        self._rms_delay_spread = math.sqrt(
            max(aux - self._mean_excess_delay ** 2, 0.0))
        self._Ts: Optional[float] = None

    # -- properties --------------------------------------------------------

    @property
    def name(self) -> str:
        return self._name

    @property
    def tap_powers_dB(self) -> np.ndarray:
        return self._tap_powers_dB

    @property
    def tap_powers_linear(self) -> np.ndarray:
        return self._tap_powers_linear

    @property
    def tap_delays(self) -> np.ndarray:
        return self._tap_delays

    @property
    def num_taps(self) -> int:
        return self._num_taps

    @property
    def mean_excess_delay(self) -> float:
        return self._mean_excess_delay

    @property
    def rms_delay_spread(self) -> float:
        return self._rms_delay_spread

    @property
    def Ts(self) -> Optional[float]:
        return self._Ts

    @property
    def is_discretized(self) -> bool:
        return self._Ts is not None

    @property
    def num_taps_with_padding(self) -> int:
        """Total tap span including zero taps (only for discretized
        profiles, where delays are integer sample indexes)."""
        if not self.is_discretized:
            raise RuntimeError(
                "num_taps_with_padding is only defined for discretized "
                "profiles")
        return int(self._tap_delays[-1]) + 1

    # -- discretization ----------------------------------------------------

    def get_discretize_profile(self, Ts: float) -> "TdlChannelProfile":
        """Round delays to the ``Ts`` grid, merge coincident taps, and
        renormalize total power to 1 (fading.py:239-304)."""
        if self.is_discretized:
            raise RuntimeError("Trying to discretize a TdlChannelProfile "
                               "object that is already discretized.")
        delay_idx, inverse = np.unique(
            np.round(self._tap_delays / Ts).astype(int).ravel(),
            return_inverse=True)
        powers = np.zeros(delay_idx.size)
        for i, p in enumerate(self._tap_powers_linear):
            powers[inverse[i]] += p
        powers /= powers.sum()
        prof = TdlChannelProfile(linear2dB(powers), delay_idx,
                                 f"{self.name} (discretized)")
        prof._Ts = Ts
        return prof

    def __repr__(self) -> str:
        return (f"<TdlChannelProfile: '{self.name}' "
                f"({self.num_taps} taps)>")


# 3GPP TR 25.943 standard profiles (public spec constants)
COST259_TUx = TdlChannelProfile(
    np.array([-5.7, -7.6, -10.1, -10.2, -10.2, -11.5, -13.4, -16.3, -16.9,
              -17.1, -17.4, -19.0, -19.0, -19.8, -21.5, -21.6, -22.1, -22.6,
              -23.5, -24.3]),
    np.array([0, 217, 512, 514, 517, 674, 882, 1230, 1287, 1311, 1349, 1533,
              1535, 1622, 1818, 1836, 1884, 1943, 2048, 2140]) * 1e-9,
    "COST259_TU")

COST259_RAx = TdlChannelProfile(
    np.array([-5.2, -6.4, -8.4, -9.3, -10.0, -13.1, -15.3, -18.5, -20.4,
              -22.4]),
    np.array([0., 42., 101., 129., 149., 245., 312., 410., 469., 528.])
    * 1e-9, "COST259_RA")

COST259_HTx = TdlChannelProfile(
    np.array([-3.6, -8.9, -10.2, -11.5, -11.8, -12.7, -13.0, -16.2, -17.3,
              -17.7, -17.6, -22.7, -24.1, -25.8, -25.8, -26.2, -29.0, -29.9,
              -30.0, -30.7]),
    np.array([0., 356., 441., 528., 546., 609., 625., 842., 916., 941.,
              15000., 16172., 16492., 16876., 16882., 16978., 17615.,
              17827., 17849., 18016.]) * 1e-9, "COST259_HT")


class TdlImpulseResponse:
    """Impulse response samples of a (discretized) TDL channel.

    ``tap_values_sparse``: CArray of shape
    ``(num_sparse_taps,) [+ (Nr, Nt)] + (num_samples,)``;
    tap positions come from the (static) discretized profile.
    """

    def __init__(self, tap_values: CArray,
                 channel_profile: TdlChannelProfile) -> None:
        if not channel_profile.is_discretized:
            raise RuntimeError("TdlImpulseResponse requires a discretized "
                               "channel profile")
        self._tap_values_sparse = tap_values
        self._channel_profile = channel_profile

    # -- properties --------------------------------------------------------

    @property
    def channel_profile(self) -> TdlChannelProfile:
        return self._channel_profile

    @property
    def tap_values_sparse(self) -> CArray:
        return self._tap_values_sparse

    @property
    def tap_indexes_sparse(self) -> np.ndarray:
        """Static integer delay indexes of the nonzero taps."""
        return self._channel_profile.tap_delays.astype(int)

    @property
    def Ts(self) -> Optional[float]:
        return self._channel_profile.Ts

    @property
    def num_samples(self) -> int:
        return self._tap_values_sparse.shape[-1]

    @property
    def tap_values(self) -> CArray:
        """Dense tap values including zero taps:
        shape ``(num_taps_with_padding,) + rest``."""
        D = self._channel_profile.num_taps_with_padding
        shape = (D,) + self._tap_values_sparse.shape[1:]
        dense = cplx.zeros(shape, self._tap_values_sparse.dtype)
        idx = self.tap_indexes_sparse
        return dense.at_set((idx,), self._tap_values_sparse)

    def get_freq_response(self, fft_size: int) -> CArray:
        """Frequency response via the matmul-DFT over the delay axis.

        Returns shape ``(..., num_samples, fft_size)`` — note the device-native
        convention puts the frequency axis LAST (the reference returns
        ``fft_size x ... x num_samples``, fading.py:513-536); last-axis
        transforms are what the matrix units want.
        """
        # Build (num_samples, ..., sparse_taps) by moving axes, then do a
        # sparse DFT: F[..., k] = sum_i tap_i * exp(-2j pi k d_i / N).
        # Taps beyond fft_size are DROPPED (numpy fft truncation semantics,
        # matching the reference's np.fft.fft(dense, fft_size, axis=0)).
        idx = self.tap_indexes_sparse
        tv = self._tap_values_sparse  # (taps, ..., num_samples)
        # move taps axis last: (..., num_samples, taps)
        perm = tuple(range(1, tv.ndim)) + (0,)
        tvt = tv.transpose(perm)
        # sparse DFT matrix (taps, fft_size) built host-side; rows for
        # out-of-range taps are zero (truncation).
        k = np.arange(fft_size)
        phase = -2.0 * np.pi / fft_size * np.outer(idx, k)
        keep = (idx < fft_size)[:, None]
        w = CArray(jnp.asarray(np.cos(phase) * keep, tv.dtype),
                   jnp.asarray(np.sin(phase) * keep, tv.dtype))
        return cplx.matmul(tvt, w, precision=jax.lax.Precision.HIGHEST)

    @property
    def tap_delays_sparse(self) -> np.ndarray:
        """Tap delays in seconds (multiples of Ts;
        parity: fading.py:430-440)."""
        return self.tap_indexes_sparse * self.Ts

    def plot_impulse_response(self) -> None:  # pragma: no cover
        """3-D plot |tap| over (delay, time) (parity: fading.py:584-619)."""
        import matplotlib.pyplot as plt
        fig = plt.figure()
        ax = fig.add_subplot(111, projection="3d")
        dense = np.abs(cplx.to_numpy(self.tap_values))
        x = np.arange(dense.shape[0])
        for i in range(self.num_samples):
            ax.plot(x, np.full(dense.shape[0], i), dense[..., i].reshape(
                dense.shape[0], -1)[:, 0])
        ax.set_xlabel("Taps (delay domain)")
        ax.set_ylabel("Time Domain")
        ax.set_zlabel("Channel Amplitude")
        plt.show()

    def plot_frequency_response(self, fft_size: int) -> None:  # pragma: no cover
        """3-D plot |H(f)| over (frequency, time)
        (parity: fading.py:621-652)."""
        import matplotlib.pyplot as plt
        fig = plt.figure()
        ax = fig.add_subplot(111, projection="3d")
        fr = np.abs(cplx.to_numpy(self.get_freq_response(fft_size)))
        # our convention: (..., num_samples, fft_size)
        fr2 = fr.reshape(-1, self.num_samples, fft_size)[0]
        x = np.arange(fft_size)
        for i in range(self.num_samples):
            ax.plot(x, np.full(fft_size, i), fr2[i])
        ax.set_xlabel("Frequency (FFT bins)")
        ax.set_ylabel("Time Domain")
        ax.set_zlabel("Channel Amplitude")
        plt.show()

    def __mul__(self, value: float) -> "TdlImpulseResponse":
        return TdlImpulseResponse(self._tap_values_sparse * value,
                                  self._channel_profile)

    __rmul__ = __mul__

    @staticmethod
    def concatenate_samples(
            responses: List["TdlImpulseResponse"]) -> "TdlImpulseResponse":
        """Concatenate along the sample (last) axis (fading.py:654-698)."""
        if len(responses) == 1:
            return responses[0]
        prof = responses[0].channel_profile
        values = cplx.concatenate(
            [r.tap_values_sparse for r in responses], axis=-1)
        return TdlImpulseResponse(values, prof)

    # -- pytree protocol -----------------------------------------------------

    def _tree_flatten(self):
        return (self._tap_values_sparse,), self._channel_profile

    @classmethod
    def _tree_unflatten(cls, profile, children):
        obj = cls.__new__(cls)
        obj._tap_values_sparse = children[0]
        obj._channel_profile = profile
        return obj


# Registered as a pytree (tap values = dynamic leaf, profile = static aux)
# so impulse responses flow through jit/vmap/scan — e.g. the vectorized
# MuChannel vmaps one TdlChannel over all K^2 links and gets the per-link
# responses back as ONE stacked TdlImpulseResponse.
jax.tree_util.register_pytree_node(
    TdlImpulseResponse,
    lambda ir: ir._tree_flatten(),
    TdlImpulseResponse._tree_unflatten)


class TdlChannel:
    """Tapped-delay-line channel (functional core + stateful convenience).

    Functional API (jit/vmap-safe):
      * ``state = channel.init_state(key)``
      * ``ir, state = channel.generate_impulse_response_f(state, n)``
      * ``out, ir, state = channel.corrupt_data(state, signal)``
      * ``out, ir, state = channel.corrupt_data_in_freq_domain(state,
        signal, fft_size, carrier_indexes)``

    Stateful convenience (host-side, reference-style): call
    ``corrupt_data(signal)`` with a single argument — an internal state is
    created (seed via :meth:`seed`) and threaded automatically.
    """

    def __init__(self, fading_generator: FadingSampleGenerator,
                 channel_profile: Optional[TdlChannelProfile] = None,
                 tap_powers_dB: Optional[np.ndarray] = None,
                 tap_delays: Optional[np.ndarray] = None,
                 Ts: Optional[float] = None) -> None:
        if isinstance(fading_generator, JakesSampleGenerator):
            if Ts is None:
                Ts = fading_generator.Ts
            elif Ts != fading_generator.Ts:
                raise RuntimeError(
                    "The provided sampling interval Ts is different from "
                    "the one in the Jakes sample generator.")

        if channel_profile is None:
            channel_profile = TdlChannelProfile(tap_powers_dB, tap_delays)

        if not channel_profile.is_discretized:
            if isinstance(fading_generator,
                          RayleighSampleGenerator) and Ts is None:
                Ts = 1.0
            if Ts is None:
                raise RuntimeError(
                    "You must provide the Ts argument (or use a Jakes "
                    "generator carrying it) to discretize the profile")
            channel_profile = channel_profile.get_discretize_profile(Ts)
        elif Ts is not None and channel_profile.Ts != Ts:
            raise RuntimeError(
                "Channel profile is already discretized, but it does not "
                "agree with the provided Ts")

        self._channel_profile = channel_profile
        self._fading_generator = fading_generator
        self._set_fading_generator_shape(fading_generator.shape)

        self.switched_direction = False
        self._last_impulse_response: Optional[TdlImpulseResponse] = None
        self._state = None
        self._seed_key = jax.random.PRNGKey(0)

    # -- shape management --------------------------------------------------

    def _set_fading_generator_shape(self, shape) -> None:
        """The generator's first axis must be the (sparse) tap count;
        MIMO channels add (Nr, Nt)."""
        n = self.num_taps
        if shape is None:
            self._fading_generator.shape = (n,)
        elif len(shape) == 2:
            self._fading_generator.shape = (n,) + tuple(shape)
        elif len(shape) in (1, 3) and shape[0] == n:
            self._fading_generator.shape = tuple(shape)
        else:
            raise ValueError(
                f"Invalid fading generator shape {shape} for a channel "
                f"with {n} taps: pass None (SISO) or (Nr, Nt) (MIMO)")

    def set_num_antennas(self, num_rx_antennas: Optional[int],
                         num_tx_antennas: Optional[int]) -> None:
        if num_rx_antennas is None and num_tx_antennas is None:
            self._set_fading_generator_shape(None)
        else:
            self._set_fading_generator_shape(
                (num_rx_antennas, num_tx_antennas))

    # -- properties --------------------------------------------------------

    @property
    def channel_profile(self) -> TdlChannelProfile:
        return self._channel_profile

    @property
    def num_taps(self) -> int:
        """Number of NONZERO (sparse) taps."""
        return self._channel_profile.num_taps

    @property
    def num_taps_with_padding(self) -> int:
        return self._channel_profile.num_taps_with_padding

    @property
    def num_tx_antennas(self) -> Optional[int]:
        shape = self._fading_generator.shape
        return shape[2] if len(shape) == 3 else None

    @property
    def num_rx_antennas(self) -> Optional[int]:
        shape = self._fading_generator.shape
        return shape[1] if len(shape) == 3 else None

    # -- functional API ----------------------------------------------------

    def init_state(self, key: jax.Array):
        return self._fading_generator.init_state(key)

    def generate_impulse_response_f(
            self, state, num_samples: int = 1
    ) -> Tuple[TdlImpulseResponse, object]:
        """Generate ``num_samples`` per-sample impulse responses: fading
        samples scaled by sqrt(tap power) (fading.py:908-960)."""
        samples, state = self._fading_generator.generate(state, num_samples)
        powers = self._channel_profile.tap_powers_linear
        bshape = (self.num_taps,) + (1,) * (samples.ndim - 1)
        scale = jnp.asarray(np.sqrt(powers).reshape(bshape),
                            samples.dtype)
        ir = TdlImpulseResponse(
            CArray(samples.re * scale, samples.im * scale),
            self._channel_profile)
        return ir, state

    def corrupt_data(self, state_or_signal, signal=None,
                     block_size: Optional[int] = None):
        """Time-domain transmission through the time-varying channel.

        Functional form ``corrupt_data(state, signal)`` returns
        ``(output, impulse_response, new_state)``; convenience form
        ``corrupt_data(signal)`` threads the internal state and returns
        only the output (reference-style).

        ``block_size``: when given, the channel is held constant over
        blocks of that many samples (block-static evolution — one Jakes
        evaluation per block instead of per sample). Physically justified
        whenever ``block_size * Ts`` is far below the coherence time
        (e.g. one OFDM symbol at moderate Doppler); the default (None)
        generates per-sample responses exactly like the reference
        (fading.py:1071).

        SISO: signal ``(N,)`` -> output ``(N + memory,)``.
        MIMO: signal ``(Nt, N)`` -> output ``(Nr, N + memory)``
        (reversed when ``switched_direction``).
        """
        if signal is None or isinstance(signal, int):
            if isinstance(signal, int):
                block_size = signal
            signal = state_or_signal
            state = self._ensure_state()
            out, ir, new_state = self._corrupt_data_impl(state, signal,
                                                         block_size)
            self._state = new_state
            self._last_impulse_response = ir
            return cplx.to_host_like(out, signal)
        return self._corrupt_data_impl(state_or_signal, signal, block_size)

    def _generate_ir_maybe_block_static(self, state, num_symbols: int,
                                        block_size: Optional[int]):
        """Per-sample IR, or block-static IR expanded to per-sample taps
        (the expansion is a cheap broadcast; the Jakes trig shrinks by a
        factor of ``block_size``)."""
        if block_size is None:
            return self.generate_impulse_response_f(state, num_symbols)
        if num_symbols % block_size != 0:
            raise ValueError(
                "block_size must divide the number of transmitted samples")
        num_blocks = num_symbols // block_size
        ir_block, state = self._generate_strided_impulse_response(
            state, num_blocks, stride=block_size)
        taps = ir_block.tap_values_sparse  # (..., num_blocks)
        shape = taps.shape[:-1] + (num_symbols,)
        taps_full = CArray(
            jnp.broadcast_to(taps.re[..., :, None],
                             taps.shape + (block_size,)).reshape(shape),
            jnp.broadcast_to(taps.im[..., :, None],
                             taps.shape + (block_size,)).reshape(shape))
        return TdlImpulseResponse(taps_full, self._channel_profile), state

    def _corrupt_data_impl(self, state, signal: CArray,
                           block_size: Optional[int] = None):
        signal = cplx.carray(signal)
        num_symbols = signal.shape[-1]
        mimo = len(self._fading_generator.shape) == 3
        if block_size is not None and not mimo:
            # SISO block-static fast path: per-block frequency-domain
            # overlap-add convolution (one DFT matmul pair per block on
            # the matrix units; reads the signal once instead of once per tap).
            if num_symbols % block_size != 0:
                raise ValueError(
                    "block_size must divide the number of transmitted "
                    "samples")
            num_blocks = num_symbols // block_size
            ir_block, state = self._generate_strided_impulse_response(
                state, num_blocks, stride=block_size)
            out = tdl_filter_block_fft(ir_block, signal, block_size)
            return out, ir_block, state
        ir, state = self._generate_ir_maybe_block_static(
            state, num_symbols, block_size)
        out = tdl_filter(ir, signal,
                         switched_direction=self.switched_direction)
        return out, ir, state

    def corrupt_data_in_freq_domain(self, state_or_signal, signal=None,
                                    fft_size: Optional[int] = None,
                                    carrier_indexes=None):
        """Block-static frequency-domain transmission (fading.py:1126-1287).

        The channel is constant over each block of ``block_size`` symbols
        (one impulse response per block, generator then skips
        ``fft_size - 1`` samples). ALL blocks' responses are generated in
        one batched evaluation — no sequential loop — because Jakes time
        enters in closed form.

        Functional form: ``corrupt_data_in_freq_domain(state, signal,
        fft_size, carrier_indexes)`` -> (output, impulse_response, state).
        """
        if signal is None or isinstance(signal, int):
            # convenience form: (signal, fft_size, carrier_indexes)
            carrier_indexes = fft_size if signal is not None else \
                carrier_indexes
            fft_size_c = signal if signal is not None else fft_size
            sig = state_or_signal
            state = self._ensure_state()
            out, ir, new_state = self._corrupt_freq_impl(
                state, cplx.carray(sig), fft_size_c, carrier_indexes)
            self._state = new_state
            self._last_impulse_response = ir
            return cplx.to_host_like(out, sig)
        return self._corrupt_freq_impl(state_or_signal, cplx.carray(signal),
                                       fft_size, carrier_indexes)

    def _corrupt_freq_impl(self, state, signal: CArray, fft_size: int,
                           carrier_indexes):
        num_symbols = signal.shape[-1]
        if carrier_indexes is None:
            block_size = fft_size
            carriers = np.arange(fft_size)
        else:
            carriers = np.asarray(carrier_indexes)
            block_size = carriers.size
        if num_symbols % block_size != 0:
            raise ValueError(
                "The number of elements in `signal` must be a multiple of "
                "the number of sent elements per `fft_size`")
        num_blocks = num_symbols // block_size

        # Impulse response for all blocks at once: block b sees the channel
        # at time t_b = t0 + b * fft_size * Ts. We generate them by
        # temporarily 'striding' the generator: generate num_blocks samples
        # with an effective Ts of fft_size*Ts. For a Jakes generator this
        # is exact (closed form in t); for Rayleigh it is iid either way.
        ir, state = self._generate_strided_impulse_response(
            state, num_blocks, stride=fft_size)

        # Frequency response at the used carriers: (..., num_blocks, Nc)
        freq = ir.get_freq_response(fft_size)[..., carriers]

        mimo = len(self._fading_generator.shape) == 3
        if not mimo:
            sig_blocks = signal.reshape(signal.shape[:-1] +
                                        (num_blocks, block_size))
            out = sig_blocks * freq
            out = out.reshape(signal.shape[:-1] + (num_symbols,))
        else:
            # signal (Nt, N) -> blocks (Nt, B, S); freq (B, Nc=S, Nr, Nt)?
            # freq shape: tap values (taps, Nr, Nt, B) -> freq (Nr, Nt, B, S)
            sig_blocks = signal.reshape((signal.shape[0], num_blocks,
                                         block_size))
            if self.switched_direction:
                # uplink: signal is per-rx; output per tx antenna
                out = cplx.einsum("rtbs,rbs->tbs", freq, sig_blocks)
            else:
                out = cplx.einsum("rtbs,tbs->rbs", freq, sig_blocks)
            out = out.reshape((out.shape[0], num_symbols))
        return out, ir, state

    def _generate_strided_impulse_response(self, state, num_blocks: int,
                                           stride: int):
        """One impulse response per block, blocks ``stride`` samples apart
        in channel time."""
        gen = self._fading_generator
        if isinstance(gen, JakesSampleGenerator):
            # Closed form z_b = exp(j(w(t0 + b stride Ts) + psi)):
            # evaluate the trig DIRECTLY for every block. Measured faster
            # than rolling powers out with an associative scan of complex
            # products (0.128 vs 0.166 ms at the bench point): the scan's
            # log2(B) passes are memory-bound while the vector units eat the
            # transcendentals in one pass.
            from .fading_generators import JakesState
            w = 2.0 * np.pi * gen.Fd * jnp.cos(state.phi_l[..., 0])
            t = state.t0 + jnp.arange(num_blocks) * (stride * gen.Ts)
            phase = w[..., None] * t + state.psi_l[..., 0][..., None]
            h = cplx.cexp(phase)                     # (L, taps, num_blocks)
            scale = math.sqrt(1.0 / gen.L)
            samples = CArray(jnp.sum(h.re, axis=0) * scale,
                             jnp.sum(h.im, axis=0) * scale)
            new_state = JakesState(
                phi_l=state.phi_l, psi_l=state.psi_l,
                t0=state.t0 + num_blocks * stride * gen.Ts)
            powers = self._channel_profile.tap_powers_linear
            bshape = (self.num_taps,) + (1,) * (samples.ndim - 1)
            pscale = jnp.asarray(np.sqrt(powers).reshape(bshape),
                                 samples.dtype)
            ir = TdlImpulseResponse(
                CArray(samples.re * pscale, samples.im * pscale),
                self._channel_profile)
            return ir, new_state
        # Rayleigh (memoryless): stride is irrelevant.
        return self.generate_impulse_response_f(state, num_blocks)

    # -- stateful convenience ---------------------------------------------

    def seed(self, key_or_int) -> None:
        """Set the PRNG key for the stateful convenience API."""
        if isinstance(key_or_int, int):
            key_or_int = jax.random.PRNGKey(key_or_int)
        self._seed_key = key_or_int
        self._state = None

    def _ensure_state(self):
        if self._state is None:
            self._state = self.init_state(self._seed_key)
        return self._state

    def generate_impulse_response(self, num_samples: int = 1) -> None:
        """Stateful form (reference API): generates and stores the last
        impulse response."""
        state = self._ensure_state()
        ir, self._state = self.generate_impulse_response_f(state,
                                                           num_samples)
        self._last_impulse_response = ir

    def get_last_impulse_response(self) -> Optional[TdlImpulseResponse]:
        return self._last_impulse_response


def tdl_filter_block_fft(ir_block: TdlImpulseResponse, signal: CArray,
                         block_size: int) -> CArray:
    """Block-static SISO TDL filtering via per-block frequency-domain
    convolution (overlap-add).

    Within a block the channel is constant, so the block's contribution is
    a linear convolution of its ``block_size`` samples with the dense
    ``D``-tap kernel. Computed exactly as a circular convolution of length
    ``block_size + D - 1`` using the matmul-DFT, then overlap-added
    across block boundaries (the ``D - 1``-sample halo). Identical output
    to :func:`tdl_filter` with per-block-constant taps, at a fraction of
    the device-memory traffic (the per-tap shifted-add materializes the signal once
    per tap).

    ``ir_block``: sparse taps (T, num_blocks). ``signal``: (N,). Returns
    (N + D - 1,).
    """
    idx = ir_block.tap_indexes_sparse
    taps = ir_block.tap_values_sparse            # (T, nb)
    D = int(idx[-1]) + 1
    n = signal.shape[-1]
    nb = n // block_size
    # circular length >= linear-conv length, rounded up to a multiple
    # of 128 (aligned DFT matmul shapes)
    L = ((block_size + D - 1 + 127) // 128) * 128

    x_blocks = signal.reshape(nb, block_size)
    # per-block frequency-domain circular convolution
    X = cfft.fft(x_blocks, n=L,
                 precision=jax.lax.Precision.DEFAULT)        # (nb, L)
    # Kernel spectrum straight from the sparse taps — computed in the
    # SIGNAL dtype: with a bfloat16 signal path the product and the big
    # inverse-DFT matmul then stay bf16 instead of silently promoting to
    # f32.
    dt = signal.dtype
    k = np.arange(L)
    phase = -2.0 * np.pi / L * np.outer(idx, k)
    w = CArray(jnp.asarray(np.cos(phase), dt),
               jnp.asarray(np.sin(phase), dt))               # (T, L)
    H = cplx.matmul(taps.astype(dt).swapaxes(-1, -2), w)     # (nb, L)
    Y = X * H
    y = cfft.ifft(Y, precision=jax.lax.Precision.DEFAULT)    # (nb, L)

    # Overlap-add: block b's tail (D-1 samples) lands at the head of
    # block b+1 — a narrow strip update on the blocked view, then one
    # concatenate for the final tail. (A full-width padded-tail add costs
    # several whole-array passes; this touches only nb x (D-1) values.)
    if block_size < D - 1:
        raise ValueError("block_size must be at least the channel span")
    main = y[..., :block_size]                               # (nb, bs)
    tail = y[..., block_size:block_size + D - 1]             # (nb, D-1)
    main_re = main.re.at[1:, :D - 1].add(tail.re[:-1])
    main_im = main.im.at[1:, :D - 1].add(tail.im[:-1])
    out_re = jnp.concatenate([main_re.reshape(nb * block_size),
                              tail.re[-1]])
    out_im = jnp.concatenate([main_im.reshape(nb * block_size),
                              tail.im[-1]])
    return CArray(out_re, out_im)


def tdl_filter_block_fft_mimo(ir_block: TdlImpulseResponse,
                              signal: CArray, block_size: int) -> CArray:
    """MIMO variant of :func:`tdl_filter_block_fft`.

    ``ir_block``: sparse taps (T, Nr, Nt, num_blocks); ``signal``:
    (Nt, N). Returns (Nr, N + D - 1). Per block the rx signal is
    ``sum_t conv(x_t, h_{r,t})`` — computed as a frequency-domain product
    contracted over transmit antennas.
    """
    idx = ir_block.tap_indexes_sparse
    taps = ir_block.tap_values_sparse            # (T, Nr, Nt, nb)
    D = int(idx[-1]) + 1
    nt, n = signal.shape
    nb = n // block_size
    nr = taps.shape[1]
    L = ((block_size + D - 1 + 127) // 128) * 128

    x_blocks = signal.reshape(nt, nb, block_size)
    X = cfft.fft(x_blocks, n=L,
                 precision=jax.lax.Precision.DEFAULT)        # (Nt, nb, L)
    k = np.arange(L)
    phase = -2.0 * np.pi / L * np.outer(idx, k)
    w = CArray(jnp.asarray(np.cos(phase), taps.dtype),
               jnp.asarray(np.sin(phase), taps.dtype))       # (T, L)
    # H[r, t, b, k] = sum_i taps[i, r, t, b] w[i, k]
    H = cplx.einsum("irtb,ik->rtbk", taps, w)                # (Nr,Nt,nb,L)
    # Y[r, b, k] = sum_t H[r, t, b, k] X[t, b, k]
    Y = cplx.einsum("rtbk,tbk->rbk", H, X)
    y = cfft.ifft(Y, precision=jax.lax.Precision.DEFAULT)    # (Nr, nb, L)

    if block_size < D - 1:
        raise ValueError("block_size must be at least the channel span")
    main = y[..., :block_size]                               # (Nr, nb, bs)
    tail = y[..., block_size:block_size + D - 1]             # (Nr, nb, D-1)
    main_re = main.re.at[:, 1:, :D - 1].add(tail.re[:, :-1])
    main_im = main.im.at[:, 1:, :D - 1].add(tail.im[:, :-1])
    out_re = jnp.concatenate([main_re.reshape(nr, nb * block_size),
                              tail.re[:, -1]], axis=-1)
    out_im = jnp.concatenate([main_im.reshape(nr, nb * block_size),
                              tail.im[:, -1]], axis=-1)
    return CArray(out_re, out_im)


def tdl_filter(ir: TdlImpulseResponse, signal: CArray,
               switched_direction: bool = False) -> CArray:
    """Apply the (time-varying) sparse FIR defined by an impulse response.

    out[m] = sum_i h_{d_i}[m - d_i] * x[m - d_i] — each sparse tap is one
    shifted fused multiply-add over the whole signal; the tap loop unrolls
    statically (~15 taps for COST259 TU) into a single XLA fusion.

    SISO: ir taps (T, N), signal (N,) -> (N + memory,)
    MIMO: ir taps (T, Nr, Nt, N), signal (Nt, N) -> (Nr, N + memory)
    """
    idx = ir.tap_indexes_sparse
    taps = ir.tap_values_sparse
    memory = int(idx[-1])
    n = signal.shape[-1]
    mimo = taps.ndim == 4

    if not mimo:
        prod = CArray(taps.re * signal.re[None, :] -
                      taps.im * signal.im[None, :],
                      taps.re * signal.im[None, :] +
                      taps.im * signal.re[None, :])        # (T, N)
        out_re = jnp.zeros(n + memory, signal.dtype)
        out_im = jnp.zeros(n + memory, signal.dtype)
        for i, d in enumerate(idx):
            d = int(d)
            out_re = out_re.at[d:d + n].add(prod.re[i])
            out_im = out_im.at[d:d + n].add(prod.im[i])
        return CArray(out_re, out_im)

    if switched_direction:
        raise NotImplementedError(
            "switched_direction uplink is handled by TdlMimoChannel "
            "transposing the impulse response")
    # MIMO: contract over tx antennas per tap:
    # prod[i, r, m] = sum_t taps[i, r, t, m] * x[t, m]
    prod = cplx.einsum("irtm,tm->irm", taps, signal)
    nr = prod.shape[1]
    out_re = jnp.zeros((nr, n + memory), signal.dtype)
    out_im = jnp.zeros((nr, n + memory), signal.dtype)
    for i, d in enumerate(idx):
        d = int(d)
        out_re = out_re.at[:, d:d + n].add(prod.re[i])
        out_im = out_im.at[:, d:d + n].add(prod.im[i])
    return CArray(out_re, out_im)


class TdlMimoChannel(TdlChannel):
    """MIMO-shaped TdlChannel (fading.py:1290-1333): same machinery with a
    (Nr, Nt) generator shape. Uplink (switched direction) transposes the
    per-tap channel matrices."""

    def __init__(self, fading_generator: FadingSampleGenerator,
                 channel_profile: Optional[TdlChannelProfile] = None,
                 tap_powers_dB: Optional[np.ndarray] = None,
                 tap_delays: Optional[np.ndarray] = None,
                 Ts: Optional[float] = None) -> None:
        if fading_generator.shape is None or \
                len(fading_generator.shape) != 2:
            raise RuntimeError(
                "The provided fading_generator for TdlMimoChannel must "
                "have a shape of (num_rx_antennas, num_tx_antennas)")
        super().__init__(fading_generator, channel_profile, tap_powers_dB,
                         tap_delays, Ts)

    def _corrupt_data_impl(self, state, signal: CArray,
                           block_size: Optional[int] = None):
        signal = cplx.carray(signal)
        num_symbols = signal.shape[-1]
        if block_size is not None:
            if num_symbols % block_size != 0:
                raise ValueError(
                    "block_size must divide the number of transmitted "
                    "samples")
            nb = num_symbols // block_size
            ir_block, state = self._generate_strided_impulse_response(
                state, nb, stride=block_size)
            taps = ir_block.tap_values_sparse
            if self.switched_direction:
                taps = taps.transpose(0, 2, 1, 3)
                ir_use = TdlImpulseResponse(taps, self._channel_profile)
            else:
                ir_use = ir_block
            out = tdl_filter_block_fft_mimo(ir_use, signal, block_size)
            return out, ir_block, state
        ir, state = self.generate_impulse_response_f(state, num_symbols)
        if self.switched_direction:
            # uplink: use H^T per tap (swap rx/tx axes of the taps)
            taps_t = ir.tap_values_sparse.transpose(0, 2, 1, 3)
            ir_t = TdlImpulseResponse(taps_t, self._channel_profile)
            out = tdl_filter(ir_t, signal)
        else:
            out = tdl_filter(ir, signal)
        return out, ir, state
