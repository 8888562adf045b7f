"""Multiuser channels: TDL interference grids and flat-fading block
channel matrices.

Behavioral counterpart of ``pyphysim/channels/multiuser.py``:

  * :class:`MuChannel` / :class:`MuMimoChannel` — a (Krx x Ktx) grid of
    independent :class:`~.singleuser.SuChannel` objects; ``corrupt_data``
    sums interference across transmitters per receiver
    (multiuser.py:42-579), per-link path loss matrix.
  * :class:`MultiUserChannelMatrix` — flat-fading MIMO interference
    channel stored as ONE dense block matrix ``big_H`` (CArray) with
    per-user antenna counts; covariances (calc_Q / calc_JP_Q), per-stream
    Bkl matrices and SINRs (Cadambe2008 eq. 28), post receive filters,
    separate channel/noise PRNG keys (multiuser.py:586-2008).
  * :class:`MultiUserChannelMatrixExtInt` — adds external interference
    sources as extra zero-Rx "users" (extra big_H columns), their
    covariance, and overridden Q/SINR (multiuser.py:2011-2807).

Device-native shape: the reference stores an object-matrix-of-matrices view;
here ``big_H`` is a single dense CArray (one matmul, not K^2
small ones) and per-block views are static host-side slices. The K-loops
in covariance/SINR computations unroll at trace time (K <= a few) into one
fused XLA program; everything jits and vmaps over realizations.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Union

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import cplx
from ..ops.cplx import CArray
from ..utils.misc import randn_c
from .fading import TdlChannelProfile
from .fading_generators import FadingSampleGenerator, RayleighSampleGenerator
from .singleuser import SuChannel

__all__ = ["MuChannel", "MuMimoChannel", "MultiUserChannelMatrix",
           "MultiUserChannelMatrixExtInt"]

IntArray = Union[int, np.ndarray]


class MuChannel:
    """TDL multiuser (interference) channel: independent SuChannels on a
    (num_rx users x num_tx users) grid."""

    def __init__(self, N: Union[int, Sequence[int]],
                 fading_generator: Optional[FadingSampleGenerator] = None,
                 channel_profile: Optional[TdlChannelProfile] = None,
                 tap_powers_dB: Optional[np.ndarray] = None,
                 tap_delays: Optional[np.ndarray] = None,
                 Ts: Optional[float] = None) -> None:
        if isinstance(N, (tuple, list)):
            num_rx, num_tx = N
        else:
            num_rx = num_tx = N
        self._num_rx_users = int(num_rx)
        self._num_tx_users = int(num_tx)
        if fading_generator is None:
            fading_generator = RayleighSampleGenerator()
            if Ts is None and channel_profile is None and \
                    tap_delays is None:
                Ts = 1.0

        self._su_channels: List[List[SuChannel]] = []
        for _ in range(self._num_rx_users):
            row = []
            for _ in range(self._num_tx_users):
                gen = fading_generator.get_similar_fading_generator()
                row.append(SuChannel(gen, channel_profile=channel_profile,
                                     tap_powers_dB=tap_powers_dB,
                                     tap_delays=tap_delays, Ts=Ts))
            self._su_channels.append(row)
        self._pathloss_matrix: Optional[np.ndarray] = None

    def __repr__(self) -> str:
        return (f"MuChannel with shape {self._num_rx_users}x"
                f"{self._num_tx_users}")

    # -- properties --------------------------------------------------------

    @property
    def num_rx_users(self) -> int:
        return self._num_rx_users

    @property
    def num_tx_users(self) -> int:
        return self._num_tx_users

    @property
    def switched_direction(self) -> bool:
        return self._su_channels[0][0].switched_direction

    @switched_direction.setter
    def switched_direction(self, value: bool) -> None:
        for row in self._su_channels:
            for ch in row:
                ch.switched_direction = value

    @property
    def channel_profile(self) -> TdlChannelProfile:
        return self._su_channels[0][0].channel_profile

    @property
    def num_taps(self) -> int:
        return self._su_channels[0][0].num_taps

    @property
    def num_taps_with_padding(self) -> int:
        return self._su_channels[0][0].num_taps_with_padding

    @property
    def num_tx_antennas(self):
        return self._su_channels[0][0].num_tx_antennas

    @property
    def num_rx_antennas(self):
        return self._su_channels[0][0].num_rx_antennas

    @property
    def pathloss_matrix(self) -> Optional[np.ndarray]:
        return self._pathloss_matrix

    def set_pathloss(self,
                     pathloss_matrix: Optional[np.ndarray] = None) -> None:
        """Per-link (rx, tx) linear path loss matrix
        (multiuser.py:256-290)."""
        self._pathloss_matrix = pathloss_matrix
        for r, row in enumerate(self._su_channels):
            for t, ch in enumerate(row):
                ch.set_pathloss(None if pathloss_matrix is None
                                else float(pathloss_matrix[r, t]))

    # -- functional API ----------------------------------------------------

    def init_state(self, key: jax.Array):
        """STACKED link states: one pytree whose leaves carry a leading
        ``(num_rx_users * num_tx_users,)`` axis (row-major over the
        (rx, tx) grid). The reference builds K^2 independent channel
        objects (multiuser.py:99-118); here the K^2 grid is ONE vmapped
        TdlChannel so `corrupt_data` traces a single XLA program instead
        of K^2 and the state is a single stacked pytree (device-native form,
        SURVEY §7)."""
        keys = jax.random.split(key,
                                self._num_rx_users * self._num_tx_users)
        base = self._base_tdl()
        return jax.vmap(base.init_state)(keys)

    def _base_tdl(self):
        """The shared per-link TdlChannel: all K^2 links are identically
        configured (same profile, generator parameters and antenna
        counts); only their states and path losses differ."""
        return self._su_channels[0][0]._tdlchannel

    def _as_stacked_states(self, states):
        """Accept legacy nested-list states (one plain list of lists with
        one pytree per link) and stack them into the leading-link-axis
        form. NamedTuple states ARE tuples, so only plain lists signal
        the legacy layout."""
        if isinstance(states, list):
            flat = [s for row in states for s in row]
            return jax.tree_util.tree_map(
                lambda *xs: jnp.stack(xs), *flat)
        return states

    def _link_pathloss_sqrt(self) -> Optional[np.ndarray]:
        if self._pathloss_matrix is None:
            return None
        return np.sqrt(np.asarray(
            self._pathloss_matrix, dtype=float)).reshape(-1)

    def _tile_signal(self, signal):
        """Stack per-tx-user signals and tile them over the rx axis so
        link ``i = r * T + t`` reads the signal of transmitter ``t``."""
        if isinstance(signal, (list, tuple)) and \
                not isinstance(signal, CArray):
            sig = cplx.stack([cplx.carray(s) for s in signal], axis=0)
        else:
            sig = cplx.carray(signal)
        reps = (self._num_rx_users,) + (1,) * (sig.re.ndim - 1)
        return CArray(jnp.tile(sig.re, reps), jnp.tile(sig.im, reps))

    def _finalize_links(self, outs: CArray, irs, new_states):
        """Apply per-link path loss, sum over transmitters, return the
        per-receiver list (multiuser.py:292-330 semantics)."""
        R, T = self._num_rx_users, self._num_tx_users
        scale = self._link_pathloss_sqrt()
        if scale is not None:
            s_out = jnp.asarray(scale, outs.re.dtype).reshape(
                (R * T,) + (1,) * (outs.re.ndim - 1))
            outs = CArray(outs.re * s_out, outs.im * s_out)
            tv = irs.tap_values_sparse  # (taps, R*T, ..., samples)
            s_ir = jnp.asarray(scale, tv.re.dtype).reshape(
                (1, R * T) + (1,) * (tv.re.ndim - 2))
            from .fading import TdlImpulseResponse
            irs = TdlImpulseResponse(CArray(tv.re * s_ir, tv.im * s_ir),
                                     irs.channel_profile)
        out_rt = outs.reshape((R, T) + outs.shape[1:])
        out_sum = CArray(out_rt.re.sum(axis=1), out_rt.im.sum(axis=1))
        out = [out_sum[r] for r in range(R)]
        return out, irs, new_states

    def corrupt_data(self, state_or_signal, signal=None):
        """``signal``: (num_tx_users, n) or list per tx user. Output:
        list per rx user of ``(n + memory,)`` CArrays summed over all
        transmitters (multiuser.py:292-330). All K^2 links run in ONE
        vmapped program."""
        if signal is None:
            signal = state_or_signal
            states = self._ensure_states()
            out, irs, new_states = self._corrupt_impl(states, signal)
            self._store_states_and_irs(new_states, irs)
            return cplx.to_host_like(out, signal)
        out, irs, states = self._corrupt_impl(state_or_signal, signal)
        return out, irs, states

    def _corrupt_impl(self, states, signal):
        states = self._as_stacked_states(states)
        base = self._base_tdl()
        sig_flat = self._tile_signal(signal)

        def link_fn(state, s):
            return base._corrupt_data_impl(state, s)

        # impulse responses come back as ONE stacked TdlImpulseResponse
        # with the link axis at position 1: (taps, R*T, ..., samples)
        outs, irs, new_states = jax.vmap(
            link_fn, out_axes=(0, 1, 0))(states, sig_flat)
        return self._finalize_links(outs, irs, new_states)

    def corrupt_data_in_freq_domain(self, state_or_signal, signal=None,
                                    fft_size=None, carrier_indexes=None):
        """Block-static frequency-domain variant (multiuser.py:332-394)."""
        if signal is None or isinstance(signal, int):
            carrier_idx = fft_size if signal is not None else carrier_indexes
            fft_size_c = signal if signal is not None else fft_size
            sig = state_or_signal
            states = self._ensure_states()
            out, irs, new_states = self._corrupt_freq_impl(
                states, sig, fft_size_c, carrier_idx)
            self._store_states_and_irs(new_states, irs)
            return cplx.to_host_like(out, sig)
        out, irs, states = self._corrupt_freq_impl(
            state_or_signal, signal, fft_size, carrier_indexes)
        return out, irs, states

    def _corrupt_freq_impl(self, states, signal, fft_size, carrier_indexes):
        states = self._as_stacked_states(states)
        base = self._base_tdl()
        sig_flat = self._tile_signal(signal)

        def link_fn(state, s):
            return base._corrupt_freq_impl(state, cplx.carray(s), fft_size,
                                           carrier_indexes)

        outs, irs, new_states = jax.vmap(
            link_fn, out_axes=(0, 1, 0))(states, sig_flat)
        return self._finalize_links(outs, irs, new_states)

    # -- stateful convenience ---------------------------------------------

    def seed(self, key_or_int) -> None:
        if isinstance(key_or_int, int):
            key_or_int = jax.random.PRNGKey(key_or_int)
        self._seed_key = key_or_int
        self._states = None

    def _ensure_states(self):
        if getattr(self, "_states", None) is None:
            self._states = self.init_state(
                getattr(self, "_seed_key", jax.random.PRNGKey(0)))
        return self._states

    def _store_states_and_irs(self, states, irs) -> None:
        self._states = states
        self._last_irs = irs

    def get_last_impulse_response(self, rx_idx: int, tx_idx: int):
        """Last impulse response of link (rx_idx, tx_idx)
        (multiuser.py:396-441) — a view into the stacked per-link
        response (link axis at position 1 of the tap values)."""
        irs = self._last_irs
        if isinstance(irs, list):  # legacy nested form
            return irs[rx_idx][tx_idx]
        from .fading import TdlImpulseResponse
        tv = irs.tap_values_sparse
        link = rx_idx * self._num_tx_users + tx_idx
        return TdlImpulseResponse(tv[:, link], irs.channel_profile)


class MuMimoChannel(MuChannel):
    """MuChannel whose links are (Nr x Nt) MIMO TDL channels
    (multiuser.py:521-584)."""

    def __init__(self, N: Union[int, Sequence[int]], num_rx_antennas: int,
                 num_tx_antennas: int,
                 fading_generator: Optional[FadingSampleGenerator] = None,
                 channel_profile: Optional[TdlChannelProfile] = None,
                 tap_powers_dB: Optional[np.ndarray] = None,
                 tap_delays: Optional[np.ndarray] = None,
                 Ts: Optional[float] = None) -> None:
        super().__init__(N, fading_generator, channel_profile,
                         tap_powers_dB, tap_delays, Ts)
        for row in self._su_channels:
            for ch in row:
                ch.set_num_antennas(num_rx_antennas, num_tx_antennas)


class MultiUserChannelMatrix:
    """Flat-fading MIMO interference channel as one dense block matrix.

    ``big_H`` is a (sum(Nr), sum(Nt)) CArray; per-user antenna counts may
    differ. Separate PRNG keys for channel and noise realizations
    (multiuser.py:655-709 semantics with explicit keys instead of
    RandomState objects).
    """

    def __init__(self) -> None:
        self._big_H: Optional[CArray] = None
        self._Nr = np.array([], dtype=int)
        self._Nt = np.array([], dtype=int)
        self._K = 0
        self._pathloss_matrix: Optional[np.ndarray] = None
        self._W: Optional[List[CArray]] = None
        self.noise_var: Optional[float] = None
        self._last_noise: Optional[CArray] = None
        self._channel_key = jax.random.PRNGKey(0)
        self._noise_key = jax.random.PRNGKey(1)

    # -- seeding -----------------------------------------------------------

    def set_channel_seed(self, seed=None) -> None:
        """Seed the channel generator; None draws a fresh random seed
        (multiuser.py:670-688)."""
        if seed is None:
            seed = int(np.random.randint(0, 2**31 - 1))
        self._channel_key = (jax.random.PRNGKey(seed)
                             if isinstance(seed, (int, np.integer)) else seed)

    def set_noise_seed(self, seed=None) -> None:
        """Seed the noise generator; None draws a fresh random seed
        (multiuser.py:690-709)."""
        if seed is None:
            seed = int(np.random.randint(0, 2**31 - 1))
        self._noise_key = (jax.random.PRNGKey(seed)
                           if isinstance(seed, (int, np.integer)) else seed)

    def re_seed(self) -> None:
        """Re-seed channel and noise generators with fresh random seeds —
        call in ``_on_simulate_current_params_start`` so parallel workers
        do not share streams (multiuser.py:700-709)."""
        self.set_channel_seed(None)
        self.set_noise_seed(None)

    # -- properties --------------------------------------------------------

    @property
    def K(self) -> int:
        return self._K

    @property
    def Nr(self) -> np.ndarray:
        return self._Nr

    @property
    def Nt(self) -> np.ndarray:
        return self._Nt

    @property
    def big_H(self) -> Optional[CArray]:
        return self._apply_pathloss(self._big_H)

    @property
    def H(self):
        """Block view: for uniform antennas a (K, K, Nr, Nt) CArray;
        otherwise a host object-array of per-block CArrays."""
        bh = self.big_H
        if bh is None:
            return None
        if len(set(self._Nr.tolist())) == 1 and \
                len(set(self._Nt.tolist())) == 1:
            K, L = self._K, self._K
            nr, nt = int(self._Nr[0]), int(self._Nt[0])
            r = bh.reshape(K, nr, L, nt)
            return r.swapaxes(1, 2)
        out = np.empty((self._K, self._K), dtype=object)
        for k in range(self._K):
            for l in range(self._K):
                out[k, l] = self.get_Hkl(k, l)
        return out

    @property
    def pathloss(self) -> Optional[np.ndarray]:
        return self._pathloss_matrix

    @property
    def last_noise(self) -> Optional[CArray]:
        return self._last_noise

    @property
    def W(self) -> Optional[List[CArray]]:
        return self._W

    @property
    def big_W(self) -> Optional[CArray]:
        """Block-diagonal stack of the per-user post receive filters."""
        if self._W is None:
            return None
        sizes_r = [w.shape[-2] for w in self._W]
        sizes_c = [w.shape[-1] for w in self._W]
        total_r, total_c = sum(sizes_r), sum(sizes_c)
        out = cplx.zeros((total_r, total_c))
        r0 = c0 = 0
        for w in self._W:
            out = out.at_set((slice(r0, r0 + w.shape[-2]),
                              slice(c0, c0 + w.shape[-1])), w)
            r0 += w.shape[-2]
            c0 += w.shape[-1]
        return out

    def set_post_filter(self, filters: Sequence) -> None:
        """Per-user post receive filters applied in corrupt_*_data
        (multiuser.py:1133-1177)."""
        self._W = [cplx.carray(f) for f in filters]

    # -- construction ------------------------------------------------------

    def _setup_counts(self, Nr: IntArray, Nt: IntArray, K: int) -> None:
        Nr = np.full(K, Nr, dtype=int) if np.isscalar(Nr) else \
            np.asarray(Nr, dtype=int)
        Nt = np.full(K, Nt, dtype=int) if np.isscalar(Nt) else \
            np.asarray(Nt, dtype=int)
        if Nr.size != K or Nt.size != K:
            raise ValueError("Nr and Nt must have a value for each of "
                             "the K users")
        self._Nr, self._Nt, self._K = Nr, Nt, int(K)
        self._rx_off = np.concatenate(([0], np.cumsum(Nr)))
        self._tx_off = np.concatenate(([0], np.cumsum(Nt)))

    def randomize(self, Nr: IntArray, Nt: IntArray, K: int,
                  key: Optional[jax.Array] = None) -> None:
        """Draw a new iid CN(0,1) block channel (multiuser.py:1003-1044)."""
        self._setup_counts(Nr, Nt, K)
        if key is None:
            self._channel_key, key = jax.random.split(self._channel_key)
        self._big_H = randn_c(key, int(self._Nr.sum()),
                              int(self._Nt.sum()))

    def init_from_channel_matrix(self, channel_matrix, Nr: IntArray,
                                 Nt: IntArray, K: int) -> None:
        """Install a given (sum Nr, sum Nt) matrix
        (multiuser.py:935-1002)."""
        self._setup_counts(Nr, Nt, K)
        cm = cplx.carray(channel_matrix)
        if cm.shape[-2:] != (int(self._Nr.sum()), int(self._Nt.sum())):
            raise ValueError(
                "Channel matrix dimensions must match sum(Nr) x sum(Nt)")
        self._big_H = cm

    # -- views -------------------------------------------------------------

    def _apply_pathloss(self, bh: Optional[CArray]) -> Optional[CArray]:
        if bh is None or self._pathloss_matrix is None:
            return bh
        scale = np.ones((int(self._Nr.sum()), int(self._Nt.sum())))
        for k in range(self._K):
            for l in range(self._K):
                scale[self._rx_off[k]:self._rx_off[k + 1],
                      self._tx_off[l]:self._tx_off[l + 1]] = \
                    math.sqrt(self._pathloss_matrix[k, l])
        s = jnp.asarray(scale, bh.re.dtype)
        return CArray(bh.re * s, bh.im * s)

    def get_Hkl(self, k: int, l: int) -> CArray:
        """Channel block from transmitter ``l`` to receiver ``k``
        (multiuser.py:1046-1090)."""
        bh = self.big_H
        return bh[..., self._rx_off[k]:self._rx_off[k + 1],
                  self._tx_off[l]:self._tx_off[l + 1]]

    def get_Hk(self, k: int) -> CArray:
        """Channel from ALL transmitters to receiver ``k``
        (multiuser.py:1091-1132)."""
        bh = self.big_H
        return bh[..., self._rx_off[k]:self._rx_off[k + 1], :]

    def set_pathloss(self,
                     pathloss_matrix: Optional[np.ndarray] = None) -> None:
        self._pathloss_matrix = pathloss_matrix

    # -- transmission ------------------------------------------------------

    def corrupt_concatenated_data(self, data,
                                  key: Optional[jax.Array] = None) -> CArray:
        """``big_H @ data + noise`` (+ optional block-diagonal post filter)
        (multiuser.py:1179-1221). ``data``: (sum Nt, n)."""
        host_like = data
        data = cplx.carray(data)
        out = cplx.matmul(self.big_H, data)
        if self.noise_var is not None and self.noise_var > 0:
            if key is None:
                self._noise_key, key = jax.random.split(self._noise_key)
            noise = randn_c(key, *out.shape) * math.sqrt(self.noise_var)
            self._last_noise = noise
            out = out + noise
        else:
            self._last_noise = None
        if self._W is not None:
            out = cplx.matmul(self.big_W, out)
        return cplx.to_host_like(out, host_like)

    def corrupt_data(self, data, key: Optional[jax.Array] = None):
        """Per-user variant: ``data`` is a list of (Nt_k, n) arrays;
        returns a list of per-receiver outputs (multiuser.py:1223-1263)."""
        concat = cplx.concatenate([cplx.carray(d) for d in data], axis=-2)
        big_out = self.corrupt_concatenated_data(concat, key)
        out = []
        for k in range(self._K):
            out.append(big_out[..., self._rx_off[k]:self._rx_off[k + 1], :])
        return cplx.to_host_like(out, data)

    # -- covariances and SINRs (Cadambe2008 eq. 28) ------------------------

    def calc_Q(self, k: int, F_all_users: Sequence) -> CArray:
        """Interference covariance at receiver k, including noise:
        ``sum_{j != k} H_kj F_j F_j^H H_kj^H + noise_var I``
        (multiuser.py:1345-1384)."""
        q = self._calc_Q_impl(k, F_all_users)
        nv = self.noise_var or 0.0
        eye = jnp.eye(int(self._Nr[k]), dtype=q.re.dtype)
        return CArray(q.re + nv * eye, q.im)

    def _calc_Q_impl(self, k: int, F_all_users: Sequence) -> CArray:
        q = cplx.zeros((int(self._Nr[k]), int(self._Nr[k])))
        for j in range(self._K):
            if j == k:
                continue
            hf = cplx.matmul(self.get_Hkl(k, j), cplx.carray(F_all_users[j]))
            q = q + cplx.matmul(hf, hf.mH)
        return q

    def calc_JP_Q(self, k: int, F_all_users: Sequence) -> CArray:
        """Joint-processing variant: uses the full row ``H_k``
        (multiuser.py:1416-1451)."""
        q = self._calc_JP_Q_impl(k, F_all_users)
        nv = self.noise_var or 0.0
        eye = jnp.eye(int(self._Nr[k]), dtype=q.re.dtype)
        return CArray(q.re + nv * eye, q.im)

    def _calc_JP_Q_impl(self, k: int, F_all_users: Sequence) -> CArray:
        q = cplx.zeros((int(self._Nr[k]), int(self._Nr[k])))
        hk = self.get_Hk(k)
        for j in range(self._K):
            if j == k:
                continue
            hf = cplx.matmul(hk, cplx.carray(F_all_users[j]))
            q = q + cplx.matmul(hf, hf.mH)
        return q

    def _calc_Bkl_cov_matrix_first_part(self, F_all_users: Sequence,
                                        k: int, N0_or_Rek=0.0) -> CArray:
        rek = self._as_Rek(N0_or_Rek, int(self._Nr[k]))
        first = rek
        for j in range(self._K):
            hkj = self.get_Hkl(k, j)
            vj = cplx.carray(F_all_users[j])
            hv = cplx.matmul(hkj, vj)
            first = first + cplx.matmul(hv, hv.mH)
        return first

    @staticmethod
    def _as_Rek(N0_or_Rek, nr: int) -> CArray:
        if N0_or_Rek is None:
            N0_or_Rek = 0.0
        if isinstance(N0_or_Rek, CArray):
            return N0_or_Rek
        if isinstance(N0_or_Rek, np.ndarray) and N0_or_Rek.ndim >= 2:
            return cplx.carray(N0_or_Rek)
        return CArray(float(N0_or_Rek) * jnp.eye(nr),
                      jnp.zeros((nr, nr)))

    def _calc_Bkl_cov_matrix_second_part(self, Fk, k: int,
                                         l: int) -> CArray:
        hkk = self.get_Hkl(k, k)
        fk = cplx.carray(Fk)
        vkl = fk[..., :, l:l + 1]
        hv = cplx.matmul(hkk, vkl)
        return cplx.matmul(hv, hv.mH)

    def _calc_Bkl_cov_matrix_all_l(self, F_all_users: Sequence, k: int,
                                   N0_or_Rek=0.0) -> List[CArray]:
        first = self._calc_Bkl_cov_matrix_first_part(F_all_users, k,
                                                     N0_or_Rek)
        ns_k = cplx.carray(F_all_users[k]).shape[-1]
        return [first - self._calc_Bkl_cov_matrix_second_part(
            F_all_users[k], k, l) for l in range(ns_k)]

    def _calc_SINR_k(self, k: int, Fk, Uk, Bkl_all_l) -> jnp.ndarray:
        hkk = self.get_Hkl(k, k)
        fk, uk = cplx.carray(Fk), cplx.carray(Uk)
        ns_k = fk.shape[-1]
        sinrs = []
        for l in range(ns_k):
            fkl = fk[..., :, l:l + 1]
            ukl = uk[..., :, l:l + 1]
            aux = cplx.matmul(ukl.mH, cplx.matmul(hkk, fkl))
            num = aux.abs2()[..., 0, 0]
            den = cplx.matmul(ukl.mH, cplx.matmul(Bkl_all_l[l], ukl))
            sinrs.append(num / jnp.abs(den.re[..., 0, 0]))
        return jnp.stack(sinrs, axis=-1)

    def calc_SINR(self, F: Sequence, U: Sequence) -> List[jnp.ndarray]:
        """Per-stream SINRs of all users (multiuser.py:1869-1900)."""
        out = []
        for k in range(self._K):
            bkl = self._calc_Bkl_cov_matrix_all_l(F, k, self.noise_var or 0.0)
            out.append(self._calc_SINR_k(k, F[k], U[k], bkl))
        return out

    # joint processing variants -------------------------------------------

    def _calc_JP_Bkl_cov_matrix_first_part(self, F_all_users: Sequence,
                                           k: int,
                                           noise_power: float = 0.0):
        hk = self.get_Hk(k)
        return self._calc_JP_Bkl_first_impl(hk, F_all_users,
                                            self._as_Rek(noise_power,
                                                         int(self._Nr[k])))

    def _calc_JP_Bkl_first_impl(self, Hk: CArray, F_all_users: Sequence,
                                rek: CArray) -> CArray:
        first = rek
        for j in range(self._K):
            vj = cplx.carray(F_all_users[j])
            hv = cplx.matmul(Hk, vj)
            first = first + cplx.matmul(hv, hv.mH)
        return first

    def _calc_JP_Bkl_cov_matrix_second_part(self, Fk, k: int,
                                            l: int) -> CArray:
        hk = self.get_Hk(k)
        fk = cplx.carray(Fk)
        vkl = fk[..., :, l:l + 1]
        hv = cplx.matmul(hk, vkl)
        return cplx.matmul(hv, hv.mH)

    def _calc_JP_Bkl_cov_matrix_all_l(self, F_all_users: Sequence, k: int,
                                      noise_power: float = 0.0):
        first = self._calc_JP_Bkl_cov_matrix_first_part(F_all_users, k,
                                                        noise_power)
        ns_k = cplx.carray(F_all_users[k]).shape[-1]
        return [first - self._calc_JP_Bkl_cov_matrix_second_part(
            F_all_users[k], k, l) for l in range(ns_k)]

    def _calc_JP_SINR_k(self, k: int, Fk, Uk, Bkl_all_l) -> jnp.ndarray:
        hk = self.get_Hk(k)
        return self._jp_sinr_impl(hk, Fk, Uk, Bkl_all_l)

    @staticmethod
    def _jp_sinr_impl(Hk: CArray, Fk, Uk, Bkl_all_l) -> jnp.ndarray:
        fk, uk = cplx.carray(Fk), cplx.carray(Uk)
        ns_k = fk.shape[-1]
        sinrs = []
        for l in range(ns_k):
            fkl = fk[..., :, l:l + 1]
            ukl = uk[..., :, l:l + 1]
            aux = cplx.matmul(ukl.mH, cplx.matmul(Hk, fkl))
            num = aux.abs2()[..., 0, 0]
            den = cplx.matmul(ukl.mH, cplx.matmul(Bkl_all_l[l], ukl))
            sinrs.append(num / jnp.abs(den.re[..., 0, 0]))
        return jnp.stack(sinrs, axis=-1)

    def calc_JP_SINR(self, F: Sequence, U: Sequence) -> List[jnp.ndarray]:
        out = []
        for k in range(self._K):
            bkl = self._calc_JP_Bkl_cov_matrix_all_l(F, k,
                                                     self.noise_var or 0.0)
            out.append(self._calc_JP_SINR_k(k, F[k], U[k], bkl))
        return out


class MultiUserChannelMatrixExtInt(MultiUserChannelMatrix):
    """Interference channel with external interference sources modeled as
    extra transmit-only "users" (extra columns of big_H)
    (multiuser.py:2011-2807)."""

    def __init__(self) -> None:
        super().__init__()
        self._extIntK = 0
        self._extIntNt = np.array([], dtype=int)

    # -- properties --------------------------------------------------------

    @property
    def extIntK(self) -> int:
        return self._extIntK

    @property
    def extIntNt(self) -> np.ndarray:
        return self._extIntNt

    @property
    def K(self) -> int:
        return self._K - self._extIntK

    @property
    def Nr(self) -> np.ndarray:
        return self._Nr[:self.K]

    @property
    def Nt(self) -> np.ndarray:
        return self._Nt[:self.K]

    @property
    def big_H_no_ext_int(self) -> CArray:
        return self.big_H[..., :, :int(self._tx_off[self.K])]

    @property
    def H_no_ext_int(self):
        full = super().H
        if isinstance(full, CArray):
            return full[:self.K, :self.K]
        return full[:self.K, :self.K]

    # -- construction ------------------------------------------------------

    @staticmethod
    def _prepare_input_parans(Nr, Nt, K, NtE):
        """Extend the antenna arrays with the external sources
        (multiuser.py:2289-2334)."""
        Nr = np.full(K, Nr, dtype=int) if np.isscalar(Nr) else \
            np.asarray(Nr, dtype=int)
        Nt = np.full(K, Nt, dtype=int) if np.isscalar(Nt) else \
            np.asarray(Nt, dtype=int)
        if np.isscalar(NtE):
            extIntK = 1
            extIntNt = np.array([NtE], dtype=int)
        else:
            extIntK = len(NtE)
            extIntNt = np.asarray(NtE, dtype=int)
        full_Nr = np.concatenate([Nr, np.zeros(extIntK, dtype=int)])
        full_Nt = np.concatenate([Nt, extIntNt])
        return full_Nr, full_Nt, K + extIntK, extIntK, extIntNt

    def randomize(self, Nr, Nt, K, NtE, key=None) -> None:  # type: ignore
        full_Nr, full_Nt, full_K, extK, extNt = \
            self._prepare_input_parans(Nr, Nt, K, NtE)
        self._extIntK, self._extIntNt = extK, extNt
        super().randomize(full_Nr, full_Nt, full_K, key)

    def init_from_channel_matrix(self, channel_matrix, Nr, Nt, K,
                                 NtE) -> None:  # type: ignore
        full_Nr, full_Nt, full_K, extK, extNt = \
            self._prepare_input_parans(Nr, Nt, K, NtE)
        self._extIntK, self._extIntNt = extK, extNt
        super().init_from_channel_matrix(channel_matrix, full_Nr, full_Nt,
                                         full_K)

    def set_pathloss(self, pathloss_matrix=None,
                     ext_int_pathloss=None) -> None:
        """Per-link path loss plus the (K, extIntK) loss from each external
        source to each receiver (multiuser.py:2415-2465). Internally the
        external sources are extra zero-Rx users, so the two blocks are
        hstacked into the full matrix (their own rows are unused)."""
        if pathloss_matrix is None:
            super().set_pathloss(None)
            return
        K, extK = self.K, self._extIntK
        full = np.ones((K + extK, K + extK))
        full[:K, :K] = np.asarray(pathloss_matrix)
        if ext_int_pathloss is not None:
            full[:K, K:] = np.asarray(ext_int_pathloss).reshape(K, extK)
        super().set_pathloss(full)

    def get_Hk_without_ext_int(self, k: int) -> CArray:
        """Row of big_H for receiver k EXCLUDING the external interference
        columns (multiuser.py:2191-2240)."""
        return self.get_Hk(k)[..., :, :int(self._tx_off[self.K])]

    def get_Hk_with_ext_int(self, k: int) -> CArray:
        return self.get_Hk(k)

    # -- transmission ------------------------------------------------------

    def corrupt_data(self, data, ext_int_data=None,  # type: ignore
                     key: Optional[jax.Array] = None):
        """``data``: per-user signals; ``ext_int_data``: per-source
        signals (multiuser.py:2130-2160)."""
        all_data = list(data) + list(ext_int_data or [])
        concat = cplx.concatenate([cplx.carray(d) for d in all_data],
                                  axis=-2)
        big_out = self.corrupt_concatenated_data(concat, key)
        out = []
        for k in range(self.K):
            out.append(big_out[..., self._rx_off[k]:self._rx_off[k + 1], :])
        return cplx.to_host_like(out, data)

    # -- external interference covariance ---------------------------------

    def calc_cov_matrix_extint_without_noise(self,
                                             pe: float = 1.0) -> List[CArray]:
        """Covariance of the external interference at each receiver:
        ``pe * sum_e H_k,e H_k,e^H`` (multiuser.py:2469-2495)."""
        out = []
        for k in range(self.K):
            acc = cplx.zeros((int(self._Nr[k]), int(self._Nr[k])))
            for e in range(self._extIntK):
                he = self.get_Hkl(k, self.K + e)
                acc = acc + cplx.matmul(he, he.mH) * pe
            out.append(acc)
        return out

    def calc_cov_matrix_extint_plus_noise(self,
                                          pe: float = 1.0) -> List[CArray]:
        """Ext-int covariance plus noise (multiuser.py:2496-2528)."""
        nv = self.noise_var or 0.0
        out = []
        for r in self.calc_cov_matrix_extint_without_noise(pe):
            n = r.shape[-1]
            out.append(CArray(r.re + nv * jnp.eye(n, dtype=r.re.dtype),
                              r.im))
        return out

    # -- overridden Q / SINR (account for ext int) ------------------------

    def calc_Q(self, k: int, F_all_users: Sequence,  # type: ignore
               pe: float = 1.0) -> CArray:
        q = self._calc_Q_impl(k, F_all_users)
        rek = self.calc_cov_matrix_extint_plus_noise(pe)[k]
        return q + rek

    def calc_JP_Q(self, k: int, F_all_users: Sequence,  # type: ignore
                  pe: float = 1.0) -> CArray:
        q = self._calc_JP_Q_impl_no_ext(k, F_all_users)
        rek = self.calc_cov_matrix_extint_plus_noise(pe)[k]
        return q + rek

    def _calc_JP_Q_impl_no_ext(self, k: int,
                               F_all_users: Sequence) -> CArray:
        q = cplx.zeros((int(self._Nr[k]), int(self._Nr[k])))
        hk = self.get_Hk_without_ext_int(k)
        for j in range(self.K):
            if j == k:
                continue
            hf = cplx.matmul(hk, cplx.carray(F_all_users[j]))
            q = q + cplx.matmul(hf, hf.mH)
        return q

    def _calc_Q_impl(self, k: int, F_all_users: Sequence) -> CArray:
        q = cplx.zeros((int(self._Nr[k]), int(self._Nr[k])))
        for j in range(self.K):
            if j == k:
                continue
            hf = cplx.matmul(self.get_Hkl(k, j), cplx.carray(F_all_users[j]))
            q = q + cplx.matmul(hf, hf.mH)
        return q

    def calc_SINR(self, F: Sequence, U: Sequence,  # type: ignore
                  pe: float = 1.0) -> List[jnp.ndarray]:
        """SINRs including external interference in the Bkl covariances
        (multiuser.py:2636-2675)."""
        out = []
        reks = self.calc_cov_matrix_extint_plus_noise(pe)
        for k in range(self.K):
            bkl = self._calc_Bkl_cov_matrix_all_l(F, k, reks[k])
            out.append(self._calc_SINR_k(k, F[k], U[k], bkl))
        return out

    def _calc_Bkl_cov_matrix_first_part(self, F_all_users: Sequence,
                                        k: int, N0_or_Rek=0.0) -> CArray:
        rek = self._as_Rek(N0_or_Rek, int(self._Nr[k]))
        first = rek
        for j in range(self.K):
            hkj = self.get_Hkl(k, j)
            vj = cplx.carray(F_all_users[j])
            hv = cplx.matmul(hkj, vj)
            first = first + cplx.matmul(hv, hv.mH)
        return first

    def _calc_JP_Bkl_cov_matrix_first_part(  # type: ignore
            self, F_all_users: Sequence, k: int, noise_power=0.0):
        hk = self.get_Hk_without_ext_int(k)
        if isinstance(noise_power, (int, float)):
            rek = self._as_Rek(noise_power, int(self._Nr[k]))
        else:
            rek = cplx.carray(noise_power)
        return self._calc_JP_Bkl_first_impl_k(hk, F_all_users, rek)

    def _calc_JP_Bkl_first_impl_k(self, Hk, F_all_users, rek) -> CArray:
        first = rek
        for j in range(self.K):
            vj = cplx.carray(F_all_users[j])
            hv = cplx.matmul(Hk, vj)
            first = first + cplx.matmul(hv, hv.mH)
        return first

    def _calc_JP_Bkl_cov_matrix_second_part(self, Fk, k: int,
                                            l: int) -> CArray:
        hk = self.get_Hk_without_ext_int(k)
        fk = cplx.carray(Fk)
        vkl = fk[..., :, l:l + 1]
        hv = cplx.matmul(hk, vkl)
        return cplx.matmul(hv, hv.mH)

    def _calc_JP_SINR_k(self, k: int, Fk, Uk, Bkl_all_l) -> jnp.ndarray:
        hk = self.get_Hk_without_ext_int(k)
        return self._jp_sinr_impl(hk, Fk, Uk, Bkl_all_l)

    def calc_JP_SINR(self, F: Sequence, U: Sequence,  # type: ignore
                     pe: float = 1.0) -> List[jnp.ndarray]:
        out = []
        reks = self.calc_cov_matrix_extint_plus_noise(pe)
        for k in range(self.K):
            bkl = self._calc_JP_Bkl_cov_matrix_all_l_ext(F, k, reks[k])
            out.append(self._calc_JP_SINR_k(k, F[k], U[k], bkl))
        return out

    def _calc_JP_Bkl_cov_matrix_all_l_ext(self, F_all_users, k, rek):
        first = self._calc_JP_Bkl_cov_matrix_first_part(F_all_users, k, rek)
        ns_k = cplx.carray(F_all_users[k]).shape[-1]
        return [first - self._calc_JP_Bkl_cov_matrix_second_part(
            F_all_users[k], k, l) for l in range(ns_k)]
