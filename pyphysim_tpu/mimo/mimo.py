"""MIMO encode/decode schemes.

Behavioral counterpart of the reference ``pyphysim/mimo/mimo.py``
(scheme semantics: Blast mimo.py:465-660, MRT mimo.py:666-783, MRC
mimo.py:789-827, SVDMimo mimo.py:833-946, GMDMimo mimo.py:952-1067,
Alamouti mimo.py:1073-1287, post-SINR helpers mimo.py:33-114).

Device-native design: every scheme is a pure batched function over
:class:`~pyphysim_tpu.ops.cplx.CArray` tensors — channels ``(..., Nr, Nt)``
and symbol streams ``(..., n)`` — with linear algebra lowering to the
real-pair kernels in ``ops.cplx`` (real matmuls, embedding solves). The
small per-realization matrices (2x2 .. 8x8) batch across thousands of
Monte Carlo realizations in one compiled program. Class wrappers mirror
the reference's object API (set_channel_matrix / encode / decode) and
accept numpy complex arrays at the host boundary.

Symbol-stream layout: encode reshapes column-major (stream index fastest,
matching the reference's ``order='F'`` reshapes at mimo.py:639,659) so the
decoded stream order is identical to the reference.
"""

from __future__ import annotations

import math
from typing import Optional, Union

import jax.numpy as jnp
import numpy as np

from ..ops import cplx
from ..ops.cplx import CArray
from ..utils.conversion import linear2dB
from ..utils.misc import gmd

__all__ = ["MimoBase", "Blast", "MRT", "MRC", "SVDMimo", "GMDMimo",
           "Alamouti", "calc_post_processing_SINRs",
           "calc_post_processing_linear_SINRs"]


def _as_c(x) -> CArray:
    return cplx.carray(x)


def calc_post_processing_linear_SINRs(channel, W, G_H,
                                      noise_var: Optional[float] = None):
    """Post-processing SINR per stream: ``|diag(G_H H W)|^2`` over
    off-diagonal interference plus noise amplification ``|G_H row|^2 s2``
    (mimo.py:64-114). Batched over leading dims; returns a real array."""
    channel, W, G_H = _as_c(channel), _as_c(W), _as_c(G_H)
    if noise_var is None:
        noise_var = 0.0
    eq = cplx.matmul(G_H, cplx.matmul(channel, W))
    s = CArray(jnp.diagonal(eq.re, axis1=-2, axis2=-1),
               jnp.diagonal(eq.im, axis1=-2, axis2=-1))
    total = eq.sum(axis=-1)
    i = total - s
    S = s.abs2()
    I = i.abs2()  # noqa: E741
    N = noise_var * jnp.sum(G_H.abs2(), axis=-1)
    return S / (I + N)


def calc_post_processing_SINRs(channel, W, G_H,
                               noise_var: Optional[float] = None):
    """Post-processing SINRs in dB (mimo.py:33-62)."""
    return linear2dB(
        calc_post_processing_linear_SINRs(channel, W, G_H, noise_var))


class MimoBase:
    """Base MIMO scheme holding the channel matrix (CArray)."""

    def __init__(self, channel=None) -> None:
        self._channel: Optional[CArray] = None
        self._host_io = False
        if channel is not None:
            self.set_channel_matrix(channel)

    def set_channel_matrix(self, channel) -> None:
        self._host_io = isinstance(channel, np.ndarray)
        self._channel = _as_c(channel)

    @property
    def channel(self) -> Optional[CArray]:
        return self._channel

    @property
    def Nr(self) -> int:
        return self._channel.shape[-2]

    @property
    def Nt(self) -> int:
        return self._channel.shape[-1]

    def getNumberOfLayers(self) -> int:  # pragma: no cover - abstract
        raise NotImplementedError

    # -- shared filters (mimo.py:264-309) ---------------------------------

    @staticmethod
    def _calcZeroForceFilter(channel: CArray) -> CArray:
        """ZF: pseudo-inverse of the channel."""
        return cplx.pinv(channel)

    @staticmethod
    def _calcMMSEFilter(channel: CArray, noise_var: float) -> CArray:
        """MMSE: ``(H^H H + s2 I)^-1 H^H`` via a batched solve."""
        hh = cplx.matmul(channel.mH, channel)
        n = hh.shape[-1]
        eye = jnp.eye(n, dtype=hh.re.dtype)
        reg = CArray(hh.re + noise_var * eye, hh.im)
        return cplx.solve(reg, channel.mH)

    def _maybe_host(self, out):
        if self._host_io and isinstance(out, CArray):
            return out.to_numpy()
        return out

    def encode(self, transmit_data):  # pragma: no cover - abstract
        raise NotImplementedError

    def decode(self, received_data):  # pragma: no cover - abstract
        raise NotImplementedError

    def calc_linear_SINRs(self, noise_var: float):
        """Post-processing SINRs (linear) of the scheme's streams from its
        precoder and receive filter (parity: mimo.py:311-329)."""
        W = self._calc_precoder(self._channel)
        try:
            G_H = self._calc_receive_filter(self._channel, noise_var)
        except TypeError:  # receive filter that does not take noise_var
            G_H = self._calc_receive_filter(self._channel)
        return calc_post_processing_linear_SINRs(self._channel, W, G_H,
                                                 noise_var)

    def calc_SINRs(self, noise_var: float):
        """Post-processing SINRs in dB (parity: mimo.py:330-348)."""
        return linear2dB(self.calc_linear_SINRs(noise_var))


def _reshape_F(data: CArray, n_streams: int) -> CArray:
    """Column-major reshape of (..., n) to (..., n_streams, n/n_streams):
    stream index varies fastest (reference ``order='F'``)."""
    batch = data.shape[:-1]
    n = data.shape[-1]
    out = data.reshape(batch + (n // n_streams, n_streams))
    return out.swapaxes(-1, -2)


def _flatten_F(data: CArray) -> CArray:
    """Inverse of :func:`_reshape_F`."""
    batch = data.shape[:-2]
    s, m = data.shape[-2], data.shape[-1]
    return data.swapaxes(-1, -2).reshape(batch + (s * m,))


class Blast(MimoBase):
    """Spatial multiplexing: Nt streams, 1/sqrt(Nt) power split, ZF or
    MMSE receive (mimo.py:465-660)."""

    def __init__(self, channel=None) -> None:
        super().__init__(channel)
        self._noise_var = 0.0

    def set_noise_var(self, noise_var: Optional[float]) -> None:
        if noise_var is None:
            self._noise_var = 0.0
        elif noise_var >= 0:
            self._noise_var = float(noise_var)
        else:
            raise ValueError("Noise variance must be a non-negative value.")

    def getNumberOfLayers(self) -> int:
        return self.Nt

    @staticmethod
    def _calc_precoder(channel: CArray) -> CArray:
        nt = channel.shape[-1]
        return cplx.eye(nt) * (1.0 / math.sqrt(nt))

    @classmethod
    def _calc_receive_filter(cls, channel: CArray,
                             noise_var: Optional[float] = None) -> CArray:
        nt = channel.shape[-1]
        if noise_var is None:
            noise_var = 0.0
        if noise_var > 0:
            g = cls._calcMMSEFilter(channel, noise_var)
        else:
            g = cls._calcZeroForceFilter(channel)
        return g * math.sqrt(nt)

    def encode(self, transmit_data):
        data = _as_c(transmit_data)
        ns = self.getNumberOfLayers()
        if data.shape[-1] % ns != 0:
            raise ValueError(
                "Input array number of elements must be a multiple of the "
                "number of transmit antennas")
        out = _reshape_F(data, ns) * (1.0 / math.sqrt(self.Nt))
        return self._maybe_host(out)

    def decode(self, received_data):
        rx = _as_c(received_data)
        g = self._calc_receive_filter(self._channel, self._noise_var)
        out = _flatten_F(cplx.matmul(g, rx))
        return self._maybe_host(out)


class MisoBase(MimoBase):
    """Base for MISO schemes (single stream, 1 receive antenna)."""

    def set_channel_matrix(self, channel) -> None:
        if isinstance(channel, np.ndarray) and channel.ndim == 1:
            channel = channel[np.newaxis, :]
        elif isinstance(channel, CArray) and channel.ndim == 1:
            channel = CArray(channel.re[None, :], channel.im[None, :])
        super().set_channel_matrix(channel)

    def getNumberOfLayers(self) -> int:
        return 1

    def decode(self, received_data):
        rx = _as_c(received_data)
        g = self._calc_receive_filter(self._channel)
        if isinstance(g, CArray):
            out = _flatten_F(cplx.matmul(g, rx)) if g.ndim >= 2 else g * rx
        else:  # real scalar filter
            out = rx.reshape(rx.shape[:-2] + (rx.shape[-1],)) * g \
                if rx.ndim >= 2 else rx * g
        return self._maybe_host(out)

    @staticmethod
    def _calc_receive_filter(channel, noise_var=None):  # pragma: no cover
        raise NotImplementedError


class MRT(MisoBase):
    """Maximum Ratio Transmission: phase-conjugate beamforming
    ``exp(-j angle(h)) / sqrt(Nt)`` (mimo.py:666-783)."""

    @staticmethod
    def _calc_precoder(channel: CArray) -> CArray:
        nt = channel.shape[-1]
        w = cplx.cexp(-channel.angle()) * (1.0 / math.sqrt(nt))
        return w.swapaxes(-1, -2)  # (Nt, 1)

    @staticmethod
    def _calc_receive_filter(channel, noise_var=None):
        nt = channel.shape[-1]
        return math.sqrt(nt) / jnp.sum(_as_c(channel).abs(), axis=(-2, -1))

    def encode(self, transmit_data):
        data = _as_c(transmit_data)
        w = self._calc_precoder(self._channel)           # (..., Nt, 1)
        out = CArray(w.re * data.re[..., None, :] -
                     w.im * data.im[..., None, :],
                     w.re * data.im[..., None, :] +
                     w.im * data.re[..., None, :])       # (..., Nt, n)
        return self._maybe_host(out)

    def decode(self, received_data):
        rx = _as_c(received_data)
        g = self._calc_receive_filter(self._channel)
        if rx.ndim >= 2:
            rx = rx.reshape(rx.shape[:-2] + (rx.shape[-1],)) \
                if rx.shape[-2] == 1 else rx
        out = rx * g
        return self._maybe_host(out)


class MRC(Blast):
    """Maximum Ratio Combining: the Blast receive filter applied to an
    ``Nr x 1`` channel (mimo.py:789-827)."""

    def set_channel_matrix(self, channel) -> None:
        if isinstance(channel, np.ndarray) and channel.ndim == 1:
            channel = channel[:, np.newaxis]
        elif isinstance(channel, CArray) and channel.ndim == 1:
            channel = CArray(channel.re[:, None], channel.im[:, None])
        super().set_channel_matrix(channel)


class SVDMimo(Blast):
    """SVD precoding: W = V / sqrt(Nt), G_H = diag(1/S) U^H sqrt(Nt)
    (mimo.py:833-946)."""

    @staticmethod
    def _calc_precoder(channel: CArray) -> CArray:
        nt = channel.shape[-1]
        _, _, v_h = cplx.svd(channel)
        return v_h.mH * (1.0 / math.sqrt(nt))

    @classmethod
    def _calc_receive_filter(cls, channel: CArray,
                             noise_var: Optional[float] = None) -> CArray:
        nt = channel.shape[-1]
        u, s, _ = cplx.svd(channel)
        uh = u.mH
        inv_s = (1.0 / s)[..., :, None]
        return CArray(uh.re * inv_s, uh.im * inv_s) * math.sqrt(nt)

    def encode(self, transmit_data):
        data = _as_c(transmit_data)
        if data.shape[-1] % self.Nt != 0:
            raise ValueError(
                "Input array number of elements must be a multiple of the "
                "number of transmit antennas")
        x = _reshape_F(data, self.Nt)
        out = cplx.matmul(self._calc_precoder(self._channel), x)
        return self._maybe_host(out)

    def decode(self, received_data):
        rx = _as_c(received_data)
        g = self._calc_receive_filter(self._channel)
        out = _flatten_F(cplx.matmul(g, rx))
        return self._maybe_host(out)


class GMDMimo(Blast):
    """GMD precoding: equal-diagonal R gives all streams the same SNR
    (mimo.py:952-1067). The GMD itself runs host-side (numpy) per channel;
    suitable for host simulators — inside jitted kernels prefer SVDMimo."""

    @staticmethod
    def _calc_precoder(channel: CArray) -> CArray:
        h = channel.to_numpy() if isinstance(channel, CArray) else channel
        nt = h.shape[-1]
        U, S, V_H = np.linalg.svd(h)
        _, _, P = gmd(U, S, V_H)
        return cplx.from_numpy(P / math.sqrt(nt))

    @classmethod
    def _calc_receive_filter(cls, channel,
                             noise_var: Optional[float] = None) -> CArray:
        h = channel.to_numpy() if isinstance(channel, CArray) else channel
        U, S, V_H = np.linalg.svd(h)
        Q, R, _ = gmd(U, S, V_H)
        channel_eq = cplx.from_numpy(Q @ R)
        return Blast._calc_receive_filter(channel_eq, noise_var)

    def encode(self, transmit_data):
        data = _as_c(transmit_data)
        if data.shape[-1] % self.Nt != 0:
            raise ValueError(
                "Input array number of elements must be a multiple of the "
                "number of transmit antennas")
        x = _reshape_F(data, self.Nt)
        out = cplx.matmul(self._calc_precoder(self._channel), x)
        return self._maybe_host(out)

    def decode(self, received_data):
        rx = _as_c(received_data)
        g = self._calc_receive_filter(self._channel, self._noise_var)
        out = _flatten_F(cplx.matmul(g, rx))
        return self._maybe_host(out)


class Alamouti(MimoBase):
    """Rate-1 2xNr space-time block code (mimo.py:1073-1287).

    Encode (pairwise, power-split by sqrt(2)):
      ``[[x0, -x1*], [x1, x0*]]``
    Decode: matched combining with ``||H||_F^2`` compensation — expressed
    here as fully vectorized even/odd slicing (no per-codeword loop).
    """

    def set_channel_matrix(self, channel) -> None:
        if isinstance(channel, np.ndarray) and channel.ndim == 1:
            channel = channel[np.newaxis, :]
        elif isinstance(channel, CArray) and channel.ndim == 1:
            channel = CArray(channel.re[None, :], channel.im[None, :])
        if channel.shape[-1] != 2:
            raise ValueError(
                "The number of transmit antennas must be equal to 2 for "
                "the Alamouti scheme")
        super().set_channel_matrix(channel)

    def getNumberOfLayers(self) -> int:
        return 1

    def calc_linear_SINRs(self, noise_var: float):
        """``||H||_F^2 / noise_var`` (mimo.py:1147-1165)."""
        h2 = jnp.sum(self._channel.abs2(), axis=(-2, -1))
        return h2 / noise_var

    @staticmethod
    def _encode(data: CArray) -> CArray:
        x0 = data[..., 0::2]                      # (..., m)
        x1 = data[..., 1::2]
        row0 = cplx.stack([x0, -x1.conj()], axis=-1)   # (..., m, 2)
        row1 = cplx.stack([x1, x0.conj()], axis=-1)
        enc = cplx.stack([row0, row1], axis=-3)        # (..., 2, m, 2)
        batch = data.shape[:-1]
        return enc.reshape(batch + (2, data.shape[-1]))

    def encode(self, transmit_data):
        data = _as_c(transmit_data)
        if data.shape[-1] % 2 != 0:
            raise ValueError(
                "Input data length must be a multiple of 2 for the "
                "Alamouti scheme")
        return self._maybe_host(self._encode(data) * (1.0 / math.sqrt(2)))

    def _decode(self, rx: CArray, channel: CArray) -> CArray:
        h0 = channel[..., :, 0]                   # (..., Nr)
        h1 = channel[..., :, 1]
        y0 = rx[..., :, 0::2]                     # (..., Nr, m)
        y1 = rx[..., :, 1::2]
        # d0 = h0^H y0 + h1^T y1*;  d1 = h1^H y0 - h0^T y1*
        def dot(a: CArray, b: CArray) -> CArray:  # sum over Nr
            return CArray(
                jnp.sum(a.re[..., :, None] * b.re - a.im[..., :, None] * b.im,
                        axis=-2),
                jnp.sum(a.re[..., :, None] * b.im + a.im[..., :, None] * b.re,
                        axis=-2))

        d0 = dot(h0.conj(), y0) + dot(h1, y1.conj())
        d1 = dot(h1.conj(), y0) + dot(-h0, y1.conj())
        inter = cplx.stack([d0, d1], axis=-1)     # (..., m, 2)
        batch = d0.shape[:-1]
        out = inter.reshape(batch + (2 * d0.shape[-1],))
        h2 = jnp.sum(channel.abs2(), axis=(-2, -1))
        return out * (1.0 / h2)[..., None] if out.ndim > 1 else \
            out * (1.0 / h2)

    def decode(self, received_data):
        rx = _as_c(received_data)
        out = self._decode(rx, self._channel) * math.sqrt(2)
        return self._maybe_host(out)
