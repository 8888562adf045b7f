"""Fundamental digital modulators: M-PSK, M-QAM, BPSK, QPSK.

JAX-native counterpart of the reference ``pyphysim/modulators/fundamental.py``
(constellation semantics at fundamental.py:412-419 for Gray-mapped PSK,
fundamental.py:689-777 for square Gray-mapped unit-energy QAM; theoretical
SER/BER at fundamental.py:462-501 and 780-857; base modulate/demodulate at
fundamental.py:175-249).

Design: a modulator is an immutable object holding its constellation table.
``modulate``/``demodulate`` are pure, shape-polymorphic functions safe inside
``jit``/``vmap``:

  * modulate   = table gather         ``constellation[indices]``
  * demodulate = nearest-neighbor     ``argmin_k |rx - constellation[k]|``
    evaluated as a fused elementwise broadcast. For square QAM a closed-form
    per-axis slicer (`QAM.demodulate_hard`) avoids the M-way search entirely
    — O(1) per symbol instead of O(M) — which matters for 64/256-QAM at
    10^9 symbols/s.

All theoretical-curve methods accept numpy or jnp inputs.
"""

from __future__ import annotations

import math
from typing import Optional, Union

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import cplx
from ..ops.cplx import CArray
from ..utils.conversion import binary2gray, dB2Linear, gray2binary
from ..utils.misc import level2bits, qfunc

__all__ = ["Modulator", "PSK", "QPSK", "BPSK", "QAM"]

NumberOrArray = Union[float, np.ndarray, jnp.ndarray]


class Modulator:
    """Base modulator defined by a constellation table.

    The table is stored as numpy (host, float64 precision for exactness)
    and as a complex64 jnp array for device work.
    """

    def __init__(self, constellation: Optional[np.ndarray] = None) -> None:
        self._constellation: Optional[np.ndarray] = None
        self._constellation_dev: Optional[CArray] = None
        self._M = 0
        self._K = 0
        if constellation is not None:
            self.setConstellation(constellation)

    # -- construction ------------------------------------------------------

    def setConstellation(self, symbols: np.ndarray) -> None:
        """Install a constellation table (size must be a power of two)."""
        symbols = np.asarray(symbols, dtype=np.complex128)
        M = symbols.size
        self._M = M
        self._K = level2bits(M)
        self._constellation = symbols
        self._constellation_dev = cplx.from_numpy(symbols)

    def plotConstellation(self) -> None:  # pragma: no cover
        """Scatter-plot the constellation with binary/decimal labels per
        point (parity: fundamental.py:148-173)."""
        import matplotlib.pyplot as plt
        _, ax = plt.subplots()
        ax.scatter(self.symbols.real, self.symbols.imag)
        ax.axis("equal")
        ax.grid()
        for index, symbol in enumerate(self.symbols):
            ax.text(symbol.real, symbol.imag + 0.03,
                    f"{index:0{self._K}b} ({index})",
                    verticalalignment="bottom",
                    horizontalalignment="center")
        plt.show()

    # -- properties --------------------------------------------------------

    @property
    def M(self) -> int:
        """Constellation cardinality."""
        return self._M

    @property
    def K(self) -> int:
        """Bits per symbol (log2 M)."""
        return self._K

    @property
    def symbols(self) -> np.ndarray:
        """The (host-side) constellation table."""
        return self._constellation

    @property
    def symbols_device(self) -> CArray:
        """The on-device constellation table (real-pair CArray)."""
        return self._constellation_dev

    @property
    def name(self) -> str:
        return f"{self.__class__.__name__.split('.')[-1]}-{self._M}"

    def __repr__(self) -> str:
        return f"{self.name} object"

    # -- modulate / demodulate --------------------------------------------

    def modulate(self, input_data):
        """Map integer symbols in [0, M) to constellation points (gather).

        Works inside jit; accepts any array shape. Host numpy input gives
        host numpy complex output via the float64 table; traced input
        gives a :class:`CArray`.
        """
        if isinstance(input_data, (np.ndarray, int)):
            idx = np.asarray(input_data)
            if idx.size and (idx.max() >= self._M or idx.min() < 0):
                raise ValueError(
                    f"Input data must be between 0 and {self._M - 1}")
            return self._constellation[idx]
        # Device path: a gather over a small table vectorizes poorly;
        # a one-hot contraction is a fused multiply-add instead.
        idx = input_data
        onehot = (idx[..., None] == jnp.arange(self._M)).astype(jnp.float32)
        table = self._constellation_dev
        return CArray(jnp.sum(onehot * table.re, axis=-1),
                      jnp.sum(onehot * table.im, axis=-1))

    def demodulate(self, received_data):
        """Nearest-neighbor hard decision: argmin_k |rx - c_k|.

        Batched over every leading dimension; the broadcast against the
        length-M table fuses into one elementwise pass under jit. Accepts numpy
        complex (host path) or CArray (device path).
        """
        if isinstance(received_data, np.ndarray):
            d = np.abs(received_data[..., None] -
                       self._constellation[None, :])
            return np.argmin(d, axis=-1)
        rx = received_data
        table = self._constellation_dev
        dr = rx.re[..., None] - table.re
        di = rx.im[..., None] - table.im
        metric = dr * dr + di * di
        return jnp.argmin(metric, axis=-1).astype(jnp.int32)

    # -- theoretical curves ------------------------------------------------

    def calcTheoreticalSER(self, SNR: NumberOrArray) -> NumberOrArray:
        raise NotImplementedError

    def calcTheoreticalBER(self, SNR: NumberOrArray) -> NumberOrArray:
        raise NotImplementedError

    def calcTheoreticalPER(self, SNR: NumberOrArray,
                           packet_length: int) -> NumberOrArray:
        """Theoretical packet error rate ``1 - (1 - BER)^L``
        (parity: fundamental.py:303-345)."""
        ber = self.calcTheoreticalBER(SNR)
        return 1.0 - (1.0 - ber) ** packet_length

    def calcTheoreticalSpectralEfficiency(
            self, SNR: NumberOrArray,
            packet_length: Optional[int] = None) -> NumberOrArray:
        """K * (1 - PER) bits/symbol (parity: fundamental.py:346-384)."""
        if packet_length is None:
            return self._K * (1.0 - self.calcTheoreticalBER(SNR))
        return self._K * (1.0 - self.calcTheoreticalPER(SNR, packet_length))


class PSK(Modulator):
    """Gray-mapped M-PSK on the unit circle (fundamental.py:393-501)."""

    def __init__(self, M: int, phaseOffset: float = 0.0) -> None:
        super().__init__()
        if 2 ** round(math.log2(M)) != M:
            raise ValueError("M must be a power of 2")
        self._phase_offset = phaseOffset
        symbols = self._createConstellation(M, phaseOffset)
        # Gray mapping: index i maps to the point at angular position
        # gray2binary-permuted i, so adjacent points differ by one bit.
        symbols = symbols[gray2binary(np.arange(M))]
        self.setConstellation(symbols)

    @staticmethod
    def _createConstellation(M: int, phaseOffset: float) -> np.ndarray:
        phases = 2.0 * np.pi / M * np.arange(M) + phaseOffset
        re = np.cos(phases)
        im = np.sin(phases)
        re[np.abs(re) < 1e-15] = 0.0
        im[np.abs(im) < 1e-15] = 0.0
        return re + 1j * im

    def setPhaseOffset(self, phaseOffset: float) -> None:
        symbols = self._createConstellation(self._M, phaseOffset)
        self.setConstellation(symbols[gray2binary(np.arange(self._M))])

    def calcTheoreticalSER(self, SNR):
        """High-SNR approximation ``2 Q(sqrt(2 snr) sin(pi/M))``."""
        snr = dB2Linear(SNR)
        xp = jnp if isinstance(snr, jnp.ndarray) else np
        return 2.0 * qfunc(xp.sqrt(2.0 * snr) * math.sin(np.pi / self._M))

    def calcTheoreticalBER(self, SNR):
        """Gray-coding approximation ``SER / K``."""
        return self.calcTheoreticalSER(SNR) / level2bits(self._M)


class QPSK(PSK):
    """4-PSK with pi/4 offset (fundamental.py:605+)."""

    def __init__(self) -> None:
        super().__init__(4, np.pi / 4.0)

    @property
    def name(self) -> str:
        return "QPSK"


class BPSK(Modulator):
    """Binary PSK: bit 0 -> +1, bit 1 -> -1 (fundamental.py:605-647)."""

    def __init__(self) -> None:
        super().__init__(np.array([1.0 + 0j, -1.0 + 0j]))

    @property
    def name(self) -> str:
        return "BPSK"

    def demodulate(self, received_data):
        """Threshold on the real part (cheaper than the generic argmin)."""
        if isinstance(received_data, np.ndarray):
            return (received_data.real < 0).astype(np.int64)
        return (received_data.re < 0).astype(jnp.int32)

    def calcTheoreticalSER(self, SNR):
        """``Q(sqrt(2 snr))`` exactly."""
        snr = dB2Linear(SNR)
        xp = jnp if isinstance(snr, jnp.ndarray) else np
        return qfunc(xp.sqrt(2.0 * snr))

    def calcTheoreticalBER(self, SNR):
        return self.calcTheoreticalSER(SNR)


class QAM(Modulator):
    """Square Gray-mapped M-QAM normalized to unit average energy
    (fundamental.py:656-860).

    Layout matches the reference: the raw grid enumerates points row-major
    with real part increasing left->right and imaginary part decreasing
    top->bottom; the Gray permutation interleaves row/column Gray codes so
    horizontally/vertically adjacent points differ in exactly one bit.

    >>> import numpy as np
    >>> qam = QAM(16)
    >>> qam.modulate(np.array([0]))
    array([-0.9486833+0.9486833j])
    >>> qam.demodulate(qam.modulate(np.array([0, 5, 10])))
    array([ 0,  5, 10])
    >>> float(np.mean(np.abs(qam.symbols) ** 2))  # unit average energy
    1.0
    """

    def __init__(self, M: int) -> None:
        super().__init__()
        power = math.log2(M)
        if power != int(power) or int(power) % 2 != 0:
            raise ValueError("M must be a square power of 2")
        L = int(round(math.sqrt(M)))
        self._L = L
        symbols = self._createConstellation(M)
        symbols = symbols[self._calculateGrayMappingIndexQAM(L)]
        self.setConstellation(symbols)
        # Per-axis PAM Gray decision tables for the fast slicer:
        # real part of point with index i is determined by the column bits,
        # imaginary part by the row bits.
        self._scale = math.sqrt((M - 1) * 2.0 / 3.0)
        # Constellation index at grid position p carries gray^-1(p) in its
        # bits (the table was built as symbols[gray(r)*L + gray(c)] at
        # index (r<<h)|c), so slicing inverts with gray2binary.
        self._pos_to_bits = jnp.asarray(gray2binary(np.arange(L)),
                                        dtype=jnp.int32)

    @staticmethod
    def _createConstellation(M: int) -> np.ndarray:
        L = int(round(math.sqrt(M)))
        jj, ii = np.meshgrid(np.arange(L), np.arange(L))
        symbols = (-(L - 1) + jj * 2) + 1j * ((L - 1) - ii * 2)
        avg_energy = (M - 1) * 2.0 / 3.0
        return (symbols / math.sqrt(avg_energy)).reshape(M)

    @staticmethod
    def _calculateGrayMappingIndexQAM(L: int) -> np.ndarray:
        col = binary2gray(np.arange(L))
        row = col.reshape(L, 1)
        half_bits = level2bits(L * L) // 2
        index_matrix = (row << half_bits) + col[None, :]
        return index_matrix.reshape(L * L)

    def modulate(self, input_data):
        """Arithmetic QAM mapping (device fast path): the constellation
        point of index ``(r << h) | c`` sits at grid position
        ``(gray(r), gray(c))`` with ``gray(x) = x ^ (x >> 1)`` — so the
        I/Q values come from a handful of integer ops (no table, no
        gather, no one-hot)."""
        if isinstance(input_data, (np.ndarray, int)):
            return Modulator.modulate(self, input_data)
        L = self._L
        half_bits = level2bits(L * L) // 2
        col = input_data & (L - 1)
        row = input_data >> half_bits
        jj = col ^ (col >> 1)  # gray code
        ii = row ^ (row >> 1)
        inv_scale = 1.0 / self._scale
        re = (2 * jj - (L - 1)).astype(jnp.float32) * inv_scale
        im = ((L - 1) - 2 * ii).astype(jnp.float32) * inv_scale
        return CArray(re, im)

    def demodulate_hard(self, received_data: CArray) -> jnp.ndarray:
        """O(1)-per-symbol QAM slicer (device fast path).

        Quantize I and Q independently to the nearest PAM level, then
        rebuild the Gray-mapped index. Exact same decisions as the generic
        argmin (rectangular decision regions), ~M/4x less work for M>=16.
        """
        L = self._L
        half_bits = level2bits(L * L) // 2
        # Position on the PAM grid: level = (-(L-1) + 2*j) / scale
        # -> j = round((x*scale + L - 1) / 2), clipped.
        col_pos = jnp.clip(jnp.round(
            (received_data.re * self._scale + (L - 1)) / 2.0),
            0, L - 1).astype(jnp.int32)
        row_pos = jnp.clip(jnp.round(
            ((L - 1) - received_data.im * self._scale) / 2.0),
            0, L - 1).astype(jnp.int32)
        # Inverse Gray code computed arithmetically (gather-free):
        # out = p ^ (p>>1) ^ (p>>2) ^ ... (xor-prefix), exact for any
        # power-of-two L.
        def inv_gray(p):
            out = p
            sh = 1
            while sh < 8:
                out = out ^ (out >> sh)
                sh *= 2
            return out

        col_bits = inv_gray(col_pos)
        row_bits = inv_gray(row_pos)
        return (row_bits << half_bits) | col_bits

    def _calcTheoreticalSingleCarrierErrorRate(self, SNR):
        snr = dB2Linear(SNR)
        xp = jnp if isinstance(snr, jnp.ndarray) else np
        sqrtM = math.sqrt(self._M)
        return (2.0 * (1.0 - 1.0 / sqrtM) *
                qfunc(xp.sqrt(snr * 3.0 / (self._M - 1.0))))

    def calcTheoreticalSER(self, SNR):
        """``1 - (1 - Psc)^2`` with the per-carrier error rate Psc."""
        Psc = self._calcTheoreticalSingleCarrierErrorRate(SNR)
        return 1.0 - (1.0 - Psc) ** 2

    def calcTheoreticalBER(self, SNR):
        """Gray-coding approximation ``2 Psc / K``."""
        return (2.0 * self._calcTheoreticalSingleCarrierErrorRate(SNR) /
                level2bits(self._M))
