"""LS and MMSE channel estimators (Fodor et al. 2014 formulations).

Behavioral counterpart of
``pyphysim/channel_estimation/estimators.py:12-213``, vectorized over a
leading realizations axis instead of a Python loop (the reference iterates
per realization; here the estimate is one batched expression).

Three input families are accepted and dispatched on:

* numpy complex arrays — the host path (parity-pinned against the live
  reference in tests/test_reference_crosscheck.py),
* jnp complex arrays — works inside jit on CPU (the device code path has no
  complex dtype support),
* :class:`~..ops.cplx.CArray` real-pair tensors — the DEVICE path: runs
  inside jit on the accelerator (the tiny Hermitian inversions ride
  :func:`~..ops.cplx.hpd_inv`'s closed-form/Schur recursion at full matmul
  precision, the library convention for small-matrix chains).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import cplx
from ..ops.cplx import CArray

__all__ = ["compute_ls_estimation", "compute_theoretical_ls_MSE",
           "compute_mmse_estimation", "compute_theoretical_mmse_MSE"]


def _xp(*arrays):
    return jnp if any(isinstance(a, jnp.ndarray) for a in arrays) else np


def _any_carray(*arrays):
    return any(isinstance(a, CArray) for a in arrays)


def compute_ls_estimation(Y_p, s):
    """LS channel estimate ``Y s^H (s s^H)^-1``.

    ``Y_p``: (..., Nr, num_pilots); ``s``: (Nt, num_pilots) shared or
    (..., Nt, num_pilots) per realization. Returns (..., Nr, Nt).
    Reference: ``channel_estimation/estimators.py:12-60``.
    """
    if _any_carray(Y_p, s):
        Y = cplx.carray(Y_p)
        sc = cplx.carray(s)
        with jax.default_matmul_precision("highest"):
            sH = sc.mH
            gram = cplx.matmul(sc, sH)          # (..., Nt, Nt) HPD
            return cplx.matmul(cplx.matmul(Y, sH), cplx.hpd_inv(gram))
    xp = _xp(Y_p, s)
    sH = xp.conj(xp.swapaxes(s, -1, -2))
    gram = xp.matmul(s, sH)
    return xp.matmul(xp.matmul(Y_p, sH), xp.linalg.inv(gram))


def compute_theoretical_ls_MSE(Nr: int, noise_power: float, alpha: float,
                               pilot_power: float,
                               num_pilots: int) -> float:
    """``Nr sigma^2 / (alpha^2 P Np)``."""
    return Nr * noise_power / ((alpha ** 2) * pilot_power * num_pilots)


def compute_mmse_estimation(Y_p, s, noise_power: float, C):
    """MMSE channel estimate for a SIMO channel (Nt must be 1):
    ``inv(sigma^2 I + Np C) C (Y s^H) * Np / (s s^H)``.

    ``Y_p``: (..., Nr, num_pilots); ``s``: (1, num_pilots) or
    (..., 1, num_pilots); ``C``: (Nr, Nr) channel covariance.
    Reference: ``channel_estimation/estimators.py:62-213``.
    """
    if s.shape[-2] != 1:
        raise AssertionError(
            "compute_mmse_estimation only supports Nt == 1")
    if _any_carray(Y_p, s, C):
        Y = cplx.carray(Y_p)
        sc = cplx.carray(s)
        Cc = cplx.carray(C)
        num_pilots = Y.shape[-1]
        Nr = Y.shape[-2]
        with jax.default_matmul_precision("highest"):
            sH = sc.mH                              # (..., Np, 1)
            y_corr = cplx.matmul(Y, sH)             # (..., Nr, 1)
            # pilot energy s s^H is real-positive (sum |s_i|^2)
            pe = cplx.matmul(sc, sH).re[..., 0, 0]  # (...,)
            A = cplx.eye(Nr) * noise_power + Cc * float(num_pilots)
            filt = cplx.matmul(cplx.hpd_inv(A), Cc)
            est = cplx.matmul(filt, y_corr)         # (..., Nr, 1)
            scale = num_pilots / pe
            if jnp.ndim(pe):
                scale = scale[..., None, None]
            return est * scale
    xp = _xp(Y_p, s, C)
    num_pilots = Y_p.shape[-1]
    Nr = Y_p.shape[-2]
    sH = xp.conj(xp.swapaxes(s, -1, -2))          # (..., Np, 1)
    y_corr = xp.matmul(Y_p, sH)                   # (..., Nr, 1)
    pilot_energy = xp.matmul(s, sH)[..., 0, 0]    # (...,)
    eye = xp.eye(Nr)
    filt = xp.matmul(xp.linalg.inv(noise_power * eye + num_pilots * C), C)
    est = xp.matmul(filt, y_corr)                  # (..., Nr, 1)
    return est * (num_pilots / pilot_energy)[..., None, None] if \
        xp.ndim(pilot_energy) else est * (num_pilots / pilot_energy)


def compute_theoretical_mmse_MSE(Nr: int, noise_power: float, alpha: float,
                                 pilot_power: float, num_pilots: int,
                                 C) -> float:
    """``tr[C inv(I + alpha^2 P Np / sigma^2 C)]``."""
    xp = _xp(C)
    return float(np.real(xp.trace(
        xp.matmul(C, xp.linalg.inv(
            xp.eye(Nr) +
            alpha ** 2 * pilot_power * num_pilots / noise_power * C)))))
