"""Device compute kernels and primitives: real-pair complex arithmetic,
matmul-DFT, channel FIR, batched small-matrix solves."""

from . import cplx  # noqa: F401
from .cplx import CArray  # noqa: F401
