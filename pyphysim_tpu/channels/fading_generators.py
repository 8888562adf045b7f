"""Fading sample generators: iid Rayleigh and Jakes sum-of-sinusoids.

JAX-native counterpart of the reference
``pyphysim/channels/fading_generators.py``. The reference generators are
stateful objects mutating ``_samples``/``_current_time``
(fading_generators.py:101-553); here the state is an EXPLICIT pytree
threaded through pure functions, so generation works inside jit/vmap/scan
and parallelizes over realizations for free:

  * :class:`RayleighState` — just a PRNG key (memoryless channel,
    fading_generators.py:208-282: ``skip`` is a no-op statistically; we
    still fold the key so skipped streams diverge deterministically),
  * :class:`JakesState` — per-ray phases ``(phi_l, psi_l)`` plus the
    current time ``t0``. Time enters the Jakes closed form analytically
    (fading_generators.py:427-523), so there is NO sequential dependency:
    any time block can be generated independently from ``(phi, psi, t0)``
    — this is what lets long symbol streams shard over devices with each
    shard computing its own block (SURVEY §5 'long-context' analog).

Samples are :class:`~pyphysim_tpu.ops.cplx.CArray` with shape
``shape + (num_samples,)`` (sample axis last, like the reference).
Generators are configuration objects (Fd/Ts/L/shape); the per-realization
randomness lives in the state, so one generator serves any number of
vmapped realizations.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import cplx
from ..ops.cplx import CArray

__all__ = ["RayleighSampleGenerator", "JakesSampleGenerator",
           "RayleighState", "JakesState", "generate_jakes_samples"]

Shape = Union[int, Tuple[int, ...]]


def _normalize_shape(shape: Optional[Shape]) -> Tuple[int, ...]:
    if shape is None:
        return ()
    if isinstance(shape, int):
        return (shape,)
    return tuple(shape)


class RayleighState(NamedTuple):
    """State of a Rayleigh generator: a PRNG key."""
    key: jax.Array


class JakesState(NamedTuple):
    """State of a Jakes generator: per-ray phases and the current time."""
    phi_l: jnp.ndarray   # (L,) + shape + (1,) — ray arrival angles
    psi_l: jnp.ndarray   # (L,) + shape + (1,) — ray phases
    t0: jnp.ndarray      # scalar — next sample time


class FadingSampleGenerator:
    """Base: configuration + the functional (state-threading) API, plus
    the reference's stateful host-convenience API
    (``generate_more_samples``/``get_samples``/
    ``skip_samples_for_next_generation``, fading_generators.py:156-205) —
    the latter keeps an internal state pytree and returns numpy complex at
    the host boundary."""

    def __init__(self, shape: Optional[Shape] = None) -> None:
        self._shape = _normalize_shape(shape) if shape is not None else None
        self._state = None
        self._samples: Optional[np.ndarray] = None
        self._seed: Optional[int] = None

    @property
    def shape(self):
        return self._shape

    @shape.setter
    def shape(self, new_shape):
        self._shape = (_normalize_shape(new_shape)
                       if new_shape is not None else None)

    # functional API (implemented by subclasses)
    def init_state(self, key):  # pragma: no cover - abstract
        raise NotImplementedError

    def generate(self, state, num_samples: int = 1):  # pragma: no cover
        raise NotImplementedError

    def skip(self, state, num_samples: int):  # pragma: no cover
        raise NotImplementedError

    def get_similar_fading_generator(self):
        raise NotImplementedError  # pragma: no cover

    # ------------------------------------------------------------------
    # Stateful reference-style API (host convenience)
    # ------------------------------------------------------------------

    def set_seed(self, seed: int) -> None:
        """(Re)seed the internal state used by the stateful API."""
        self._seed = int(seed)
        self._state = self.init_state(jax.random.PRNGKey(self._seed))

    def _ensure_state(self) -> None:
        if self._state is None:
            if self._seed is None:
                # fresh entropy per generator, like the reference's
                # per-object RandomState (fading_generators.py:403-425)
                self._seed = int(np.random.randint(0, 2**31 - 1))
            self._state = self.init_state(jax.random.PRNGKey(self._seed))

    def generate_more_samples(
            self, num_samples: Optional[int] = None) -> None:
        """Generate the next batch of samples into ``get_samples()``
        (parity: fading_generators.py:166-181). With ``num_samples=None``
        a single sample of shape ``self.shape`` is generated (no trailing
        sample axis), matching the reference."""
        self._ensure_state()
        n = 1 if num_samples is None else int(num_samples)
        samples, self._state = self.generate(self._state, n)
        host = samples.to_numpy()
        if num_samples is None:
            host = host[..., 0]
        self._samples = host

    def get_samples(self) -> Optional[np.ndarray]:
        """The samples from the last ``generate_more_samples`` call
        (parity: fading_generators.py:156-164)."""
        return self._samples

    def skip_samples_for_next_generation(self, num_samples: int) -> None:
        """Advance the generation process without generating samples
        (parity: fading_generators.py:183-196)."""
        self._ensure_state()
        self._state = self.skip(self._state, num_samples)


class RayleighSampleGenerator(FadingSampleGenerator):
    """iid CN(0, 1) blocks (fading_generators.py:208-282)."""

    def __init__(self, shape: Optional[Shape] = None) -> None:
        super().__init__(shape)

    def init_state(self, key: jax.Array) -> RayleighState:
        return RayleighState(key=key)

    def generate(self, state: RayleighState,
                 num_samples: int = 1) -> Tuple[CArray, RayleighState]:
        from ..utils.misc import randn_c
        key, sub = jax.random.split(state.key)
        shape = (self._shape or ()) + (num_samples,)
        samples = randn_c(sub, *shape)
        return samples, RayleighState(key=key)

    def skip(self, state: RayleighState, num_samples: int) -> RayleighState:
        # Memoryless: statistically a no-op; fold the count so the stream
        # still advances deterministically.
        return RayleighState(key=jax.random.fold_in(state.key, num_samples))

    def get_similar_fading_generator(self) -> "RayleighSampleGenerator":
        return RayleighSampleGenerator(self._shape)


class JakesSampleGenerator(FadingSampleGenerator):
    """Jakes sum-of-sinusoids:
    ``h(t) = sqrt(1/L) sum_l exp(j(2 pi Fd cos(phi_l) t + psi_l))``.

    The heavy trig evaluation ``cos/sin((L,) + shape + (N,))`` is pure elementwise
    work that XLA fuses with the ray-sum; the closed form in ``t`` makes
    blocks independent (block-static evolution via :meth:`skip`).
    """

    def __init__(self, Fd: float = 100.0, Ts: float = 1e-3, L: int = 8,
                 shape: Optional[Shape] = None) -> None:
        super().__init__(shape)
        self._Fd = float(Fd)
        self._Ts = float(Ts)
        self._L = int(L)

    @property
    def Fd(self) -> float:
        return self._Fd

    @property
    def Ts(self) -> float:
        return self._Ts

    @property
    def L(self) -> int:
        return self._L

    def init_state(self, key: jax.Array) -> JakesState:
        shape = (self._L,) + (self._shape or ()) + (1,)
        k1, k2 = jax.random.split(key)
        two_pi = 2.0 * np.pi
        phi = jax.random.uniform(k1, shape, minval=0.0, maxval=two_pi)
        psi = jax.random.uniform(k2, shape, minval=0.0, maxval=two_pi)
        return JakesState(phi_l=phi, psi_l=psi, t0=jnp.zeros(()))

    def generate(self, state: JakesState,
                 num_samples: int = 1) -> Tuple[CArray, JakesState]:
        t = state.t0 + jnp.arange(num_samples, dtype=state.t0.dtype) \
            * self._Ts                                   # (N,)
        # broadcast to (L,) + 1s-for-shape + (N,)
        w = 2.0 * np.pi * self._Fd * jnp.cos(state.phi_l)  # (L, *shape, 1)
        phase = w * t + state.psi_l                        # (L, *shape, N)
        h = cplx.cexp(phase)
        scale = math.sqrt(1.0 / self._L)
        samples = CArray(jnp.sum(h.re, axis=0) * scale,
                         jnp.sum(h.im, axis=0) * scale)
        new_state = JakesState(phi_l=state.phi_l, psi_l=state.psi_l,
                               t0=state.t0 + num_samples * self._Ts)
        return samples, new_state

    def skip(self, state: JakesState, num_samples: int) -> JakesState:
        """Advance the clock without generating samples — the block-static
        channel trick (fading_generators.py:525-540)."""
        return JakesState(phi_l=state.phi_l, psi_l=state.psi_l,
                          t0=state.t0 + num_samples * self._Ts)

    def get_similar_fading_generator(self) -> "JakesSampleGenerator":
        return JakesSampleGenerator(self._Fd, self._Ts, self._L, self._shape)


def generate_jakes_samples(Fd: float, Ts: float = 1e-3,
                           num_samples: int = 100, L: int = 8,
                           shape: Optional[Shape] = None,
                           key: Optional[jax.Array] = None) -> CArray:
    """Stateless convenience mirroring the reference free function
    (fading_generators.py:15-98)."""
    if key is None:
        key = jax.random.PRNGKey(0)
    gen = JakesSampleGenerator(Fd, Ts, L, shape)
    samples, _ = gen.generate(gen.init_state(key), num_samples)
    return samples
