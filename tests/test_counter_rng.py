"""Tests for the counter-based generator shared by the Monte Carlo
kernels (ops/counter_rng.py): bit-for-bit Threefry-2x32, independence
across the coordinates that key the streams, and the bits -> float maps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.extend.random import threefry_2x32

from pyphysim_tpu.ops.counter_rng import (channel_planes, gauss_half,
                                          random_bits, threefry2x32, u11)


@pytest.mark.parametrize("k0,k1", [(0, 0), (123, 0xDEADBEEF),
                                   (0xFFFFFFFF, 1), (0x7FFFFFFF, 2 ** 31)])
def test_threefry_bit_identical_to_jax(k0, k1):
    """Same function as jax.extend.random.threefry_2x32, whose count
    array is split into the (x0, x1) halves."""
    x0 = jnp.arange(64, dtype=jnp.uint32) * jnp.uint32(2654435761)
    x1 = jnp.arange(64, dtype=jnp.uint32) ^ jnp.uint32(0x5555AAAA)
    want = np.asarray(threefry_2x32(
        jnp.array([k0, k1], jnp.uint32), jnp.concatenate([x0, x1])))
    y0, y1 = threefry2x32(np.uint32(k0), np.uint32(k1), x0, x1)
    np.testing.assert_array_equal(np.concatenate([y0, y1]), want)


def test_threefry_jitted_broadcast_matches_eager():
    """The kernels call it on broadcast (rows, 1) x (1, cols) shapes
    inside jit; the result must equal the flat eager evaluation."""
    rows = jnp.arange(8, dtype=jnp.uint32)[:, None]
    cols = jnp.arange(16, dtype=jnp.uint32)[None, :]
    idx = rows * 16 + cols
    got = jax.jit(lambda i: random_bits(jnp.uint32(5), jnp.uint32(9),
                                        i, 3))(idx)
    flat = random_bits(np.uint32(5), np.uint32(9), idx.reshape(-1), 3)
    for g, f in zip(got, flat):
        np.testing.assert_array_equal(np.asarray(g).reshape(-1), f)


def _fraction_differing_bits(a, b):
    x = np.bitwise_xor(np.asarray(a), np.asarray(b))
    return np.unpackbits(x.view(np.uint8)).mean()


@pytest.mark.parametrize("coord", ["seed", "attempt", "index", "stream"])
def test_streams_independent_across_coordinates(coord):
    """Changing any one key/counter coordinate by one gives words whose
    bits differ in ~half the positions (no shared or shifted stream)."""
    base = dict(seed=11, attempt=4, index=jnp.arange(4096,
                                                     dtype=jnp.uint32),
                stream=1)
    other = dict(base)
    other[coord] = (base[coord] + 1 if coord != "index"
                    else base["index"] + jnp.uint32(1))

    def words(c):
        return random_bits(np.uint32(c["seed"]), np.uint32(c["attempt"]),
                           c["index"], c["stream"])

    a0, a1 = words(base)
    b0, b1 = words(other)
    for a, b in ((a0, b0), (a1, b1), (a0, a1)):
        assert 0.48 < _fraction_differing_bits(a, b) < 0.52
    if coord == "index":
        # counter-based: the word of element i + 1 depends on nothing
        # but its own coordinates
        np.testing.assert_array_equal(np.asarray(a0)[1:],
                                      np.asarray(b0)[:-1])


def test_words_uniform():
    w0, w1 = random_bits(np.uint32(1), np.uint32(2),
                         jnp.arange(1 << 16, dtype=jnp.uint32), 0)
    for w in (w0, w1):
        u = np.asarray(u11(w), np.float64)
        assert -1.0 <= u.min() and u.max() <= 1.0
        assert abs(u.mean()) < 0.01
        assert abs(u.var() - 1 / 3) < 0.004


def test_u11_range():
    bits = jnp.array([0, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF], jnp.uint32)
    np.testing.assert_allclose(np.asarray(u11(bits)),
                               [0.0, 1.0, -1.0, 0.0], atol=1e-7)


def test_gauss_half_moments():
    w, _ = random_bits(np.uint32(3), np.uint32(0),
                       jnp.arange(1 << 17, dtype=jnp.uint32), 7)
    g = np.asarray(gauss_half(w), np.float64)
    assert np.all(np.isfinite(g))
    assert abs(g.mean()) < 0.01
    assert abs(g.var() - 0.5) < 0.01


def test_channel_planes_layout():
    """Entry q's (re, im) planes are the two words of stream q."""
    idx = jnp.arange(32, dtype=jnp.uint32)
    planes = channel_planes(np.uint32(2), np.uint32(8), idx, 3)
    assert len(planes) == 6
    for q in range(3):
        re, im = random_bits(np.uint32(2), np.uint32(8), idx, q)
        np.testing.assert_array_equal(planes[2 * q], re)
        np.testing.assert_array_equal(planes[2 * q + 1], im)
