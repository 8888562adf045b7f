"""Wrapper rules shared by the Pallas kernel tier (ops/pallas_common.py,
ops/{ia,bd,alamouti}_pallas.py): the GPU-only build rule, block shapes,
the absolute element layout, output shapes and the repetition-axis
split (parallel.shard_reps); plus the compiled kernels against their
plain references, which runs only on a GPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pyphysim_tpu.ops.alamouti_pallas import MonteCarloAlamouti
from pyphysim_tpu.ops.bd_pallas import MonteCarloBD
from pyphysim_tpu.ops.ia_pallas import MonteCarloMaxSinr
from pyphysim_tpu.ops.pallas_common import (block_elements, check_block,
                                            require_kernel_backend)
from pyphysim_tpu.parallel import make_mesh, shard_reps

# name -> (builder, build arguments after (reps, num_tiles), call args,
#          output dtype)
KERNELS = {
    "ia": (lambda: MonteCarloMaxSinr(tile=1, lane=16, iterations=1, K=2),
           (np.float32(0.1),), np.float32),
    "bd": (lambda: MonteCarloBD(tile=1, lane=16, K=2, Nr_u=1), (),
           np.float32),
    "alamouti": (lambda: MonteCarloAlamouti(tile=2, lane=16),
                 (np.float32(10.0),), np.int32),
}


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_build_raises_without_gpu_unless_interpret(name):
    make, _, _ = KERNELS[name]
    with pytest.raises(RuntimeError, match="interpret=True"):
        make().build(1, 1)
    make().build(1, 1, interpret=True)   # the interpreter is allowed


def test_require_kernel_backend_passes_on_interpret():
    require_kernel_backend(True)
    with pytest.raises(RuntimeError):
        require_kernel_backend(False)


@pytest.mark.parametrize("tile,lane", [(3, 128), (8, 96), (0, 128)])
def test_block_must_be_power_of_two(tile, lane):
    with pytest.raises(ValueError, match="power of two"):
        check_block(tile, lane)
    for cls in (MonteCarloMaxSinr, MonteCarloBD, MonteCarloAlamouti):
        with pytest.raises(ValueError):
            cls(tile=tile, lane=lane)


def test_block_elements_absolute_layout():
    """Block s of a tile x lane layout covers elements
    [s * tile * lane, (s + 1) * tile * lane) in row-major order."""
    got = np.asarray(block_elements(2, 4, 8))
    want = np.arange(2 * 32, 3 * 32, dtype=np.uint32).reshape(4, 8)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.uint32


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_output_shape_and_start_offset(name):
    """(reps, num_tiles) output; repetition r of a call at ``start`` is
    attempt start + r, so a shifted call reproduces the tail."""
    make, args, dtype = KERNELS[name]
    k = make()
    whole = np.asarray(k.build(3, 2, interpret=True)(jnp.int32(4), *args,
                                                     jnp.int32(0)))
    assert whole.shape == (3, 2) and whole.dtype == dtype
    tail = np.asarray(k.build(2, 2, interpret=True)(jnp.int32(4), *args,
                                                    jnp.int32(1)))
    np.testing.assert_array_equal(whole[1:], tail)


def test_shard_reps_offsets_and_divisibility():
    """Each device's slice of the rep axis starts at its absolute
    attempt; the result is gathered and equals the unsharded call."""
    def make_call(n):
        return lambda seeds, scale: (seeds[1] + jnp.arange(n)) * scale

    def prologue(scale, start=0):
        return jnp.stack([jnp.int32(0), jnp.asarray(start, jnp.int32)]), \
            jnp.asarray(scale, jnp.int32)

    one = np.asarray(shard_reps(make_call, prologue, 8)(3, 5))
    np.testing.assert_array_equal(one, (5 + np.arange(8)) * 3)
    sharded = np.asarray(shard_reps(make_call, prologue, 8,
                                    mesh=make_mesh(4))(3, 5))
    np.testing.assert_array_equal(sharded, one)
    with pytest.raises(ValueError, match="divisible"):
        shard_reps(make_call, prologue, 6, mesh=make_mesh(4))


@pytest.fixture
def gpu():
    """Skips unless JAX's default backend is a GPU (decided at run time,
    never at import)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: the compiled Triton kernels have no CPU "
                    "lowering (their interpret-mode twins run everywhere)")


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(KERNELS))
def test_compiled_kernel_matches_reference(gpu, name):
    """The compiled kernels against their plain references on the card
    (chip_smoke.py runs the same comparison at full size)."""
    make, args, _ = KERNELS[name]
    k = make()
    got = np.asarray(k.build(4, 8)(jnp.int32(1), *args), np.float64)
    if name == "alamouti":
        want = np.asarray(k.reference_counts(4, 8, 1, *args), np.float64)
        assert np.abs(got - want).sum() <= 4
    else:
        want = np.asarray(k.reference_caps(4, 8, 1, *args), np.float64)
        np.testing.assert_allclose(got, want, rtol=1e-3)
