"""Tests for the BD CoMP capacity Pallas kernel (ops/bd_pallas.py):
channel bits come from the counter-based generator, so the tests draw
the same bits, and the CPU interpreter pins the full
bit->capacity pipeline against the (already host-pinned) XLA chain
``comm/batched.bd_precoders_batched`` + normalized water-filling on
IDENTICAL channel realizations (the bench's bd_step semantics)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy.special import erfinv

from pyphysim_tpu.comm import bd_precoders_batched
from pyphysim_tpu.ops import cplx
from pyphysim_tpu.ops.bd_pallas import MonteCarloBD
from pyphysim_tpu.ops.counter_rng import channel_planes, u11

CLIP = 0.99999994


def _draw_bits(seed, mc, reps, num_tiles, start=0):
    """The kernel's channel bits for ``reps`` repetitions, laid out as
    ``(reps, num_tiles * tile, num_planes * lane)`` with plane i at lanes
    [i*lane, (i+1)*lane): the words ``channel_planes`` draws for the
    absolute element ``row * lane + l`` of each repetition."""
    rows = num_tiles * mc._tile
    elem = (jnp.arange(rows, dtype=jnp.uint32)[:, None] * mc._lane +
            jnp.arange(mc._lane, dtype=jnp.uint32)[None, :])
    out = []
    for r in range(reps):
        planes = channel_planes(np.uint32(seed), np.uint32(start + r),
                                elem, mc.num_planes // 2)
        out.append(jnp.concatenate(planes, axis=1))
    return jnp.stack(out)


def _channels_from_bits(mc, ch_bits):
    lane = mc._lane
    nt = mc._K * mc._NR
    bits = np.asarray(ch_bits)
    reps, rows, _ = bits.shape
    planes = bits.reshape(reps, rows, mc.num_planes, lane)

    def gauss(b):
        return erfinv(np.clip(np.asarray(u11(b)), -CLIP, CLIP))

    H = np.zeros((reps, rows, lane, nt, nt), np.complex64)
    idx = 0
    for i in range(nt):
        for j in range(nt):
            H[..., i, j] = (gauss(planes[:, :, idx]) +
                            1j * gauss(planes[:, :, idx + 1]))
            idx += 2
    return H.reshape(-1, nt, nt)


def _xla_caps(H, iPu=10.0 / 3, noise_var=1.0, K=3, mode="normalized"):
    """The bench's bd_step on explicit channels (bench.py)."""

    def one(h):
        _, Ms, Sigma = bd_precoders_batched(h, K, iPu, noise_var,
                                            mode)
        p = jnp.sum(Ms.re ** 2 + Ms.im ** 2, axis=-2)
        cap = jnp.sum(jnp.log2(1.0 + p * Sigma ** 2 / noise_var))
        ok = jnp.min(Sigma) > 1e-6 * jnp.max(Sigma)
        return jnp.where(jnp.isfinite(cap) & ok, cap, 0.0)

    return np.asarray(jax.jit(jax.vmap(one))(cplx.from_numpy(H)))


_DIRECT_CACHE = {}


def _direct_caps(mc, bits, noise_var):
    """Kernel math as a plain jitted jax function with noise_var
    TRACED — one XLA:CPU compile per kernel shape for the module (the
    pallas_call plumbing is covered by test_inject_plumbing)."""
    lane = mc._lane
    num_planes = mc.num_planes
    reps, rows, _ = bits.shape
    nt = rows // mc._tile
    key = (mc._tile, lane, reps, nt, mc._K, mc._NR, mc._mode)
    if key not in _DIRECT_CACHE:
        @jax.jit
        def run(b, nv):
            blocks = b.reshape(reps * nt, mc._tile, num_planes, lane)

            def one(block):
                planes = [block[:, i] for i in range(num_planes)]
                return mc._solve_block(planes, noise_var=nv)

            return jax.vmap(one)(blocks).reshape(reps, nt, -1)

        _DIRECT_CACHE[key] = run
    per_elem = np.asarray(_DIRECT_CACHE[key](
        bits.astype(jnp.int32), jnp.float32(noise_var)))
    return per_elem.sum(axis=-1), per_elem


class TestInjectMatchesXlaChain:
    @pytest.mark.heavy  # ~25 s of interpreter; the same generator
    # plumbing is covered by default in
    # test_ia_pallas.py::test_inject_plumbing
    def test_inject_plumbing(self):
        """The interpreted kernel draws exactly the documented generator
        bits and reproduces the direct _solve_block math on them."""
        mc = MonteCarloBD(tile=8, lane=128)
        bits = _draw_bits(9, mc, 1, 1)
        got = np.asarray(mc.build(1, 1, interpret=True)(jnp.int32(9)))
        want, _ = _direct_caps(mc, bits, 1.0)
        np.testing.assert_allclose(got, want, rtol=1e-5)

    def test_capacity_matches_xla_chain_per_batch(self):
        mc = MonteCarloBD(tile=8, lane=128)
        reps, nt = 1, 1
        bits = _draw_bits(0, mc, reps, nt)
        got, _ = _direct_caps(mc, bits, 1.0)

        H = _channels_from_bits(mc, bits)
        caps = _xla_caps(H).reshape(reps, nt, mc._tile * mc._lane)
        want = caps.sum(axis=-1)
        np.testing.assert_allclose(got, want, rtol=3e-3)
        mean_cap = got.sum() / (reps * nt * mc._tile * mc._lane)
        assert 5.0 < mean_cap < 16.0, mean_cap  # bench BD_CAP_RANGE

    def test_power_budget_respected(self):
        """The implied per-stream powers never exceed the per-BS
        budget: capacity computed with the FULL per-BS budget on every
        stream upper-bounds the kernel's."""
        mc = MonteCarloBD(tile=8, lane=128)
        bits = _draw_bits(2, mc, 1, 1)
        got = float(_direct_caps(mc, bits, 1.0)[0].sum())
        H = _channels_from_bits(mc, bits)

        def upper(h):
            _, _, Sigma = bd_precoders_batched(h, 3, 10.0 / 3, 1.0,
                                               "none")
            return jnp.sum(jnp.log2(1.0 + 10.0 * Sigma ** 2))

        ub = float(np.asarray(jax.jit(jax.vmap(upper))(
            cplx.from_numpy(H))).sum())
        assert 0.0 < got < ub

    def test_noise_var_monotonicity(self):
        mc = MonteCarloBD(tile=8, lane=128)
        bits = _draw_bits(3, mc, 1, 1)
        lo = float(_direct_caps(mc, bits, 0.5)[0].sum())
        hi = float(_direct_caps(mc, bits, 2.0)[0].sum())
        assert hi < lo

    def test_noise_var_matches_xla_chain_off_unity(self):
        """The noise_var knob is consistent end to end (water level AND
        per-stream SNR): kernel == XLA chain at noise_var != 1."""
        mc = MonteCarloBD(tile=8, lane=128, K=2, Nr_u=1)
        bits = _draw_bits(6, mc, 1, 1)
        got, _ = _direct_caps(mc, bits, 0.3)
        H = _channels_from_bits(mc, bits)
        caps = _xla_caps(H, noise_var=0.3, K=2).reshape(
            1, 1, mc._tile * mc._lane)
        np.testing.assert_allclose(got, caps.sum(axis=-1), rtol=3e-3)


class TestGeometryMenu:
    """The kernel tier's geometry menu (VERDICT r4 item 3): each
    (K, Nr_u) point pinned against the shape-general XLA chain
    (reference blockdiagonalization.py:272-401) on identical channel
    realizations."""

    @pytest.mark.parametrize("K,NR", [(2, 1), (2, 2), (4, 1)])
    def test_capacity_matches_xla_chain(self, K, NR):
        mc = MonteCarloBD(tile=8, lane=128, K=K, Nr_u=NR)
        bits = _draw_bits(10 * K + NR, mc, 1, 1)
        got, _ = _direct_caps(mc, bits, 1.0)
        H = _channels_from_bits(mc, bits)
        caps = _xla_caps(H, K=K).reshape(1, 1, mc._tile * mc._lane)
        np.testing.assert_allclose(got, caps.sum(axis=-1), rtol=3e-3)
        mean_cap = got.sum() / (mc._tile * mc._lane)
        assert 0.5 < mean_cap < 40.0, mean_cap

    @pytest.mark.heavy  # largest geometry: NT=8, 128 bit planes
    def test_capacity_matches_xla_chain_4x2(self):
        mc = MonteCarloBD(tile=8, lane=128, K=4, Nr_u=2)
        bits = _draw_bits(42, mc, 1, 1)
        got, _ = _direct_caps(mc, bits, 1.0)
        H = _channels_from_bits(mc, bits)
        caps = _xla_caps(H, K=4).reshape(1, 1, mc._tile * mc._lane)
        np.testing.assert_allclose(got, caps.sum(axis=-1), rtol=3e-3)


class TestModeMenu:
    """The water-filling MODE menu of the kernel
    (global / normalized / none), each pinned against the XLA chain's
    mode (reference blockdiagonalization.py:365-565) on identical
    channels."""

    @pytest.mark.parametrize("mode", ["global", "none"])
    def test_capacity_matches_xla_chain(self, mode):
        mc = MonteCarloBD(tile=8, lane=128, K=2, Nr_u=2, mode=mode)
        bits = _draw_bits(60, mc, 1, 1)
        got, _ = _direct_caps(mc, bits, 1.0)
        H = _channels_from_bits(mc, bits)
        caps = _xla_caps(H, K=2, mode=mode).reshape(
            1, 1, mc._tile * mc._lane)
        np.testing.assert_allclose(got, caps.sum(axis=-1), rtol=3e-3)

    def test_mode_ordering(self):
        """Global WF >= normalized (a pure down-scale) >= 0; all three
        modes positive on the same channels."""
        bits = None
        caps = {}
        for mode in ("global", "normalized", "none"):
            mc = MonteCarloBD(tile=8, lane=128, K=2, Nr_u=2, mode=mode)
            if bits is None:
                bits = _draw_bits(61, mc, 1, 1)
            caps[mode] = float(_direct_caps(mc, bits, 1.0)[0].sum())
        assert caps["global"] >= caps["normalized"] > 0
        assert caps["none"] > 0


class TestShardedInject:
    def test_sharded_inject_bit_identical(self):
        """The rep axis sharded over the 8-device CPU mesh under
        shard_map is BIT-identical to the unsharded kernel (the
        absolute-index stream contract, as for the OFDM and Alamouti
        kernels; smallest geometry keeps the interpreter cost down)."""
        from pyphysim_tpu.parallel import make_mesh
        mc = MonteCarloBD(tile=8, lane=128, K=2, Nr_u=1)
        reps, nt = 8, 1
        one = np.asarray(mc.build(reps, nt, interpret=True)(jnp.int32(11)))
        sharded = np.asarray(mc.build(reps, nt, mesh=make_mesh(8),
                                      interpret=True)(jnp.int32(11)))
        assert np.array_equal(one, sharded), (one, sharded)
