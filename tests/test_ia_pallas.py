"""Tests for the Max-SINR IA Pallas kernel (ops/ia_pallas.py): the
channel bits come from the counter-based generator, so the tests draw
the same bits, and the CPU interpreter pins the full bit->capacity
pipeline against the (already host-pinned) XLA solver
``ia/batched.max_sinr_solve`` on IDENTICAL channel realizations."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy.special import erfinv

from pyphysim_tpu.ia.batched import calc_sinrs, max_sinr_solve, sum_capacity
from pyphysim_tpu.ops import cplx
from pyphysim_tpu.ops.ia_pallas import MonteCarloMaxSinr
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
    """(reps, rows, elements...) -> complex H of shape
    (n_elem, K, K, N, N), exactly the kernel's bit->Gaussian map."""
    lane = mc._lane
    K, N = mc._K, mc._N
    bits = np.asarray(ch_bits)
    reps, rows, _ = bits.shape
    planes = bits.reshape(reps, rows, mc.num_planes, lane)

    def gauss(b):
        return erfinv(np.clip(np.asarray(u11(b)), -CLIP, CLIP))

    H = np.zeros((reps, rows, lane, K, K, N, N), np.complex64)
    idx = 0
    for k in range(K):
        for j in range(K):
            for e in range(N * N):
                re = gauss(planes[:, :, idx])
                im = gauss(planes[:, :, idx + 1])
                idx += 2
                H[..., k, j, e // N, e % N] = re + 1j * im
    return H.reshape(-1, K, K, N, N)


_DIRECT_CACHE = {}


def _direct_caps(mc, bits, noise_var):
    """Run the kernel math as a plain jitted jax function (the
    pallas_call is a thin bit-drawing wrapper around _solve_block; its
    plumbing is covered by test_inject_plumbing).
    noise_var is TRACED and the jitted program cached per kernel
    shape, so the XLA:CPU compile of the unrolled recursion is paid
    once per (tile, lane, iterations) across the whole module."""
    lane = mc._lane
    num_planes = mc.num_planes
    reps, rows, _ = bits.shape
    nt = rows // mc._tile
    key = (mc._tile, lane, mc._iters, reps, nt, mc._K, mc._N,
           mc._Ns, mc._init_iters)
    if key not in _DIRECT_CACHE:
        @jax.jit
        def run(b, nv):
            blocks = b.reshape(reps * nt, mc._tile, num_planes, lane)

            def one(block):
                planes = [block[:, i] for i in range(num_planes)]
                return mc._solve_block(planes, nv)

            return jax.vmap(one)(blocks).reshape(reps, nt, -1)

        _DIRECT_CACHE[key] = run
    per_elem = np.asarray(_DIRECT_CACHE[key](
        bits.astype(jnp.int32), jnp.float32(noise_var)))
    return per_elem.sum(axis=-1), per_elem


class TestInjectMatchesXlaSolver:
    def test_inject_plumbing(self):
        """The interpreted kernel draws exactly the documented generator
        bits and reproduces the direct _solve_block math on them."""
        mc = MonteCarloMaxSinr(tile=8, lane=128, iterations=1)
        bits = _draw_bits(9, mc, 1, 1)
        got = np.asarray(mc.build(1, 1, interpret=True)(jnp.int32(9), 0.1))
        want, _ = _direct_caps(mc, bits, 0.1)
        np.testing.assert_allclose(got, want, rtol=1e-5)

    def test_capacity_matches_xla_solver_per_batch(self):
        """Kernel capacity sums vs the XLA max_sinr_solve chain on the
        SAME channels: the svd-init fixed-iteration recursion is
        deterministic, so the sums must agree to f32 accumulation
        accuracy (4 iterations here — the same unrolled code path as
        the bench's 10, sized for CI compile time)."""
        mc = MonteCarloMaxSinr(tile=8, lane=128, iterations=4)
        reps, nt = 1, 1
        noise_var = 0.1
        bits = _draw_bits(0, mc, reps, nt)
        got, _ = _direct_caps(mc, bits, noise_var)

        H = _channels_from_bits(mc, bits)
        Hc = cplx.from_numpy(H)

        def one(h):
            F, U = max_sinr_solve(h, jax.random.PRNGKey(0), Ns=1,
                                  noise_var=noise_var, iterations=4,
                                  init="svd")
            return sum_capacity(calc_sinrs(h, F, U, noise_var, 1.0))

        caps = np.asarray(jax.jit(jax.vmap(one))(Hc))
        caps = caps.reshape(reps, nt, mc._tile * mc._lane)
        want = caps.sum(axis=-1)
        np.testing.assert_allclose(got, want, rtol=3e-3)
        # and the physics is plausible (bench IA_CAP_RANGE band)
        mean_cap = got.sum() / (reps * nt * mc._tile * mc._lane)
        assert 6.0 < mean_cap < 16.0, mean_cap

    def test_noise_var_monotonicity(self):
        """More noise -> less capacity, through the whole kernel."""
        mc = MonteCarloMaxSinr(tile=8, lane=128, iterations=4)
        bits = _draw_bits(3, mc, 1, 1)
        lo = float(_direct_caps(mc, bits, 0.05)[0].sum())
        hi = float(_direct_caps(mc, bits, 0.5)[0].sum())
        assert hi < lo

    def test_iterations_improve_alignment(self):
        """The recursion converges: 4 iterations beat 1 on average."""
        mc1 = MonteCarloMaxSinr(tile=8, lane=128, iterations=1)
        mc4 = MonteCarloMaxSinr(tile=8, lane=128, iterations=4)
        bits = _draw_bits(5, mc1, 1, 1)
        c1 = float(_direct_caps(mc1, bits, 0.1)[0].sum())
        c4 = float(_direct_caps(mc4, bits, 0.1)[0].sum())
        assert c4 > c1


class TestGeometryMenu:
    """The kernel tier's K menu (VERDICT r4 item 3): each user count
    pinned against the shape-general XLA solver (reference
    algorithms.py:1243-1504) on identical channel realizations."""

    # iterations=1 keeps the K=4 XLA:CPU compile inside the default
    # profile's budget; parity is iteration-matched so the evidence is
    # the same recursion either way
    @pytest.mark.parametrize("K", [2, 4])
    def test_capacity_matches_xla_solver(self, K):
        mc = MonteCarloMaxSinr(tile=8, lane=128, iterations=1, K=K)
        noise_var = 0.1
        bits = _draw_bits(20 + K, mc, 1, 1)
        got, _ = _direct_caps(mc, bits, noise_var)

        H = _channels_from_bits(mc, bits)
        Hc = cplx.from_numpy(H)

        def one(h):
            F, U = max_sinr_solve(h, jax.random.PRNGKey(0), Ns=1,
                                  noise_var=noise_var, iterations=1,
                                  init="svd")
            return sum_capacity(calc_sinrs(h, F, U, noise_var, 1.0))

        caps = np.asarray(jax.jit(jax.vmap(one))(Hc))
        want = caps.reshape(1, 1, mc._tile * mc._lane).sum(axis=-1)
        np.testing.assert_allclose(got, want, rtol=3e-3)


def _orth_iter_init_np(G, Ns, iters):
    """Numpy replication of the kernel's orthogonal-iteration init:
    G (B, N, N) Hermitian PSD -> (B, N, Ns) orthonormal columns."""
    B, N, _ = G.shape
    V = np.zeros((B, N, Ns), np.complex64)
    for l in range(Ns):
        V[:, l, l] = 1.0
    for _ in range(iters):
        W = np.einsum("bij,bjl->bil", G, V)
        Q = np.zeros_like(W)
        for l in range(Ns):
            v = W[:, :, l]
            for m in range(l):
                q = Q[:, :, m]
                proj = np.sum(np.conj(q) * v, axis=-1, keepdims=True)
                v = v - proj * q
            nrm = np.sqrt(np.sum(np.abs(v) ** 2, axis=-1,
                                 keepdims=True))
            Q[:, :, l] = v / np.maximum(nrm, 1e-30)
        V = Q
    return V


class TestAntennaStreamMenu:
    """Antenna/stream variants of the kernel menu (VERDICT r4 item 3's
    'Ns and antenna variants for IA'): the general (K, N, Ns) plane
    program pinned against the XLA solver on identical channels AND
    identical initialization (init='fix' — the reference's 'fix'
    option, algorithms.py:347-368 — fed the numpy replication of the
    kernel's orthogonal-iteration init)."""

    @pytest.mark.heavy  # ~50 s each: the 4x4 general program's
    # XLA:CPU compile dominates; the default profile still pins the
    # K menu and the (2,1) bench point, and the FULL profile (recorded
    # in CLAUDE.md) runs these
    @pytest.mark.parametrize("K,N,Ns", [(3, 4, 1), (2, 4, 2)])
    def test_capacity_matches_xla_solver_fix_init(self, K, N, Ns):
        mc = MonteCarloMaxSinr(tile=8, lane=128, iterations=2, K=K,
                               N=N, Ns=Ns, init_iters=4)
        noise_var = 0.1
        bits = _draw_bits(100 + 10 * K + Ns, mc, 1, 1)
        got, _ = _direct_caps(mc, bits, noise_var)

        H = _channels_from_bits(mc, bits)          # (B, K, K, N, N)
        B = H.shape[0]
        F0 = np.zeros((B, K, N, Ns), np.complex64)
        for k in range(K):
            Hkk = H[:, k, k]
            G = np.einsum("bij,bil->bjl", np.conj(Hkk), Hkk)
            F0[:, k] = _orth_iter_init_np(G, Ns, 4) / np.sqrt(Ns)

        def one(h, f0):
            F, U = max_sinr_solve(h, jax.random.PRNGKey(0), Ns=Ns,
                                  noise_var=noise_var, iterations=2,
                                  init="fix", F0=f0)
            return sum_capacity(
                calc_sinrs(h, F, U, noise_var, 1.0, Ns=Ns))

        caps = np.asarray(jax.jit(jax.vmap(one))(
            cplx.from_numpy(H), cplx.from_numpy(F0)))
        want = caps.reshape(1, 1, mc._tile * mc._lane).sum(axis=-1)
        np.testing.assert_allclose(got, want, rtol=5e-3)
        mean_cap = got.sum() / (mc._tile * mc._lane)
        assert 1.0 < mean_cap < 60.0, mean_cap


class TestShardedInject:
    def test_sharded_inject_bit_identical(self):
        """The rep axis sharded over the 8-device CPU mesh under
        shard_map is BIT-identical to the unsharded kernel (the
        absolute-index stream contract, as for the OFDM and Alamouti
        kernels)."""
        from pyphysim_tpu.parallel import make_mesh
        mc = MonteCarloMaxSinr(tile=8, lane=128, iterations=1, K=2)
        reps, nt = 8, 1
        one = np.asarray(mc.build(reps, nt, interpret=True)(
            jnp.int32(31), 0.1))
        sharded = np.asarray(mc.build(reps, nt, mesh=make_mesh(8),
                                      interpret=True)(jnp.int32(31), 0.1))
        assert np.array_equal(one, sharded), (one, sharded)


class TestIaMcKernelApp:
    def test_runner_sweep_capacity_monotone_and_chunk_invariant(self):
        """The bulk-path app (apps/ia/ia_mc_kernel.py) on the CPU
        interpreter at a K-menu point: sum capacity grows with SNR,
        and results are chunk-size invariant (the absolute-attempt-
        cursor contract)."""
        import os
        import sys
        sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
        from apps.ia.ia_mc_kernel import IaMcKernelSimulationRunner

        def make(batch):
            r = IaMcKernelSimulationRunner(K=2, tile=8, lane=128,
                                           num_tiles=1, iterations=1,
                                           interpret=True)
            r.params.add("SNR", np.array([0.0, 15.0]))
            r.rep_max = 4
            r.batch_size = batch
            r.update_progress_function_style = None
            return r

        r1 = make(2)
        r1.simulate()
        caps = [float(v) for v in
                r1.results.get_result_values_list("sum_capacity")]
        assert caps[1] > caps[0] > 0.0, caps

        r2 = make(4)
        r2.simulate()
        caps2 = [float(v) for v in
                 r2.results.get_result_values_list("sum_capacity")]
        assert caps == caps2  # absolute-attempt-cursor contract
