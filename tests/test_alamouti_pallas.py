"""Tests for the monolithic Alamouti Monte-Carlo Pallas kernel
(ops/alamouti_pallas.py): the kernel draws its bits from the counter-based generator, so the tests draw the
same bits and the interpreted kernel (``interpret=True``) is pinned
against (a) an independent numpy model fed those bits and (b) the
repo's (already test-pinned) mimo.Alamouti + QPSK chain fed the same
realizations; BER is then checked against the chain's empirical corner
with honest Monte Carlo statistics."""

import math

import jax
import jax.numpy as jnp
import numpy as np
from scipy.special import erfinv

from pyphysim_tpu.mimo import Alamouti
from pyphysim_tpu.modulators import QPSK
from pyphysim_tpu.ops import cplx
from pyphysim_tpu.ops.alamouti_pallas import MonteCarloAlamouti
from pyphysim_tpu.ops.counter_rng import random_bits, u11

CLIP = 0.99999994


SNR = 10.0
AMP = np.float32(math.sqrt(0.5 / SNR))


def _draw_bits(seed, mc, reps, num_tiles, start=0):
    """The kernel's generator words: per-(rep, lane) channel bits
    ``(reps, 4, lane)`` (h1re, h1im, h2re, h2im) and per-element data
    and noise bits ``(reps, num_tiles * tile, lane)``."""
    tile, lane = mc._tile, mc._lane
    lanes = jnp.arange(lane, dtype=jnp.uint32)[None, :]
    elem = (jnp.arange(num_tiles * tile, dtype=jnp.uint32)[:, None] *
            lane + lanes)
    out = []
    for r in range(reps):
        key = (np.uint32(seed), np.uint32(start + r))
        ch = jnp.concatenate(random_bits(*key, lanes, 0) +
                             random_bits(*key, lanes, 1))
        planes = (random_bits(*key, elem, 2) + random_bits(*key, elem, 3) +
                  random_bits(*key, elem, 4)[:1])
        out.append((ch, *planes))
    return tuple(jnp.stack(x) for x in zip(*out))


def _run(mc, seed, reps, num_tiles, start=0, mesh=None):
    fn = mc.build(reps, num_tiles, mesh=mesh, interpret=True)
    return np.asarray(fn(jnp.int32(seed), np.float32(SNR),
                         jnp.int32(start)), np.int64)


def _gauss_np(bits):
    return erfinv(np.clip(np.asarray(u11(bits)), -CLIP, CLIP))


def _realizations(mc, ch, d, n1r, n1i, n2r, n2i):
    """Map the raw bits to (h, data indices, noise) exactly as the
    kernel does — shared by both reference models."""
    h1 = _gauss_np(ch[:, 0:1, :]) + 1j * _gauss_np(ch[:, 1:2, :])
    h2 = _gauss_np(ch[:, 2:3, :]) + 1j * _gauss_np(ch[:, 3:4, :])
    idx = np.asarray(d).astype(np.int64) & 15
    s2 = math.sqrt(2.0)
    n1 = (_gauss_np(n1r) + 1j * _gauss_np(n1i)) * s2
    n2 = (_gauss_np(n2r) + 1j * _gauss_np(n2i)) * s2
    return h1[:, 0], h2[:, 0], idx, n1, n2


def _model_counts(mc, ch, d, n1r, n1i, n2r, n2i, amp):
    """Independent complex-arithmetic numpy model."""
    tile = mc._tile
    reps = ch.shape[0]
    num_tiles = d.shape[1] // tile
    h1, h2, idx, n1, n2 = _realizations(mc, ch, d, n1r, n1i, n2r, n2i)
    c = 1.0 / math.sqrt(2.0)
    s1 = ((1 - 2 * (idx & 1)) + 1j * (1 - 2 * ((idx >> 1) & 1))) * c
    s2_ = ((1 - 2 * ((idx >> 2) & 1)) +
           1j * (1 - 2 * ((idx >> 3) & 1))) * c
    H1, H2 = h1[:, None, :], h2[:, None, :]
    r1 = (H1 * s1 + H2 * s2_) * c + amp * n1
    r2 = (-H1 * np.conj(s2_) + H2 * np.conj(s1)) * c + amp * n2
    d1 = np.conj(H1) * r1 + H2 * np.conj(r2)
    d2 = np.conj(H2) * r1 - H1 * np.conj(r2)
    decided = ((d1.real < 0).astype(np.int64) |
               ((d1.imag < 0).astype(np.int64) << 1) |
               ((d2.real < 0).astype(np.int64) << 2) |
               ((d2.imag < 0).astype(np.int64) << 3))
    diff = idx ^ decided
    errs = sum((diff >> k) & 1 for k in range(4))
    return errs.reshape(reps, num_tiles, tile, -1).sum(axis=(2, 3))


class TestInjectMatchesModel:
    def test_counts_match_independent_model(self):
        mc = MonteCarloAlamouti(tile=32, lane=128)
        reps, num_tiles = 2, 2
        bits = _draw_bits(0, mc, reps, num_tiles, start=5)
        got = _run(mc, 0, reps, num_tiles, start=5)
        want = _model_counts(mc, *bits, AMP)
        total = 2 * mc._tile * mc._lane * 2 * 2
        # identical realizations; tolerate a handful of decision-
        # boundary flips from f32-vs-f64 association differences
        assert np.abs(got - want).sum() <= max(4, total // 200_000), \
            (got, want)

    def test_counts_match_library_chain(self):
        """The same realizations through the TESTED mimo.Alamouti +
        QPSK objects give the same error counts: the kernel's collapsed
        sign arithmetic IS the library chain."""
        mc = MonteCarloAlamouti(tile=32, lane=128)
        reps, num_tiles = 2, 1
        bits = _draw_bits(3, mc, reps, num_tiles)
        amp = AMP
        got = _run(mc, 3, reps, num_tiles)

        h1, h2, idx, n1, n2 = _realizations(mc, *bits[:6])
        mod = QPSK()
        want = np.zeros((reps, num_tiles), np.int64)
        for r in range(reps):
            for lane_i in range(mc._lane):
                data = np.stack([idx[r, :, lane_i] & 3,
                                 (idx[r, :, lane_i] >> 2) & 3],
                                axis=-1).reshape(-1)      # interleaved
                tx = np.asarray(mod.modulate(data))
                h = np.array([[h1[r, lane_i], h2[r, lane_i]]])
                obj = Alamouti(h)
                enc = obj.encode(tx)                      # (2, n)
                noise = np.stack([n1[r, :, lane_i],
                                  n2[r, :, lane_i]], axis=-1).reshape(-1)
                rx = (h @ np.asarray(enc) + amp * noise[None, :])
                dec = obj.decode(rx)
                decided = np.asarray(mod.demodulate(np.asarray(dec)))
                want[r, 0] += int(np.sum(
                    (data ^ decided) & 1) + np.sum((data ^ decided) >> 1))
        assert np.abs(got - want).sum() <= 4, (got, want)

    def test_ber_matches_theory(self):
        """BER at 10 dB inside the empirical bracket used by bench.py
        (diversity-2 Alamouti 2x1 QPSK, measured ~0.017)."""
        mc = MonteCarloAlamouti(tile=64, lane=256)
        reps, num_tiles = 4, 2
        counts = _run(mc, 7, reps, num_tiles)
        total_bits = reps * num_tiles * mc._tile * mc._lane * 4
        ber = counts.sum() / total_bits
        assert 0.008 < ber < 0.030, ber

    def test_stream_contract_channel_constant_per_rep(self):
        """Per (rep, lane) the channel is drawn once and every word is
        keyed by absolute coordinates: tile 0 of a rep has the same
        count whether the rep has one tile or two, and rep r of a call
        at ``start`` is attempt start + r."""
        mc = MonteCarloAlamouti(tile=32, lane=128)
        two = _run(mc, 9, 2, 2)
        one = _run(mc, 9, 2, 1)
        np.testing.assert_array_equal(two[:, :1], one)
        np.testing.assert_array_equal(_run(mc, 9, 1, 2, start=1), two[1:])

    def test_sharded_inject_bit_identical(self):
        """The rep axis sharded over the 8-device CPU mesh under
        shard_map is BIT-identical to the unsharded kernel (the
        absolute-index stream contract, as for the OFDM kernel)."""
        from pyphysim_tpu.parallel import make_mesh
        mc = MonteCarloAlamouti(tile=16, lane=128)
        reps, num_tiles = 8, 2
        one = _run(mc, 11, reps, num_tiles)
        sharded = _run(mc, 11, reps, num_tiles, mesh=make_mesh(8))
        assert np.array_equal(one, sharded), (one, sharded)


class TestAlamoutiMcKernelApp:
    def test_runner_sweep_ber_monotone_and_bracketed(self):
        """The bulk-path app (apps/mimo/alamouti_mc_kernel.py) on the
        CPU interpreter: BER decreasing in SNR, 10 dB point inside the
        bench bracket, chunk-size invariant."""
        sys_path = __import__("sys").path
        import os
        sys_path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
        from apps.mimo.alamouti_mc_kernel import \
            AlamoutiMcKernelSimulationRunner

        r = AlamoutiMcKernelSimulationRunner(tile=16, lane=128,
                                             num_tiles=2, interpret=True)
        r.params.add("SNR", np.array([0.0, 10.0]))
        r.rep_max = 4
        r.batch_size = 2
        r.update_progress_function_style = None
        r.simulate()
        ber = [float(v) for v in
               r.results.get_result_values_list("ber")]
        assert ber[1] < ber[0] < 0.5
        assert 0.008 < ber[1] < 0.030, ber

        r2 = AlamoutiMcKernelSimulationRunner(tile=16, lane=128,
                                              num_tiles=2, interpret=True)
        r2.params.add("SNR", np.array([0.0, 10.0]))
        r2.rep_max = 4
        r2.batch_size = 4
        r2.update_progress_function_style = None
        r2.simulate()
        ber2 = [float(v) for v in
                r2.results.get_result_values_list("ber")]
        assert ber == ber2  # absolute-attempt-cursor contract
