"""Benchmark: simulated QAM symbols/s on one GPU through the OFDM+TDL chain.

Prints ONE JSON line: {"metric": ..., "value": N, "unit": ..., "vs_baseline":
N, "device": {...}, ...}. Needs a GPU: without one it exits non-zero.

Chain: 16-QAM -> OFDM(512, cp 52, 300 used) -> COST259-TU TDL with Jakes
Doppler (block-static per OFDM symbol) -> AWGN -> one-tap equalization ->
hard demodulation -> BER count. Monte Carlo realizations vmapped into one
jitted program. Numbers reported:

  * ``value`` (headline) = ``value_xla_fused``: the fused OFDM-over-TDL
    XLA path (ops/fused_ofdm_tdl.py) — the CP both absorbs the convolution tail
    and is discarded, so TX and RX each collapse to ONE matmul and the
    AWGN is injected post-demodulation with the exactly equivalent
    variance; tests pin the fused path's outputs to the time-domain
    chain's (tests/test_fused_ofdm_tdl.py). (A Pallas kernel for this
    chain lost to it on the H100 and was removed; see PERF.md.)
  * ``engine_sym_s``: the same chain through the runner's bulk path.
  * ``value_time_domain``: the UNFUSED chain — full OFDM transforms and
    the general per-block convolution through the channel — so the claim
    "the general channel path is fast" stays independently verifiable.
  * the secondary families (Alamouti, Max-SINR IA, BD CoMP), each as
    its XLA chain and as its Pallas kernel, under separate keys.

BER is asserted at LOW / MID / HIGH SNR corners (5 / 15 / 30 dB), not just
one point, so dtype/precision regressions on either end of the curve fail
the bench rather than silently shipping. Any failing stage raises.

Each stage is one jitted program of many Monte Carlo steps whose summed
error count is fetched to the host (which waits for the device), timed
as the median of several runs after a warm-up.

Baseline (BASELINE.md): reference pyphysim sustains ~4.3e5 simulated
symbols/s on one CPU core (its OFDM+TDL chain is strictly slower).
"""

from __future__ import annotations

import json
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

BASELINE_SYMBOLS_PER_SEC = 4.3e5  # reference, 1 CPU core (BASELINE.md)

# 16-QAM over the per-subcarrier-Rayleigh OFDM/TDL chain: empirical BER
# brackets per SNR corner (wide enough for MC noise at ~1e8 bits, tight
# enough to catch a precision/dtype regression or an elided chain).
BER_CORNERS = {
    5.0: (0.08, 0.22),
    15.0: (0.02, 0.06),
    30.0: (2e-4, 6e-3),
}


def _make_key(seed: int):
    return jax.random.PRNGKey(seed)


def _timed(run, args, n: int = 5):
    """Median of ``n`` timed calls of an already-warm runner, whose
    result is fetched to the host (returns (median_dt, last_total)).
    The totals are seed-deterministic, so every call asserts the same
    physics."""
    times, total = [], None
    for _ in range(n):
        t0 = time.perf_counter()
        total = run(*args)
        times.append(time.perf_counter() - t0)
    return float(np.median(times)), total


def _make_runner(step, batch: int, iters: int):
    """One jitted dispatch: ``iters`` scan steps of a ``batch``-wide vmap,
    returning the total bit-error count (result-dependent fetch)."""

    @jax.jit
    def _run(base_key, snr_linear):
        snrs = jnp.full((batch,), snr_linear)

        def body(carry, i):
            keys = jax.random.split(jax.random.fold_in(base_key, i), batch)
            return carry, jnp.sum(jax.vmap(step)(keys, snrs))

        # per-step totals, summed on the host in python ints: a single
        # int32 accumulator overflows at ~2.1e9 errors (one high-BER
        # corner at this batch is ~4e9) and x64 is disabled on device
        _, per_step = jax.lax.scan(body, 0, jnp.arange(iters))
        return per_step

    def run_many(base_key, snr_linear) -> int:
        return int(np.asarray(_run(base_key, snr_linear),
                              dtype=np.int64).sum())

    return run_many


def _bench_engine(results, log):
    """Engine-in-the-loop: the fused flagship chain self-batched over
    an absolute attempt cursor (apps/ofdm/ofdm_mc_kernel.py) driven by
    the ACTUAL SimulationRunner bulk path (``_gen_bulk_kernel`` ->
    ``_bulk_loop``: chunked dispatch, double-buffered speculation,
    checkpoint throttle ON, early stop off). Reports engine-inclusive
    sym/s next to the fused chain's own rate; the double-buffer
    contract (runner.py:997-1016) is what must hide the per-chunk host
    work — the reference makes the analogous claim for its engine,
    runner.py:1700-1736."""
    import shutil
    import tempfile

    from apps.ofdm.ofdm_mc_kernel import build_bulk_chain
    from pyphysim_tpu.simulations import Result, SimulationRunner

    ofdm_symbols, bsize, rep_max = 4096, 1024, 8192
    # ONE compiled program reused by every runner instance below (the
    # bulk loop always dispatches full bsize chunks when no stop
    # criterion is set, so a single shape suffices)
    run = build_bulk_chain(ofdm_symbols, bsize)
    bits_per_rep = ofdm_symbols * 300 * 4
    snr = 10 ** 1.5

    class _EngineBench(SimulationRunner):
        def __init__(self, rep_max):
            super().__init__(read_command_line_args=False)
            self.params.add("SNR", np.array([15.0]))
            self.params.set_unpack_parameter("SNR")
            self.rep_max = rep_max
            self.batch_size = bsize
            self.update_progress_function_style = None
            self.batch_result_types = {"bit_errors": Result.SUMTYPE,
                                       "ber": Result.RATIOTYPE}

        def _gen_bulk_kernel(self, p):
            def bulk(start, n):
                assert n == bsize, n
                counts = run(jnp.int32(29), jnp.float32(snr),
                             jnp.int32(start))
                return {"bit_errors": counts,
                        "ber": (counts.astype(jnp.float32),
                                np.full(n, float(bits_per_rep)))}

            return bulk

    tmp = tempfile.mkdtemp(prefix="bench_engine_")
    try:
        log("engine: compiling + warmup (one chunk)")
        warm = _EngineBench(bsize)
        warm.update_progress_function_style = None
        warm.simulate()

        bench = _EngineBench(rep_max)
        bench.set_results_filename(tmp + "/engine_bench")
        bench.partial_results_folder = tmp + "/partial"
        t0 = time.perf_counter()
        bench.simulate()
        dt = time.perf_counter() - t0
        ber = float(bench.results.get_result_values_list("ber")[0])
        lo, hi = BER_CORNERS[15.0]
        assert lo < ber < hi, f"implausible engine BER {ber}"
        rate = rep_max * ofdm_symbols * 300 / dt
        results["engine_sym_s"] = rate
        log(f"engine: {rate:.3e} sym/s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# Secondary-family plausibility brackets (empirical, wide enough for MC
# noise at these sample sizes, tight enough to catch an elided chain or
# a precision regression):
ALAMOUTI_BER_10DB = (0.008, 0.030)   # QPSK Alamouti 2x1, measured ~0.017
IA_CAP_RANGE = (6.0, 16.0)   # mean sum cap, K=3 2x2 Ns=1, noise 0.1
BD_CAP_RANGE = (5.0, 16.0)   # mean sum cap, K=3 Nr=2 Nt=6, Pu=10/3


def _make_runner_f(step, batch: int, iters: int):
    """Float-accumulating variant of :func:`_make_runner` (capacity
    sums instead of error counts)."""

    @jax.jit
    def _run(base_key, arg):
        args = jnp.full((batch,), arg)

        def body(carry, i):
            keys = jax.random.split(jax.random.fold_in(base_key, i), batch)
            return carry, jnp.sum(jax.vmap(step)(keys, args))

        _, per_step = jax.lax.scan(body, 0.0, jnp.arange(iters))
        return per_step

    def run_many(base_key, arg) -> float:
        return float(np.asarray(_run(base_key, arg),
                                dtype=np.float64).sum())

    return run_many


def _bench_families(results, log):
    """Secondary Monte Carlo families on the chip (the reference's other
    primary workloads, which it runs one numpy repetition at a time):

    * Alamouti 2x1 QPSK flat-Rayleigh BER chain
      (apps/mimo/simulate_mimo.py:69-141 semantics) -> symbols/s,
    * batched Max-SINR IA sum-capacity sweep (apps/ia/simulate_ia.py,
      10 solver iterations, svd init) -> IA solves/s,
    * batched BD CoMP capacity (comp_BD family,
      blockdiagonalization.py:181-663) -> BD solves/s.

    Each is ONE jitted scan-of-vmapped-reps dispatch with a
    result-dependent fetch and a plausibility assert on its physics; the
    Pallas kernel of each family is timed under its own key.
    """
    from pyphysim_tpu.comm import bd_precoders_batched
    from pyphysim_tpu.ia.batched import (calc_sinrs, max_sinr_solve,
                                         sum_capacity)
    from pyphysim_tpu.mimo import Alamouti
    from pyphysim_tpu.modulators import QPSK
    from pyphysim_tpu.ops import cplx
    from pyphysim_tpu.utils.misc import count_bit_errors, randn_c

    # ---- (a) Alamouti 2x1 flat Rayleigh -----------------------------
    mod = QPSK()
    n = 2048

    def ala_step(key, snr_linear):
        k1, k2, k3 = jax.random.split(key, 3)
        data = jax.random.randint(k1, (n,), 0, 4)
        tx = mod.modulate(data)
        h = randn_c(k2, 1, 2)
        obj = Alamouti(h)
        rx = cplx.matmul(h, obj.encode(tx)) + \
            randn_c(k3, 1, n) * jnp.sqrt(1.0 / snr_linear)
        return count_bit_errors(data, mod.demodulate(obj.decode(rx)))

    batch, iters = 1024, 200
    run = _make_runner(ala_step, batch, iters)
    log("alamouti: compiling + warmup")
    run(_make_key(4), 10.0)
    bits = batch * n * 2 * iters
    dt, errors = _timed(run, (_make_key(5), 10.0))
    ber = errors / bits
    lo, hi = ALAMOUTI_BER_10DB
    assert lo < ber < hi, f"implausible Alamouti BER {ber} at 10 dB"
    results["alamouti_xla_sym_s"] = batch * n * iters / dt
    results["alamouti_ber_10dB"] = ber
    log(f"alamouti (XLA chain): {results['alamouti_xla_sym_s']:.3e} "
        f"sym/s (BER@10dB {ber:.4f})")

    # ---- (a') Alamouti Pallas kernel --------------------------------
    from pyphysim_tpu.ops.alamouti_pallas import MonteCarloAlamouti
    mca = MonteCarloAlamouti()
    reps_a, nt_a, iters_a = 512, 64, 50
    astep = mca.build(reps_a, nt_a)

    @jax.jit
    def _arun(seed, snr_linear):
        def body(carry, i):
            return carry, jnp.sum(astep(seed + i, snr_linear))

        _, per_step = jax.lax.scan(body, 0, jnp.arange(iters_a))
        return per_step

    def arun_many(seed, snr_linear) -> int:
        return int(np.asarray(_arun(jnp.int32(seed), snr_linear),
                              dtype=np.int64).sum())

    sym = reps_a * nt_a * mca.symbols_per_grid_step * iters_a
    log("alamouti-pallas: compiling + warmup")
    arun_many(31, 10.0)
    dt, errors = _timed(arun_many, (37, 10.0))
    ber_k = errors / (sym * 2)
    assert lo < ber_k < hi, \
        f"implausible Alamouti kernel BER {ber_k} at 10 dB"
    results["alamouti_sym_s"] = sym / dt
    results["alamouti_kernel_ber_10dB"] = ber_k
    log(f"alamouti (pallas): {results['alamouti_sym_s']:.3e} sym/s "
        f"(BER@10dB {ber_k:.4f})")

    # ---- (b) Max-SINR IA sum capacity -------------------------------
    def ia_step(key, _):
        H = randn_c(key, 3, 3, 2, 2)
        F, U = max_sinr_solve(H, key, Ns=1, noise_var=0.1,
                              iterations=10, init="svd")
        return sum_capacity(calc_sinrs(H, F, U, 0.1, 1.0))

    batch, iters = 4096, 100
    run = _make_runner_f(ia_step, batch, iters)
    log("ia: compiling + warmup")
    run(_make_key(6), 0.0)
    dt, total_cap = _timed(run, (_make_key(7), 0.0))
    mean_cap = total_cap / (batch * iters)
    lo, hi = IA_CAP_RANGE
    assert lo < mean_cap < hi, f"implausible IA mean capacity {mean_cap}"
    results["ia_maxsinr_xla_solves_s"] = batch * iters / dt
    log(f"ia (XLA chain): {results['ia_maxsinr_xla_solves_s']:.3e} "
        f"solves/s (mean cap {mean_cap:.2f})")

    # ---- (b') Max-SINR IA Pallas kernel -----------------------------
    from pyphysim_tpu.ops.ia_pallas import MonteCarloMaxSinr
    mci = MonteCarloMaxSinr(iterations=10)
    reps_i, nt_i, iters_i = 128, 128, 20
    istep = mci.build(reps_i, nt_i)

    @jax.jit
    def _irun(seed, nv):
        def body(carry, i):
            return carry, jnp.sum(istep(seed + i, nv, 0))

        _, per_step = jax.lax.scan(body, 0.0, jnp.arange(iters_i))
        return per_step

    def irun_many(seed, nv) -> float:
        return float(np.asarray(_irun(jnp.int32(seed), nv),
                                dtype=np.float64).sum())

    solves = reps_i * nt_i * mci.solves_per_grid_step * iters_i
    log("ia-pallas: compiling + warmup")
    irun_many(41, jnp.float32(0.1))
    dt, total_cap = _timed(irun_many, (43, jnp.float32(0.1)))
    mean_cap = total_cap / solves
    assert lo < mean_cap < hi, \
        f"implausible IA kernel mean capacity {mean_cap}"
    results["ia_maxsinr_solves_s"] = solves / dt
    log(f"ia (pallas): {results['ia_maxsinr_solves_s']:.3e} "
        f"solves/s (mean cap {mean_cap:.2f})")

    # ---- (c) BD CoMP capacity ---------------------------------------
    def bd_step(key, _):
        noise_var = 1.0
        H = randn_c(key, 6, 6)
        _, Ms, Sigma = bd_precoders_batched(H, 3, 10.0 / 3, noise_var,
                                            "normalized")
        p = jnp.sum(Ms.re ** 2 + Ms.im ** 2, axis=-2)
        # per-stream SNR = p sigma^2 / noise_var (the noise_var knob
        # applies to the capacity term too, matching ops/bd_pallas.py)
        cap = jnp.sum(jnp.log2(1.0 + p * Sigma ** 2 / noise_var))
        # rare degenerate draws (~1e-5 of a 1e5-draw run) zero out
        # instead of NaN-poisoning the mean — the runner-path __valid__
        # skip semantics, inlined
        # scale-RELATIVE degeneracy guard (library convention, see
        # comm/batched.py _bd_conditioning_ok)
        ok = jnp.min(Sigma) > 1e-6 * jnp.max(Sigma)
        return jnp.where(jnp.isfinite(cap) & ok, cap, 0.0)

    batch, iters = 4096, 100
    run = _make_runner_f(bd_step, batch, iters)
    log("bd: compiling + warmup")
    run(_make_key(8), 0.0)
    dt, total_cap = _timed(run, (_make_key(9), 0.0))
    mean_cap = total_cap / (batch * iters)
    lo, hi = BD_CAP_RANGE
    assert lo < mean_cap < hi, f"implausible BD mean capacity {mean_cap}"
    results["bd_xla_solves_s"] = batch * iters / dt
    log(f"bd (XLA chain): {results['bd_xla_solves_s']:.3e} solves/s "
        f"(mean cap {mean_cap:.2f})")

    # ---- (c') BD CoMP Pallas kernel ---------------------------------
    from pyphysim_tpu.ops.bd_pallas import MonteCarloBD
    mcb = MonteCarloBD()
    reps_b, nt_b, iters_b = 128, 128, 20
    bstep = mcb.build(reps_b, nt_b)

    @jax.jit
    def _brun(seed):
        def body(carry, i):
            return carry, jnp.sum(bstep(seed + i, 0))

        _, per_step = jax.lax.scan(body, 0.0, jnp.arange(iters_b))
        return per_step

    def brun_many(seed) -> float:
        return float(np.asarray(_brun(jnp.int32(seed)),
                                dtype=np.float64).sum())

    solves = reps_b * nt_b * mcb.solves_per_grid_step * iters_b
    log("bd-pallas: compiling + warmup")
    brun_many(47)
    dt, total_cap = _timed(brun_many, (53,))
    mean_cap = total_cap / solves
    assert lo < mean_cap < hi, \
        f"implausible BD kernel mean capacity {mean_cap}"
    results["bd_solves_s"] = solves / dt
    log(f"bd (pallas): {results['bd_solves_s']:.3e} solves/s "
        f"(mean cap {mean_cap:.2f})")


# comp_BD scenario SER bands at the bench point (SNR 20 dB, Pe 10 dBm,
# random drops): the HOST parity engine measured ser_None 0.069,
# ser_capacity 0.0072, ser_Whitening 0.054 at 150 reps; bands are wide
# enough for scenario variance at >=2048 reps, tight enough to catch an
# elided/degenerate device program.
COMP_BD_SER_CAPACITY = (0.0015, 0.03)
COMP_BD_SER_NONE = (0.025, 0.15)


def _bench_comp_bd_scenario(results, log):
    """Hardware number for the FULL comp_BD scenario ENGINE: the
    biggest app (apps/comp_BD/simulate_comp.py — random user drops in
    the hexagon fan, pathloss channels, external interference, the
    EnhancedBD/WhiteningBD solver sweep, SER/BER/PER accounting)
    driven end to end by SimulationRunner's bulk path on the chip, at
    one (SNR, Pe) point with capped reps — the engine-delivers-it
    claim the OFDM family already earns via engine_sym_s (reference
    claim surface: apps/comp_BD/simulate_comp.py:1-883). A 3-metric
    subset (None/capacity/Whitening) keeps the device program's
    compile inside the bench budget; the compiled program is shared
    between the warm and timed runners via the app's _vkernels cache."""
    import os
    import sys as _sys

    repo = os.path.dirname(os.path.abspath(__file__))
    if repo not in _sys.path:
        _sys.path.insert(0, repo)
    from apps.comp_BD.simulate_comp import BDSimulationRunner

    def make(rep_max):
        r = BDSimulationRunner(read_command_line_args=False,
                               engine="device",
                               metrics=["None", "capacity", "Whitening"])
        r.params.add("SNR", np.array([20.0]))
        r.params.add("Pe_dBm", np.array([10.0]))
        r.params.add("user_positioning_method", "Random")
        r.rep_max = rep_max
        # the program is latency-bound (serial small-op solver chain):
        # chunk time grows far sublinearly with the chunk width
        r.batch_size = 4096
        r.update_progress_function_style = None
        return r

    log("comp_bd: compiling + warmup (one chunk)")
    warm = make(4096)
    warm.simulate()

    reps = 16384
    bench = make(reps)
    bench._vkernels = warm._vkernels  # reuse the compiled program
    t0 = time.perf_counter()
    bench.simulate()
    dt = time.perf_counter() - t0
    sers = {m: float(bench.results.get_result_values_list(f"ser_{m}")[0])
            for m in ("None", "capacity", "Whitening")}
    lo, hi = COMP_BD_SER_CAPACITY
    assert lo < sers["capacity"] < hi, \
        f"implausible comp_bd ser_capacity {sers['capacity']}"
    lo, hi = COMP_BD_SER_NONE
    assert lo < sers["None"] < hi, \
        f"implausible comp_bd ser_None {sers['None']}"
    assert sers["capacity"] < sers["None"], sers
    results["comp_bd_scenario_reps_s"] = reps / dt
    results["comp_bd_scenario_ser_capacity"] = sers["capacity"]
    results["comp_bd_scenario_ser_none"] = sers["None"]
    log(f"comp_bd scenario engine: "
        f"{results['comp_bd_scenario_reps_s']:.3e} reps/s "
        f"(ser None/capacity/Whitening = {sers['None']:.4f}/"
        f"{sers['capacity']:.4f}/{sers['Whitening']:.4f})")


def bench_ofdm_tdl():
    import pyphysim_tpu.ops.fft as cfft
    cfft.FOUR_STEP_MIN = 10_000  # direct DFT matmul beats 4-step here
    import __graft_entry__ as g

    results = {}

    def log(msg):
        print(f"[bench {time.strftime('%H:%M:%S')}] {msg}",
              file=sys.stderr, flush=True)

    _bench_engine(results, log)

    # ---- fused diag-collapse path --------------------------------------
    batch, num_symbols, iters = 512, 300 * 16, 400
    step = g._make_chain_step(num_symbols=num_symbols, fft_size=512,
                              cp_size=52, num_used=300, block_static=True,
                              precision=jax.lax.Precision.DEFAULT,
                              signal_dtype=jnp.bfloat16, fused=True)
    run_many = _make_runner(step, batch, iters)
    bits = batch * num_symbols * 4 * iters

    log("fused: compiling + warmup")
    run_many(_make_key(0), 10 ** 1.5)
    log("fused: warm")

    # BER corners: same compiled program, one dispatch per corner
    for snr_db, (lo, hi) in BER_CORNERS.items():
        ber = run_many(_make_key(2), 10 ** (snr_db / 10.0)) / bits
        log(f"fused: BER at {snr_db} dB = {ber:.5f}")
        assert lo < ber < hi, f"implausible BER {ber} at {snr_db} dB"
        results[f"ber_{snr_db:g}dB"] = ber

    dt, total_errors = _timed(run_many, (_make_key(1), 10 ** 1.5))
    lo, hi = BER_CORNERS[15.0]
    assert lo < total_errors / bits < hi
    results["value_xla_fused"] = batch * num_symbols * iters / dt
    results["value"] = results["value_xla_fused"]
    log(f"fused: {results['value_xla_fused']:.3e} sym/s")

    # ---- unfused time-domain chain -----------------------------------
    batch, num_symbols, iters = 256, 300 * 32, 100
    step_td = g._make_chain_step(num_symbols=num_symbols, fft_size=512,
                                 cp_size=52, num_used=300,
                                 block_static=True,
                                 precision=jax.lax.Precision.DEFAULT,
                                 signal_dtype=jnp.bfloat16, fused=False)
    run_td = _make_runner(step_td, batch, iters)
    bits = batch * num_symbols * 4 * iters
    log("time-domain: compiling + warmup")
    run_td(_make_key(0), 10 ** 1.5)
    log("time-domain: warm")
    dt, total_errors = _timed(run_td, (_make_key(1), 10 ** 1.5))
    ber = total_errors / bits
    lo, hi = BER_CORNERS[15.0]
    assert lo < ber < hi, f"implausible time-domain BER {ber}"
    results["value_time_domain"] = batch * num_symbols * iters / dt
    log(f"time-domain: {results['value_time_domain']:.3e} sym/s")

    _bench_families(results, log)
    _bench_comp_bd_scenario(results, log)
    return results


def main() -> int:
    from chip_smoke import card_name_and_power_limit, use_compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench: needs a GPU, JAX found {dev.platform!r}",
              file=sys.stderr)
        return 1
    use_compile_cache(jax)
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices()),
              "name_power_limit": card_name_and_power_limit()}
    r = bench_ofdm_tdl()
    print(json.dumps({
        "metric": "simulated QAM symbols/s on one GPU (OFDM+TDL chain)",
        "device": device,
        "value": r["value"],
        "unit": "symbols/s",
        "vs_baseline": r["value"] / BASELINE_SYMBOLS_PER_SEC,
        "value_xla_fused": r.get("value_xla_fused"),
        "value_time_domain": r["value_time_domain"],
        "vs_baseline_time_domain":
            r["value_time_domain"] / BASELINE_SYMBOLS_PER_SEC,
        "ber_corners": {k: v for k, v in r.items()
                        if k.startswith("ber_")},
        "engine_sym_s": r.get("engine_sym_s"),
        "families": {k: r[k] for k in
                     ("alamouti_sym_s", "alamouti_xla_sym_s",
                      "alamouti_ber_10dB", "alamouti_kernel_ber_10dB",
                      "ia_maxsinr_solves_s", "ia_maxsinr_xla_solves_s",
                      "bd_solves_s", "bd_xla_solves_s",
                      "comp_bd_scenario_reps_s",
                      "comp_bd_scenario_ser_capacity",
                      "comp_bd_scenario_ser_none") if k in r},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
