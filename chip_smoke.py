#!/usr/bin/env python
"""Smoke run of the flagship Monte Carlo BER sweep on one GPU.

Runs in ONE process, in phases, each printing its own lines:

1. device   -- JAX's platform, device kind and count, and the card's name
               and power limit from ``nvidia-smi`` (a child process that
               never imports JAX). Anything but a GPU fails the run.
2. compile  -- every Pallas kernel compiled at its real widths
               (``interpret=False``), with ``memory_analysis()``.
3. check    -- each kernel against its plain XLA reference on the card,
               with the tolerance and precision printed on the line.
4. sweep    -- the flagship BER sweep (16-QAM / OFDM 512, cp 52, 300 used /
               COST259-TU TDL with Jakes Doppler / one-tap equalizer) at
               SNR 0:5:30 dB through ``SimulationRunner.simulate()``:
               the batch path with the fused XLA chain and with the
               unfused time-domain chain (the plain reference), and the
               bulk path (the fused chain self-batched over an absolute
               attempt cursor, ``apps/ofdm/ofdm_mc_kernel.py``). BER at
               5/15/30 dB must lie inside ``bench.BER_CORNERS`` and, at
               every SNR, both fused paths must agree with the time-domain
               chain within 99% confidence intervals.
5. timing   -- each kernel against XLA's plain version of the same work,
               in turns after a warm-up, median of 5 runs and spread.

``--devices 4`` runs only the multi-card phase on a 1-D mesh of four
cards: the flagship batch and bulk paths under ``simulate_in_parallel``,
the bulk chain's and the IA kernel's ``build(mesh=)``, each compared bit
for bit with the same work on one card, and a check that every card
held work.

The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
Any failure raises and exits non-zero before it is printed.

``--rehearse`` runs every phase on the CPU at toy sizes with the kernels
under the Pallas interpreter, to check the control flow without a card;
it prints no result line.

Usage::

    python chip_smoke.py               # phases 1-5 on one GPU
    python chip_smoke.py --devices 4   # the four-card phase only

On the GPU, the persistent compilation cache goes where
``JAX_COMPILATION_CACHE_DIR`` says, and otherwise to ``.jax_cache/``
beside this file.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
SNRS_DB = (0.0, 5.0, 10.0, 15.0, 20.0, 25.0, 30.0)


@dataclasses.dataclass(frozen=True)
class Sizes:
    """Work sizes: ``FULL`` is what users run, ``TOY`` the rehearsal."""
    # bulk path: a repetition is ofdm_symbols OFDM symbols (x 300 bins)
    ofdm_symbols: int
    bulk_reps: int          # repetitions per chunk and per SNR point
    # batch path: one repetition = chain_symbols QAM symbols
    chain_symbols: int
    chain_batch: int
    chain_reps: int
    # IA / BD kernels: repetitions x tiles of 128-solve blocks
    solve_reps: int
    solve_tiles: int
    # Alamouti kernel: repetitions x tiles of 8 x 128 codewords
    ala_reps: int
    ala_tiles: int
    timing_runs: int
    devices_snrs_db: tuple


FULL = Sizes(ofdm_symbols=4096, bulk_reps=1024,
             chain_symbols=4800, chain_batch=4096, chain_reps=24576,
             solve_reps=128, solve_tiles=128, ala_reps=512, ala_tiles=64,
             timing_runs=5, devices_snrs_db=(5.0, 15.0, 30.0))
TOY = Sizes(ofdm_symbols=4, bulk_reps=8,
            chain_symbols=600, chain_batch=8, chain_reps=16,
            solve_reps=4, solve_tiles=1, ala_reps=2, ala_tiles=1,
            timing_runs=5, devices_snrs_db=(5.0, 15.0, 30.0))


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def card_name_and_power_limit() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def use_compile_cache(jax) -> str:
    directory = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not directory:
        directory = os.path.join(REPO, ".jax_cache")
        jax.config.update("jax_compilation_cache_dir", directory)
    return directory


def timed(fns, runs: int):
    """Median and spread of ``runs`` timings of each function, taken in
    turns after one warm-up each; every run ends in block_until_ready."""
    import jax
    for fn in fns.values():
        jax.block_until_ready(fn())
    times = {name: [] for name in fns}
    for _ in range(runs):
        for name, fn in fns.items():
            t0 = time.perf_counter()
            jax.block_until_ready(fn())
            times[name].append(time.perf_counter() - t0)
    return {name: (statistics.median(ts), min(ts), max(ts))
            for name, ts in times.items()}


# ---------------------------------------------------------------------------
# the kernels and their plain references
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Kernel:
    obj: object             # the kernel builder
    fn: object              # the compiled kernel (jitted)
    args: tuple             # its arguments
    reference: object       # plain XLA version of the same work (jitted)
    work: int               # units of work per call
    unit: str


def make_kernels(sz: Sizes, interpret: bool):
    import jax
    import jax.numpy as jnp

    from pyphysim_tpu.ops.alamouti_pallas import MonteCarloAlamouti
    from pyphysim_tpu.ops.bd_pallas import MonteCarloBD
    from pyphysim_tpu.ops.ia_pallas import MonteCarloMaxSinr

    ia, bd, ala = MonteCarloMaxSinr(), MonteCarloBD(), MonteCarloAlamouti()
    seed, start = jnp.int32(17), jnp.int32(0)
    nv, snr = jnp.float32(0.1), jnp.float32(10.0)
    R, T = sz.solve_reps, sz.solve_tiles
    AR, AT = sz.ala_reps, sz.ala_tiles
    return {
        "ia_max_sinr": Kernel(
            ia, ia.build(R, T, interpret=interpret), (seed, nv, start),
            jax.jit(lambda: ia.reference_caps(R, T, seed, nv)),
            R * T * ia.solves_per_grid_step, "solves"),
        "bd_capacity": Kernel(
            bd, bd.build(R, T, interpret=interpret), (seed, start),
            jax.jit(lambda: bd.reference_caps(R, T, seed)),
            R * T * bd.solves_per_grid_step, "solves"),
        "alamouti": Kernel(
            ala, ala.build(AR, AT, interpret=interpret), (seed, snr, start),
            jax.jit(lambda: ala.reference_counts(AR, AT, seed, snr)),
            AR * AT * ala.symbols_per_grid_step, "symbols"),
    }


def phase_compile(kernels) -> None:
    fields = ("argument_size_in_bytes", "output_size_in_bytes",
              "temp_size_in_bytes", "generated_code_size_in_bytes")
    for name, k in kernels.items():
        t0 = time.perf_counter()
        ma = k.fn.lower(*k.args).compile().memory_analysis()
        stats = ", ".join(f"{f}={getattr(ma, f, None)}" for f in fields)
        log("compile", f"{name}: {time.perf_counter() - t0:.1f} s; "
            f"memory_analysis: {stats}")


def phase_check(kernels) -> None:
    import numpy as np

    from bench import ALAMOUTI_BER_10DB, BD_CAP_RANGE, IA_CAP_RANGE

    for name, cap_range in (("ia_max_sinr", IA_CAP_RANGE),
                            ("bd_capacity", BD_CAP_RANGE)):
        k = kernels[name]
        got = np.asarray(k.fn(*k.args), np.float64)
        want = np.asarray(k.reference(), np.float64)
        rel = float(np.max(np.abs(got / want - 1.0)))
        mean = float(got.sum()) / k.work
        tol = 1e-3
        log("check", f"{name} ({got.size} blocks x "
            f"{k.obj.solves_per_grid_step} solves): max rel diff of the "
            f"per-block capacity sums {rel:.2e} <= {tol:g} (kernel: f32 "
            f"plane arithmetic; reference: XLA solver, f32, matmul "
            f"HIGHEST); mean capacity {mean:.4f} in {cap_range}")
        assert rel <= tol, (name, rel)
        assert cap_range[0] < mean < cap_range[1], (name, mean)

    k = kernels["alamouti"]
    got = np.asarray(k.fn(*k.args), np.int64)
    want = np.asarray(k.reference(), np.int64)
    diff = int(np.abs(got - want).sum())
    tol = max(4, int(1e-5 * want.sum()))
    ber = float(got.sum()) / (2 * k.work)
    log("check", f"alamouti ({k.work} symbols): kernel {int(got.sum())} vs "
        f"reference {int(want.sum())} bit errors, summed |diff| {diff} <= "
        f"{tol} (kernel: f32 sign arithmetic; reference: complex64 "
        f"combiner); BER at 10 dB {ber:.5f} in {ALAMOUTI_BER_10DB}")
    assert diff <= tol, (diff, tol)
    assert ALAMOUTI_BER_10DB[0] < ber < ALAMOUTI_BER_10DB[1], ber


# ---------------------------------------------------------------------------
# the flagship sweep through SimulationRunner
# ---------------------------------------------------------------------------

def make_chain_runner(sz: Sizes, fused: bool, snrs_db=SNRS_DB):
    import jax
    import jax.numpy as jnp
    import numpy as np

    import __graft_entry__ as g
    from pyphysim_tpu.simulations import Result, SimulationRunner
    from pyphysim_tpu.utils.conversion import dB2Linear

    class ChainRunner(SimulationRunner):
        """Batch path: one repetition = ``chain_symbols`` QAM symbols
        through the fused XLA chain or the time-domain chain."""

        def __init__(self):
            super().__init__(read_command_line_args=False)
            self.params.add("SNR", np.array(snrs_db))
            self.params.set_unpack_parameter("SNR")
            self.rep_max = sz.chain_reps
            self.batch_size = sz.chain_batch
            self.update_progress_function_style = None
            self.batch_result_types = {"bit_errors": Result.SUMTYPE,
                                       "ber": Result.RATIOTYPE}
            self._step = g._make_chain_step(
                num_symbols=sz.chain_symbols, fft_size=512, cp_size=52,
                num_used=300, block_static=True, fused=fused,
                precision=None if fused else jax.lax.Precision.HIGHEST)

        def _gen_simulation_kernel(self, current_parameters):
            snr = float(dB2Linear(float(current_parameters["SNR"])))
            bits = float(sz.chain_symbols * 4)
            step = self._step

            def kernel(key):
                errs = step(key, snr)
                return {"bit_errors": errs,
                        "ber": (errs.astype(jnp.float32),
                                jnp.float32(bits))}

            return kernel

    return ChainRunner()


def make_bulk_runner(sz: Sizes, snrs_db=SNRS_DB):
    import numpy as np

    from apps.ofdm.ofdm_mc_kernel import OfdmMcKernelSimulationRunner

    r = OfdmMcKernelSimulationRunner(ofdm_symbols=sz.ofdm_symbols,
                                     read_command_line_args=False)
    r.params.add("SNR", np.array(snrs_db))
    r.params.set_unpack_parameter("SNR")
    r.rep_max = sz.bulk_reps
    r.batch_size = sz.bulk_reps
    r.update_progress_function_style = None
    return r


def sweep_summary(runner):
    ber = runner.results.get_result_values_list("ber")
    ci = runner.results.get_result_values_confidence_intervals("ber", P=99)
    return [(float(b), (float(lo), float(hi))) for b, (lo, hi)
            in zip(ber, ci)]


def phase_sweep(sz: Sizes) -> None:
    import jax

    from bench import BER_CORNERS

    runs = {}
    for name, make, per_rep in (
            ("time_domain", lambda: make_chain_runner(sz, fused=False),
             sz.chain_symbols),
            ("fused_batch", lambda: make_chain_runner(sz, fused=True),
             sz.chain_symbols),
            ("fused_bulk", lambda: make_bulk_runner(sz),
             sz.ofdm_symbols * 300)):
        runner = make()
        t0 = time.perf_counter()
        with (jax.default_matmul_precision("highest")
              if name == "time_domain" else contextlib.nullcontext()):
            runner.simulate()
        dt = time.perf_counter() - t0
        log("sweep", f"{name}: {runner.runned_reps[0]} reps x {per_rep} "
            f"symbols = {runner.runned_reps[0] * per_rep:.4e} symbols per "
            f"SNR point, {len(SNRS_DB)} points in {dt:.2f} s "
            f"(compilation included)")
        runs[name] = sweep_summary(runner)

    for i, snr_db in enumerate(SNRS_DB):
        ref, (rlo, rhi) = runs["time_domain"][i]
        line = [f"{snr_db:4.0f} dB: time_domain {ref:.5e} "
                f"[{rlo:.5e}, {rhi:.5e}]"]
        for name in ("fused_batch", "fused_bulk"):
            ber, (lo, hi) = runs[name][i]
            agree = lo <= rhi and rlo <= hi
            line.append(f"{name} {ber:.5e} [{lo:.5e}, {hi:.5e}] "
                        f"{'agrees' if agree else 'DISAGREES'}")
            assert agree, (name, snr_db, ber, (lo, hi), ref, (rlo, rhi))
        log("sweep", "; ".join(line) + " (99% CIs)")
    for snr_db, (lo, hi) in BER_CORNERS.items():
        i = SNRS_DB.index(snr_db)
        for name, res in runs.items():
            assert lo < res[i][0] < hi, (name, snr_db, res[i][0])
        log("sweep", f"BER corner {snr_db:g} dB in ({lo:g}, {hi:g}) on "
            f"every path")


# ---------------------------------------------------------------------------
# timings
# ---------------------------------------------------------------------------

def alamouti_library_chain(symbols: int):
    """The family's XLA chain (bench.py ``ala_step``: jax.random bits,
    ``mimo.Alamouti`` encode/decode, QPSK demodulation) over
    ``symbols`` QAM symbols."""
    import jax
    import jax.numpy as jnp

    from pyphysim_tpu.mimo import Alamouti
    from pyphysim_tpu.modulators import QPSK
    from pyphysim_tpu.ops import cplx
    from pyphysim_tpu.utils.misc import count_bit_errors, randn_c

    mod, n = QPSK(), 2048
    batch = max(1, min(4096, symbols // n))
    steps = max(1, symbols // (batch * n))

    def ala_step(key):
        k1, k2, k3 = jax.random.split(key, 3)
        data = jax.random.randint(k1, (n,), 0, 4)
        h = randn_c(k2, 1, 2)
        obj = Alamouti(h)
        rx = cplx.matmul(h, obj.encode(mod.modulate(data))) + \
            randn_c(k3, 1, n) * jnp.sqrt(1.0 / 10.0)
        return count_bit_errors(data, mod.demodulate(obj.decode(rx)))

    @jax.jit
    def run(key):
        def body(carry, i):
            keys = jax.random.split(jax.random.fold_in(key, i), batch)
            return carry, jnp.sum(jax.vmap(ala_step)(keys))
        return jax.lax.scan(body, 0, jnp.arange(steps))[1]

    return run, steps * batch * n


def phase_timing(sz: Sizes, kernels) -> None:
    import jax
    import jax.numpy as jnp

    from apps.ofdm.ofdm_mc_kernel import build_bulk_chain

    for name, k in kernels.items():
        fns = {"kernel": lambda k=k: k.fn(*k.args),
               "xla_same_work": k.reference}
        work = {"kernel": k.work, "xla_same_work": k.work}
        if name == "alamouti":
            chain, work["xla_library_chain"] = alamouti_library_chain(
                k.work)
            fns["xla_library_chain"] = lambda: chain(
                jax.random.PRNGKey(17))
        res = timed(fns, sz.timing_runs)
        for version, (med, lo, hi) in res.items():
            log("timing", f"{name} {version}: median {med * 1e3:.3f} ms "
                f"[min {lo * 1e3:.3f}, max {hi * 1e3:.3f}] over "
                f"{sz.timing_runs} runs, {work[version]} {k.unit} -> "
                f"{work[version] / med:.4e} {k.unit}/s")

    bulk = build_bulk_chain(sz.ofdm_symbols, sz.bulk_reps)
    symbols = sz.ofdm_symbols * 300 * sz.bulk_reps
    med, lo, hi = timed({"bulk": lambda: bulk(
        jnp.int32(17), jnp.float32(10 ** 1.5))}, sz.timing_runs)["bulk"]
    log("timing", f"flagship fused chain, bulk path chunk: median "
        f"{med * 1e3:.3f} ms [min {lo * 1e3:.3f}, max {hi * 1e3:.3f}] over "
        f"{sz.timing_runs} runs, {symbols} symbols -> "
        f"{symbols / med:.4e} symbols/s (no Pallas kernel: XLA)")


# ---------------------------------------------------------------------------
# four cards
# ---------------------------------------------------------------------------

def phase_devices(sz: Sizes, n_dev: int, interpret: bool) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from apps.ofdm.ofdm_mc_kernel import build_bulk_chain
    from pyphysim_tpu.ops.ia_pallas import MonteCarloMaxSinr
    from pyphysim_tpu.parallel import make_mesh

    if len(jax.devices()) < n_dev:
        raise RuntimeError(f"--devices {n_dev} needs {n_dev} devices, "
                           f"found {len(jax.devices())}")
    mesh = make_mesh(n_dev)

    def peaks():
        stats = [d.memory_stats() or {} for d in mesh.devices.flat]
        return [s.get("peak_bytes_in_use", 0) for s in stats]

    ia = MonteCarloMaxSinr()
    snr, nv = jnp.float32(10 ** 1.5), jnp.float32(0.1)
    builds = (
        ("flagship bulk chain",
         lambda mesh=None: build_bulk_chain(sz.ofdm_symbols, sz.bulk_reps,
                                            mesh=mesh),
         (jnp.int32(7), snr)),
        ("ia_max_sinr kernel",
         lambda mesh=None: ia.build(sz.solve_reps, sz.solve_tiles,
                                    mesh=mesh, interpret=interpret),
         (jnp.int32(7), nv)),
    )
    for name, build, args in builds:
        one, many = build(), build(mesh)
        a = np.asarray(one(*args))
        b = np.asarray(many(*args))
        res = timed({"one": lambda: one(*args), "many": lambda: many(*args)},
                    sz.timing_runs)
        log("devices", f"{name} build(mesh={n_dev} cards) vs one card: "
            f"{'bit-identical' if np.array_equal(a, b) else 'DIFFERENT'} "
            f"(sum {float(a.sum()):.6g}); median one card "
            f"{res['one'][0] * 1e3:.3f} ms, {n_dev} cards "
            f"{res['many'][0] * 1e3:.3f} ms; peak bytes per device "
            f"{peaks()}")
        assert np.array_equal(a, b), name

    for name, make in (
            ("fused batch path", lambda: make_chain_runner(
                sz, True, sz.devices_snrs_db)),
            ("fused bulk path", lambda: make_bulk_runner(
                sz, sz.devices_snrs_db))):
        r1 = make()
        r1.simulate()
        rn = make()
        rn.simulate_in_parallel(mesh)
        same = rn.runned_reps == r1.runned_reps and all(
            np.array_equal(np.asarray(r1.results.get_result_values_list(k)),
                           np.asarray(rn.results.get_result_values_list(k)))
            for k in ("bit_errors", "ber"))
        errs = [int(v) for v in
                r1.results.get_result_values_list("bit_errors")]
        log("devices", f"{name}: simulate_in_parallel over {n_dev} cards "
            f"vs simulate() on one card, SNR {list(sz.devices_snrs_db)} "
            f"dB: {'bit-identical' if same else 'DIFFERENT'} (bit errors "
            f"per SNR {errs})")
        assert same, name

    final = peaks()
    log("devices", f"peak bytes in use per device at the end: {final}")
    if not interpret:
        # every card, not only the first, held work
        assert all(p > 0 for p in final), final


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--devices", type=int, default=1,
                    help="run only the multi-card phase on this many "
                         "cards (4)")
    ap.add_argument("--rehearse", action="store_true",
                    help="CPU rehearsal at toy sizes, kernels interpreted")
    args = ap.parse_args(argv)

    import jax

    dev = jax.devices()[0]
    info = {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}
    log("device", f"platform={info['platform']} kind={info['kind']} "
        f"count={info['count']}")
    if args.rehearse:
        sz, interpret = TOY, True
    else:
        if dev.platform != "gpu":
            print(f"chip_smoke: needs a GPU, JAX found {dev.platform!r}",
                  file=sys.stderr)
            return 1
        log("device", f"nvidia-smi name, power.limit: "
            f"{card_name_and_power_limit()}")
        log("device", f"compile cache: {use_compile_cache(jax)}")
        sz, interpret = FULL, False
    sys.path.insert(0, REPO)

    if args.devices > 1:
        phase_devices(sz, args.devices, interpret)
    else:
        kernels = make_kernels(sz, interpret)
        phase_compile(kernels)
        phase_check(kernels)
        phase_sweep(sz)
        phase_timing(sz, kernels)

    if args.rehearse:
        print(json.dumps({"rehearsal": True, "device": info}))
        return 0
    print(json.dumps({"ok": True, "device": info}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
