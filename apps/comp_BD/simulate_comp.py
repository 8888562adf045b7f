#!/usr/bin/env python
"""Full CoMP Block Diagonalization scenario simulator.

JAX-native counterpart of the reference's LARGEST app,
``apps/comp_BD/simulate_comp.py:1-883``: a cell-grid cluster with one
user per cell (dropped at a RANDOM position each repetition, or at the
symmetric far-away border points), 3GPP path-loss-derived channels, an
external interference source at the cluster border, and a sweep
comparing ALL the stream-sacrifice metric variants of EnhancedBD
("None", "naive", "fixed", "capacity", "effective_throughput") AND
WhiteningBD over an (SNR, Pe_dBm) grid — recording BER / SER / packet
error rate / effective spectral efficiency / mean SINR per metric, the
reference's full result surface.

Device-first delta: the reference solves one numpy realization per
repetition inside ``_run_simulation``; here the default engine is the
SimulationRunner BULK path — per chunk, the host vectorizes ONLY the
scenario geometry (user drops -> path-loss matrices, exact
triangle-fan hexagon sampling keyed by the absolute attempt index, so
results are chunk-size invariant and resumable), and one jitted device
program draws the channels and runs all six precoder solvers
(``enhanced_bd_batched`` x 5 metrics + ``whitening_bd_batched``) plus
the full transmit chain for every repetition in the chunk. The host
per-repetition engine (``engine="host"``, the reference flow on the
host solver classes) remains available as the parity anchor.

Run:  python apps/comp_BD/simulate_comp.py [-c config] [-i index]
"""

import sys

sys.path.insert(0, ".")

import numpy as np

from pyphysim_tpu.cell.cell import Grid
from pyphysim_tpu.channels.multiuser import MultiUserChannelMatrixExtInt
from pyphysim_tpu.channels.pathloss import PathLoss3GPP1
from pyphysim_tpu.comm.blockdiagonalization import EnhancedBD, WhiteningBD
from pyphysim_tpu.modulators import BPSK, PSK, QAM, QPSK
from pyphysim_tpu.simulations import (Result, SimulationResults,
                                      SimulationRunner)
from pyphysim_tpu.utils.conversion import dB2Linear, dBm2Linear
from pyphysim_tpu.utils.misc import count_bit_errors, randn_c_RS

# Config spec mirroring the reference's (simulate_comp.py:37-61)
SPEC = """[Grid]
cell_radius=float(min=0.01, default=1.0)
num_cells=integer(min=3, default=3)
num_clusters=integer(min=1, default=1)
[Scenario]
NSymbs=integer(min=10, max=1000000, default=500)
SNR=real_numpy_array(min=-50, max=100, default=0:3:31)
Pe_dBm=real_numpy_array(min=-50, max=100, default=[-10. 0. 10.])
Nr=integer(default=2)
Nt=integer(default=2)
N0=float(default=-116.4)
ext_int_rank=integer(min=1, default=1)
user_positioning_method=option("Random", 'Symmetric Far Away', default="Symmetric Far Away")
[Modulation]
M=integer(min=4, max=512, default=4)
modulator=option('PSK', 'QPSK', 'QAM', 'BPSK', default="PSK")
packet_length=integer(min=1, default=60)
[General]
rep_max=integer(min=1, default=5000)
unpacked_parameters=string_list(default=list('SNR','Pe_dBm'))
""".split("\n")

# result-name suffixes, matching the reference's
# (simulate_comp.py:444-486: 'None', 'naive', 'fixed', 'capacity',
# 'effec_throughput', 'Whitening')
METRICS = ["None", "naive", "fixed", "capacity", "effec_throughput",
           "Whitening"]


def _make_modulator(name: str, M: int):
    if name == "BPSK":
        return BPSK()
    if name == "QPSK":
        return QPSK()
    if name == "QAM":
        return QAM(M)
    return PSK(M)


def _hexagon_fan(cluster):
    """(centers (K,), vertices (K, 6)) complex arrays of the cluster's
    cells, for exact vectorized uniform sampling (each hexagon = a fan
    of 6 triangles around its center)."""
    centers = np.array([c.pos for c in cluster._cells])
    verts = np.stack([np.asarray(c.vertices) for c in cluster._cells])
    return centers, verts


class BDSimulationRunner(SimulationRunner):
    """The reference's ``BDSimulationRunner`` (simulate_comp.py:30-660)
    on the device engine: one runner computes ALL six metric variants per
    repetition (sharing data / external interference / noise draws, as
    the reference does)."""

    def __init__(self, read_command_line_args: bool = True,
                 engine: str = "device",
                 default_config_file: str = None,
                 metrics=None):
        import os
        if default_config_file is None:
            default_config_file = os.path.join(
                os.path.dirname(os.path.abspath(__file__)),
                "bd_config_file.txt")
        super().__init__(default_config_file, SPEC, read_command_line_args)

        self.engine = engine
        # optional subset of METRICS to simulate (all six by default);
        # e.g. CI runs a 2-metric subset — the EnhancedBD candidate
        # unrolls dominate the device program's compile time
        self.metrics = list(METRICS if metrics is None else metrics)
        unknown = set(self.metrics) - set(METRICS)
        if unknown:
            raise ValueError(f"unknown metrics: {sorted(unknown)}")
        self.path_loss_obj = PathLoss3GPP1()
        self.cell_grid = Grid()
        self.cell_grid.create_clusters(int(self.params["num_clusters"]),
                                       int(self.params["num_cells"]),
                                       float(self.params["cell_radius"]))
        self._cluster0 = self.cell_grid.get_cluster_from_index(0)
        self._centers, self._verts = _hexagon_fan(self._cluster0)
        self.noise_var = float(dBm2Linear(float(self.params["N0"])))
        self.modulator = _make_modulator(str(self.params["modulator"]),
                                         int(self.params["M"]))
        self.rep_max = int(self.params["rep_max"])
        self.batch_size = 32
        self.progressbar_message = "SNR: {SNR}, Pe_dBm: {Pe_dBm}"

        self.batch_result_types = {}
        for m in self.metrics:
            self.batch_result_types[f"ber_{m}"] = Result.RATIOTYPE
            self.batch_result_types[f"ser_{m}"] = Result.RATIOTYPE
            self.batch_result_types[f"per_{m}"] = Result.RATIOTYPE
            self.batch_result_types[f"spec_effic_{m}"] = Result.RATIOTYPE
            self.batch_result_types[f"sinr_{m}"] = Result.RATIOTYPE

        # host channel object for the parity engine
        self.multiuser_channel = MultiUserChannelMatrixExtInt()
        self.multiuser_channel.noise_var = self.noise_var

        # compiled device programs keyed by the parameter point; shared
        # between runner instances (bench warm/timed runs) by assigning
        # the dict — the programs close over parameter VALUES only
        self._vkernels = {}

    # -- shared scenario helpers ------------------------------------------

    def _transmit_power(self, snr_db: float) -> float:
        """Transmit power giving the desired mean SNR at the cell border
        (simulate_comp.py:664-698)."""
        pl_border = float(self.path_loss_obj.calc_path_loss(
            float(self.params["cell_radius"])))
        return float(dB2Linear(snr_db)) * self.noise_var / pl_border

    def _positions_for_attempts(self, p, start: int, n: int) -> np.ndarray:
        """User positions (n, K) complex for absolute attempts
        [start, start+n) — a pure function of (base_seed, unpack_index,
        attempt), which is what makes the bulk path chunk-size
        invariant and resumable.

        Random drops ride ONE counter-based Philox stream keyed by
        (base_seed, unpack_index): attempt ``i`` owns a fixed
        BLOCK-ALIGNED draw window (Philox counters index 4-word output
        blocks, so each attempt gets ceil(3K/4) whole blocks — setting
        ``counter = start * blocks_per_attempt`` reaches it in O(1);
        ``Philox.advance`` does NOT align with stream positions and
        cannot be used here). Any chunking/resume therefore reads
        identical values, the whole chunk is one vectorized draw, and
        there is no per-attempt RandomState construction (which
        measured ~0.4 ms/attempt and dominated the engine at wide
        chunks)."""
        method = str(p["user_positioning_method"])
        K = self._centers.size
        if method != "Random":
            # Symmetric Far Away (simulate_comp.py:171-185): fixed
            # border points at 70% radius, angles 210 / -30 / 90 deg
            if K != 3:
                raise ValueError(
                    "'Symmetric Far Away' needs num_cells == 3")
            ang = np.deg2rad(np.array([210.0, -30.0, 90.0]))
            r = 0.7 * float(self.params["cell_radius"])
            return np.tile(self._centers + r * np.exp(1j * ang), (n, 1))
        B = 3 * K                          # doubles needed per attempt
        blocks = (B + 3) // 4              # whole 4-word blocks
        W = 4 * blocks                     # words drawn per attempt
        bg = np.random.Philox(
            key=np.array([self.base_seed & 0xFFFFFFFFFFFFFFFF,
                          max(p.unpack_index, 0)], dtype=np.uint64),
            counter=np.array([start * blocks, 0, 0, 0], np.uint64))
        u = np.random.Generator(bg).random(n * W).reshape(n, W)
        # exact triangle-fan hexagon sampling, vectorized over attempts
        tri = np.minimum((u[:, :K] * 6).astype(np.int64), 5)
        r1 = np.sqrt(u[:, K:2 * K])
        r2 = u[:, 2 * K:3 * K]
        k_idx = np.arange(K)[None, :]
        A = self._verts[k_idx, tri] - self._centers[None, :]
        Bv = self._verts[k_idx, (tri + 1) % 6] - self._centers[None, :]
        return self._centers[None, :] + r1 * (A + r2 * (Bv - A))

    def _positions_for_attempt(self, p, attempt: int) -> np.ndarray:
        """Scalar view of :meth:`_positions_for_attempts` (the host
        parity engine's per-repetition call — same stream, same
        values)."""
        return self._positions_for_attempts(p, attempt, 1)[0]

    def _scenario_pathloss(self, p, start: int, n: int):
        """sqrt path-loss arrays for attempts [start, start+n):
        (n, K, K) user-to-cell and (n, K) ext-int-to-user; one
        vectorized position draw + one vectorized path-loss call."""
        pos = self._positions_for_attempts(p, start, n)
        dists = np.abs(pos[:, :, None] - self._centers[None, None, :])
        spl = np.sqrt(self.path_loss_obj.calc_path_loss(dists))
        d_center = np.abs(pos - self._cluster0.pos)
        spl_i = np.sqrt(self.path_loss_obj.calc_path_loss(
            self._cluster0.external_radius - d_center))
        return np.asarray(spl), np.asarray(spl_i)

    # -- device bulk engine ------------------------------------------------

    def _gen_bulk_kernel(self, p):
        if self.engine != "device":
            return None
        import jax
        import jax.numpy as jnp

        from pyphysim_tpu.comm.batched import (enhanced_bd_batched,
                                               whitening_bd_batched)
        from pyphysim_tpu.ops import cplx
        from pyphysim_tpu.utils.misc import randn_c

        K = self._centers.size
        nr, nt = int(p["Nr"]), int(p["Nt"])
        if nt < nr:
            raise ValueError(
                "device engine needs Nt >= Nr per BS (the coherent "
                "stream-sacrifice family); use engine='host'")
        rank = int(p["ext_int_rank"])
        NSymbs = int(p["NSymbs"])
        M = int(p["M"])
        L = int(p["packet_length"])
        mod = self.modulator
        Kmod = mod.K
        pt = self._transmit_power(float(p["SNR"]))
        pe = float(dBm2Linear(float(p["Pe_dBm"])))
        nv = self.noise_var
        base = jax.random.fold_in(jax.random.PRNGKey(self.base_seed),
                                  max(p.unpack_index, 0))
        solver_cases = [c for c in [
            ("None", None, {}),
            ("naive", "naive", {"num_streams": 1}),
            ("fixed", "fixed", {"num_streams": 1}),
            ("capacity", "capacity", {}),
            ("effec_throughput", "effective_throughput",
             {"modulator": mod, "packet_length": L}),
        ] if c[0] in self.metrics]
        do_whitening = "Whitening" in self.metrics
        cache_key = (float(p["SNR"]), float(p["Pe_dBm"]), K, nr, nt,
                     rank, NSymbs, M, L, tuple(self.metrics), nv,
                     self.base_seed)

        def rep_kernel(key, spl, spl_i):
            kH, kE, kD, kX, kN = jax.random.split(key, 5)
            Hb = randn_c(kH, K, K, nr, nt)          # [rx k, tx j]
            Hb = cplx.CArray(Hb.re * spl[:, :, None, None],
                             Hb.im * spl[:, :, None, None])
            H = cplx.concatenate(
                [cplx.concatenate([Hb[k, j] for j in range(K)], axis=-1)
                 for k in range(K)], axis=-2)       # (K*nr, K*nt)
            He = randn_c(kE, K, nr, rank)
            He = cplx.CArray(He.re * spl_i[:, None, None],
                             He.im * spl_i[:, None, None])
            gram = cplx.matmul(He, He.mH)
            eye = jnp.eye(nr, dtype=jnp.float32)
            R = cplx.CArray(pe * gram.re + nv * eye, pe * gram.im)

            sols = []
            valid = jnp.asarray(True)
            names = [c[0] for c in solver_cases]
            for _, metric, kw in solver_cases:
                Ms, Wk, Ns, sinrs, ok = enhanced_bd_batched(
                    H, R, K, pt, metric=metric, **kw)
                sols.append((Ms, Wk, Ns, sinrs))
                valid = valid & ok
            if do_whitening:
                Ms_w, Wk_w, ok_w = whitening_bd_batched(H, R, K, pt)
                valid = valid & ok_w
                # WhiteningBD keeps all streams; its SINRs use the same
                # formula as EnhancedBD (_calc_linear_SINRs,
                # blockdiagonalization.py:1100-1139)
                sinr_w = []
                for k in range(K):
                    Heq = cplx.matmul(H[k * nr:(k + 1) * nr, :], Ms_w[k])
                    mtP = cplx.matmul(Wk_w[k], Heq)
                    desired = cplx.CArray(
                        jnp.diagonal(mtP.re, axis1=-2, axis2=-1),
                        jnp.diagonal(mtP.im, axis1=-2, axis2=-1)).abs2()
                    internal = jnp.sum(mtP.abs2(), axis=-1) - desired
                    wrw = cplx.matmul(Wk_w[k],
                                      cplx.matmul(R[k], Wk_w[k].mH))
                    ext_n = jnp.abs(
                        jnp.diagonal(wrw.re, axis1=-2, axis2=-1))
                    sinr_w.append(desired /
                                  jnp.maximum(internal + ext_n, 1e-30))
                sols.append((Ms_w, Wk_w,
                             jnp.full((K,), float(nr)),
                             jnp.stack(sinr_w)))
                names.append("Whitening")

            data = jax.random.randint(kD, (K, nr, NSymbs), 0, M)
            x = mod.modulate(data)
            ext = randn_c(kX, rank, NSymbs) * float(np.sqrt(pe))
            He_stack = cplx.concatenate([He[k] for k in range(K)],
                                        axis=-2)    # (K*nr, rank)
            noise = randn_c(kN, K * nr, NSymbs) * float(np.sqrt(nv))

            out = {}
            for name, (Ms, Wk, Ns, sinrs) in zip(names, sols):
                tx = cplx.matmul(Ms[0], x[0])
                for k in range(1, K):
                    tx = tx + cplx.matmul(Ms[k], x[k])
                rx = cplx.matmul(H, tx) + cplx.matmul(He_stack, ext) + \
                    noise
                sym_errs = jnp.asarray(0.0, jnp.float32)
                bit_errs = jnp.asarray(0.0, jnp.float32)
                pkg_errs = jnp.asarray(0.0, jnp.float32)
                spec_eff = jnp.asarray(0.0, jnp.float32)
                for k in range(K):
                    y = cplx.matmul(Wk[k], rx[k * nr:(k + 1) * nr, :])
                    decided = mod.demodulate(y)      # (nr, NSymbs)
                    active = (jnp.arange(nr, dtype=jnp.float32) <
                              Ns[k])                 # (nr,)
                    stream_sym = jnp.sum(
                        jnp.where(active[:, None],
                                  decided != data[k], False), axis=-1)
                    sym_errs = sym_errs + jnp.sum(stream_sym)
                    stream_bits = jax.vmap(count_bit_errors)(
                        jnp.where(active[:, None].astype(bool),
                                  data[k], 0),
                        jnp.where(active[:, None].astype(bool),
                                  decided, 0))       # (nr,)
                    bit_errs = bit_errs + jnp.sum(stream_bits)
                    # per-stream PER -> packet errors + effective
                    # spectral efficiency (simulate_comp.py:560-585)
                    ber_s = stream_bits / float(NSymbs * Kmod)
                    per_s = 1.0 - (1.0 - ber_s) ** L
                    pkg_errs = pkg_errs + jnp.sum(
                        jnp.where(active > 0, per_s, 0.0) *
                        float(NSymbs * Kmod / L))
                    spec_eff = spec_eff + jnp.sum(
                        jnp.where(active > 0,
                                  (1.0 - per_s) * Kmod, 0.0))
                n_streams = jnp.sum(Ns)
                n_syms = n_streams * NSymbs
                out[f"ber_{name}"] = (bit_errs, n_syms * Kmod)
                out[f"ser_{name}"] = (sym_errs, n_syms)
                out[f"per_{name}"] = (pkg_errs,
                                      n_syms * Kmod / L)
                out[f"spec_effic_{name}"] = (spec_eff,
                                             jnp.asarray(1.0))
                out[f"sinr_{name}"] = (jnp.sum(sinrs), n_streams)
            out["__valid__"] = valid
            return out

        if cache_key not in self._vkernels:
            vmapped = jax.vmap(rep_kernel)
            box = {}

            @jax.jit
            def packed(keys, spl, spl_i):
                out = vmapped(keys, spl, spl_i)
                # the engine's single-transfer packing: every
                # device-to-host transfer pays a fixed latency, so the
                # ~31 per-metric result arrays are packed into one
                # array and fetched once per chunk
                ones = jnp.ones(keys.shape[0], bool)
                return self._pack_tree(out, ones, box)

            self._vkernels[cache_key] = (packed, box)
            # bounded cache: a full sweep visits dozens of parameter
            # points, each a large compiled program — keep the bench's
            # warm/timed reuse without unbounded executable retention
            while len(self._vkernels) > 4:
                self._vkernels.pop(next(iter(self._vkernels)))
        packed, box = self._vkernels[cache_key]

        def bulk(start, n):
            spl, spl_i = self._scenario_pathloss(p, start, n)
            keys = jax.vmap(
                lambda i: jax.random.fold_in(base, i))(
                    np.arange(start, start + n))
            # lazy: the bulk loop enqueues the next speculative chunk
            # before materialize() triggers the one host fetch
            return self._LazyChunk(
                packed(keys, jnp.asarray(spl, jnp.float32),
                       jnp.asarray(spl_i, jnp.float32)), box)

        return bulk

    # -- host parity engine (the reference's flow) -------------------------

    def _run_simulation(self, current_parameters):
        p = current_parameters
        K = self._centers.size
        nr, nt = int(p["Nr"]), int(p["Nt"])
        rank = int(p["ext_int_rank"])
        NSymbs = int(p["NSymbs"])
        M = int(p["M"])
        L = int(p["packet_length"])
        mod = self.modulator
        pt = self._transmit_power(float(p["SNR"]))
        pe = float(dBm2Linear(float(p["Pe_dBm"])))

        # the engine's resume-safe serial cursor (monotone within the
        # variation, derived from the persisted repetition count): a
        # checkpoint-resume of engine='host' continues the attempt
        # sequence instead of replaying accumulated realizations (the
        # bulk engine's absolute-cursor contract, serial-path form).
        # Mix in the unpack index so variations draw independently.
        attempt = self.serial_attempt
        salt = max(p.unpack_index, 0) * 1_000_003 + attempt
        pos = self._positions_for_attempt(p, attempt)
        dists = np.abs(pos[:, None] - self._centers[None, :])
        pathloss = np.asarray(self.path_loss_obj.calc_path_loss(dists))
        d_center = np.abs(pos - self._cluster0.pos)
        pathloss_int = np.asarray(self.path_loss_obj.calc_path_loss(
            self._cluster0.external_radius - d_center)).reshape(K, 1)

        mu = self.multiuser_channel
        mu.randomize(np.full(K, nr), np.full(K, nt), K, rank)
        mu.set_pathloss(pathloss, pathloss_int)

        solvers = {}
        for name, metric, extra in [
                ("None", "None", None),
                ("naive", "naive", {"num_streams": 1}),
                ("fixed", "fixed", {"num_streams": 1}),
                ("capacity", "capacity", None),
                ("effec_throughput", "effective_throughput",
                 {"modulator": mod, "packet_length": L})]:
            if name not in self.metrics:
                continue
            bd = EnhancedBD(K, pt, self.noise_var, pe)
            bd.set_ext_int_handling_metric(metric, extra)
            solvers[name] = bd.block_diagonalize_no_waterfilling(mu)
        if "Whitening" in self.metrics:
            wbd = WhiteningBD(K, pt, self.noise_var, pe)
            solvers["Whitening"] = \
                wbd.block_diagonalize_no_waterfilling(mu)

        rs = np.random.RandomState(salt & 0x7FFFFFFF)
        ext_data = (np.sqrt(pe) *
                    randn_c_RS(rs, rank, NSymbs))
        # ALL metrics share the same data / ext-interference / noise
        # draws, as the reference does by re-seeding per metric
        # (simulate_comp.py:524-545) and as the device engine does by
        # construction: re-seed the data stream and reuse one noise key
        # for every metric
        data_seed = (salt * 7919 + 13) & 0x7FFFFFFF
        noise_key = __import__("jax").random.PRNGKey(
            (salt * 104729 + 7) & 0x7FFFFFFF)
        results = SimulationResults()
        for name, (MsPk, Wk, Ns) in solvers.items():
            Ns_total = int(np.sum(Ns))
            data = np.random.RandomState(data_seed).randint(
                0, M, (Ns_total, NSymbs))
            symbols = np.asarray(mod.modulate(data))
            precoded = np.hstack(list(MsPk)) @ symbols
            all_data = np.vstack([precoded, ext_data])
            received = np.asarray(
                mu.corrupt_concatenated_data(all_data, key=noise_key))
            from scipy.linalg import block_diag
            W = block_diag(*list(Wk))
            decided = np.asarray(mod.demodulate(W @ received))
            sym_errs = int(np.sum(decided != data))
            bit_errs = int(count_bit_errors(data, decided))
            ber_s = np.array([
                int(count_bit_errors(data[s], decided[s])) /
                (NSymbs * mod.K) for s in range(Ns_total)])
            per_s = 1.0 - (1.0 - ber_s) ** L
            n_pkgs = NSymbs * mod.K / L
            sinr_all = mu.calc_JP_SINR(
                list(MsPk), [np.asarray(w).conj().T for w in Wk], pe)
            results.add_result(Result.create(
                f"ber_{name}", Result.RATIOTYPE, bit_errs,
                Ns_total * NSymbs * mod.K))
            results.add_result(Result.create(
                f"ser_{name}", Result.RATIOTYPE, sym_errs,
                Ns_total * NSymbs))
            results.add_result(Result.create(
                f"per_{name}", Result.RATIOTYPE,
                float(np.sum(per_s) * n_pkgs), Ns_total * n_pkgs))
            results.add_result(Result.create(
                f"spec_effic_{name}", Result.RATIOTYPE,
                float(np.sum((1 - per_s) * mod.K)), 1))
            sinr_flat = np.concatenate(
                [np.atleast_1d(np.asarray(s)) for s in sinr_all])
            results.add_result(Result.create(
                f"sinr_{name}", Result.RATIOTYPE,
                float(np.sum(sinr_flat)), sinr_flat.size))
        return results


if __name__ == "__main__":
    from pyphysim_tpu.simulations import simulate_do_what_i_mean

    runner = BDSimulationRunner()
    runner.set_results_filename(
        "bd_results_{Nr}x{Nt}_ext_int_rank_{ext_int_rank}")
    simulate_do_what_i_mean(runner, ".")
    if runner.command_line_args.index is None:
        print(f"Runned iterations: {runner.runned_reps}")
        print(f"Elapsed Time: {runner.elapsed_time}")
