# %% [markdown]
# # Transmission over Rayleigh and AWGN channels (with MRC diversity)
#
# Tutorial counterpart of the reference's
# `Transmission_with_Rayleigh_and_AWGN_channels.ipynb` and `MRC.ipynb`:
# QPSK through (a) a pure AWGN channel, (b) a flat Rayleigh fading channel
# with one receive antenna, and (c) a 1x2 Rayleigh channel with maximum
# ratio combining. Everything is ONE vmapped device kernel per SNR point;
# the fading BER is compared against the closed-form Rayleigh curve.
#
# Runs as a script or as percent-format notebook cells.

# %%
import jax
import jax.numpy as jnp
import numpy as np

from pyphysim_tpu.modulators import QPSK
from pyphysim_tpu.utils.conversion import dB2Linear
from pyphysim_tpu.utils.misc import count_bit_errors, randn_c

mod = QPSK()
NUM_SYMBOLS = 20_000
NUM_REPS = 50
SNRS_DB = np.arange(0.0, 22.0, 3.0)

# %% [markdown]
# ## The three channel kernels
#
# Flat Rayleigh fading multiplies each symbol by h ~ CN(0, 1); the
# receiver knows h (coherent detection), so equalization is the
# matched-filter division. With two receive antennas, MRC combines
# y = h^H r / ||h||^2 which is exactly the Blast/MRC receive filter of
# `pyphysim_tpu.mimo` specialized to one stream — written inline here to
# keep the whole kernel in one screen.


# %%
def make_kernel(snr_db, mode):
    scale = float(np.sqrt(1.0 / dB2Linear(snr_db)))

    def kernel(key):
        k1, k2, k3 = jax.random.split(key, 3)
        data = jax.random.randint(k1, (NUM_SYMBOLS,), 0, mod.M)
        tx = mod.modulate(data)
        noise = randn_c(k2, NUM_SYMBOLS) * scale
        if mode == "awgn":
            y = tx + noise
        elif mode == "rayleigh":
            h = randn_c(k3, NUM_SYMBOLS)
            y = (h * tx + noise) * h.conj() / h.abs2()
        else:  # mrc over 2 rx antennas
            h = randn_c(k3, 2, NUM_SYMBOLS)
            noise2 = randn_c(k2, 2, NUM_SYMBOLS) * scale
            r = h * tx[None, :] + noise2
            num = (h.conj() * r).sum(axis=0)
            y = num / h.abs2().sum(axis=0)
        decided = mod.demodulate(y)
        return count_bit_errors(data, decided)

    return kernel


def simulate(mode):
    ber = []
    for snr_db in SNRS_DB:
        kernel = make_kernel(snr_db, mode)
        keys = jax.random.split(jax.random.PRNGKey(int(snr_db)), NUM_REPS)
        errors = jax.jit(lambda ks: jnp.sum(jax.vmap(kernel)(ks)))(keys)
        ber.append(int(errors) / (NUM_SYMBOLS * NUM_REPS * mod.K))
    return np.array(ber)


ber_awgn = simulate("awgn")
ber_rayleigh = simulate("rayleigh")
ber_mrc = simulate("mrc")

# %% [markdown]
# ## Compare against theory
#
# AWGN: the QPSK closed form. Flat Rayleigh (1 rx): per-bit
# `0.5 (1 - sqrt(g / (1 + g)))` with g the average SNR per bit. MRC with
# L antennas follows the diversity-order-L closed form.

# %%
snr_lin = dB2Linear(SNRS_DB)
theory_awgn = mod.calcTheoreticalBER(SNRS_DB)
g = snr_lin / mod.K  # average SNR per bit
theory_rayleigh = 0.5 * (1.0 - np.sqrt(g / (1.0 + g)))
mu = np.sqrt(g / (1.0 + g))
theory_mrc = (((1 - mu) / 2) ** 2) * (2 + mu)  # L = 2 diversity

print(f"{'SNR':>5} {'AWGN sim':>10} {'AWGN th':>10} {'Ray sim':>10} "
      f"{'Ray th':>10} {'MRC sim':>10} {'MRC th':>10}")
for i, s in enumerate(SNRS_DB):
    print(f"{s:5.0f} {ber_awgn[i]:10.2e} {theory_awgn[i]:10.2e} "
          f"{ber_rayleigh[i]:10.2e} {theory_rayleigh[i]:10.2e} "
          f"{ber_mrc[i]:10.2e} {theory_mrc[i]:10.2e}")

# %% [markdown]
# Fading costs orders of magnitude at high SNR (the BER decays only as
# 1/SNR), and two-branch MRC restores a slope of 1/SNR^2 — the classic
# diversity picture, reproduced at device speed.

# %%
try:
    from matplotlib import pyplot as plt
    plt.semilogy(SNRS_DB, ber_awgn, "o-", label="AWGN (sim)")
    plt.semilogy(SNRS_DB, ber_rayleigh, "s-", label="Rayleigh (sim)")
    plt.semilogy(SNRS_DB, ber_mrc, "^-", label="Rayleigh + MRC 1x2 (sim)")
    plt.semilogy(SNRS_DB, theory_awgn, "k:", label="theory")
    plt.semilogy(SNRS_DB, theory_rayleigh, "k:")
    plt.semilogy(SNRS_DB, theory_mrc, "k:")
    plt.xlabel("SNR (dB)"), plt.ylabel("BER"), plt.legend()
    plt.grid(True, which="both")
    plt.savefig("rayleigh_awgn_ber.png", dpi=120)
    print("Saved rayleigh_awgn_ber.png")
except ImportError:
    pass
