#!/usr/bin/env python
"""Max-SINR IA with quantized (limited-feedback) channel knowledge.

Counterpart of the reference's ``apps/ia/simple_maxsinr_quantized.py``:
each cross-link channel block is quantized to the nearest codeword of a
random vector codebook (the CSI the transmitters would get over a limited
feedback link); Max-SINR IA is solved on the QUANTIZED channel while the
data is transmitted over the TRUE channel, and the BER degradation against
perfect-CSI IA is measured.

Device redesign: the reference loops rep_max=300 host repetitions, each with a
Python codebook scan per channel block. Here quantization is one real
matmul against the whole codebook + argmax + one-hot contraction (no
gathers), the IA solve is the batched fixed-iteration Max-SINR from
``pyphysim_tpu.ia.batched``, and all repetitions run in ONE vmapped
dispatch.

Run:  python apps/ia/simple_maxsinr_quantized.py [--reps 300]
         [--codebook-size 512]
"""

import argparse
import sys

sys.path.insert(0, ".")

import jax
import jax.numpy as jnp
import numpy as np

from pyphysim_tpu.ia import batched
from pyphysim_tpu.ops import cplx
from pyphysim_tpu.ops.cplx import CArray
from pyphysim_tpu.utils.conversion import dB2Linear
from pyphysim_tpu.utils.misc import randn_c


def gen_codebook(key, codebook_size, dimension):
    """Random unit-norm codewords, shape (codebook_size, dimension)
    (reference gen_codebook via SVD of a random vector — a random unit
    vector either way)."""
    c = randn_c(key, codebook_size, dimension)
    norm = jnp.sqrt(jnp.sum(c.abs2(), axis=-1, keepdims=True))
    return CArray(c.re / norm, c.im / norm)


def quantize_channel(H, codebook):
    """Quantize each (Nr, Nt) block of ``H`` (K, K, Nr, Nt) to its nearest
    codeword (min euclidean distance after normalization, as the
    reference's quant_small_matrix/calc_dist).

    Minimizing ``||v/||v|| - c||^2 = 2 - 2 Re<v, c>`` means maximizing
    ``Re<v, c>`` — one real contraction against the whole codebook.
    """
    K1, K2, Nr, Nt = H.shape
    v = CArray(H.re.reshape(K1, K2, Nr * Nt), H.im.reshape(K1, K2, Nr * Nt))
    norm = jnp.sqrt(jnp.sum(v.abs2(), axis=-1, keepdims=True))
    v = CArray(v.re / norm, v.im / norm)
    # Re<v, c> for every (block, codeword) pair
    scores = (jnp.einsum("abd,cd->abc", v.re, codebook.re) +
              jnp.einsum("abd,cd->abc", v.im, codebook.im))
    onehot = jax.nn.one_hot(jnp.argmax(scores, axis=-1), codebook.shape[0],
                            dtype=H.re.dtype)
    q = CArray(jnp.einsum("abc,cd->abd", onehot, codebook.re),
               jnp.einsum("abc,cd->abd", onehot, codebook.im))
    return CArray(q.re.reshape(K1, K2, Nr, Nt), q.im.reshape(K1, K2, Nr, Nt))


def main():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--reps", type=int, default=300)
    parser.add_argument("--codebook-size", type=int, default=512)
    parser.add_argument("--snr", type=float, default=15.0)
    parser.add_argument("--nsymbs", type=int, default=50)
    args = parser.parse_args()

    K, Nr, Nt, Ns = 3, 2, 2, 1
    noise_var = 1.0 / dB2Linear(args.snr)
    iterations = 60

    key = jax.random.PRNGKey(0)
    k_cb, k_run = jax.random.split(key)
    codebook = gen_codebook(k_cb, args.codebook_size, Nr * Nt)

    def one_rep(k, quantized):
        kH, kF, kd, kn = jax.random.split(k, 4)
        H = randn_c(kH, K, K, Nr, Nt)
        H_csi = quantize_channel(H, codebook) if quantized else H
        F, U = batched.max_sinr_solve(H_csi, kF, Ns, 1.0, noise_var,
                                      iterations=iterations)
        # BPSK data, one stream per user
        bits = jax.random.randint(kd, (K, Ns, args.nsymbs), 0, 2)
        x = CArray(2.0 * bits - 1.0, jnp.zeros(bits.shape))
        # receive over the TRUE channel: rx_k = sum_l H_kl F_l x_l + n
        noise = randn_c(kn, K, Nr, args.nsymbs)
        rx = []
        for kk in range(K):
            acc = CArray(noise.re[kk] * jnp.sqrt(noise_var),
                         noise.im[kk] * jnp.sqrt(noise_var))
            for ll in range(K):
                acc = acc + cplx.matmul(cplx.matmul(H[kk, ll], F[ll]), x[ll])
            # interference cancellation with the IA receive filter
            rx.append(cplx.matmul(U[kk].mH, acc))
        y = cplx.stack(rx, axis=0)
        decided = (y.re < 0).astype(jnp.int32) ^ 1  # BPSK: sign of Re
        errors = jnp.sum(decided != bits)
        return errors

    @jax.jit
    def run(keys):
        err_q = jax.vmap(lambda k: one_rep(k, True))(keys)
        err_p = jax.vmap(lambda k: one_rep(k, False))(keys)
        return jnp.sum(err_q), jnp.sum(err_p)

    keys = jax.random.split(k_run, args.reps)
    err_q, err_p = run(keys)
    num_bits = args.reps * K * Ns * args.nsymbs
    print(f"SNR {args.snr} dB, {args.reps} reps, codebook size "
          f"{args.codebook_size}, {K} users {Nr}x{Nt}({Ns})")
    print(f"BER with quantized CSI: {int(err_q) / num_bits:.5f}")
    print(f"BER with perfect CSI:   {int(err_p) / num_bits:.5f}")


if __name__ == "__main__":
    main()
